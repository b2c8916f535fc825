// MP3 export sink via libmp3lame.
//
// Mirrors the reference's LAME configuration exactly
// (reference: src/processor/audio-io.cpp:809-831): CBR (vbr_off), quality 2,
// STEREO/MONO mode by channel count, out_samplerate forced to the canonical
// rate so LAME performs the final resample — and the per-format encode entry
// points (audio-io.cpp:696-789): int16 PCM goes through the integer API for
// a bit-identical path, float PCM through the ieee_float API.
//
// The image ships libmp3lame.so.0 without headers, so the needed API surface
// is declared locally (stable public LAME ABI) and bound via dlopen.

#include "nodey_host.h"

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

void set_err(char* errbuf, int len, const char* msg) {
  if (errbuf && len > 0) std::snprintf(errbuf, static_cast<size_t>(len), "%s", msg);
}

// Public LAME ABI subset (lame.h). MPEG_mode: STEREO=0, MONO=3.
// vbr_mode: vbr_off=0.
typedef void* lame_t;
struct LameApi {
  lame_t (*init)();
  int (*set_in_samplerate)(lame_t, int);
  int (*set_num_channels)(lame_t, int);
  int (*set_quality)(lame_t, int);
  int (*set_mode)(lame_t, int);
  int (*set_out_samplerate)(lame_t, int);
  int (*set_VBR)(lame_t, int);
  int (*set_brate)(lame_t, int);
  int (*init_params)(lame_t);
  int (*encode_buffer)(lame_t, const short*, const short*, int,
                       unsigned char*, int);
  int (*encode_buffer_interleaved)(lame_t, short*, int, unsigned char*, int);
  int (*encode_buffer_ieee_float)(lame_t, const float*, const float*, int,
                                  unsigned char*, int);
  int (*encode_buffer_interleaved_ieee_float)(lame_t, const float*, int,
                                              unsigned char*, int);
  int (*encode_flush)(lame_t, unsigned char*, int);
  int (*close)(lame_t);
  // Optional symbols (present in every lame >= 3.98; checked before use):
  // segmented parallel encode needs frame-independent output (reservoir
  // off) and tag-less interior segments.
  int (*set_bWriteVbrTag)(lame_t, int) = nullptr;
  int (*set_disable_reservoir)(lame_t, int) = nullptr;
  int (*get_encoder_delay)(lame_t) = nullptr;
  size_t (*get_lametag_frame)(lame_t, unsigned char*, size_t) = nullptr;
  void* handle = nullptr;
  bool ok = false;
};

LameApi load_lame() {
  LameApi api{};
  void* h = dlopen("libmp3lame.so.0", RTLD_NOW | RTLD_LOCAL);
  if (!h) h = dlopen("libmp3lame.so", RTLD_NOW | RTLD_LOCAL);
  if (!h) return api;
  api.handle = h;
  auto sym = [&](const char* name) { return dlsym(h, name); };
  api.init = reinterpret_cast<decltype(api.init)>(sym("lame_init"));
  api.set_in_samplerate = reinterpret_cast<decltype(api.set_in_samplerate)>(
      sym("lame_set_in_samplerate"));
  api.set_num_channels = reinterpret_cast<decltype(api.set_num_channels)>(
      sym("lame_set_num_channels"));
  api.set_quality =
      reinterpret_cast<decltype(api.set_quality)>(sym("lame_set_quality"));
  api.set_mode = reinterpret_cast<decltype(api.set_mode)>(sym("lame_set_mode"));
  api.set_out_samplerate = reinterpret_cast<decltype(api.set_out_samplerate)>(
      sym("lame_set_out_samplerate"));
  api.set_VBR = reinterpret_cast<decltype(api.set_VBR)>(sym("lame_set_VBR"));
  api.set_brate =
      reinterpret_cast<decltype(api.set_brate)>(sym("lame_set_brate"));
  api.init_params =
      reinterpret_cast<decltype(api.init_params)>(sym("lame_init_params"));
  api.encode_buffer =
      reinterpret_cast<decltype(api.encode_buffer)>(sym("lame_encode_buffer"));
  api.encode_buffer_interleaved =
      reinterpret_cast<decltype(api.encode_buffer_interleaved)>(
          sym("lame_encode_buffer_interleaved"));
  api.encode_buffer_ieee_float =
      reinterpret_cast<decltype(api.encode_buffer_ieee_float)>(
          sym("lame_encode_buffer_ieee_float"));
  api.encode_buffer_interleaved_ieee_float =
      reinterpret_cast<decltype(api.encode_buffer_interleaved_ieee_float)>(
          sym("lame_encode_buffer_interleaved_ieee_float"));
  api.encode_flush =
      reinterpret_cast<decltype(api.encode_flush)>(sym("lame_encode_flush"));
  api.close = reinterpret_cast<decltype(api.close)>(sym("lame_close"));
  api.set_bWriteVbrTag = reinterpret_cast<decltype(api.set_bWriteVbrTag)>(
      sym("lame_set_bWriteVbrTag"));
  api.set_disable_reservoir =
      reinterpret_cast<decltype(api.set_disable_reservoir)>(
          sym("lame_set_disable_reservoir"));
  api.get_encoder_delay = reinterpret_cast<decltype(api.get_encoder_delay)>(
      sym("lame_get_encoder_delay"));
  api.get_lametag_frame = reinterpret_cast<decltype(api.get_lametag_frame)>(
      sym("lame_get_lametag_frame"));
  api.ok = api.init && api.set_in_samplerate && api.set_num_channels &&
           api.set_quality && api.set_mode && api.set_out_samplerate &&
           api.set_VBR && api.set_brate && api.init_params &&
           api.encode_buffer && api.encode_buffer_interleaved &&
           api.encode_buffer_ieee_float &&
           api.encode_buffer_interleaved_ieee_float && api.encode_flush &&
           api.close;
  return api;
}

LameApi& lame_api() {
  static LameApi api = load_lame();
  return api;
}

}  // namespace

struct na_mp3 {
  lame_t lame = nullptr;
  FILE* file = nullptr;
  int channels = 0;
  std::vector<unsigned char> buf;
  std::vector<float> plane_l, plane_r;
  std::vector<short> short_l, short_r;
};

// flags for na_mp3_open_ex (combinable):
//   1 = NO_TAG: suppress the Xing/Info header frame (interior segments of
//       a segmented parallel encode must splice without it)
//   2 = NO_RESERVOIR: frame-independent output — retained frames of a
//       segmented encode must not back-reference bits in dropped warmup
//       frames (main_data_begin stays 0)
extern "C" na_mp3* na_mp3_open_ex(const char* path, int in_rate, int channels,
                                  int kbps, int out_rate, int flags,
                                  char* errbuf, int errbuf_len) {
  LameApi& api = lame_api();
  if (!api.ok) {
    set_err(errbuf, errbuf_len, "libmp3lame not available");
    return nullptr;
  }
  if (channels != 1 && channels != 2) {
    set_err(errbuf, errbuf_len, "MP3 encode supports 1 or 2 channels");
    return nullptr;
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_err(errbuf, errbuf_len, "Failed to open output file");
    return nullptr;
  }
  lame_t lame = api.init();
  if (!lame) {
    std::fclose(f);
    set_err(errbuf, errbuf_len, "lame_init failed");
    return nullptr;
  }
  // Reference parameter block: audio-io.cpp:809-831.
  api.set_in_samplerate(lame, in_rate);
  api.set_num_channels(lame, channels);
  api.set_quality(lame, 2);
  api.set_mode(lame, channels == 2 ? 0 /*STEREO*/ : 3 /*MONO*/);
  api.set_out_samplerate(lame, out_rate);
  api.set_VBR(lame, 0 /*vbr_off*/);
  api.set_brate(lame, kbps);
  if ((flags & 1) || (flags & 2)) {
    if (!api.set_bWriteVbrTag || !api.set_disable_reservoir) {
      api.close(lame);
      std::fclose(f);
      set_err(errbuf, errbuf_len,
              "libmp3lame lacks segmented-encode entry points");
      return nullptr;
    }
    if (flags & 1) api.set_bWriteVbrTag(lame, 0);
    if (flags & 2) api.set_disable_reservoir(lame, 1);
  }
  if (api.init_params(lame) == -1) {
    api.close(lame);
    std::fclose(f);
    set_err(errbuf, errbuf_len, "lame_init_params failed");
    return nullptr;
  }
  na_mp3* h = new na_mp3;
  h->lame = lame;
  h->file = f;
  h->channels = channels;
  return h;
}

extern "C" na_mp3* na_mp3_open(const char* path, int in_rate, int channels,
                               int kbps, int out_rate, char* errbuf,
                               int errbuf_len) {
  return na_mp3_open_ex(path, in_rate, channels, kbps, out_rate, 0, errbuf,
                        errbuf_len);
}

// Encoder delay in samples (lame_get_encoder_delay; -1 when the symbol is
// unavailable) — segmented encode uses it only for documentation/tests;
// the splice itself is frame-aligned and delay-invariant.
extern "C" int na_mp3_encoder_delay(na_mp3* h) {
  LameApi& api = lame_api();
  if (!h || !h->lame || !api.get_encoder_delay) return -1;
  return api.get_encoder_delay(h->lame);
}

namespace {

int write_out(na_mp3* h, int written) {
  if (written < 0) return -1;
  if (written > 0 &&
      std::fwrite(h->buf.data(), 1, static_cast<size_t>(written), h->file) !=
          static_cast<size_t>(written)) {
    return -1;
  }
  return 0;
}

}  // namespace

extern "C" int na_mp3_write_flt(na_mp3* h, const float* interleaved,
                                int64_t n) {
  LameApi& api = lame_api();
  const int nn = static_cast<int>(n);
  h->buf.resize(static_cast<size_t>(1.25 * n) + 7200);
  int written;
  if (h->channels == 2) {
    written = api.encode_buffer_interleaved_ieee_float(
        h->lame, interleaved, nn, h->buf.data(),
        static_cast<int>(h->buf.size()));
  } else {
    written = api.encode_buffer_ieee_float(h->lame, interleaved, interleaved,
                                           nn, h->buf.data(),
                                           static_cast<int>(h->buf.size()));
  }
  return write_out(h, written);
}

extern "C" int na_mp3_write_s16(na_mp3* h, const int16_t* interleaved,
                                int64_t n) {
  LameApi& api = lame_api();
  const int nn = static_cast<int>(n);
  h->buf.resize(static_cast<size_t>(1.25 * n) + 7200);
  int written;
  if (h->channels == 2) {
    // lame_encode_buffer_interleaved takes a non-const pointer; copy.
    h->short_l.assign(interleaved, interleaved + n * 2);
    written = api.encode_buffer_interleaved(h->lame, h->short_l.data(), nn,
                                            h->buf.data(),
                                            static_cast<int>(h->buf.size()));
  } else {
    written =
        api.encode_buffer(h->lame, interleaved, interleaved, nn, h->buf.data(),
                          static_cast<int>(h->buf.size()));
  }
  return write_out(h, written);
}

extern "C" int na_mp3_close(na_mp3* h) {
  LameApi& api = lame_api();
  int rc = 0;
  h->buf.resize(7200);
  const int written =
      api.encode_flush(h->lame, h->buf.data(), static_cast<int>(h->buf.size()));
  if (write_out(h, written) != 0) rc = -1;
  // Finalize the Xing/Info header: LAME emits a zeroed placeholder frame
  // at stream start and fills it only through this call — without it the
  // export carries no duration/gapless (delay+padding) metadata and the
  // placeholder decodes as 1152 samples of silence. (When the tag was
  // disabled via open flags, get_lametag_frame returns 0 bytes.)
  if (rc == 0 && api.get_lametag_frame) {
    const size_t tag =
        api.get_lametag_frame(h->lame, h->buf.data(), h->buf.size());
    if (tag > 0 && tag <= h->buf.size()) {
      if (std::fseek(h->file, 0, SEEK_SET) != 0 ||
          std::fwrite(h->buf.data(), 1, tag, h->file) != tag) {
        rc = -1;
      }
    }
  }
  api.close(h->lame);
  if (std::fclose(h->file) != 0) rc = -1;
  delete h;
  return rc;
}
