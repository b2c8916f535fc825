// Audio decode: demux + decode + normalize to interleaved f32.
//
// TPU-era counterpart of the reference's per-file decode fiber
// (reference: src/processor/audio-io.cpp:86-226): same libavformat/libavcodec
// pipeline, exposed two ways:
//   * na_decode_file  — whole clip into one contiguous buffer (offline path)
//   * na_decoder_*    — streaming pull API with bounded memory (the chunked
//                       long-clip path; the analog of the reference's
//                       O(16-frame) channel bound, SURVEY.md §5.7)
// pts gaps become zero-filled spans, where the reference's export path
// would synthesize silence (audio-io.cpp:666-694).

#include "nodey_host.h"

#include <algorithm>
#include <cstdio>
#include <cstring>
#include <deque>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/samplefmt.h>
}

namespace {

void set_err(char* errbuf, int len, const char* msg) {
  if (errbuf && len > 0) {
    std::snprintf(errbuf, static_cast<size_t>(len), "%s", msg);
  }
}

// Normalization scales match nodey_tpu.core.stream.FMT_SCALE: power-of-two
// divisors so integer PCM round-trips exactly through float32.
template <typename T>
float norm(T v);
template <>
float norm<int16_t>(int16_t v) { return static_cast<float>(v) / 32768.0f; }
template <>
float norm<int32_t>(int32_t v) {
  return static_cast<float>(static_cast<double>(v) / 2147483648.0);
}
template <>
float norm<float>(float v) { return v; }
template <>
float norm<uint8_t>(uint8_t v) {
  return (static_cast<float>(v) - 128.0f) / 128.0f;
}
template <>
float norm<double>(double v) { return static_cast<float>(v); }

template <typename T>
void append_interleaved(std::deque<float>& dst, const AVFrame* f, int ch) {
  const T* src = reinterpret_cast<const T*>(f->data[0]);
  const int64_t n = static_cast<int64_t>(f->nb_samples) * ch;
  for (int64_t i = 0; i < n; ++i) dst.push_back(norm<T>(src[i]));
}

template <typename T>
void append_planar(std::deque<float>& dst, const AVFrame* f, int ch) {
  for (int i = 0; i < f->nb_samples; ++i) {
    for (int c = 0; c < ch; ++c) {
      const T* src = reinterpret_cast<const T*>(f->data[c]);
      dst.push_back(norm<T>(src[i]));
    }
  }
}

int fmt_tag(AVSampleFormat fmt) {
  switch (fmt) {
    case AV_SAMPLE_FMT_S16:
    case AV_SAMPLE_FMT_S16P:
      return NA_FMT_S16;
    case AV_SAMPLE_FMT_S32:
    case AV_SAMPLE_FMT_S32P:
      return NA_FMT_S32;
    default:
      return NA_FMT_FLT;
  }
}

bool append_frame(std::deque<float>& pcm, const AVFrame* f, int ch,
                  char* errbuf, int errlen) {
  switch (static_cast<AVSampleFormat>(f->format)) {
    case AV_SAMPLE_FMT_FLT:  append_interleaved<float>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_FLTP: append_planar<float>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_S16:  append_interleaved<int16_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_S16P: append_planar<int16_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_S32:  append_interleaved<int32_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_S32P: append_planar<int32_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_U8:   append_interleaved<uint8_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_U8P:  append_planar<uint8_t>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_DBL:  append_interleaved<double>(pcm, f, ch); return true;
    case AV_SAMPLE_FMT_DBLP: append_planar<double>(pcm, f, ch); return true;
    default:
      set_err(errbuf, errlen, "unsupported sample format");
      return false;
  }
}

}  // namespace

struct na_decoder {
  AVFormatContext* fmt_ctx = nullptr;
  AVCodecContext* codec_ctx = nullptr;
  AVPacket* packet = nullptr;
  AVFrame* frame = nullptr;
  int stream_idx = -1;
  double time_base = 0.0;

  std::deque<float> pending;  // interleaved normalized samples
  int channels = 0;
  int sample_rate = 0;
  int tag = NA_FMT_FLT;
  bool first = true;
  bool eof = false;
  bool failed = false;
  int64_t pts0_us = 0;
  int64_t written = 0;  // per-channel samples handed out or pending
  char err[256] = {0};

  ~na_decoder() {
    if (packet) av_packet_free(&packet);
    if (frame) av_frame_free(&frame);
    if (codec_ctx) avcodec_free_context(&codec_ctx);
    if (fmt_ctx) avformat_close_input(&fmt_ctx);
  }

  bool handle_frame(const AVFrame* f) {
    if (first) {
      first = false;
      channels = f->ch_layout.nb_channels;
      sample_rate = f->sample_rate;
      tag = fmt_tag(static_cast<AVSampleFormat>(f->format));
      if (f->pts != AV_NOPTS_VALUE) {
        pts0_us = static_cast<int64_t>(f->pts * time_base * 1e6);
      }
    }
    if (f->ch_layout.nb_channels != channels ||
        f->sample_rate != sample_rate) {
      set_err(err, sizeof(err), "Stream changed format mid-file");
      return false;
    }
    // Gap fill (>= 10 ms) from pts discontinuities.
    if (f->pts != AV_NOPTS_VALUE) {
      const double t = f->pts * time_base - static_cast<double>(pts0_us) / 1e6;
      const int64_t total =
          written + static_cast<int64_t>(pending.size()) / channels;
      const int64_t expect = static_cast<int64_t>(t * sample_rate + 0.5);
      if (expect > total + sample_rate / 100) {
        pending.insert(pending.end(),
                       static_cast<size_t>((expect - total) * channels),
                       0.0f);
      }
    }
    return append_frame(pending, f, channels, err, sizeof(err));
  }

  // Decode until `pending` holds >= want per-channel samples or EOF.
  // (`first` forces at least one decoded frame so `channels` is known.)
  bool fill(int64_t want) {
    while (!eof &&
           (first ||
            static_cast<int64_t>(pending.size()) < want * channels)) {
      int r = av_read_frame(fmt_ctx, packet);
      if (r < 0) {
        avcodec_send_packet(codec_ctx, nullptr);  // flush
        eof = true;
      } else if (packet->stream_index == stream_idx) {
        avcodec_send_packet(codec_ctx, packet);
      }
      if (r >= 0) av_packet_unref(packet);
      while (true) {
        const int rr = avcodec_receive_frame(codec_ctx, frame);
        if (rr == AVERROR(EAGAIN) || rr == AVERROR_EOF) break;
        if (rr < 0) {
          set_err(err, sizeof(err), "Decode error");
          return false;
        }
        if (!handle_frame(frame)) return false;
      }
    }
    return true;
  }
};

extern "C" na_decoder* na_decoder_open(const char* path, na_decoded* info,
                                       char* errbuf, int errbuf_len) {
  av_log_set_level(AV_LOG_QUIET);
  if (info) std::memset(info, 0, sizeof(*info));

  auto d = new na_decoder;
  if (avformat_open_input(&d->fmt_ctx, path, nullptr, nullptr) < 0) {
    set_err(errbuf, errbuf_len, "Failed to open input file");
    delete d;
    return nullptr;
  }
  if (avformat_find_stream_info(d->fmt_ctx, nullptr) < 0) {
    set_err(errbuf, errbuf_len, "Failed to find stream info");
    delete d;
    return nullptr;
  }
  d->stream_idx =
      av_find_best_stream(d->fmt_ctx, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr, 0);
  if (d->stream_idx < 0) {
    set_err(errbuf, errbuf_len, "No audio stream found");
    delete d;
    return nullptr;
  }
  AVStream* stream = d->fmt_ctx->streams[d->stream_idx];
  d->time_base = av_q2d(stream->time_base);

  const AVCodec* codec = avcodec_find_decoder(stream->codecpar->codec_id);
  if (!codec) {
    set_err(errbuf, errbuf_len, "No decoder for codec");
    delete d;
    return nullptr;
  }
  d->codec_ctx = avcodec_alloc_context3(codec);
  if (!d->codec_ctx ||
      avcodec_parameters_to_context(d->codec_ctx, stream->codecpar) < 0 ||
      avcodec_open2(d->codec_ctx, codec, nullptr) < 0) {
    set_err(errbuf, errbuf_len, "Failed to open decoder");
    delete d;
    return nullptr;
  }
  d->packet = av_packet_alloc();
  d->frame = av_frame_alloc();

  // Pull the first frame so the caller learns the stream format.
  if (!d->fill(1)) {
    set_err(errbuf, errbuf_len, d->err[0] ? d->err : "Decode error");
    delete d;
    return nullptr;
  }
  if (d->first) {
    set_err(errbuf, errbuf_len, "File contains no audio frames");
    delete d;
    return nullptr;
  }
  if (info) {
    info->sample_rate = d->sample_rate;
    info->channels = d->channels;
    info->fmt = d->tag;
    info->num_samples = -1;  // unknown until EOF
    info->pts0_us = d->pts0_us;
    info->data = nullptr;
  }
  return d;
}

extern "C" int64_t na_decoder_read(na_decoder* d, float* out,
                                   int64_t max_samples) {
  if (d->failed) return -1;
  if (!d->fill(max_samples)) {
    d->failed = true;
    return -1;
  }
  const int64_t have =
      static_cast<int64_t>(d->pending.size()) / d->channels;
  const int64_t n = std::min(max_samples, have);
  const int64_t count = n * d->channels;
  std::copy(d->pending.begin(), d->pending.begin() + count, out);
  d->pending.erase(d->pending.begin(), d->pending.begin() + count);
  d->written += n;
  return n;
}

extern "C" void na_decoder_close(na_decoder* d) { delete d; }

extern "C" int na_decode_file(const char* path, na_decoded* out, char* errbuf,
                              int errbuf_len) {
  na_decoded info;
  na_decoder* d = na_decoder_open(path, &info, errbuf, errbuf_len);
  if (!d) return -1;

  std::vector<float> pcm;
  const int64_t chunk = 1 << 18;
  std::vector<float> buf(static_cast<size_t>(chunk) * info.channels);
  while (true) {
    const int64_t n = na_decoder_read(d, buf.data(), chunk);
    if (n < 0) {
      set_err(errbuf, errbuf_len, d->err[0] ? d->err : "Decode error");
      na_decoder_close(d);
      return -1;
    }
    if (n == 0) break;
    pcm.insert(pcm.end(), buf.begin(),
               buf.begin() + static_cast<size_t>(n) * info.channels);
  }
  na_decoder_close(d);

  float* data = static_cast<float*>(
      std::malloc(pcm.size() * sizeof(float) + sizeof(float)));
  if (!data) {
    set_err(errbuf, errbuf_len, "Out of memory");
    return -1;
  }
  std::memcpy(data, pcm.data(), pcm.size() * sizeof(float));

  out->sample_rate = info.sample_rate;
  out->channels = info.channels;
  out->fmt = info.fmt;
  out->num_samples = static_cast<int64_t>(pcm.size()) / info.channels;
  out->pts0_us = info.pts0_us;
  out->data = data;
  return 0;
}

extern "C" void na_free_decoded(na_decoded* d) {
  if (d && d->data) {
    std::free(d->data);
    d->data = nullptr;
  }
}
