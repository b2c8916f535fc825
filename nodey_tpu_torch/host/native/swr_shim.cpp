// libswresample wrapper: the golden-test oracle for the device polyphase
// resampler and a host-side fallback path.
//
// Equivalent to the reference's Audio_resampler utility
// (reference: include/utility/sw-resample.hpp:14-71,
// src/utility/sw-resample.cpp:8-43) operating on one whole buffer with a
// full drain — the batched analog of per-frame swr_convert calls.

#include "nodey_host.h"

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavutil/channel_layout.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

namespace {
void set_err(char* errbuf, int len, const char* msg) {
  if (errbuf && len > 0) std::snprintf(errbuf, static_cast<size_t>(len), "%s", msg);
}
}  // namespace

extern "C" int64_t na_swr_convert_full(const float* in, int64_t in_samples,
                                       int in_rate, int in_channels,
                                       int out_rate, int out_channels,
                                       float** out_data, char* errbuf,
                                       int errbuf_len) {
  *out_data = nullptr;
  AVChannelLayout in_layout, out_layout;
  av_channel_layout_default(&in_layout, in_channels);
  av_channel_layout_default(&out_layout, out_channels);

  SwrContext* swr = nullptr;
  if (swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT, out_rate,
                          &in_layout, AV_SAMPLE_FMT_FLT, in_rate, 0,
                          nullptr) < 0 ||
      swr_init(swr) < 0) {
    if (swr) swr_free(&swr);
    set_err(errbuf, errbuf_len, "swr init failed");
    return -1;
  }

  const int64_t cap =
      av_rescale_rnd(in_samples + 256, out_rate, in_rate, AV_ROUND_UP) + 256;
  float* out =
      static_cast<float*>(std::malloc(static_cast<size_t>(cap) * out_channels *
                                      sizeof(float)));
  if (!out) {
    swr_free(&swr);
    set_err(errbuf, errbuf_len, "Out of memory");
    return -1;
  }

  uint8_t* out_planes[1] = {reinterpret_cast<uint8_t*>(out)};
  const uint8_t* in_planes[1] = {reinterpret_cast<const uint8_t*>(in)};

  int64_t total = 0;
  int n = swr_convert(swr, out_planes, static_cast<int>(cap), in_planes,
                      static_cast<int>(in_samples));
  if (n < 0) {
    std::free(out);
    swr_free(&swr);
    set_err(errbuf, errbuf_len, "swr_convert failed");
    return -1;
  }
  total += n;

  // Full drain (flush the filter tail).
  while (true) {
    out_planes[0] =
        reinterpret_cast<uint8_t*>(out + total * out_channels);
    n = swr_convert(swr, out_planes, static_cast<int>(cap - total), nullptr, 0);
    if (n <= 0) break;
    total += n;
  }

  swr_free(&swr);
  *out_data = out;
  return total;
}

extern "C" void na_free_buffer(float* p) { std::free(p); }
