// nodey_host — native host runtime for the nodey_tpu framework.
//
// Host-bound codec work the TPU cannot do: container demux + decode
// (libavformat/libavcodec), MP3 encode (libmp3lame, loaded via dlopen — the
// image ships the runtime library without headers), and a libswresample
// wrapper used both as the golden-test oracle for the device polyphase
// resampler and as a host-side fallback.
//
// Counterpart of the reference's FFmpeg decode fibers
// (reference: src/processor/audio-io.cpp:86-226) and LAME export sink
// (audio-io.cpp:640-844), reduced to a clean C ABI for ctypes.
#pragma once

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

// Sample-format tags matching nodey_tpu.core.stream.
enum na_fmt { NA_FMT_FLT = 0, NA_FMT_S16 = 1, NA_FMT_S32 = 2 };

typedef struct na_decoded {
  int32_t sample_rate;
  int32_t channels;
  int32_t fmt;          // na_fmt origin tag
  int64_t num_samples;  // per channel
  int64_t pts0_us;      // first frame pts in microseconds
  float*  data;         // interleaved f32, normalized to [-1, 1]
} na_decoded;

// Decode an audio file fully into normalized interleaved f32 PCM.
// Frames are placed on the sample grid derived from their pts; forward pts
// jumps are zero-filled (the batched-world equivalent of the reference's
// export-side gap silence synthesis, audio-io.cpp:666-694).
// Returns 0 on success; on failure returns -1 and fills errbuf.
int na_decode_file(const char* path, na_decoded* out,
                   char* errbuf, int errbuf_len);
void na_free_decoded(na_decoded* d);

// --- streaming decode (bounded host memory for long clips) -----------------
typedef struct na_decoder na_decoder;

// Open and decode up to the first frame to learn the format. ``info->data``
// stays NULL; rate/channels/fmt/pts0_us are filled (num_samples = -1,
// unknown). NULL on failure (errbuf filled).
na_decoder* na_decoder_open(const char* path, na_decoded* info,
                            char* errbuf, int errbuf_len);
// Read up to max_samples per-channel samples of normalized interleaved f32.
// Returns the count (< max only at EOF), 0 at EOF, -1 on error.
int64_t na_decoder_read(na_decoder* d, float* out, int64_t max_samples);
void na_decoder_close(na_decoder* d);

// --- MP3 encode (LAME, CBR quality 2 — reference: audio-io.cpp:809-831) ---
typedef struct na_mp3 na_mp3;

// channels: 1 or 2. kbps: CBR bitrate. in_rate: native PCM rate; LAME
// resamples to out_rate internally, like the reference's
// lame_set_out_samplerate(config::audio::sample_rate).
na_mp3* na_mp3_open(const char* path, int in_rate, int channels, int kbps,
                    int out_rate, char* errbuf, int errbuf_len);
// Append interleaved float PCM in [-1, 1]. Returns 0 / -1.
int na_mp3_write_flt(na_mp3* h, const float* interleaved, int64_t n);
// Append interleaved int16 PCM (bit-exact integer path). Returns 0 / -1.
int na_mp3_write_s16(na_mp3* h, const int16_t* interleaved, int64_t n);
// Flush + close. Returns 0 / -1. Frees the handle either way.
int na_mp3_close(na_mp3* h);

// --- libswresample oracle --------------------------------------------------
// Convert interleaved f32 between rates/channel-counts through a real
// SwrContext, full drain. Caller frees *out_data with na_free_buffer.
// Returns number of output samples per channel, or -1 (errbuf filled).
int64_t na_swr_convert_full(const float* in, int64_t in_samples,
                            int in_rate, int in_channels,
                            int out_rate, int out_channels,
                            float** out_data, char* errbuf, int errbuf_len);
void na_free_buffer(float* p);

#ifdef __cplusplus
}
#endif
