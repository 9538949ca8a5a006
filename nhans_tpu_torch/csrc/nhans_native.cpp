// Threaded wav decoding into padded batch buffers: the port's own copy of
// the JAX package's native/nhans_native.cpp, bound with ctypes by
// nhans_tpu_torch/utils/native.py and built by nhans_tpu_torch/ops/_build.py
// (g++ -O3 -std=c++17 -fPIC -pthread -shared) into build/nhans_tpu_torch/.
//
// The device does all signal math, so the host's part is "decode N wavs
// into an [N, L] buffer as fast as possible": a simple RIFF parser and a
// std::thread fan-out, exposed through a C ABI.
//
// Audio contract (reference reader.py:118-125): 16 kHz, 16-bit signed PCM;
// multi-channel is downmixed by averaging; samples keep int16 scale
// (normalisation happens on the device).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavInfo {
  uint32_t sample_rate = 0;
  uint16_t channels = 0;
  uint16_t bits = 0;
  uint16_t format = 0;  // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  long data_offset = -1;
  uint32_t data_bytes = 0;
};

bool parse_header(FILE* f, WavInfo* info) {
  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12) return false;
  if (memcmp(hdr, "RIFF", 4) != 0 || memcmp(hdr + 8, "WAVE", 4) != 0)
    return false;
  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = chunk[4] | (chunk[5] << 8) | (chunk[6] << 16) |
                    ((uint32_t)chunk[7] << 24);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      unsigned char fmt[16];
      if (size < 16 || fread(fmt, 1, 16, f) != 16) return false;
      info->format = fmt[0] | (fmt[1] << 8);
      info->channels = fmt[2] | (fmt[3] << 8);
      info->sample_rate = fmt[4] | (fmt[5] << 8) | (fmt[6] << 16) |
                          ((uint32_t)fmt[7] << 24);
      info->bits = fmt[14] | (fmt[15] << 8);
      if (size > 16) fseek(f, size - 16 + (size & 1), SEEK_CUR);
    } else if (memcmp(chunk, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = size;
      return info->data_offset >= 0;
    } else {
      fseek(f, size + (size & 1), SEEK_CUR);
    }
  }
  return false;
}

// Decode one wav file: up to max_samples mono float32 samples (int16
// scale).  Returns number of samples written, or a negative error code:
//   -1 open failed   -2 bad riff   -3 unsupported format
//   -4 wrong sample rate
// If `peak` is non-null it receives max(|x|) over the WHOLE file (the
// reference normalizes by the whole-file peak, reader.py:186-189, even
// when the decode buffer caps the sample count).
int64_t decode_one(const char* path, float* out, int64_t max_samples,
                   int32_t expect_rate, float* peak) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  if (info.bits != 16 || (info.format != 1 && info.format != 0xFFFE) ||
      info.channels == 0) {
    fclose(f);
    return -3;
  }
  if (expect_rate > 0 && (int32_t)info.sample_rate != expect_rate) {
    fclose(f);
    return -4;
  }
  const int ch = info.channels;
  const int64_t total_frames = info.data_bytes / (2 * ch);
  int64_t frames = total_frames;
  if (frames > max_samples) frames = max_samples;
  std::vector<int16_t> buf(static_cast<size_t>(frames) * ch);
  size_t got = fread(buf.data(), 2 * ch, frames, f);
  frames = static_cast<int64_t>(got);
  float pk = 0.f;
  if (ch == 1) {
    for (int64_t i = 0; i < frames; ++i) out[i] = (float)buf[i];
  } else {
    // downmix by mean (reference reader.py:122-123)
    const float inv = 1.0f / ch;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += (float)buf[i * ch + c];
      out[i] = acc * inv;
    }
  }
  for (int64_t i = 0; i < frames; ++i) {
    const float a = out[i] < 0 ? -out[i] : out[i];
    if (a > pk) pk = a;
  }
  // Scan the remainder of the data chunk (beyond the buffer cap) so the
  // peak covers the whole file.
  if (peak && frames == max_samples && total_frames > frames) {
    const float inv = 1.0f / ch;
    std::vector<int16_t> tail(4096 * ch);
    int64_t left = total_frames - frames;
    while (left > 0) {
      int64_t want = left < 4096 ? left : 4096;
      size_t n = fread(tail.data(), 2 * ch, want, f);
      if (n == 0) break;
      for (size_t i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += (float)tail[i * ch + c];
        float v = ch == 1 ? (float)tail[i] : acc * inv;
        if (v < 0) v = -v;
        if (v > pk) pk = v;
      }
      left -= static_cast<int64_t>(n);
    }
  }
  fclose(f);
  if (peak) *peak = pk;
  return frames;
}

// int16 variant: decodes straight into an int16 buffer (the wire format
// of the input pipeline), skipping the float32 intermediate and the
// GIL-bound numpy rint conversion entirely.  Mono files stream directly
// from disk into the output buffer; multi-channel is mean-downmixed with
// rounding.  `peak` receives the whole-file max |downmixed sample|.
int64_t decode_one_i16(const char* path, int16_t* out, int64_t max_samples,
                       int32_t expect_rate, float* peak) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  if (info.bits != 16 || (info.format != 1 && info.format != 0xFFFE) ||
      info.channels == 0) {
    fclose(f);
    return -3;
  }
  if (expect_rate > 0 && (int32_t)info.sample_rate != expect_rate) {
    fclose(f);
    return -4;
  }
  const int ch = info.channels;
  const int64_t total_frames = info.data_bytes / (2 * ch);
  int64_t frames = total_frames;
  if (frames > max_samples) frames = max_samples;
  float pk = 0.f;
  if (ch == 1) {
    size_t got = fread(out, 2, frames, f);
    frames = static_cast<int64_t>(got);
    for (int64_t i = 0; i < frames; ++i) {
      const float a = out[i] < 0 ? -(float)out[i] : (float)out[i];
      if (a > pk) pk = a;
    }
  } else {
    std::vector<int16_t> buf(static_cast<size_t>(frames) * ch);
    size_t got = fread(buf.data(), 2 * ch, frames, f);
    frames = static_cast<int64_t>(got);
    const float inv = 1.0f / ch;
    for (int64_t i = 0; i < frames; ++i) {
      float acc = 0.f;
      for (int c = 0; c < ch; ++c) acc += (float)buf[i * ch + c];
      const float v = acc * inv;
      out[i] = (int16_t)(v < 0 ? v - 0.5f : v + 0.5f);  // round half away
      const float a = v < 0 ? -v : v;
      if (a > pk) pk = a;
    }
  }
  if (peak && frames == max_samples && total_frames > frames) {
    const float inv = 1.0f / ch;
    std::vector<int16_t> tail(4096 * ch);
    int64_t left = total_frames - frames;
    while (left > 0) {
      int64_t want = left < 4096 ? left : 4096;
      size_t n = fread(tail.data(), 2 * ch, want, f);
      if (n == 0) break;
      for (size_t i = 0; i < n; ++i) {
        float acc = 0.f;
        for (int c = 0; c < ch; ++c) acc += (float)tail[i * ch + c];
        float v = ch == 1 ? (float)tail[i] : acc * inv;
        if (v < 0) v = -v;
        if (v > pk) pk = v;
      }
      left -= static_cast<int64_t>(n);
    }
  }
  fclose(f);
  if (peak) *peak = pk;
  return frames;
}

}  // namespace

extern "C" {

// Decode a single wav; returns sample count or negative error code.
// `peak` (nullable) receives the whole-file max(|x|).
int64_t nhans_read_wav(const char* path, float* out, int64_t max_samples,
                       int32_t expect_rate, float* peak) {
  return decode_one(path, out, max_samples, expect_rate, peak);
}

// Decode a batch of n wavs into out[n * max_samples] (zero-padded), with
// per-file lengths in lens[n] (negative on per-file error) and whole-file
// peaks in peaks[n] (nullable).  Buffers must be pre-zeroed by the caller
// if padding zeros matter.  Returns 0, or the count of files that failed.
int32_t nhans_load_batch(const char** paths, int32_t n, float* out,
                         int64_t max_samples, int64_t* lens,
                         int32_t expect_rate, int32_t num_threads,
                         float* peaks) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n > 0 ? n : 1;
  std::atomic<int32_t> next(0), failed(0);
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t r = decode_one(paths[i], out + (int64_t)i * max_samples,
                             max_samples, expect_rate,
                             peaks ? peaks + i : nullptr);
      lens[i] = r;
      if (r < 0) failed.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < num_threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failed.load();
}

// int16 batch decode: out[n * max_samples] int16 (zero-padded by caller),
// whole-file peaks in peaks[n].  Same error protocol as nhans_load_batch.
int32_t nhans_load_batch_i16(const char** paths, int32_t n, int16_t* out,
                             int64_t max_samples, int64_t* lens,
                             int32_t expect_rate, int32_t num_threads,
                             float* peaks) {
  if (num_threads < 1) num_threads = 1;
  if (num_threads > n) num_threads = n > 0 ? n : 1;
  std::atomic<int32_t> next(0), failed(0);
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t r = decode_one_i16(paths[i], out + (int64_t)i * max_samples,
                                 max_samples, expect_rate,
                                 peaks ? peaks + i : nullptr);
      lens[i] = r;
      if (r < 0) failed.fetch_add(1);
    }
  };
  std::vector<std::thread> pool;
  for (int32_t t = 1; t < num_threads; ++t) pool.emplace_back(work);
  work();
  for (auto& t : pool) t.join();
  return failed.load();
}

}  // extern "C"
