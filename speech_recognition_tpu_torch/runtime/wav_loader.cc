// Native batched wav loader of the PyTorch port.
//
// Parses RIFF/WAVE PCM16 files, converts them to float32 and writes them
// straight into a caller-provided zero-padded [B, L] batch buffer with a
// length and a sample rate per file, fanning the files out over a pool of
// threads, so that reading the next batch from disk overlaps the card's
// work on this one (runtime/loader.py's PrefetchWavBatches).  A
// multi-channel file keeps channel 0; a file longer than L is truncated.
//
// Exposed C ABI (bound with ctypes, see loader.py):
//   int load_wav_batch(const char** paths, int n, float* out, int64 cap,
//                      int32* lengths, int32* rates, int n_threads);
// Returns 0 on success, else the (1-based) index of the first file that
// failed to parse.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct WavData {
  int32_t rate = 0;
  int64_t n_samples = 0;
  bool ok = false;
};

uint32_t rd_u32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const unsigned char* p) {
  return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// Parse one PCM16 RIFF/WAVE file into out[0..cap), zero-padding the
// tail.  Multi-channel files keep channel 0.
WavData load_one(const char* path, float* out, int64_t cap) {
  WavData res;
  FILE* f = fopen(path, "rb");
  if (!f) return res;

  unsigned char hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) != 0 ||
      memcmp(hdr + 8, "WAVE", 4) != 0) {
    fclose(f);
    return res;
  }

  uint16_t channels = 1, bits = 16, fmt = 1;
  uint32_t rate = 0;
  bool have_fmt = false;

  unsigned char chunk[8];
  while (fread(chunk, 1, 8, f) == 8) {
    uint32_t size = rd_u32(chunk + 4);
    if (memcmp(chunk, "fmt ", 4) == 0) {
      std::vector<unsigned char> buf(size);
      if (fread(buf.data(), 1, size, f) != size) break;
      fmt = rd_u16(&buf[0]);
      channels = rd_u16(&buf[2]);
      rate = rd_u32(&buf[4]);
      bits = rd_u16(&buf[14]);
      have_fmt = true;
    } else if (memcmp(chunk, "data", 4) == 0) {
      if (!have_fmt || fmt != 1 || bits != 16 || channels == 0) break;
      int64_t n_frames = (int64_t)size / (2 * channels);
      int64_t n_keep = n_frames < cap ? n_frames : cap;
      std::vector<int16_t> raw(n_keep * channels);
      if ((int64_t)fread(raw.data(), 2, n_keep * channels, f) !=
          n_keep * channels)
        break;
      for (int64_t i = 0; i < n_keep; ++i)
        out[i] = (float)raw[i * channels];
      for (int64_t i = n_keep; i < cap; ++i) out[i] = 0.0f;
      res.rate = (int32_t)rate;
      res.n_samples = n_keep;
      res.ok = true;
      break;
    } else {
      // skip unknown chunk (word-aligned)
      fseek(f, (long)(size + (size & 1)), SEEK_CUR);
    }
  }
  fclose(f);
  return res;
}

}  // namespace

extern "C" {

int load_wav_batch(const char** paths, int n, float* out, int64_t cap,
                   int32_t* lengths, int32_t* rates, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> first_err(0);

  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) return;
      WavData r = load_one(paths[i], out + (int64_t)i * cap, cap);
      if (!r.ok) {
        int expected = 0;
        first_err.compare_exchange_strong(expected, i + 1);
        lengths[i] = 0;
        rates[i] = 0;
      } else {
        lengths[i] = (int32_t)r.n_samples;
        rates[i] = r.rate;
      }
    }
  };

  std::vector<std::thread> threads;
  int spawn = n_threads < n ? n_threads : n;
  for (int t = 1; t < spawn; ++t) threads.emplace_back(worker);
  worker();
  for (auto& t : threads) t.join();
  return first_err.load();
}

}  // extern "C"
