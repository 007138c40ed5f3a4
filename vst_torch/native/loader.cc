// vst_torch native data loader — threaded .npy batch reader, a copy of
// vst/native/loader.cc.
//
// The reference's input pipeline is its biggest host-side bottleneck
// (tensors moved to the GPU inside __getitem__, workers impossible —
// SURVEY §7 hard part #5). vst's loader prefetches on the host; this
// library removes the remaining GIL-bound file I/O by reading a whole
// batch of .npy files with a C++ thread pool directly into the caller's
// pinned buffer.
//
// Scope: NumPy format v1.0/2.0, little-endian float32 ('<f4'), C-order —
// exactly what vst.data.datagen writes and FC2 ships. Returns per-file
// element counts (0 on failure) so Python can fall back per file.
//
// Build (vst_torch/data/native_loader.py does it at first use, into
// vst_torch/_build/): g++ -O3 -shared -fPIC -o libvstloader.so loader.cc -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>
#include <atomic>

namespace {

// Parses an .npy header; returns data offset in bytes and element count,
// or 0 on any mismatch with the supported subset.
size_t parse_npy_header(FILE* f, size_t* elem_count) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return 0;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return 0;
  const int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    uint16_t len16;
    if (fread(&len16, 2, 1, f) != 1) return 0;
    header_len = len16;
  } else if (major == 2) {
    if (fread(&header_len, 4, 1, f) != 1) return 0;
  } else {
    return 0;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return 0;

  if (header.find("'descr': '<f4'") == std::string::npos &&
      header.find("\"descr\": \"<f4\"") == std::string::npos)
    return 0;
  if (header.find("'fortran_order': False") == std::string::npos)
    return 0;

  size_t p = header.find("'shape':");
  if (p == std::string::npos) return 0;
  p = header.find('(', p);
  size_t q = header.find(')', p);
  if (p == std::string::npos || q == std::string::npos) return 0;
  size_t count = 1;
  std::string dims = header.substr(p + 1, q - p - 1);
  char* s = &dims[0];
  char* end = s + dims.size();
  bool any = false;
  while (s < end) {
    while (s < end && (*s == ' ' || *s == ',')) ++s;
    if (s >= end) break;
    size_t d = strtoull(s, &s, 10);
    count *= d;
    any = true;
  }
  if (!any) return 0;
  *elem_count = count;
  size_t offset = (major == 1 ? 10 : 12) + header_len;
  return offset;
}

size_t load_one(const char* path, float* dst, size_t capacity) {
  FILE* f = fopen(path, "rb");
  if (!f) return 0;
  size_t count = 0;
  size_t offset = parse_npy_header(f, &count);
  if (offset == 0 || count > capacity) {
    fclose(f);
    return 0;
  }
  if (fseek(f, (long)offset, SEEK_SET) != 0) {
    fclose(f);
    return 0;
  }
  size_t got = fread(dst, sizeof(float), count, f);
  fclose(f);
  return got == count ? count : 0;
}

}  // namespace

extern "C" {

// Loads n files in parallel. paths: array of n C strings; out: contiguous
// buffer of n slots, each `slot_elems` floats; counts[i] receives the
// number of elements read for file i (0 = failure → caller falls back).
void vst_load_npy_batch(const char** paths, int n, float* out,
                        size_t slot_elems, size_t* counts, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto worker = [&]() {
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      counts[i] = load_one(paths[i], out + (size_t)i * slot_elems, slot_elems);
    }
  };
  std::vector<std::thread> threads;
  int t = n_threads < n ? n_threads : n;
  threads.reserve(t);
  for (int i = 0; i < t; ++i) threads.emplace_back(worker);
  for (auto& th : threads) th.join();
}

}  // extern "C"
