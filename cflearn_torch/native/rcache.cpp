// rcache — packed random-access record store (the image-folder data's native core).
//
// The store format is shared with `cflearn_tpu/native/rcache.cpp`, byte for byte, so that a folder that either
// package packed opens in the other. Layout:
//   [magic u64][num_records u64][record_size u64]
//   [payload: num_records * record_size bytes]
// Fixed-size records (uniform decoded images) allow O(1) mmap'd random access and a single gather loop per
// batch, with no per-record Python overhead.
//
// Exposed through ctypes (`cflearn_torch/native/rcache.py`):
//   rc_open(path) -> handle          rc_close(handle)
//   rc_num_records(handle)           rc_record_size(handle)
//   rc_gather(handle, indices*, n, out*)   // parallel memcpy gather
//   rc_write(path, data*, num_records, record_size)
//
// Build: c++ -O3 -shared -fPIC -std=c++17 -o librcache.so rcache.cpp -lpthread

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <thread>
#include <vector>

static const uint64_t RC_MAGIC = 0x52434143484531ULL;  // "RCACHE1"

struct RCache {
  int fd = -1;
  uint8_t* base = nullptr;
  size_t mapped = 0;
  uint64_t num_records = 0;
  uint64_t record_size = 0;
  const uint8_t* payload = nullptr;
};

extern "C" {

void* rc_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 24) {
    ::close(fd);
    return nullptr;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (base == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* rc = new RCache();
  rc->fd = fd;
  rc->base = static_cast<uint8_t*>(base);
  rc->mapped = st.st_size;
  const uint64_t* header = reinterpret_cast<const uint64_t*>(base);
  if (header[0] != RC_MAGIC) {
    munmap(base, st.st_size);
    ::close(fd);
    delete rc;
    return nullptr;
  }
  rc->num_records = header[1];
  rc->record_size = header[2];
  rc->payload = rc->base + 24;
  if (24 + rc->num_records * rc->record_size > rc->mapped) {
    munmap(base, st.st_size);
    ::close(fd);
    delete rc;
    return nullptr;
  }
  return rc;
}

void rc_close(void* handle) {
  if (!handle) return;
  auto* rc = static_cast<RCache*>(handle);
  if (rc->base) munmap(rc->base, rc->mapped);
  if (rc->fd >= 0) ::close(rc->fd);
  delete rc;
}

uint64_t rc_num_records(void* handle) {
  return handle ? static_cast<RCache*>(handle)->num_records : 0;
}

uint64_t rc_record_size(void* handle) {
  return handle ? static_cast<RCache*>(handle)->record_size : 0;
}

// Gather `n` records by index into `out` (n * record_size bytes).
// Returns 0 on success, -1 on bad index. Parallel memcpy for large batches.
int rc_gather(void* handle, const int64_t* indices, int64_t n, uint8_t* out) {
  if (!handle) return -1;
  auto* rc = static_cast<RCache*>(handle);
  const uint64_t rs = rc->record_size;
  for (int64_t i = 0; i < n; ++i) {
    if (indices[i] < 0 || static_cast<uint64_t>(indices[i]) >= rc->num_records) return -1;
  }
  auto copy_range = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(out + i * rs, rc->payload + indices[i] * rs, rs);
    }
  };
  const int64_t total_bytes = n * static_cast<int64_t>(rs);
  if (total_bytes < (1 << 20)) {
    copy_range(0, n);
    return 0;
  }
  unsigned hw = std::thread::hardware_concurrency();
  int64_t num_threads = hw ? (hw < 8 ? hw : 8) : 4;
  if (num_threads > n) num_threads = n;
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int64_t t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back(copy_range, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Writer: create a store from a contiguous buffer (records pre-packed).
int rc_write(const char* path, const uint8_t* data, uint64_t num_records, uint64_t record_size) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  uint64_t header[3] = {RC_MAGIC, num_records, record_size};
  if (fwrite(header, sizeof(header), 1, f) != 1) {
    fclose(f);
    return -1;
  }
  size_t total = num_records * record_size;
  if (total && fwrite(data, 1, total, f) != total) {
    fclose(f);
    return -1;
  }
  // fclose flushes stdio buffers — a failure here (e.g. disk full) means
  // the store on disk is truncated and must NOT be reported as success
  if (fclose(f) != 0) return -1;
  return 0;
}

}  // extern "C"
