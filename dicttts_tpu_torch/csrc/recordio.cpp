// recordio: mmap-backed random-access tensor-record reader with background
// prefetch, for the .rio corpus format (dicttts_tpu_torch/data/recordio.py).
// Records are raw little-endian tensor blobs that numpy views zero-copy;
// this library provides the mmap lifetime, bounds-checked record lookup and
// a small thread pool that touches the next batch's pages so they are
// resident before the trainer asks for them.
//
// This is the port's own copy of the JAX package's reader, with the same
// ABI; dicttts_tpu_torch/data/recordio.py builds it with g++ at first use.
//
// Build (data/recordio.py::build): g++ -O2 -shared -fPIC -pthread -std=c++17 -o <lib>.so recordio.cpp
// ABI (ctypes):
//   void*   rio_open(const char* data_path, const char* idx_path);
//   void    rio_close(void* h);
//   int64_t rio_len(void* h);
//   const uint8_t* rio_record(void* h, int64_t i, int64_t* size);
//   void    rio_prefetch(void* h, const int64_t* ids, int64_t n);
//   int64_t rio_total_bytes(void* h);

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Rio {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  std::vector<int64_t> offsets;  // n+1 entries

  // prefetch thread pool
  std::vector<std::thread> workers;
  std::deque<std::pair<int64_t, int64_t>> queue;  // (offset, length)
  std::mutex mu;
  std::condition_variable cv;
  std::atomic<bool> stop{false};

  void worker_loop() {
    for (;;) {
      std::pair<int64_t, int64_t> job;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (stop.load() && queue.empty()) return;
        job = queue.front();
        queue.pop_front();
      }
      // touch pages so the kernel pulls them in; volatile prevents
      // the read loop from being optimized out.
      const uint8_t* p = base + job.first;
      volatile uint8_t sink = 0;
      for (int64_t i = 0; i < job.second; i += 4096) sink ^= p[i];
      (void)sink;
    }
  }
};

}  // namespace

extern "C" {

void* rio_open(const char* data_path, const char* idx_path) {
  auto* r = new Rio();
  r->fd = ::open(data_path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->size = static_cast<size_t>(st.st_size);
  r->base = static_cast<const uint8_t*>(
      mmap(nullptr, r->size, PROT_READ, MAP_SHARED, r->fd, 0));
  if (r->base == MAP_FAILED) {
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(r->base), r->size, MADV_RANDOM);

  // index: little-endian int64 count, then count+1 offsets
  FILE* f = fopen(idx_path, "rb");
  if (!f) {
    munmap(const_cast<uint8_t*>(r->base), r->size);
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  int64_t count = 0;
  if (fread(&count, sizeof(int64_t), 1, f) != 1 || count < 0) {
    fclose(f);
    munmap(const_cast<uint8_t*>(r->base), r->size);
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  r->offsets.resize(count + 1);
  size_t got = fread(r->offsets.data(), sizeof(int64_t), count + 1, f);
  fclose(f);
  if (got != static_cast<size_t>(count + 1)) {
    munmap(const_cast<uint8_t*>(r->base), r->size);
    ::close(r->fd);
    delete r;
    return nullptr;
  }
  const int n_workers = 2;
  for (int i = 0; i < n_workers; ++i)
    r->workers.emplace_back([r] { r->worker_loop(); });
  return r;
}

void rio_close(void* h) {
  auto* r = static_cast<Rio*>(h);
  if (!r) return;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop.store(true);
  }
  r->cv.notify_all();
  for (auto& t : r->workers) t.join();
  if (r->base && r->base != MAP_FAILED)
    munmap(const_cast<uint8_t*>(r->base), r->size);
  if (r->fd >= 0) ::close(r->fd);
  delete r;
}

int64_t rio_len(void* h) {
  auto* r = static_cast<Rio*>(h);
  return r ? static_cast<int64_t>(r->offsets.size()) - 1 : 0;
}

const uint8_t* rio_record(void* h, int64_t i, int64_t* size) {
  auto* r = static_cast<Rio*>(h);
  if (!r || i < 0 || i + 1 >= static_cast<int64_t>(r->offsets.size())) {
    if (size) *size = 0;
    return nullptr;
  }
  int64_t off = r->offsets[i], end = r->offsets[i + 1];
  if (off < 0 || end < off || static_cast<size_t>(end) > r->size) {
    if (size) *size = 0;
    return nullptr;
  }
  if (size) *size = end - off;
  return r->base + off;
}

void rio_prefetch(void* h, const int64_t* ids, int64_t n) {
  auto* r = static_cast<Rio*>(h);
  if (!r) return;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    for (int64_t k = 0; k < n; ++k) {
      int64_t i = ids[k];
      if (i < 0 || i + 1 >= static_cast<int64_t>(r->offsets.size())) continue;
      r->queue.emplace_back(r->offsets[i], r->offsets[i + 1] - r->offsets[i]);
    }
  }
  r->cv.notify_all();
}

int64_t rio_total_bytes(void* h) {
  auto* r = static_cast<Rio*>(h);
  return r ? static_cast<int64_t>(r->size) : 0;
}

}  // extern "C"
