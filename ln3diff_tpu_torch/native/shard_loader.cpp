// Threaded tar-shard reader: the IO side of the wds data pipeline.
//
// The port's copy of ln3diff_tpu/native/shard_loader.cpp, built at first
// use by ln3diff_tpu_torch/ops/_build.py with g++ (-pthread) and bound in
// ln3diff_tpu_torch/native/build.py.
//
// Plays the role the reference delegates to torch DataLoader worker
// processes + the webdataset package (datasets/g_buffer_objaverse.py
// load_wds_ResampledShard): a background producer thread streams tar
// entries from a shard list into a bounded queue while the training
// process consumes decoded batches.  Python's tarfile walks headers
// with interpreter-level seeks and per-member object churn; this reader
// does sequential 512-byte-block parsing with raw fread and hands whole
// entry blobs ([u32 name_len][name][u64 data_len][data]) across ctypes.
//
// API (ctypes):
//   void* ln_loader_create(const char** paths, int64 n, int64 cap, int loop)
//   int64 ln_loader_next_size(void*)   // blocks; -1 = end of stream
//   void  ln_loader_next_copy(void*, char* dst)  // copy + pop
//   void  ln_loader_destroy(void*)

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Blob {
  std::vector<char> bytes;
};

struct Loader {
  std::vector<std::string> paths;
  size_t queue_cap;
  bool loop;

  std::deque<Blob> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  bool done = false;
  bool stop = false;
  std::thread worker;
};

// Parse one octal field (tar size encoding).
int64_t parse_octal(const char* p, size_t n) {
  int64_t v = 0;
  for (size_t i = 0; i < n && p[i]; ++i) {
    if (p[i] == ' ') continue;
    if (p[i] < '0' || p[i] > '7') break;
    v = v * 8 + (p[i] - '0');
  }
  return v;
}

bool all_zero(const char* p, size_t n) {
  for (size_t i = 0; i < n; ++i)
    if (p[i]) return false;
  return true;
}

void push_blob(Loader* L, Blob&& b) {
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_push.wait(lk, [L] {
    return L->queue.size() < L->queue_cap || L->stop;
  });
  if (L->stop) return;
  L->queue.push_back(std::move(b));
  L->cv_pop.notify_one();
}

void read_shard(Loader* L, const std::string& path) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return;
  char hdr[512];
  std::string pending_longname;
  while (!L->stop && std::fread(hdr, 1, 512, f) == 512) {
    if (all_zero(hdr, 512)) break;  // end-of-archive marker
    int64_t size = parse_octal(hdr + 124, 12);
    char type = hdr[156];
    int64_t padded = (size + 511) & ~int64_t(511);

    std::string name;
    if (!pending_longname.empty()) {
      name.swap(pending_longname);
    } else {
      char prefix[156] = {0};
      std::memcpy(prefix, hdr + 345, 155);
      char base[101] = {0};
      std::memcpy(base, hdr, 100);
      name = prefix[0] ? std::string(prefix) + "/" + base : std::string(base);
    }

    if (type == 'L') {  // GNU longname: payload is the real name
      std::vector<char> buf(padded);
      if (std::fread(buf.data(), 1, padded, f) != (size_t)padded) break;
      pending_longname.assign(buf.data(), size);
      while (!pending_longname.empty() && pending_longname.back() == '\0')
        pending_longname.pop_back();
      continue;
    }
    if (type != '0' && type != '\0') {  // dirs, PAX headers, links: skip
      if (padded && std::fseek(f, padded, SEEK_CUR) != 0) break;
      continue;
    }

    Blob b;
    b.bytes.resize(4 + name.size() + 8 + size);
    uint32_t nl = (uint32_t)name.size();
    std::memcpy(b.bytes.data(), &nl, 4);
    std::memcpy(b.bytes.data() + 4, name.data(), nl);
    uint64_t dl = (uint64_t)size;
    std::memcpy(b.bytes.data() + 4 + nl, &dl, 8);
    if (size) {
      if (std::fread(b.bytes.data() + 4 + nl + 8, 1, size, f)
          != (size_t)size) break;
      int64_t pad = padded - size;
      if (pad && std::fseek(f, pad, SEEK_CUR) != 0) break;
    }
    push_blob(L, std::move(b));
  }
  std::fclose(f);
}

void worker_main(Loader* L) {
  do {
    for (const auto& p : L->paths) {
      if (L->stop) break;
      read_shard(L, p);
    }
  } while (L->loop && !L->stop);
  std::lock_guard<std::mutex> lk(L->mu);
  L->done = true;
  L->cv_pop.notify_all();
}

}  // namespace

extern "C" {

void* ln_loader_create(const char** paths, int64_t n_paths,
                       int64_t queue_cap, int loop) {
  auto* L = new Loader;
  for (int64_t i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->queue_cap = queue_cap > 0 ? (size_t)queue_cap : 64;
  L->loop = loop != 0;
  L->worker = std::thread(worker_main, L);
  return L;
}

int64_t ln_loader_next_size(void* h) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv_pop.wait(lk, [L] { return !L->queue.empty() || L->done; });
  if (L->queue.empty()) return -1;
  return (int64_t)L->queue.front().bytes.size();
}

void ln_loader_next_copy(void* h, char* dst) {
  auto* L = (Loader*)h;
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->queue.empty()) return;
  auto& b = L->queue.front();
  std::memcpy(dst, b.bytes.data(), b.bytes.size());
  L->queue.pop_front();
  L->cv_push.notify_one();
}

void ln_loader_destroy(void* h) {
  auto* L = (Loader*)h;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
    L->cv_push.notify_all();
    L->cv_pop.notify_all();
  }
  if (L->worker.joinable()) L->worker.join();
  delete L;
}

}  // extern "C"
