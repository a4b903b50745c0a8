// Native (C++) tube-training data loader.
//
// The port's copy of legged_gym_dev_tpu/native/tube_dataloader.cc, with
// the same shard layout and C ABI. The collectors write binary shard files
// (see tube/shards.py) and this library streams shuffled,
// sliding-window-assembled training batches out of core:
//
//   - shards are mmap'd (datasets larger than RAM stream from page cache),
//   - a worker-thread pool assembles batches ahead into a bounded queue,
//     overlapping host-side gather with the training step on the card,
//   - the sliding-window gather uses a caller-provided source-index map, so
//     the window SEMANTICS (the stride-aligned get_slice of
//     tube/datasets.py) stay defined in exactly one place (Python).
//
// Shard layout (little-endian):
//   int32 magic 'TDL1', int32 version, int32 E, int32 T,
//   int32 Fs (static feats), int32 Fw (windowed feats), int32 G (targets),
//   int32 n_zero_tail (input dims zeroed in window padding)
//   f32 static [E*T*Fs], f32 windowed [E*T*Fw], f32 target [E*T*G],
//   u8 done [E*T]
//
// C ABI (driven from Python through ctypes):
//   tdl_open / tdl_rows / tdl_row_dim / tdl_target_dim /
//   tdl_start_epoch / tdl_next_batch / tdl_close / tdl_error

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int32_t kMagic = 0x314C4454;  // 'TDL1'

struct Shard {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t map_len = 0;
  int32_t E = 0, T = 0, Fs = 0, Fw = 0, G = 0;
  const float* stat = nullptr;
  const float* win = nullptr;
  const float* tgt = nullptr;
  const uint8_t* done = nullptr;
};

struct Batch {
  std::vector<float> x;
  std::vector<float> y;
  int rows = 0;
};

struct Loader {
  std::vector<Shard> shards;
  int N = 1, dN = 1, n_zero_tail = 0;
  std::vector<int32_t> srcmap;  // (N, T): source t per shift, -1 = pad row
  int32_t T = 0, Fs = 0, Fw = 0, G = 0;
  // kept rows across shards: (shard, episode, t) packed
  std::vector<uint64_t> rows;
  std::string error;

  // epoch state
  std::vector<uint32_t> order;
  std::atomic<size_t> next_row{0};
  int batch = 0;
  bool running = false;
  std::vector<std::thread> workers;
  std::deque<Batch> queue;
  std::mutex mu;
  std::condition_variable cv_push, cv_pop;
  size_t max_queue = 4;
  std::atomic<int> active_workers{0};

  ~Loader() { stop(); unmap(); }

  void unmap() {
    for (auto& s : shards) {
      if (s.base) munmap(const_cast<uint8_t*>(s.base), s.map_len);
      if (s.fd >= 0) close(s.fd);
      s.base = nullptr;
      s.fd = -1;
    }
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lk(mu);
      running = false;
    }
    cv_push.notify_all();
    cv_pop.notify_all();
    for (auto& w : workers) {
      if (w.joinable()) w.join();
    }
    workers.clear();
    queue.clear();
  }

  int row_dim() const { return Fs + N * Fw; }

  // Assemble one training row (static feats + N window slices).
  void assemble_row(uint64_t packed, float* x, float* y) const {
    const uint32_t si = packed >> 48;
    const uint32_t e = (packed >> 24) & 0xFFFFFF;
    const uint32_t t = packed & 0xFFFFFF;
    const Shard& s = shards[si];
    const size_t et = static_cast<size_t>(e) * T;
    if (Fs > 0) {
      std::memcpy(x, s.stat + (et + t) * Fs, sizeof(float) * Fs);
      x += Fs;
    }
    for (int i = 0; i < N; ++i) {
      const int32_t src = srcmap[static_cast<size_t>(i) * T + t];
      if (src >= 0) {
        std::memcpy(x, s.win + (et + src) * Fw, sizeof(float) * Fw);
      } else {
        // pad: episode's first frame with the trailing input dims zeroed
        // (get_slice semantics)
        std::memcpy(x, s.win + et * Fw, sizeof(float) * Fw);
        std::memset(x + (Fw - n_zero_tail), 0,
                    sizeof(float) * n_zero_tail);
      }
      x += Fw;
    }
    std::memcpy(y, s.tgt + (et + t) * G, sizeof(float) * G);
  }

  void worker_loop() {
    const int xd = row_dim();
    while (true) {
      size_t start = next_row.fetch_add(static_cast<size_t>(batch));
      if (start >= order.size()) break;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (!running) break;
      }
      const size_t end = std::min(order.size(),
                                  start + static_cast<size_t>(batch));
      Batch b;
      b.rows = static_cast<int>(end - start);
      b.x.resize(static_cast<size_t>(b.rows) * xd);
      b.y.resize(static_cast<size_t>(b.rows) * G);
      for (size_t r = start; r < end; ++r) {
        assemble_row(rows[order[r]],
                     b.x.data() + (r - start) * xd,
                     b.y.data() + (r - start) * G);
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_push.wait(lk, [&] { return queue.size() < max_queue || !running; });
      if (!running) break;
      queue.push_back(std::move(b));
      cv_pop.notify_one();
    }
    if (active_workers.fetch_sub(1) == 1) cv_pop.notify_all();
  }
};

Loader* as_loader(void* h) { return static_cast<Loader*>(h); }

thread_local std::string g_error;

}  // namespace

extern "C" {

const char* tdl_error() { return g_error.c_str(); }

void* tdl_open(const char** paths, int n_paths, int N, int dN,
               int n_zero_tail, const int32_t* srcmap, int T_expect) {
  auto ld = std::unique_ptr<Loader>(new Loader());
  ld->N = N;
  ld->dN = dN;
  ld->n_zero_tail = n_zero_tail;
  for (int p = 0; p < n_paths; ++p) {
    Shard s;
    s.fd = open(paths[p], O_RDONLY);
    if (s.fd < 0) {
      g_error = std::string("cannot open ") + paths[p];
      return nullptr;
    }
    struct stat st;
    if (fstat(s.fd, &st) != 0 || st.st_size < 32) {
      g_error = std::string("bad shard ") + paths[p];
      close(s.fd);
      return nullptr;
    }
    s.map_len = static_cast<size_t>(st.st_size);
    s.base = static_cast<const uint8_t*>(
        mmap(nullptr, s.map_len, PROT_READ, MAP_PRIVATE, s.fd, 0));
    if (s.base == MAP_FAILED) {
      g_error = std::string("mmap failed for ") + paths[p];
      close(s.fd);
      return nullptr;
    }
    const int32_t* hdr = reinterpret_cast<const int32_t*>(s.base);
    if (hdr[0] != kMagic || hdr[1] != 1) {
      g_error = std::string("bad magic/version in ") + paths[p];
      return nullptr;
    }
    s.E = hdr[2]; s.T = hdr[3]; s.Fs = hdr[4]; s.Fw = hdr[5]; s.G = hdr[6];
    if (n_zero_tail < 0) n_zero_tail = hdr[7];
    if (hdr[7] != n_zero_tail) {
      g_error = std::string("n_zero_tail mismatch in ") + paths[p];
      return nullptr;
    }
    ld->n_zero_tail = n_zero_tail;
    const size_t ET = static_cast<size_t>(s.E) * s.T;
    size_t off = 32;
    s.stat = reinterpret_cast<const float*>(s.base + off);
    off += ET * s.Fs * sizeof(float);
    s.win = reinterpret_cast<const float*>(s.base + off);
    off += ET * s.Fw * sizeof(float);
    s.tgt = reinterpret_cast<const float*>(s.base + off);
    off += ET * s.G * sizeof(float);
    s.done = s.base + off;
    off += ET;
    if (off > s.map_len) {
      g_error = std::string("truncated shard ") + paths[p];
      return nullptr;
    }
    if (p == 0) {
      ld->T = s.T; ld->Fs = s.Fs; ld->Fw = s.Fw; ld->G = s.G;
    } else if (s.T != ld->T || s.Fs != ld->Fs || s.Fw != ld->Fw ||
               s.G != ld->G) {
      g_error = "shard shape mismatch";
      return nullptr;
    }
    if (s.E > 0xFFFFFF || s.T > 0xFFFFFF) {
      g_error = "shard too large for row packing";
      return nullptr;
    }
    ld->shards.push_back(s);
  }
  if (T_expect != ld->T) {
    g_error = "srcmap T mismatch";
    return nullptr;
  }
  ld->srcmap.assign(srcmap, srcmap + static_cast<size_t>(N) * ld->T);
  // kept rows: all (shard, e, t) with done == 0, in (shard, e, t) order
  for (size_t si = 0; si < ld->shards.size(); ++si) {
    const Shard& s = ld->shards[si];
    for (int32_t e = 0; e < s.E; ++e) {
      const uint8_t* drow = s.done + static_cast<size_t>(e) * s.T;
      for (int32_t t = 0; t < s.T; ++t) {
        if (!drow[t]) {
          ld->rows.push_back((static_cast<uint64_t>(si) << 48) |
                             (static_cast<uint64_t>(e) << 24) |
                             static_cast<uint64_t>(t));
        }
      }
    }
  }
  return ld.release();
}

int64_t tdl_rows(void* h) {
  return static_cast<int64_t>(as_loader(h)->rows.size());
}

int tdl_row_dim(void* h) { return as_loader(h)->row_dim(); }

int tdl_target_dim(void* h) { return as_loader(h)->G; }

void tdl_start_epoch(void* h, uint64_t seed, int batch, int n_threads,
                     int shuffle) {
  Loader* ld = as_loader(h);
  ld->stop();
  ld->batch = batch;
  ld->order.resize(ld->rows.size());
  for (size_t i = 0; i < ld->order.size(); ++i) {
    ld->order[i] = static_cast<uint32_t>(i);
  }
  if (shuffle) {
    std::mt19937_64 rng(seed);
    for (size_t i = ld->order.size(); i > 1; --i) {
      std::swap(ld->order[i - 1], ld->order[rng() % i]);
    }
  }
  ld->next_row.store(0);
  ld->running = true;
  const int nt = n_threads > 0 ? n_threads : 2;
  ld->active_workers.store(nt);
  for (int i = 0; i < nt; ++i) {
    ld->workers.emplace_back([ld] { ld->worker_loop(); });
  }
}

// Fills x (batch*row_dim) and y (batch*target_dim); returns rows written,
// 0 at epoch end, -1 on error.
int tdl_next_batch(void* h, float* x, float* y) {
  Loader* ld = as_loader(h);
  std::unique_lock<std::mutex> lk(ld->mu);
  ld->cv_pop.wait(lk, [&] {
    return !ld->queue.empty() || ld->active_workers.load() == 0 ||
           !ld->running;
  });
  if (ld->queue.empty()) return 0;  // epoch drained
  Batch b = std::move(ld->queue.front());
  ld->queue.pop_front();
  ld->cv_push.notify_one();
  lk.unlock();
  std::memcpy(x, b.x.data(), b.x.size() * sizeof(float));
  std::memcpy(y, b.y.data(), b.y.size() * sizeof(float));
  return b.rows;
}

void tdl_close(void* h) { delete as_loader(h); }

}  // extern "C"
