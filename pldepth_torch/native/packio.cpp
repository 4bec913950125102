// packio: memory-mapped packed-dataset reader of pldepth_torch's host feed
// (data/packed.py), the port's own copy of pldepth_tpu/native/packio.cpp with
// the same file format, so one pack file loads in both packages:
//
//   header:  "PLDPACK1" | u32 version | u32 n | u32 h | u32 w
//   records: n x [ u8 image[h*w*3] | f32 gt[h*w] | u8 mask[h*w] ]
//
// The hot call converts u8 -> f32/255 straight out of the page cache into
// caller-provided batch buffers, fanned out over worker threads, and a
// background prefetcher keeps a ring of ready batches (epoch order from
// std::shuffle over std::mt19937_64(seed), drop-remainder), so Python's only
// per-step work is one copy out of the ring. No Python in the steady state.
//
// C ABI only (ctypes). Thread-safe per handle. Built by data/packed.py with
// g++ at first use (or by the Makefile beside this file).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <fcntl.h>
#include <mutex>
#include <queue>
#include <random>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'P', 'L', 'D', 'P', 'A', 'C', 'K', '1'};

struct Header {
  char magic[8];
  uint32_t version;
  uint32_t n;
  uint32_t h;
  uint32_t w;
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t mapped = 0;
  uint32_t n = 0, h = 0, w = 0;
  size_t rec_size = 0;
  const uint8_t* records = nullptr;
};

inline size_t record_size(uint32_t h, uint32_t w) {
  return (size_t)h * w * 3 /*img u8*/ + (size_t)h * w * 4 /*gt f32*/ +
         (size_t)h * w /*mask u8*/;
}

void decode_record(const Reader* r, uint32_t idx, float* img_out,
                   float* gt_out, float* mask_out) {
  const size_t hw = (size_t)r->h * r->w;
  const uint8_t* rec = r->records + (size_t)idx * r->rec_size;
  const uint8_t* img_u8 = rec;
  const float* gt_f32 = reinterpret_cast<const float*>(rec + hw * 3);
  const uint8_t* mask_u8 = rec + hw * 3 + hw * 4;

  constexpr float kInv255 = 1.0f / 255.0f;
  for (size_t i = 0; i < hw * 3; ++i) img_out[i] = img_u8[i] * kInv255;
  std::memcpy(gt_out, gt_f32, hw * sizeof(float));
  for (size_t i = 0; i < hw; ++i) mask_out[i] = mask_u8[i] ? 1.0f : 0.0f;
}

struct Batch {
  std::vector<float> img, gt, mask;   // f32 mode
  std::vector<uint8_t> img8, mask8;   // u8 wire mode (gt stays f32)
};

struct Prefetcher {
  Reader* reader = nullptr;
  uint32_t batch = 0;
  bool shuffle = true;
  bool loop = true;
  uint64_t seed = 0;
  int workers = 1;

  bool u8 = false;  // emit u8 images/masks (4x less host->device traffic)
  uint64_t start_batch = 0;  // skip this many batches of the stream (resume)

  std::thread thread;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::queue<Batch*> ready;
  size_t capacity = 2;
  std::atomic<bool> stop{false};
  bool finished = false;

  ~Prefetcher() {
    {
      // store under the mutex: a producer that has evaluated its wait
      // predicate (ring full, stop false) but not yet blocked would miss
      // a lock-free notify and sleep forever, hanging thread.join()
      std::lock_guard<std::mutex> lk(mu);
      stop.store(true);
    }
    cv_space.notify_all();
    cv_ready.notify_all();
    if (thread.joinable()) thread.join();
    std::unique_lock<std::mutex> lk(mu);
    while (!ready.empty()) {
      delete ready.front();
      ready.pop();
    }
  }
};

// Persistent worker pool: fill_batch used to spawn+join fresh threads for
// EVERY batch (thousands/min of create/destroy jitter on the hot data
// path). Workers park on a condition variable between batches.
struct WorkerPool {
  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_go, cv_done;
  std::function<void(int, int)> job;  // (worker_index, stride)
  uint64_t epoch = 0;
  int pending = 0;
  bool stop = false;

  explicit WorkerPool(int n) {
    for (int i = 1; i < n; ++i)
      threads.emplace_back([this, i, n] {
        uint64_t seen = 0;
        std::unique_lock<std::mutex> lk(mu);
        for (;;) {
          cv_go.wait(lk, [&] { return stop || epoch != seen; });
          if (stop) return;
          seen = epoch;
          auto fn = job;
          lk.unlock();
          fn(i, n);
          lk.lock();
          if (--pending == 0) cv_done.notify_all();
        }
      });
  }
  // run fn(worker, stride) on all workers + the caller; blocks until done
  void run(const std::function<void(int, int)>& fn) {
    int n = (int)threads.size() + 1;
    if (n == 1) {
      fn(0, 1);
      return;
    }
    {
      std::lock_guard<std::mutex> lk(mu);
      job = fn;
      pending = n - 1;
      ++epoch;
    }
    cv_go.notify_all();
    fn(0, n);
    std::unique_lock<std::mutex> lk(mu);
    cv_done.wait(lk, [&] { return pending == 0; });
  }
  ~WorkerPool() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv_go.notify_all();
    for (auto& t : threads) t.join();
  }
};

void fill_batch_u8(Reader* r, const uint32_t* idx, uint32_t batch, int workers,
                   uint8_t* img, float* gt, uint8_t* mask) {
  const size_t hw = (size_t)r->h * r->w;
  auto work = [&](uint32_t start, uint32_t stride) {
    for (uint32_t b = start; b < batch; b += stride) {
      const uint8_t* rec = r->records + (size_t)idx[b] * r->rec_size;
      std::memcpy(img + (size_t)b * hw * 3, rec, hw * 3);
      std::memcpy(gt + (size_t)b * hw, rec + hw * 3, hw * sizeof(float));
      std::memcpy(mask + (size_t)b * hw, rec + hw * 3 + hw * 4, hw);
    }
  };
  int t = (workers < (int)batch ? workers : (int)batch);
  if (t <= 1) {
    work(0, 1);
    return;
  }
  std::vector<std::thread> threads;
  for (int i = 1; i < t; ++i) threads.emplace_back(work, i, t);
  work(0, t);
  for (auto& th : threads) th.join();
}

void fill_batch(Reader* r, const uint32_t* idx, uint32_t batch, int workers,
                float* img, float* gt, float* mask) {
  const size_t hw = (size_t)r->h * r->w;
  auto work = [&](uint32_t start, uint32_t stride) {
    for (uint32_t b = start; b < batch; b += stride) {
      decode_record(r, idx[b], img + (size_t)b * hw * 3, gt + (size_t)b * hw,
                    mask + (size_t)b * hw);
    }
  };
  if (workers <= 1 || batch <= 1) {
    work(0, 1);
    return;
  }
  int t = workers < (int)batch ? workers : (int)batch;
  std::vector<std::thread> threads;
  threads.reserve(t - 1);
  for (int i = 1; i < t; ++i) threads.emplace_back(work, i, t);
  work(0, t);
  for (auto& th : threads) th.join();
}

void prefetch_loop(Prefetcher* p) {
  Reader* r = p->reader;
  const size_t hw = (size_t)r->h * r->w;
  int nw = p->workers;
  if (nw > (int)p->batch) nw = (int)p->batch;
  if (nw < 1) nw = 1;
  WorkerPool pool(nw);
  std::mt19937_64 rng(p->seed);
  std::vector<uint32_t> order(r->n);
  for (uint32_t i = 0; i < r->n; ++i) order[i] = i;

  // Resume support: the rng is seeded, so replaying epoch shuffles from 0 is
  // deterministic; skipped batches are never decoded, only their permutation
  // entries are advanced past.
  uint64_t skip = p->start_batch;
  while (!p->stop.load()) {
    if (p->shuffle) std::shuffle(order.begin(), order.end(), rng);
    uint32_t n_batches = r->n / p->batch;
    if (skip >= n_batches) {
      skip -= n_batches;
      if (!p->loop) break;
      continue;
    }
    uint32_t bi0 = (uint32_t)skip;
    skip = 0;
    for (uint32_t bi = bi0; bi < n_batches && !p->stop.load(); ++bi) {
      Batch* out = new Batch;
      out->gt.resize((size_t)p->batch * hw);
      if (p->u8) {
        out->img8.resize((size_t)p->batch * hw * 3);
        out->mask8.resize((size_t)p->batch * hw);
        {
          const uint32_t* bidx = order.data() + (size_t)bi * p->batch;
          uint32_t batch = p->batch;
          uint8_t* img8 = out->img8.data();
          float* gtp = out->gt.data();
          uint8_t* mask8 = out->mask8.data();
          pool.run([&](int wi, int stride) {
            for (uint32_t b = wi; b < batch; b += stride) {
              const uint8_t* rec = r->records + (size_t)bidx[b] * r->rec_size;
              std::memcpy(img8 + (size_t)b * hw * 3, rec, hw * 3);
              std::memcpy(gtp + (size_t)b * hw, rec + hw * 3,
                          hw * sizeof(float));
              std::memcpy(mask8 + (size_t)b * hw, rec + hw * 3 + hw * 4, hw);
            }
          });
        }
      } else {
        out->img.resize((size_t)p->batch * hw * 3);
        out->mask.resize((size_t)p->batch * hw);
        {
          const uint32_t* bidx = order.data() + (size_t)bi * p->batch;
          uint32_t batch = p->batch;
          float* imgp = out->img.data();
          float* gtp = out->gt.data();
          float* maskp = out->mask.data();
          pool.run([&](int wi, int stride) {
            for (uint32_t b = wi; b < batch; b += stride) {
              decode_record(r, bidx[b], imgp + (size_t)b * hw * 3,
                            gtp + (size_t)b * hw, maskp + (size_t)b * hw);
            }
          });
        }
      }
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_space.wait(lk, [&] { return p->ready.size() < p->capacity || p->stop.load(); });
      if (p->stop.load()) {
        delete out;
        return;
      }
      p->ready.push(out);
      p->cv_ready.notify_one();
    }
    if (!p->loop) break;
  }
  std::unique_lock<std::mutex> lk(p->mu);
  p->finished = true;
  p->cv_ready.notify_all();
}

}  // namespace

extern "C" {

void* packio_open(const char* path) {
  Reader* r = new Reader;
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    close(r->fd);
    delete r;
    return nullptr;
  }
  r->mapped = (size_t)st.st_size;
  void* m = mmap(nullptr, r->mapped, PROT_READ, MAP_PRIVATE, r->fd, 0);
  if (m == MAP_FAILED) {
    close(r->fd);
    delete r;
    return nullptr;
  }
  r->base = static_cast<const uint8_t*>(m);
  const Header* h = reinterpret_cast<const Header*>(r->base);
  if (r->mapped < sizeof(Header) || std::memcmp(h->magic, kMagic, 8) != 0 ||
      h->version != 1) {
    munmap(m, r->mapped);
    close(r->fd);
    delete r;
    return nullptr;
  }
  r->n = h->n;
  r->h = h->h;
  r->w = h->w;
  r->rec_size = record_size(r->h, r->w);
  r->records = r->base + sizeof(Header);
  if (r->mapped < sizeof(Header) + (size_t)r->n * r->rec_size) {
    munmap(m, r->mapped);
    close(r->fd);
    delete r;
    return nullptr;
  }
  madvise(const_cast<uint8_t*>(r->base), r->mapped, MADV_WILLNEED);
  return r;
}

void packio_close(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (!r) return;
  if (r->base) munmap(const_cast<uint8_t*>(r->base), r->mapped);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

void packio_info(void* handle, uint32_t* n, uint32_t* h, uint32_t* w) {
  Reader* r = static_cast<Reader*>(handle);
  *n = r->n;
  *h = r->h;
  *w = r->w;
}

// Decode `batch` records at `indices` into caller buffers.
void packio_get_batch(void* handle, const uint32_t* indices, uint32_t batch,
                      int workers, float* img_out, float* gt_out,
                      float* mask_out) {
  Reader* r = static_cast<Reader*>(handle);
  fill_batch(r, indices, batch, workers, img_out, gt_out, mask_out);
}

void* packio_prefetch_start(void* handle, uint32_t batch, uint64_t seed,
                            int shuffle, int loop, int workers,
                            uint32_t ring_capacity, int u8_mode,
                            uint64_t start_batch) {
  Prefetcher* p = new Prefetcher;
  p->reader = static_cast<Reader*>(handle);
  p->batch = batch;
  p->seed = seed;
  p->shuffle = shuffle != 0;
  p->loop = loop != 0;
  p->workers = workers;
  p->capacity = ring_capacity ? ring_capacity : 2;
  p->u8 = u8_mode != 0;
  p->start_batch = start_batch;
  p->thread = std::thread(prefetch_loop, p);
  return p;
}

static Batch* pop_batch(Prefetcher* p) {
  std::unique_lock<std::mutex> lk(p->mu);
  p->cv_ready.wait(lk, [&] { return !p->ready.empty() || p->finished || p->stop.load(); });
  if (p->ready.empty()) return nullptr;
  Batch* b = p->ready.front();
  p->ready.pop();
  p->cv_space.notify_one();
  return b;
}

// Returns 1 and fills buffers; 0 at end of (non-looping) stream.
int packio_prefetch_next(void* pf, float* img_out, float* gt_out,
                         float* mask_out) {
  Batch* b = pop_batch(static_cast<Prefetcher*>(pf));
  if (!b) return 0;
  std::memcpy(img_out, b->img.data(), b->img.size() * sizeof(float));
  std::memcpy(gt_out, b->gt.data(), b->gt.size() * sizeof(float));
  std::memcpy(mask_out, b->mask.data(), b->mask.size() * sizeof(float));
  delete b;
  return 1;
}

// u8-wire variant: images/masks as raw u8, gt f32.
int packio_prefetch_next_u8(void* pf, uint8_t* img_out, float* gt_out,
                            uint8_t* mask_out) {
  Batch* b = pop_batch(static_cast<Prefetcher*>(pf));
  if (!b) return 0;
  std::memcpy(img_out, b->img8.data(), b->img8.size());
  std::memcpy(gt_out, b->gt.data(), b->gt.size() * sizeof(float));
  std::memcpy(mask_out, b->mask8.data(), b->mask8.size());
  delete b;
  return 1;
}

void packio_prefetch_stop(void* pf) { delete static_cast<Prefetcher*>(pf); }

}  // extern "C"
