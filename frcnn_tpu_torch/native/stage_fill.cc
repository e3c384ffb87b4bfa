// The host's fill of a page-locked staging block: one memcpy of a batch,
// split into pieces that the calling thread and a pool of helper threads
// claim in order.
//
// The served batch reaches the card through a page-locked block
// (engine/graphs.stage): the host copies it in, chunk by chunk, and each
// chunk's copy to the card is enqueued as soon as its bytes are in.  A
// parallel region with a fixed share a thread (OpenMP's static split, as
// torch's CPU copy has it) ends when its slowest thread ends, so a helper
// that is slow to wake holds up every chunk.  Here a helper that has not
// woken holds nothing: the caller starts on the first piece at once, and
// each helper claims the next unclaimed piece when it runs.  The caller's
// wait for a prefix of the batch helps with the pieces left before it
// spins on pieces that others hold.
//
// C API (ctypes, stage_fill.py):
//   frcnn_stage_pool(helpers)        a pool of `helpers` threads, never freed
//   frcnn_stage_begin(pool, dst, src, n)
//                                    start copying n bytes src -> dst
//   frcnn_stage_wait(pool, upto)     return once bytes [0, upto) are copied;
//                                    0, or -1 where no fill is open
// One fill at a time a pool: a fill's last wait (upto n) ends it.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
static inline void relax() { _mm_pause(); }
#else
static inline void relax() { std::this_thread::yield(); }
#endif

namespace {

// Bytes a thread copies at a claim: small beside a chunk, so a helper that
// is preempted holds up little; large beside the cost of a claim
constexpr int64_t kPiece = 256 << 10;

struct Fill {
  char* dst;
  const char* src;
  int64_t n, pieces;
  std::atomic<int64_t> next{0};
  std::unique_ptr<std::atomic<uint8_t>[]> done;
  int64_t prefix = 0;  // pieces known done from the start (the caller's)

  Fill(void* d, const void* s, int64_t bytes)
      : dst(static_cast<char*>(d)), src(static_cast<const char*>(s)), n(bytes),
        pieces((bytes + kPiece - 1) / kPiece), done(new std::atomic<uint8_t>[pieces]) {
    for (int64_t i = 0; i < pieces; ++i) done[i].store(0, std::memory_order_relaxed);
  }

  // Claim the next piece and copy it; false once every piece is claimed.
  bool run_one() {
    int64_t i = next.fetch_add(1, std::memory_order_relaxed);
    if (i >= pieces) return false;
    int64_t a = i * kPiece;
    std::memcpy(dst + a, src + a, static_cast<size_t>(std::min(kPiece, n - a)));
    done[i].store(1, std::memory_order_release);
    return true;
  }
};

struct Pool {
  std::mutex m;
  std::condition_variable cv;
  std::shared_ptr<Fill> fill;  // the open fill, shared with the helpers in it
  uint64_t generation = 0;

  void helper() {
    uint64_t seen = 0;
    for (;;) {
      std::shared_ptr<Fill> f;
      {
        std::unique_lock<std::mutex> lock(m);
        cv.wait(lock, [&] { return generation != seen; });
        seen = generation;
        f = fill;
      }
      if (f) {
        while (f->run_one()) {
        }
      }
    }
  }
};

}  // namespace

extern "C" {

void* frcnn_stage_pool(int helpers) {
  Pool* pool = new Pool();
  for (int i = 0; i < helpers; ++i) std::thread([pool] { pool->helper(); }).detach();
  return pool;
}

void frcnn_stage_begin(void* handle, void* dst, const void* src, int64_t n) {
  Pool* pool = static_cast<Pool*>(handle);
  auto f = std::make_shared<Fill>(dst, src, n);
  {
    std::lock_guard<std::mutex> lock(pool->m);
    pool->fill = f;
    ++pool->generation;
  }
  pool->cv.notify_all();
}

int frcnn_stage_wait(void* handle, int64_t upto) {
  Pool* pool = static_cast<Pool*>(handle);
  std::shared_ptr<Fill> f;
  {
    std::lock_guard<std::mutex> lock(pool->m);
    f = pool->fill;
  }
  if (!f) return -1;
  int64_t need = std::min(f->pieces, (std::max<int64_t>(upto, 0) + kPiece - 1) / kPiece);
  while (f->prefix < need) {
    if (f->done[f->prefix].load(std::memory_order_acquire)) {
      ++f->prefix;
    } else if (!f->run_one()) {
      relax();  // every piece is claimed: wait for those in flight
    }
  }
  if (need == f->pieces) {
    std::lock_guard<std::mutex> lock(pool->m);
    if (pool->fill == f) pool->fill.reset();
  }
  return 0;
}

}  // extern "C"
