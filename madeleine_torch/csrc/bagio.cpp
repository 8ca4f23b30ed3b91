// bagio — mmap-backed .bag reader and threaded training-batch assembler:
// the host library behind madeleine_torch/native (a copy of the JAX
// package's madeleine_tpu/native/bagio.cpp with the same C API and the same
// results bit for bit; the port imports nothing of that package).
//
// A training batch at full scale is 65 cases x 5 stains x 2048 tokens x 512
// features, about 1.4 GB of f32 rows gathered from page cache. The gathers
// run on a fixed thread pool with no Python involvement (the library is
// loaded as a ctypes.CDLL, which releases the interpreter lock around each
// call), into a caller's buffer: a pinned host tensor of the loader's ring,
// from which the train step copies the batch to the card.
//
// Built with g++ (no CUDA): madeleine_torch/ops/_build.py::load_host.
//
// .bag format v1 (little-endian):
//   [0]  magic   "MBAG"
//   [4]  u32     version = 1
//   [8]  u64     n_rows
//   [16] u64     n_cols
//   [24] u32     dtype   (0 = f32, 1 = f16(unused), 2 = bf16)
//   [28] u32     reserved
//   [32] u64     coords_offset (0 = none; i64 [n_rows, 2] at that offset)
//   [40] data    row-major feature matrix
//
// C API (ctypes-friendly): bag_open/rows/cols/dtype/gather/coords/close,
// bag_assemble_batch[_bf16] for parallel multi-bag gathers and
// bag_sample_indices for the per-batch subsample draw.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__x86_64__) || defined(__i386__)
#include <immintrin.h>
#define BAGIO_X86 1
#endif

namespace {

constexpr uint32_t kMagic = 0x4741424d;  // "MBAG" little-endian
constexpr uint32_t kDtypeF32 = 0;
constexpr uint32_t kDtypeBf16 = 2;
constexpr int64_t kHeaderSize = 40;

struct Bag {
  void* map = nullptr;
  int64_t map_size = 0;
  int64_t n_rows = 0;
  int64_t n_cols = 0;
  uint32_t dtype = kDtypeF32;
  const uint8_t* data = nullptr;
  const int64_t* coords = nullptr;
  std::atomic<bool> warmed{false};
};

// Random-order row gathers over a cold mmap degrade to ~1k IOPS of 4 KB
// page-ins (measured ~4 MB/s effective on virtio disk; MADV_WILLNEED alone
// did not fix it). When the gather will touch most of the bag anyway, fault
// the mapping in sequentially first — the kernel's sequential-fault
// readahead streams the file at full disk bandwidth — then gather from RAM.
inline void warm_bag_sequential(Bag* bag) {
  madvise(bag->map, bag->map_size, MADV_SEQUENTIAL);
  volatile uint8_t sink = 0;
  const uint8_t* p = static_cast<const uint8_t*>(bag->map);
  for (int64_t off = 0; off < bag->map_size; off += 4096) sink += p[off];
  (void)sink;
  madvise(bag->map, bag->map_size, MADV_NORMAL);
}

inline void prefetch_bag(Bag* bag, int64_t rows_needed) {
  // Warm ONCE per bag per process: re-touching every page on every batch
  // cost ~20 ms/batch of cache-line misses + 650 madvise syscalls at
  // canonical scale once the pages were resident. If the kernel later
  // evicts them, the sorted gathers fault in ascending order, which the
  // readahead window streams at disk bandwidth anyway.
  if (rows_needed * 4 >= bag->n_rows && !bag->warmed.exchange(true))
    warm_bag_sequential(bag);
  // sparse gathers (<25% coverage) keep demand paging — reading the whole
  // file would waste more IO than the random faults cost
}

// Copy with non-temporal (streaming) stores. The assembled batch buffer is
// write-only for the CPU — it goes straight to the device transfer — so
// regular stores waste a third of the memory traffic on read-for-ownership
// of destination lines the core will never read. NT stores skip the RFO:
// traffic drops from (read src + RFO dst + write dst) to (read src + write
// dst). Callers that make NT stores must _mm_sfence() before publishing
// the buffer to another thread (gather_rows_stream does).
inline void stream_copy(uint8_t* dst, const uint8_t* src, int64_t n) {
#ifdef BAGIO_X86
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && n >= 128) {
    int64_t i = 0;
#ifdef __AVX512F__
    if ((reinterpret_cast<uintptr_t>(dst) & 63) == 0) {
      for (; i + 64 <= n; i += 64) {
        __m512i v = _mm512_loadu_si512(
            reinterpret_cast<const void*>(src + i));
        _mm512_stream_si512(reinterpret_cast<__m512i*>(dst + i), v);
      }
    }
#endif
    for (; i + 16 <= n; i += 16) {
      __m128i v =
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
      _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i), v);
    }
    if (i < n) std::memcpy(dst + i, src + i, n - i);
    return;
  }
#endif
  std::memcpy(dst, src, n);
}

// Same-dtype row gather with run merging: bag_sample_indices emits SORTED
// indices, so consecutive rows arrive as runs (coverage at canonical scale
// is 60-100% of the bag -> mean run length ~3 rows) that collapse into one
// streaming copy each. ITEM = bytes per element on disk AND in dst.
template <int ITEM>
inline void gather_rows_stream(const Bag* bag, const int64_t* idx, int64_t t,
                               uint8_t* dst) {
  const int64_t row_bytes = bag->n_cols * ITEM;
  int64_t i = 0;
  while (i < t) {
    const int64_t r = idx[i];
    if (r < 0 || r >= bag->n_rows) {
      std::memset(dst + i * row_bytes, 0, row_bytes);
      ++i;
      continue;
    }
    int64_t j = i + 1;
    while (j < t && idx[j] == idx[j - 1] + 1 && idx[j] < bag->n_rows) ++j;
    stream_copy(dst + i * row_bytes, bag->data + r * row_bytes,
                (j - i) * row_bytes);
    i = j;
  }
#ifdef BAGIO_X86
  _mm_sfence();  // drain write-combining buffers before the pool's done_
                 // handshake publishes the batch
#endif
}

inline float bf16_to_f32(uint16_t v) {
  uint32_t bits = static_cast<uint32_t>(v) << 16;
  float out;
  std::memcpy(&out, &bits, sizeof(out));
  return out;
}

// Gather one row (with dtype conversion) into `out` (f32, n_cols wide).
inline void copy_row(const Bag* bag, int64_t row, float* out) {
  if (row < 0 || row >= bag->n_rows) {
    std::memset(out, 0, sizeof(float) * bag->n_cols);
    return;
  }
  if (bag->dtype == kDtypeF32) {
    std::memcpy(out, bag->data + row * bag->n_cols * 4,
                sizeof(float) * bag->n_cols);
  } else {  // bf16 -> f32: widen via u32 shift; the u32 stores go through
    // memcpy-able temporaries in blocks so the loop vectorizes (the scalar
    // per-element bf16_to_f32 call ran ~15x slower on this path)
    const uint16_t* src = reinterpret_cast<const uint16_t*>(
        bag->data + row * bag->n_cols * 2);
    int64_t c = 0;
    uint32_t tmp[64];
    for (; c + 64 <= bag->n_cols; c += 64) {
      for (int k = 0; k < 64; ++k)
        tmp[k] = static_cast<uint32_t>(src[c + k]) << 16;
      std::memcpy(out + c, tmp, sizeof(tmp));
    }
    for (; c < bag->n_cols; ++c) out[c] = bf16_to_f32(src[c]);
  }
}

inline uint16_t f32_to_bf16(float f) {
  uint32_t bits;
  std::memcpy(&bits, &f, sizeof(bits));
  bits += 0x8000;  // same truncation rounding as the Python writer
  return static_cast<uint16_t>(bits >> 16);
}

// Gather one row into a bf16 buffer. bf16-on-disk rows are a straight
// 2-byte-per-element memcpy — HALF the batch bytes of the f32 path, and the
// train loop's host-side bf16 cast (1.4 GB/step at canonical scale)
// disappears entirely: the batch is born in the transfer dtype.
inline void copy_row_bf16(const Bag* bag, int64_t row, uint16_t* out) {
  if (row < 0 || row >= bag->n_rows) {
    std::memset(out, 0, sizeof(uint16_t) * bag->n_cols);
    return;
  }
  if (bag->dtype == kDtypeBf16) {
    std::memcpy(out, bag->data + row * bag->n_cols * 2,
                sizeof(uint16_t) * bag->n_cols);
  } else {
    const float* src = reinterpret_cast<const float*>(
        bag->data + row * bag->n_cols * 4);
    for (int64_t c = 0; c < bag->n_cols; ++c) out[c] = f32_to_bf16(src[c]);
  }
}

// Minimal fixed thread pool shared by all assemble calls. Tasks are coarse
// (one multi-MB row-gather each), so claims are mutex-guarded — trivially
// race-free, and the lock cost is noise next to the memcpy work. One batch
// runs at a time (run_mu_); batch/task state is only touched under mu_.
class Pool {
 public:
  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers_.emplace_back([this] { Loop(); });
  }
  ~Pool() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Grow to at least n workers (never shrinks). Taken between batches
  // (run_mu_), so no task state races with the spawn.
  void EnsureThreads(int n) {
    std::unique_lock<std::mutex> run_lk(run_mu_);
    std::unique_lock<std::mutex> lk(mu_);
    while (static_cast<int>(workers_.size()) < n)
      workers_.emplace_back([this] { Loop(); });
  }

  void Run(const std::vector<std::function<void()>>& tasks) {
    std::unique_lock<std::mutex> run_lk(run_mu_);  // one batch at a time
    {
      std::unique_lock<std::mutex> lk(mu_);
      batch_ = &tasks;
      n_tasks_ = tasks.size();
      next_ = 0;
      done_ = 0;
    }
    cv_.notify_all();
    Work();  // caller participates
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [this] { return done_ >= n_tasks_; });
    batch_ = nullptr;
  }

 private:
  void Work() {
    while (true) {
      const std::vector<std::function<void()>>* batch;
      size_t i;
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (batch_ == nullptr || next_ >= n_tasks_) return;
        batch = batch_;
        i = next_++;
      }
      (*batch)[i]();
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (++done_ >= n_tasks_) cv_done_.notify_all();
      }
    }
  }
  void Loop() {
    while (true) {
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] {
          return stop_ || (batch_ != nullptr && next_ < n_tasks_);
        });
        if (stop_) return;
      }
      Work();
    }
  }

  std::vector<std::thread> workers_;
  std::mutex mu_, run_mu_;
  std::condition_variable cv_, cv_done_;
  const std::vector<std::function<void()>>* batch_ = nullptr;
  size_t n_tasks_ = 0;
  size_t next_ = 0;
  size_t done_ = 0;
  bool stop_ = false;
};

Pool* GetPool(int n_threads) {
  static Pool* pool = new Pool(n_threads > 0 ? n_threads : 8);
  // honor later callers asking for MORE threads (the pool used to latch the
  // first caller's size forever, silently under-threading everyone after)
  if (n_threads > 0) pool->EnsureThreads(n_threads);
  return pool;
}

}  // namespace

extern "C" {

void* bag_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < kHeaderSize) {
    close(fd);
    return nullptr;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (map == MAP_FAILED) return nullptr;
  const uint8_t* p = static_cast<const uint8_t*>(map);
  uint32_t magic, version, dtype;
  std::memcpy(&magic, p, 4);
  std::memcpy(&version, p + 4, 4);
  if (magic != kMagic || version != 1) {
    munmap(map, st.st_size);
    return nullptr;
  }
  Bag* bag = new Bag();
  bag->map = map;
  bag->map_size = st.st_size;
  std::memcpy(&bag->n_rows, p + 8, 8);
  std::memcpy(&bag->n_cols, p + 16, 8);
  std::memcpy(&dtype, p + 24, 4);
  bag->dtype = dtype;
  uint64_t coords_off;
  std::memcpy(&coords_off, p + 32, 8);
  bag->data = p + kHeaderSize;
  bag->coords = coords_off
                    ? reinterpret_cast<const int64_t*>(p + coords_off)
                    : nullptr;
  return bag;
}

int64_t bag_rows(void* h) { return static_cast<Bag*>(h)->n_rows; }
int64_t bag_cols(void* h) { return static_cast<Bag*>(h)->n_cols; }
int32_t bag_dtype(void* h) { return static_cast<Bag*>(h)->dtype; }
int32_t bag_has_coords(void* h) {
  return static_cast<Bag*>(h)->coords != nullptr;
}

void bag_close(void* h) {
  Bag* bag = static_cast<Bag*>(h);
  if (bag->map) munmap(bag->map, bag->map_size);
  delete bag;
}

// Gather rows by index into an f32 buffer [n_idx, n_cols].
void bag_gather(void* h, const int64_t* idx, int64_t n_idx, float* out) {
  Bag* bag = static_cast<Bag*>(h);
  for (int64_t i = 0; i < n_idx; ++i)
    copy_row(bag, idx[i], out + i * bag->n_cols);
}

void bag_coords(void* h, const int64_t* idx, int64_t n_idx, int64_t* out) {
  Bag* bag = static_cast<Bag*>(h);
  if (!bag->coords) {
    std::memset(out, 0, sizeof(int64_t) * 2 * n_idx);
    return;
  }
  for (int64_t i = 0; i < n_idx; ++i) {
    int64_t r = idx[i];
    if (r < 0 || r >= bag->n_rows) {
      out[2 * i] = out[2 * i + 1] = 0;
    } else {
      out[2 * i] = bag->coords[2 * r];
      out[2 * i + 1] = bag->coords[2 * r + 1];
    }
  }
}

// Parallel multi-bag gather: task k copies rows indices[k*t .. k*t+t) from
// handles[k] into out + k*t*d. handles[k] == nullptr zero-fills (missing
// stain placeholder, ref: wsi_dataset.py:66). d must match every open bag.
void bag_assemble_batch(void** handles, int64_t n_tasks, const int64_t* indices,
                        int64_t t, int64_t d, float* out, int32_t n_threads) {
  std::vector<std::function<void()>> tasks;
  tasks.reserve(n_tasks);
  for (int64_t k = 0; k < n_tasks; ++k) {
    tasks.emplace_back([=] {
      float* dst = out + k * t * d;
      Bag* bag = static_cast<Bag*>(handles[k]);
      if (bag == nullptr) {
        std::memset(dst, 0, sizeof(float) * t * d);
        return;
      }
      prefetch_bag(bag, t);
      const int64_t* idx = indices + k * t;
      if (bag->dtype == kDtypeF32) {  // same-dtype: merged streaming gather
        gather_rows_stream<4>(bag, idx, t, reinterpret_cast<uint8_t*>(dst));
      } else {
        for (int64_t i = 0; i < t; ++i) copy_row(bag, idx[i], dst + i * d);
      }
    });
  }
  GetPool(n_threads)->Run(tasks);
}

// bf16-output variant of bag_assemble_batch (out: uint16 bf16 bits).
void bag_assemble_batch_bf16(void** handles, int64_t n_tasks,
                             const int64_t* indices, int64_t t, int64_t d,
                             uint16_t* out, int32_t n_threads) {
  std::vector<std::function<void()>> tasks;
  tasks.reserve(n_tasks);
  for (int64_t k = 0; k < n_tasks; ++k) {
    tasks.emplace_back([=] {
      uint16_t* dst = out + k * t * d;
      Bag* bag = static_cast<Bag*>(handles[k]);
      if (bag == nullptr) {
        std::memset(dst, 0, sizeof(uint16_t) * t * d);
        return;
      }
      prefetch_bag(bag, t);
      const int64_t* idx = indices + k * t;
      if (bag->dtype == kDtypeBf16) {  // same-dtype: merged streaming gather
        gather_rows_stream<2>(bag, idx, t, reinterpret_cast<uint8_t*>(dst));
      } else {
        for (int64_t i = 0; i < t; ++i)
          copy_row_bf16(bag, idx[i], dst + i * d);
      }
    });
  }
  GetPool(n_threads)->Run(tasks);
}

// Deterministic subsample index generation for a batch of bags — the native
// fast path behind NativeTrainLoader._batch_indices (the numpy draw cost
// ~100 ms/batch at canonical scale; this is ~2 ms). Per bag k with
// n = n_rows[k] rows: n == 0 -> zeros (missing stain), n >= t -> partial
// Fisher-Yates without replacement, n < t -> with replacement
// (ref semantics: madeleine/datasets/wsi_dataset.py:42-50). The stream is
// splitmix64 seeded per bag from (seed, k), so output is a pure function of
// (seed, bag position, n).
static inline uint64_t splitmix64(uint64_t* s) {
  uint64_t z = (*s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

// Unbiased-enough bounded draw (Lemire multiply-shift; bias < 2^-40 for the
// bag sizes involved — sampling noise, not a correctness surface).
static inline uint64_t bounded(uint64_t* s, uint64_t range) {
  return static_cast<uint64_t>(
      (static_cast<unsigned __int128>(splitmix64(s)) * range) >> 64);
}

void bag_sample_indices(uint64_t seed, const int64_t* n_rows, int64_t n_bags,
                        int64_t t, int64_t* out) {
  std::vector<int64_t> scratch;
  for (int64_t k = 0; k < n_bags; ++k) {
    int64_t* dst = out + k * t;
    const int64_t n = n_rows[k];
    uint64_t s = seed ^ (0xd1342543de82ef95ull * static_cast<uint64_t>(k + 1));
    // Output is SORTED ascending: a subsample is a (multi)set — the model
    // is permutation-invariant over tokens and the half-bag views draw
    // their own on-device permutation (models/abmil.py) — and sorted
    // indices turn the gather into near-sequential runs that
    // gather_rows_stream merges into big streaming copies. Both branches
    // generate sorted output DIRECTLY (an explicit std::sort of the old
    // Fisher-Yates output cost ~35 ms/batch at canonical scale, most of
    // the gather win).
    if (n <= 0) {
      std::memset(dst, 0, sizeof(int64_t) * t);
    } else if (n < t) {  // with replacement: draw counts, counting-sort
      scratch.assign(n, 0);
      for (int64_t i = 0; i < t; ++i)
        ++scratch[static_cast<int64_t>(bounded(&s, n))];
      int64_t p = 0;
      for (int64_t r = 0; r < n; ++r)
        for (int64_t c = 0; c < scratch[r]; ++c) dst[p++] = r;
    } else {  // uniform WOR via selection sampling (Knuth Algorithm S):
      // visit rows in order, take row with prob needed/remaining — exactly
      // uniform over t-subsets, emitted in ascending order, O(n) cheap
      // draws and no scratch permutation
      int64_t needed = t;
      for (int64_t row = 0; row < n && needed > 0; ++row) {
        if (bounded(&s, n - row) < static_cast<uint64_t>(needed)) {
          dst[t - needed] = row;
          --needed;
        }
      }
    }
  }
}

// Sequential whole-bag read (f32 out), for inference paths.
void bag_read_all(void* h, float* out) {
  Bag* bag = static_cast<Bag*>(h);
  warm_bag_sequential(bag);
  for (int64_t i = 0; i < bag->n_rows; ++i)
    copy_row(bag, i, out + i * bag->n_cols);
}

}  // extern "C"
