// pileup_build: a region load's pileup build and pure-reference flags on
// the card (the steps and their design: pileup_build.cuh).
//
// sniper_card_pileup is what the native loader calls, through the pointer
// the windowed driver registers with it (sniper_set_card_pileup), once
// the loader has found the region's records and filtered them: it copies
// the records' bytes up through the calling thread's stage
// (card_stage.cuh), runs the build on the stage's stream, and copies the
// columns, their slots and flags back into a pinned buffer of a pool,
// which the pileup gives back when the loader frees it.  The first CUDA
// error ends the card's part, as in bgzf_inflate.cu.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <climits>
#include <mutex>
#include <cstdint>
#include <vector>

#include "card_stage.cuh"
#include "pileup_build.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kTileWarps = 4;

std::atomic<long long> g_launches{0};  // calls that launched, a region each
std::atomic<int> g_error{0};           // the first CUDA error, then kept

__global__ void pileup_cover_kernel(const uint8_t* bytes, const uint32_t* rec,
                                    int n_reads, long long lo, long long hi,
                                    uint32_t* diff, int* pos) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < n_reads) pileup::cover_read(bytes, rec, r, lo, hi, diff, pos);
}

// In-place inclusive scan of s[0, kScanThreads) by the whole block.
__device__ void block_scan(uint32_t* s, int t) {
  for (int o = 1; o < kScanThreads; o <<= 1) {
    const uint32_t v = t >= o ? s[t - o] : 0;
    __syncthreads();
    s[t] += v;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kScanThreads)
    pileup_scan_kernel(uint32_t* diff, long long span, long long lo,
                       long long key_hi, long long* ukeys,
                       long long* offsets, long long* counts) {
  __shared__ uint32_t s_d[kScanThreads], s_c[kScanThreads],
      s_e[kScanThreads];
  const int t = threadIdx.x;
  long long first, last;
  pileup::scan_range(span, t, kScanThreads, &first, &last);
  const uint32_t step = pileup::scan_sum(diff, first, last);
  s_d[t] = step;
  __syncthreads();
  block_scan(s_d, t);
  const uint32_t d0 = s_d[t] - step;
  uint32_t nc, ne;
  pileup::scan_count(diff, first, last, d0, &nc, &ne);
  s_c[t] = nc;
  s_e[t] = ne;
  __syncthreads();
  block_scan(s_c, t);
  block_scan(s_e, t);
  pileup::scan_write(diff, first, last, d0, s_c[t] - nc, s_e[t] - ne, lo,
                     key_hi, ukeys, offsets);
  if (t == kScanThreads - 1) {
    offsets[s_c[t]] = s_e[t];
    counts[0] = s_c[t];
    counts[1] = s_e[t];
  }
}

__global__ void __launch_bounds__(32 * kTileWarps)
    pileup_scatter_kernel(const uint8_t* bytes, const uint32_t* rec,
                          const int* pos, int n_reads, long long lo,
                          long long hi, int tile, long long n_tiles,
                          long long max_len, const uint32_t* cur0,
                          uint32_t* slots) {
  extern __shared__ uint32_t s_cur[];
  const int w = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kTileWarps + w;
  if (i >= n_tiles) return;
  const long long p0 = lo + i * tile;
  const long long p1 = p0 + tile < hi ? p0 + tile : hi;
  pileup::scatter_tile(threadIdx.x & 31, bytes, rec, pos, n_reads, lo, p0,
                       p1, max_len, cur0, s_cur + w * tile, slots);
}

__global__ void pileup_pure_kernel(const uint32_t* slots,
                                   const long long* ukeys,
                                   const long long* offsets,
                                   long long n_cols, long long lo,
                                   const uint8_t* refc, long long n_ref,
                                   const double* tabs, double margin,
                                   int fused, uint8_t* pure) {
  __shared__ double s_tabs[512];  // fk, then gmin
  for (int i = threadIdx.x; i < 512; i += blockDim.x) s_tabs[i] = tabs[i];
  __syncthreads();
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cols) return;
  const long long rel = (ukeys[c] & ((1LL << 40) - 1)) - lo;
  const uint32_t rcode = rel < n_ref ? refc[rel] : 0;
  pure[c] = pileup::pure_column(slots, offsets[c], offsets[c + 1], rcode,
                                s_tabs, s_tabs + 256, margin, fused != 0);
}

// The stage's arrays of the build.
enum Buf { kBytes, kRec, kPos, kDiff, kUkeys, kOffsets, kSlots, kPure, kRef,
           kTabs, kCounts };

template <typename T>
T* at(card::Stage* s, Buf b) {
  return static_cast<T*>(s->buf[b].p);
}

// The host arrays of a pileup the card built: one pinned buffer holding its
// ukeys (n_cols i64), offsets (n_cols + 1 i64), slots (n_entries u32) and
// flags (n_cols u8), in that order, after a head that holds the buffer's
// size.  Buffers come from a process-wide pool and go back to it when the
// loader frees the pileup (sniper_card_pileup_release), so the copies back
// land in pinned memory straight from the card, and a load touches no
// fresh page once the pool holds as many buffers as the driver keeps
// pileups alive.  A new buffer has 1/32 more room than asked (a window's
// entries vary by far less from one pass to the next); where none fits,
// the free buffers too small for it go, so the pool stays the size of the
// pileups alive at once.  It keeps them between passes: pinning a 300 MB
// buffer anew takes ~0.25 s (cudaMallocHost, or malloc and
// cudaHostRegister, on an H100 host), longer than the build.
struct HostBuf {
  uint8_t* p;
  size_t cap;
};

constexpr size_t kHead = 64;      // the buffer's size, then the arrays
constexpr size_t kPoolKept = 32;  // free buffers kept; more are freed
std::mutex g_pool_mu;
std::vector<HostBuf> g_pool;  // free buffers

// A buffer of at least ``bytes``: the smallest free one that holds them,
// or a new one.
cudaError_t take(size_t bytes, HostBuf* out) {
  std::vector<HostBuf> small;
  {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    size_t best = g_pool.size();
    for (size_t i = 0; i < g_pool.size(); ++i)
      if (g_pool[i].cap >= bytes &&
          (best == g_pool.size() || g_pool[i].cap < g_pool[best].cap))
        best = i;
    if (best < g_pool.size()) {
      *out = g_pool[best];
      g_pool.erase(g_pool.begin() + best);
      return cudaSuccess;
    }
    small.swap(g_pool);
  }
  for (const HostBuf& b : small) cudaFreeHost(b.p);
  out->cap = std::max<size_t>(bytes + bytes / 32, 1u << 16);
  cudaError_t e = cudaMallocHost(reinterpret_cast<void**>(&out->p), out->cap);
  if (e == cudaSuccess) *reinterpret_cast<size_t*>(out->p) = out->cap;
  return e;
}

void give(HostBuf b) {
  std::lock_guard<std::mutex> lk(g_pool_mu);
  g_pool.push_back(b);
  if (g_pool.size() > kPoolKept) {
    auto least = std::min_element(
        g_pool.begin(), g_pool.end(),
        [](const HostBuf& a, const HostBuf& c) { return a.cap < c.cap; });
    cudaFreeHost(least->p);
    g_pool.erase(least);
  }
}

// sniper_card_pileup's work; ``*declined`` set where the host builds the
// region instead (a region past 4 GiB of bytes).
cudaError_t build(int device, const uint8_t* bytes, long long n_bytes,
                  const long long* rec, int n_reads, int tid, long long lo,
                  long long hi, long long max_len, const uint8_t* ref,
                  long long n_ref, const double* fk, const double* gmin,
                  double margin, int fused, void** out, long long* counts,
                  bool* declined) {
  const long long span = hi > lo ? hi - lo : 0;
  if (n_reads > 0 && span > 0) {
    const long long base = *std::min_element(rec, rec + n_reads);
    if (n_bytes - base > (long long)UINT32_MAX || span >= INT_MAX) {
      *declined = true;
      return cudaSuccess;
    }
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  long long n_cols = 0, n_entries = 0;
  card::Stage* s = nullptr;
  if (n_reads > 0 && span > 0) {
    if ((e = card::stage_for(device, &s)) != cudaSuccess) return e;
    const long long base = *std::min_element(rec, rec + n_reads);
    const size_t n_up = (size_t)(n_bytes - base);
    const long long n_codes = std::min(std::max(n_ref, 0LL), span);
    const size_t sizes[] = {n_up + 4,
                            (size_t)n_reads * 4,
                            (size_t)n_reads * 4,
                            (size_t)(span + 1) * 4,
                            (size_t)span * 8,
                            (size_t)(span + 1) * 8,
                            0,
                            (size_t)span,
                            (size_t)n_codes + 1,
                            512 * 8,
                            16};
    for (int b = kBytes; b <= kCounts; ++b)
      if (b != kSlots && (e = card::grow(s->buf[b], sizes[b]))) return e;
    static thread_local std::vector<uint32_t> rec32;
    rec32.resize((size_t)n_reads);
    for (int r = 0; r < n_reads; ++r) rec32[r] = (uint32_t)(rec[r] - base);
    if ((e = card::upload(s, s->buf[kRec].p, rec32.data(),
                          rec32.size() * 4)))
      return e;
    if (ref) {
      std::vector<double> tabs(512);
      std::copy(fk, fk + 256, tabs.begin());
      std::copy(gmin, gmin + 256, tabs.begin() + 256);
      if ((e = card::upload(s, s->buf[kTabs].p, tabs.data(), 512 * 8)) ||
          (n_codes > 0 &&
           (e = card::upload(s, s->buf[kRef].p, ref, (size_t)n_codes))))
        return e;
    }
    if ((e = card::upload(s, s->buf[kBytes].p, bytes + base, n_up)) ||
        (e = cudaMemsetAsync(s->buf[kDiff].p, 0, sizes[kDiff], s->stream)))
      return e;
    pileup_cover_kernel<<<(n_reads + 255) / 256, 256, 0, s->stream>>>(
        at<uint8_t>(s, kBytes), at<uint32_t>(s, kRec), n_reads, lo, hi,
        at<uint32_t>(s, kDiff), at<int>(s, kPos));
    pileup_scan_kernel<<<1, kScanThreads, 0, s->stream>>>(
        at<uint32_t>(s, kDiff), span, lo, (long long)tid << 40,
        at<long long>(s, kUkeys), at<long long>(s, kOffsets),
        at<long long>(s, kCounts));
    if ((e = cudaGetLastError()) ||
        (e = cudaMemcpyAsync(s->h_desc, s->buf[kCounts].p, 16,
                             cudaMemcpyDeviceToHost, s->stream)) ||
        (e = card::wait(s)))
      return e;
    n_cols = reinterpret_cast<const long long*>(s->h_desc)[0];
    n_entries = reinterpret_cast<const long long*>(s->h_desc)[1];
    if ((e = card::grow(s->buf[kSlots], (size_t)n_entries * 4 + 4)))
      return e;
    const int tile = pileup::tile_width(n_entries, span);
    const long long n_tiles = (span + tile - 1) / tile;
    pileup_scatter_kernel<<<(unsigned)((n_tiles + kTileWarps - 1) /
                                       kTileWarps),
                            32 * kTileWarps,
                            kTileWarps * tile * sizeof(uint32_t),
                            s->stream>>>(
        at<uint8_t>(s, kBytes), at<uint32_t>(s, kRec), at<int>(s, kPos),
        n_reads, lo, hi, tile, n_tiles, max_len, at<uint32_t>(s, kDiff),
        at<uint32_t>(s, kSlots));
    if (ref && n_cols > 0)
      pileup_pure_kernel<<<(unsigned)((n_cols + 255) / 256), 256, 0,
                           s->stream>>>(
          at<uint32_t>(s, kSlots), at<long long>(s, kUkeys),
          at<long long>(s, kOffsets), n_cols, lo, at<uint8_t>(s, kRef),
          n_codes, at<double>(s, kTabs), margin, fused,
          at<uint8_t>(s, kPure));
    if ((e = cudaGetLastError())) return e;
    g_launches.fetch_add(1);
  }
  // the host arrays, and the copies back into them
  const size_t o_off = kHead + (size_t)n_cols * 8,
               o_slots = o_off + (n_cols + 1) * 8,
               o_pure = o_slots + (size_t)n_entries * 4;
  HostBuf h;
  if ((e = take(o_pure + (size_t)n_cols, &h))) return e;
  out[0] = h.p;
  out[1] = h.p + kHead;
  out[2] = h.p + o_off;
  out[3] = h.p + o_slots;
  out[4] = h.p + o_pure;
  counts[0] = n_cols;
  counts[1] = n_entries;
  if (!s) {
    static_cast<long long*>(out[2])[0] = 0;
    return cudaSuccess;
  }
  const struct {
    size_t at, n;
    Buf from;
  } copies[] = {{kHead, o_off - kHead, kUkeys},
                {o_off, o_slots - o_off, kOffsets},
                {o_slots, o_pure - o_slots, kSlots},
                {o_pure, ref ? (size_t)n_cols : 0, kPure}};
  for (const auto& c : copies)
    if (c.n && (e = cudaMemcpyAsync(h.p + c.at, s->buf[c.from].p, c.n,
                                    cudaMemcpyDeviceToHost, s->stream))) {
      give(h);
      return e;
    }
  if ((e = card::wait(s))) give(h);
  return e;
}

}  // namespace

// The pileup of one region's records, built on the card.  ``rec`` holds
// the body offsets into ``bytes`` of the records the loader kept, in read
// order (one contig ``tid``, sorted by position); columns are those of
// [lo, hi).  ``ref`` (NULL: no flags) holds the reference codes from lo
// on, ``n_ref`` of them (the positions past them are not pure); ``fk``,
// ``gmin`` (256 doubles each), ``margin`` and ``fused`` (the host's chain
// contracts to an FMA) are the flags' parameters.  ``max_len`` bounds a
// read's extent on the reference.  On 0, counts[0..1] hold n_cols and
// n_entries, and out[0..4] the pinned buffer that holds the pileup (for
// sniper_card_pileup_release) and its ukeys (n_cols i64), offsets
// (n_cols + 1 i64), slots (n_entries u32) and flags (n_cols u8, written
// where ``ref`` is given).  Returns 0; a negative number where the host
// is to build the region instead; or the CUDA error that stopped this
// call or an earlier one (the caller fails its load).
extern "C" int sniper_card_pileup(int device, const void* bytes,
                                  long long n_bytes, const void* rec,
                                  int n_reads, int tid, long long lo,
                                  long long hi, long long max_len,
                                  const void* ref, long long n_ref,
                                  const void* fk, const void* gmin,
                                  double margin, int fused, void* out,
                                  void* counts) {
  if (const int failed = g_error.load()) return failed;
  bool declined = false;
  const cudaError_t e =
      build(device, static_cast<const uint8_t*>(bytes), n_bytes,
            static_cast<const long long*>(rec), n_reads, tid, lo, hi, max_len,
            static_cast<const uint8_t*>(ref), n_ref,
            static_cast<const double*>(fk), static_cast<const double*>(gmin),
            margin, fused, static_cast<void**>(out),
            static_cast<long long*>(counts), &declined);
  if (e != cudaSuccess) {
    int none = 0;
    g_error.compare_exchange_strong(none, (int)e);
    return (int)e;
  }
  return declined ? -1 : 0;
}

// Give back the buffer (out[0]) of a pileup sniper_card_pileup built.
extern "C" void sniper_card_pileup_release(void* buffer) {
  uint8_t* p = static_cast<uint8_t*>(buffer);
  give({p, *reinterpret_cast<size_t*>(p)});
}

// Calls of sniper_card_pileup that launched the build, one a region, since
// the library was loaded (the port's STATS read it as
// launches_pileup_card).
extern "C" long long sniper_pileup_card_launches() { return g_launches.load(); }
