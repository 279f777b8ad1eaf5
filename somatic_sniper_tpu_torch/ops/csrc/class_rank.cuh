// class_rank.cuh: the per-column class rank and fixed-order class sums
// shared by accumulate32.cu, accumulate.cu and accumulate16.cu.
//
// The MAQ weight of a read is table[r], r its rank within its (base,
// strand) class in descending quality order (reference
// sniper_maqcns.c:160-176).  A kernel writes one int key per lane, class
// in the high bits so that a class is a contiguous run after an ascending
// sort, quality inverted below it so that the best read comes first;
// lanes that take no part get a class >= 8 and sort after every real one.
// After the sort, rank = position - start of the class's run.
//
// Layouts, chosen by layout_for(D) on the host.  P is the next power of
// two >= max(D, 32):
//   P <= 256     the warp layout: one column a warp, 8 warps a block, the
//                column's P keys in registers, P / 32 a lane; kernels take
//                P as a template argument (kP).  No shared memory and no
//                block barrier: the bitonic network's strides below 32 are
//                __shfl_xor_sync exchanges, the strides from 32 up are
//                compare-exchanges between a lane's own registers; the
//                class starts come from a neighbour compare, one ballot a
//                register and a count of leading zeros; the sums are a
//                butterfly inside the warp;
//   P <= 16384   the block layout: one column per block, min(P, 1024)
//                threads, P / threads keys a thread, keys in dynamic shared
//                memory (opt in above 48 KB); kP = 0, P at run time;
//   P > 16384    the same, keys in a global scratch of P ints per column
//                that the wrapper allocates.
//
// Sums are per-thread partials in position order, then a fixed tree (the
// warp's butterfly; in the block layout a warp-shuffle tree, then the
// column's warps in order): no float atomics, so repeated runs give the
// same bits.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace class_rank {

constexpr int kWarpThreads = 256;               // threads a block, warp layout
constexpr int kWarpCols = kWarpThreads / 32;    // columns a block, warp layout
constexpr int kMaxWarpP = 256;
constexpr int kBigThreads = 1024;
// A block of 1024 threads fits an SM twice only at 32 registers a thread
// or fewer; the block layout's kernels ask for that in their launch
// bounds (one more register halves their occupancy).
constexpr int kBigBlocksPerSM = 2;
constexpr int kMaxSharedP = 16384;
constexpr int kMinP = 32;
constexpr int kMaxWarps = kBigThreads / 32;
constexpr int kMaxRank = 255;
constexpr int kNumClasses = 8;
constexpr unsigned kFullMask = 0xffffffffu;

struct Layout {
  int P;          // keys per column
  int cols;       // columns per block
  int threads;    // threads per block
  size_t smem;    // dynamic shared memory bytes (0 with a global scratch)
  long long scratch_ints;  // global scratch ints per column (0 if none)
};

inline Layout layout_for(int D) {
  Layout l;
  int P = kMinP;
  while (P < D) P <<= 1;
  l.P = P;
  if (P <= kMaxWarpP) {
    l.cols = kWarpCols;
    l.threads = kWarpThreads;
    l.smem = 0;
    l.scratch_ints = 0;
  } else {
    l.cols = 1;
    l.threads = P < kBigThreads ? P : kBigThreads;
    l.smem = P <= kMaxSharedP ? sizeof(int) * P : 0;
    l.scratch_ints = P <= kMaxSharedP ? 0 : P;
  }
  return l;
}

// Calls f(std::integral_constant<int, kP>) with kP = the layout's P for
// the warp layout and 0 above it; returns what f returns.
template <typename F>
int with_kp(const Layout& l, F f) {
  switch (l.P) {
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// Opts a kernel into the dynamic shared memory a layout needs, then
// launches it; returns the launch's cudaGetLastError().
template <typename Kernel, typename... Args>
int launch(Kernel kernel, const Layout& l, int B, cudaStream_t stream,
           Args... args) {
  if (l.smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (B + l.cols - 1) / l.cols;
  kernel<<<grid, l.threads, l.smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

template <int kInts>
struct Sums {
  float e[4];
  float f[4];
  int i[kInts];  // c[4], then any per-column integer sums
};

// Adds one participating read of base class k4 with weight fkw and
// effective quality eff.
template <int kInts>
__device__ inline void add_read(Sums<kInts>& s, int k4, float fkw, int eff) {
  const float et = fkw * (float)eff;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (k == k4) {
      s.e[k] += et;
      s.f[k] += fkw;
      s.i[k] += 1;
    }
  }
}

// -- the warp layout (P <= 256) ----------------------------------------------
//
// A warp holds its column's kP keys in K = kP / 32 registers a lane.  In
// sorted order, key x of the column is register x / 32 of lane x % 32.

// The warp's column, or -1 past the batch (the whole warp then returns:
// nothing in this layout waits on another warp).
__device__ inline int warp_column(int B) {
  const int col = (int)blockIdx.x * kWarpCols + ((int)threadIdx.x >> 5);
  return col < B ? col : -1;
}

// Elements one wide load brings a lane: K of them, at most 16 bytes.
template <typename T, int K>
__host__ __device__ constexpr int chunk_elems() {
  return K * (int)sizeof(T) <= 16 ? K : 16 / (int)sizeof(T);
}

// Whether every row of a [B, D] array of T at `p` can be read with wide
// loads of chunk_elems<T, K>() elements: rows start on a chunk boundary.
template <typename T, int K>
inline bool rows_take_wide_loads(const void* p, int D) {
  constexpr int C = chunk_elems<T, K>();
  return C > 1 && D % C == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <int kBytes> struct WideWord;
template <> struct WideWord<4> { using type = unsigned int; };
template <> struct WideWord<8> { using type = uint2; };
template <> struct WideWord<16> { using type = uint4; };

// Reads the first `count` elements of a column's row (count <= D) into K
// registers a lane; pos[q] is the element v[q] holds (any order will do:
// the sort follows), or >= count where the lane holds none.  `wide`: a
// lane reads K consecutive elements with loads of up to 128 bits (see
// rows_take_wide_loads); else lane l reads elements l, l + 32, ...  Either
// way a warp reads its row contiguously.
template <typename T, int K>
__device__ inline void load_row(const T* __restrict__ row, int count,
                                bool wide, T (&v)[K], int (&pos)[K]) {
  const int lane = threadIdx.x & 31;
  constexpr int C = chunk_elems<T, K>();
  if constexpr (C > 1) {
    if (wide) {
      using W = typename WideWord<C * (int)sizeof(T)>::type;
      union Chunk {
        W word;
        T elem[C];
      };
#pragma unroll
      for (int ch = 0; ch < K / C; ++ch) {
        const int first = lane * K + ch * C;
        Chunk chunk = {};
        if (first < count) {
          chunk.word = *reinterpret_cast<const W*>(row + first);
        }
#pragma unroll
        for (int q = 0; q < C; ++q) {
          v[ch * C + q] = chunk.elem[q];
          pos[ch * C + q] = first + q;
        }
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < K; ++q) {
    pos[q] = q * 32 + lane;
    v[q] = pos[q] < count ? row[pos[q]] : T(0);
  }
}

// Ascending bitonic sort of the warp's kP keys.  A stride below 32 is a
// lane exchange, one shuffle a register; a stride from 32 up pairs two
// registers of the same lane, and its direction is known at compile time.
template <int kP>
__device__ inline void warp_sort(int (&key)[kP / 32]) {
  constexpr int K = kP / 32;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= kP; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int jr = j >> 5;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          if ((r & jr) == 0) {
            const bool up = ((r << 5) & k) == 0;  // k >= 64: no lane bit
            const int lo = min(key[r], key[r | jr]);
            const int hi = max(key[r], key[r | jr]);
            key[r] = up ? lo : hi;
            key[r | jr] = up ? hi : lo;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r) {
          const int x = (r << 5) | lane;
          const int other = __shfl_xor_sync(kFullMask, key[r], j);
          const bool keep_min = ((lane & j) == 0) == ((x & k) == 0);
          key[r] = keep_min ? min(key[r], other) : max(key[r], other);
        }
      }
    }
  }
}

// rank[r] = position of the sorted key[r] within its class's run, the
// class being key >> kShift: a lane flags a run's first key by comparing
// with its neighbour's class, one ballot a register collects the flags,
// and the run's start is the highest flag at or below the key's position.
template <int kShift, int kP>
__device__ inline void warp_ranks(const int (&key)[kP / 32],
                                  int (&rank)[kP / 32]) {
  constexpr int K = kP / 32;
  const int lane = threadIdx.x & 31;
  unsigned first[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int cls = key[r] >> kShift;
    int prev = __shfl_up_sync(kFullMask, cls, 1);
    if (r > 0) {
      const int last = __shfl_sync(kFullMask, key[r - 1] >> kShift, 31);
      if (lane == 0) prev = last;
    }
    first[r] = __ballot_sync(kFullMask,
                             (r == 0 && lane == 0) || prev != cls);
  }
  const unsigned at_or_below = kFullMask >> (31 - lane);
#pragma unroll
  for (int r = 0; r < K; ++r) {
    int start = -1;  // first[0] has bit 0 set, so a start is always found
#pragma unroll
    for (int rr = K - 1; rr >= 0; --rr) {
      if (rr <= r) {
        const unsigned m = rr == r ? first[rr] & at_or_below : first[rr];
        if (start < 0 && m != 0) start = (rr << 5) + 31 - __clz(m);
      }
    }
    rank[r] = ((r << 5) | lane) - start;
  }
}

// The warp's totals of eight per-lane floats, in a fixed order: each of
// the first three butterfly steps halves the values a lane carries, so
// nine shuffles do the work of forty.  Returns, in lane l, the total of
// value l >> 2.
__device__ inline float warp_sum8(float (&v)[8]) {
  const int lane = threadIdx.x & 31;
  bool up = (lane & 16) != 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = up ? v[i] : v[i + 4];
    const float keep = up ? v[i + 4] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 16);
  }
  up = (lane & 8) != 0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = up ? v[i] : v[i + 2];
    const float keep = up ? v[i + 2] : v[i];
    v[i] = keep + __shfl_xor_sync(kFullMask, send, 8);
  }
  up = (lane & 4) != 0;
  const float send = up ? v[0] : v[1];
  const float keep = up ? v[1] : v[0];
  float t = keep + __shfl_xor_sync(kFullMask, send, 4);
  t += __shfl_xor_sync(kFullMask, t, 2);
  t += __shfl_xor_sync(kFullMask, t, 1);
  return t;
}

// A column's class sums in the warp layout: ef in lane l is esum[l >> 2]
// for l < 16 and fsum[(l >> 2) - 4] above; c[4] is whole in every lane.
struct WarpClassSums {
  float ef;
  int c[4];
};

// Sorts the warp's keys, ranks them within their classes and sums
// weights[min(rank, 255)] (x eff) per base class; eff_of(key) is the
// effective quality a key weighs its read by.
template <int kShift, int kP, typename EffOf>
__device__ inline WarpClassSums warp_rank_sums(
    int (&key)[kP / 32], const float* __restrict__ weights, EffOf eff_of) {
  constexpr int K = kP / 32;
  warp_sort<kP>(key);
  int rank[K];
  warp_ranks<kShift, kP>(key, rank);
  Sums<4> part = {};
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int cls = key[r] >> kShift;
    if (cls < kNumClasses) {
      // the 1 KB table stays in L1; a warp's ranks are mostly below 32,
      // one 128-byte line
      add_read(part, cls & 3, __ldg(weights + min(rank[r], kMaxRank)),
               eff_of(key[r]));
    }
  }
  float ef[8] = {part.e[0], part.e[1], part.e[2], part.e[3],
                 part.f[0], part.f[1], part.f[2], part.f[3]};
  WarpClassSums s;
  s.ef = warp_sum8(ef);
#pragma unroll
  for (int k = 0; k < 4; ++k) s.c[k] = __reduce_add_sync(kFullMask, part.i[k]);
  return s;
}

// Writes a column's esum, fsum and c from the warp layout's sums.
__device__ inline void warp_store_class_sums(const WarpClassSums& s, int col,
                                             float* esum, float* fsum,
                                             int* c) {
  const int lane = threadIdx.x & 31;
  if ((lane & 3) == 0) {
    float* dst = lane < 16 ? esum : fsum;
    dst[(size_t)col * 4 + ((lane >> 2) & 3)] = s.ef;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (lane == k) c[(size_t)col * 4 + k] = s.c[k];
  }
}

// -- the block layout (P > 256) ----------------------------------------------
//
// One column a block today (Layout::cols is 1 in both block layouts); the
// geometry keeps the general form of `cols` columns a block.

constexpr int kMaxColsPerBlock = 8;

// Where a thread sits: P keys a column, `cols` columns a block of
// `threads`, this thread's column `col` and its slot `seg` in the block.
struct Geometry {
  int P, cols, threads, seg, col;
  __device__ Geometry(int P_rt, int cols_rt) {
    P = P_rt;
    cols = cols_rt;
    threads = (int)blockDim.x;
    seg = (int)threadIdx.x / (threads / cols);
    col = (int)blockIdx.x * cols + seg;
  }
  // the thread that holds its column's totals after column_sums
  __device__ bool leader() const {
    return (int)threadIdx.x % (threads / cols) == 0;
  }
};

// Ascending bitonic sort of each column's P keys: pair p of a stage
// compares lo and lo + j, strided over the block.  The direction comes
// from the within-column index, so every column ends ascending.
__device__ inline void segmented_sort(int* keys, const Geometry& g) {
  const int P = g.P;
  const int half = (P * g.cols) >> 1;
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += g.threads) {
        const int lo = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int hi = lo + j;
        const bool up = ((lo & (P - 1)) & k) == 0;
        const int a = keys[lo], b = keys[hi];
        if ((a > b) == up) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncthreads();
    }
  }
}

// start[seg][cls] = position of the first key of class cls in the sorted
// run of the block's column seg (written only for classes present; the
// tail, class 8 and above, is not recorded).
template <int kShift>
__device__ inline void class_starts(const int* keys, const Geometry& g,
                                    int (*start)[kNumClasses]) {
  const int P = g.P;
  for (int i = threadIdx.x; i < P * g.cols; i += g.threads) {
    const int x = i & (P - 1);
    const int cls = keys[i] >> kShift;
    if (cls < kNumClasses && (x == 0 || (keys[i - 1] >> kShift) != cls)) {
      start[i / P][cls] = x;
    }
  }
  __syncthreads();
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

__device__ inline int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFullMask, v, o);
  return v;
}

// The column totals of every thread's partials, valid in each column's
// leader thread.
template <int kInts>
__device__ inline Sums<kInts> column_sums(Sums<kInts> s, const Geometry& g) {
  __shared__ Sums<kInts> part[kMaxWarps];
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.e[k] = warp_sum(s.e[k]);
    s.f[k] = warp_sum(s.f[k]);
  }
#pragma unroll
  for (int k = 0; k < kInts; ++k) s.i[k] = warp_sum(s.i[k]);
  if ((threadIdx.x & 31) == 0) part[warp] = s;
  __syncthreads();
  if (g.leader()) {
    s = part[warp];
    const int col_warps = g.threads / g.cols / 32;
    for (int x = 1; x < col_warps; ++x) {
      const Sums<kInts>& o = part[warp + x];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        s.e[k] += o.e[k];
        s.f[k] += o.f[k];
      }
#pragma unroll
      for (int k = 0; k < kInts; ++k) s.i[k] += o.i[k];
    }
  }
  return s;
}

// Writes a column's esum, fsum and c (its leader thread calls this).
template <int kInts>
__device__ inline void store_class_sums(const Sums<kInts>& s, int col,
                                        float* esum, float* fsum, int* c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    esum[(size_t)col * 4 + k] = s.e[k];
    fsum[(size_t)col * 4 + k] = s.f[k];
    c[(size_t)col * 4 + k] = s.i[k];
  }
}

// -- u32 slot words (accumulate32, accumulate) -------------------------------
//
// A slot word is mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21.
// Decode (reference sniper_maqcns.c:144-156): '=' (base code 0) is the
// reference base, ambiguity codes fall into class A, eff = min(baseQ,
// mapQ) raised to 4 when below 4 and baseQ & 0x3F is nonzero; a lane
// takes part when eff > 0.  The rank orders by the RAW min(baseQ, mapQ),
// then has_base, then baseQ, descending, as the reference does: the key is
//     cls << 17 | (0x1FFFF - (raw_eff << 9 | has_base << 8 | baseQ)),
// and lanes that take no part get the past-the-end class 64.

constexpr int kSlotShift = 17;
constexpr int kSlotSub = (1 << kSlotShift) - 1;
constexpr int kSlotTail = (64 << kSlotShift) | kSlotSub;

__device__ inline int slot_key(int w, int ref) {
  const int mapq = w & 0xFF;
  const int q = (w >> 8) & 0xFF;
  const int b16 = (w >> 16) & 0xF;
  const int strand = (w >> 20) & 1;
  const int code = b16 != 0 ? b16 : ref;
  int base2 = 0, has_base = 1;
  switch (code) {
    case 1: base2 = 0; break;
    case 2: base2 = 1; break;
    case 4: base2 = 2; break;
    case 8: base2 = 3; break;
    default: has_base = 0; break;
  }
  const int eff_raw = min(q, mapq);
  const int eff = (eff_raw < 4 && (q & 0x3F) != 0) ? 4 : eff_raw;
  if (eff <= 0) return kSlotTail;
  const int sub = (eff_raw << 9) | (has_base << 8) | q;
  return ((strand * 4 + base2) << kSlotShift) | (kSlotSub - sub);
}

// The floored eff a sorted slot key weighs its read by.
struct SlotKeyEff {
  __device__ int operator()(int key) const {
    const int sub = kSlotSub - (key & kSlotSub);
    const int eff_raw = sub >> 9;
    const int q = sub & 0xFF;
    return (eff_raw < 4 && (q & 0x3F) != 0) ? 4 : eff_raw;
  }
};

// One slot word's key, with its share of rms and n (n = lanes taken in);
// with kDel, a word whose is_del bit is set takes no part.
template <bool kDel>
__device__ inline int take_slot(int w, int ref, int cap_mapq, int& rms,
                                int& n) {
  if (kDel && ((w >> 21) & 1) != 0) return kSlotTail;
  const int mq7 = min(w & 0x7F, cap_mapq);
  rms += mq7 * mq7;
  n += 1;
  return slot_key(w, ref);
}

struct WarpSlotSums {
  WarpClassSums cls;
  int rms, n;  // whole in every lane
};

// Warp layout: the sums over one column's u32 slot words, the first
// `count` of the row occupied.
template <bool kDel, int kP>
__device__ inline WarpSlotSums warp_slot_sums(
    const int* __restrict__ row, int count, int ref,
    const float* __restrict__ weights, bool wide, int cap_mapq) {
  constexpr int K = kP / 32;
  int w[K], pos[K], key[K];
  load_row<int, K>(row, count, wide, w, pos);
  int rms = 0, n = 0;
#pragma unroll
  for (int q = 0; q < K; ++q) {
    key[q] = pos[q] < count ? take_slot<kDel>(w[q], ref, cap_mapq, rms, n)
                            : kSlotTail;
  }
  WarpSlotSums s;
  s.cls = warp_rank_sums<kSlotShift, kP>(key, weights, SlotKeyEff{});
  s.rms = __reduce_add_sync(kFullMask, rms);
  s.n = __reduce_add_sync(kFullMask, n);
  return s;
}

// Block layout: sums over one column's u32 slot words, c[4], rms, n,
// valid in the column's leader.
template <bool kDel>
__device__ inline Sums<6> slot_rank_sums(const int* __restrict__ slots,
                                         int count, int ref,
                                         const float* __restrict__ weights,
                                         int* keys, const Geometry& g, int D,
                                         int cap_mapq) {
  __shared__ int start[kMaxColsPerBlock][kNumClasses];
  const int P = g.P;
  Sums<6> s = {};  // c[4], rms, n
  for (int i = threadIdx.x; i < P * g.cols; i += g.threads) {
    const int x = i & (P - 1);
    keys[i] = x < count
                  ? take_slot<kDel>(slots[(size_t)g.col * D + x], ref,
                                    cap_mapq, s.i[4], s.i[5])
                  : kSlotTail;
  }
  __syncthreads();

  segmented_sort(keys, g);
  class_starts<kSlotShift>(keys, g, start);

  for (int i = threadIdx.x; i < P * g.cols; i += g.threads) {
    const int k = keys[i];
    const int cls = k >> kSlotShift;
    if (cls < kNumClasses) {
      const int rank = (i & (P - 1)) - start[g.seg][cls];
      add_read(s, cls & 3, weights[min(rank, kMaxRank)], SlotKeyEff{}(k));
    }
  }
  return column_sums(s, g);
}

}  // namespace class_rank
