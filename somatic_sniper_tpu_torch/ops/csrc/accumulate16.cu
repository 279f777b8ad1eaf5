// accumulate16: MAQ rank-weighted class sums over compact u16 lanes.
//
// Replaces the TPU kernel somatic_sniper_tpu/ops/pallas_glfgen.py,
// accumulate16 / _kernel16.  Per pileup column (one row of D u16 lanes
// effq | base2 << 8 | strand << 10, the first n_keep[b] of them occupied,
// deletions already dropped and '=' already resolved by the host) it
// computes for the four base classes esum = sum(w * effq),
// fsum = sum(w) and c = count over the lanes with effq > 0.  The host
// supplies the rms sums.  Within a class (strand * 4 + base2) the rank
// orders by effq alone, descending: the u16 lane holds nothing else, and
// reads of equal (class, effq) are interchangeable under the weighting,
// so any order among them gives the same sums (glfgen.py
// _fast_accumulate16).  Weights come from the host-built 256-entry f32
// table, table[min(r, 255)].
//
// What bounds it on an H100: by bytes a memory kernel (a column of D = 40
// is 80 bytes of lanes in and 48 bytes out), but at the depths that carry
// the u16 batch path (D = 32 and 40) a column's work is a few hundred
// warp instructions, as in accumulate.cu: instruction issue sets the
// time, and halving the lane bytes buys little (a fifth at D = 40).  At
// the deep buckets it is the per-column sort.
//
// Design: a sort, not a count.  The key cls << 8 | (255 - effq) (lanes
// that take no part: class 8, after every real class) goes through the
// same rank and fixed-order sums as accumulate.cu (class_rank.cuh), so
// the three accumulates share one rank and one summation order.  To
// P = 256 that is the warp layout: a warp owns a column, keys in
// registers, the row read contiguously with loads of up to 128 bits
// (D % 8 == 0 at eight keys a lane), the bitonic network on shuffles and
// in-thread exchanges, class starts from one ballot a register, sums by
// a butterfly in the warp; no shared memory and no block barrier.  A
// counting rank (an 8 x 256 histogram per column, or a shuffle loop over
// the column's lanes) was the alternative: the histogram costs more to
// clear than a 32-key sort, and the shuffle loop needs as many shuffles
// as the sort with twice the compares (see accumulate.cu).  Above P = 256
// the block layout (one block a column).  The TPU kernel's lane packing
// of several columns into one 128-lane row and its rotation loop existed
// for the TPU's lane width; every depth the batch path produces runs
// here, with no fallback (the TPU kernel could not pad past 128).
//
// The fused entry, sniper_glfgen16 (what the u16 batch path launches for
// D <= 255): the warp layout's rank, then the ten-genotype assembly of
// assembly10.cuh on the sums while they are still in the warp's registers.
// It replaces both accumulate16 / _kernel16 and assembly10 / _kernel_asm
// of pallas_glfgen.py there: esum, fsum and c are never written, a sample
// of a batch is one launch, and since c_tot <= D <= NK - 1 there is no
// error word to wait for.  A separate kernel: the unfused one keeps its
// registers.

#include <cuda_runtime.h>

#include "assembly10.cuh"
#include "class_rank.cuh"

namespace {

using namespace class_rank;

constexpr int kShift16 = 8;
constexpr int kTailKey = (kNumClasses << kShift16) | 0xFF;

// The sort key of one u16 lane.
__device__ inline int lane_key(int v) {
  const int eff = v & 0xFF;
  if (eff == 0) return kTailKey;
  const int cls = ((v >> 10) & 1) * 4 + ((v >> 8) & 3);
  return (cls << kShift16) | (255 - eff);
}

struct LaneKeyEff {
  __device__ int operator()(int key) const { return 255 - (key & 0xFF); }
};

// Warp layout: the class sums of the warp's column, nk of its lanes
// occupied.
template <int kP>
__device__ inline WarpClassSums warp_lane_sums(
    const unsigned short* __restrict__ row, int nk,
    const float* __restrict__ weights, bool wide) {
  constexpr int K = kP / 32;
  unsigned short v[K];
  int pos[K], key[K];
  load_row<unsigned short, K>(row, nk, wide, v, pos);
#pragma unroll
  for (int q = 0; q < K; ++q) {
    key[q] = pos[q] < nk ? lane_key(v[q]) : kTailKey;
  }
  return warp_rank_sums<kShift16, kP>(key, weights, LaneKeyEff{});
}

template <int kP>
__global__ void __launch_bounds__(kWarpThreads) glfgen16_kernel(
    const unsigned short* __restrict__ slots16,
    const int* __restrict__ n_keep, const float* __restrict__ weights,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int* __restrict__ lk, int* __restrict__ min_lk, int B, int D, int NK,
    bool wide) {
  const int col = warp_column(B);
  if (col < 0) return;
  const int nk = n_keep[col];
  const WarpClassSums s = warp_lane_sums<kP>(slots16 + (size_t)col * D,
                                             min(nk, D), weights, wide);
  assembly10::warp_sums_assembly10(s.ef, s.c, nk > 0, col, coef_sub, lhet_sub,
                                   NK, lk, min_lk);
}

template <int kP>
__global__ void __launch_bounds__(kP > 0 ? kWarpThreads : kBigThreads,
                                  kP > 0 ? 1 : kBigBlocksPerSM)
accumulate16_kernel(const unsigned short* __restrict__ slots16,
                    const int* __restrict__ n_keep,
                    const float* __restrict__ weights,
                    float* __restrict__ esum, float* __restrict__ fsum,
                    int* __restrict__ c_out, int* scratch, int B, int D,
                    int P, int cols, bool wide) {
  if constexpr (kP > 0) {
    const int col = warp_column(B);
    if (col < 0) return;
    const WarpClassSums s = warp_lane_sums<kP>(
        slots16 + (size_t)col * D, min(n_keep[col], D), weights, wide);
    warp_store_class_sums(s, col, esum, fsum, c_out);
  } else {
    extern __shared__ int smem_keys[];
    __shared__ int start[kMaxColsPerBlock][kNumClasses];
    const Geometry g(P, cols);
    int* keys = scratch != nullptr ? scratch + (size_t)blockIdx.x * g.P
                                   : smem_keys;
    const int nk = g.col < B ? min(n_keep[g.col], D) : 0;
    for (int i = threadIdx.x; i < g.P * g.cols; i += g.threads) {
      const int x = i & (g.P - 1);
      keys[i] = x < nk ? lane_key(slots16[(size_t)g.col * D + x]) : kTailKey;
    }
    __syncthreads();

    segmented_sort(keys, g);
    class_starts<kShift16>(keys, g, start);

    Sums<4> s = {};
    for (int i = threadIdx.x; i < g.P * g.cols; i += g.threads) {
      const int k = keys[i];
      const int cls = k >> kShift16;
      if (cls < kNumClasses) {
        const int rank = (i & (g.P - 1)) - start[g.seg][cls];
        add_read(s, cls & 3, weights[min(rank, kMaxRank)], LaneKeyEff{}(k));
      }
    }

    s = column_sums(s, g);
    if (g.leader() && g.col < B) store_class_sums(s, g.col, esum, fsum, c_out);
  }
}

}  // namespace

extern "C" int sniper_accumulate16(const void* slots16, const void* n_keep,
                                   const void* weights, void* esum,
                                   void* fsum, void* c, void* scratch,
                                   long long scratch_ints, int B, int D,
                                   void* stream) {
  if (B <= 0 || D <= 0 || D > (1 << 24)) return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(D);
  if (l.scratch_ints * (long long)B > scratch_ints ||
      (l.scratch_ints > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    constexpr int kRegs = kP > 0 ? kP / 32 : 1;
    return launch(accumulate16_kernel<kP>, l, B,
                  static_cast<cudaStream_t>(stream),
                  static_cast<const unsigned short*>(slots16),
                  static_cast<const int*>(n_keep),
                  static_cast<const float*>(weights),
                  static_cast<float*>(esum), static_cast<float*>(fsum),
                  static_cast<int*>(c),
                  l.scratch_ints > 0 ? static_cast<int*>(scratch) : nullptr,
                  B, D, l.P, l.cols,
                  rows_take_wide_loads<unsigned short, kRegs>(slots16, D));
  });
}

// accumulate16 and assembly10 in one launch: D <= 255 and tables of depth
// NK - 1 >= D.
extern "C" int sniper_glfgen16(const void* slots16, const void* n_keep,
                               const void* weights, const void* coef_sub,
                               const void* lhet_sub, void* lk, void* min_lk,
                               int B, int D, int NK, void* stream) {
  if (B <= 0 || D <= 0 || D > 255 || NK <= D || NK > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout l = layout_for(D);
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    if constexpr (kP == 0) {
      return (int)cudaErrorInvalidValue;  // D <= 255 never gets here
    } else {
      return launch(glfgen16_kernel<kP>, l, B,
                    static_cast<cudaStream_t>(stream),
                    static_cast<const unsigned short*>(slots16),
                    static_cast<const int*>(n_keep),
                    static_cast<const float*>(weights),
                    static_cast<const float*>(coef_sub),
                    static_cast<const float*>(lhet_sub),
                    static_cast<int*>(lk), static_cast<int*>(min_lk), B, D,
                    NK,
                    rows_take_wide_loads<unsigned short, kP / 32>(slots16, D));
    }
  });
}
