// accumulate32: MAQ rank-weighted class sums over raw kept-only slab lanes.
//
// Replaces the TPU kernel somatic_sniper_tpu/ops/pallas_glfgen.py,
// accumulate32 / _kernel32.  Per pileup column (one slab row of D lanes,
// the first n_keep of them occupied) it computes, for the four base
// classes, esum = sum(w * eff), fsum = sum(w), c = count, plus the rms
// sum of min(mapQ & 0x7F, cap)^2 (reference sniper_maqcns.c:144-176).
// w = theta^r * (1 - eta) + eta, where r is the lane's rank within its
// (base, strand) class in descending (raw eff, has_base, baseQ) order;
// the weights come from a 256-entry f32 table built on the host, so this
// kernel and its plain torch version read identical weights.
//
// What bounds it on an H100: launch cost and latency.  A slab is
// B = 8192 columns; at D = 48 one sample's lanes are 1.6 MB, read once,
// and the outputs are 13 words per column, so the bytes take well under
// a microsecond, and 8192 columns are 1024 blocks, under eight to an SM:
// the time is one column's chain of loads, shuffles and stores, a few
// times over.
//
// Design: class_rank.cuh's warp layout, shared with accumulate.cu: a warp
// owns a column, its P keys (P = the next power of two >= max(D, 32), a
// template argument) live in registers, P / 32 a lane, the row is read
// contiguously with loads of up to 128 bits, and the decode, the sort key
// (raw-eff rank, past-the-end class 64 for lanes that take no part), the
// shuffle bitonic network, the ballot class starts and the butterfly sums
// are the header's; no shared memory, no block barrier.  This kernel's
// lanes carry no deletions, so every occupied lane is taken in.  The TPU
// version's 128-lane segment packing, roll-based bitonic network and
// prefix-max class start existed only for the TPU's lane width and are
// not carried over.
//
// The fused entry, sniper_glfgen32 (what the slab path launches): the same
// rank, then the ten-genotype assembly of assembly10.cuh on the sums while
// they are still in the warp's registers (the lower 16 lanes, a lane a
// genotype).  It replaces both accumulate32 / _kernel32 and assembly10 /
// _kernel_asm of pallas_glfgen.py for D <= 255: esum, fsum and c (12
// words a column) are never written, and a sample of a slab is one launch
// instead of two.  The counts come from at most D <= NK - 1 lanes, so
// they index inside the tables by construction and there is no error
// word to wait for.  A separate kernel: the unfused one keeps its
// registers.

#include <cuda_runtime.h>

#include "assembly10.cuh"
#include "class_rank.cuh"

namespace {

using namespace class_rank;

template <int kP>
__global__ void __launch_bounds__(kWarpThreads) accumulate32_kernel(
    const int* __restrict__ slots, const int* __restrict__ n_keep,
    const int* __restrict__ ref16, const float* __restrict__ weights,
    float* __restrict__ esum, float* __restrict__ fsum,
    int* __restrict__ c_out, int* __restrict__ rms_out, int B, int D,
    bool wide, int cap_mapq) {
  const int col = warp_column(B);
  if (col < 0) return;
  const WarpSlotSums s = warp_slot_sums<false, kP>(
      slots + (size_t)col * D, min(n_keep[col], D), ref16[col], weights, wide,
      cap_mapq);
  warp_store_class_sums(s.cls, col, esum, fsum, c_out);
  if ((threadIdx.x & 31) == 0) rms_out[col] = s.rms;
}

template <int kP>
__global__ void __launch_bounds__(kWarpThreads) glfgen32_kernel(
    const int* __restrict__ slots, const int* __restrict__ n_keep,
    const int* __restrict__ ref16, const float* __restrict__ weights,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int* __restrict__ lk, int* __restrict__ min_lk, int* __restrict__ rms_out,
    int B, int D, int NK, bool wide, int cap_mapq) {
  const int col = warp_column(B);
  if (col < 0) return;
  const int nk = n_keep[col];
  const WarpSlotSums s = warp_slot_sums<false, kP>(
      slots + (size_t)col * D, min(nk, D), ref16[col], weights, wide,
      cap_mapq);
  if ((threadIdx.x & 31) == 0) rms_out[col] = s.rms;
  assembly10::warp_sums_assembly10(s.cls.ef, s.cls.c, nk > 0, col, coef_sub,
                                   lhet_sub, NK, lk, min_lk);
}

}  // namespace

extern "C" int sniper_accumulate32(const void* slots, const void* n_keep,
                                   const void* ref16, const void* weights,
                                   void* esum, void* fsum, void* c,
                                   void* rms, int B, int D, int cap_mapq,
                                   void* stream) {
  if (B <= 0 || D <= 0 || D > kMaxWarpP) return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(D);
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    if constexpr (kP == 0) {
      return (int)cudaErrorInvalidValue;  // D <= 256 never gets here
    } else {
      return launch(accumulate32_kernel<kP>, l, B,
                    static_cast<cudaStream_t>(stream),
                    static_cast<const int*>(slots),
                    static_cast<const int*>(n_keep),
                    static_cast<const int*>(ref16),
                    static_cast<const float*>(weights),
                    static_cast<float*>(esum), static_cast<float*>(fsum),
                    static_cast<int*>(c), static_cast<int*>(rms), B, D,
                    rows_take_wide_loads<int, kP / 32>(slots, D), cap_mapq);
    }
  });
}

// accumulate32 and assembly10 in one launch: D <= 255 and tables of depth
// NK - 1 >= D.
extern "C" int sniper_glfgen32(const void* slots, const void* n_keep,
                               const void* ref16, const void* weights,
                               const void* coef_sub, const void* lhet_sub,
                               void* lk, void* min_lk, void* rms, int B,
                               int D, int NK, int cap_mapq, void* stream) {
  if (B <= 0 || D <= 0 || D > 255 || NK <= D || NK > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout l = layout_for(D);
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    if constexpr (kP == 0) {
      return (int)cudaErrorInvalidValue;  // D <= 255 never gets here
    } else {
      return launch(glfgen32_kernel<kP>, l, B,
                    static_cast<cudaStream_t>(stream),
                    static_cast<const int*>(slots),
                    static_cast<const int*>(n_keep),
                    static_cast<const int*>(ref16),
                    static_cast<const float*>(weights),
                    static_cast<const float*>(coef_sub),
                    static_cast<const float*>(lhet_sub),
                    static_cast<int*>(lk), static_cast<int*>(min_lk),
                    static_cast<int*>(rms), B, D, NK,
                    rows_take_wide_loads<int, kP / 32>(slots, D), cap_mapq);
    }
  });
}

extern "C" const char* sniper_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
