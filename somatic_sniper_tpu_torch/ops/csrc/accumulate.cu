// accumulate: MAQ rank-weighted class sums over full u32 slot words.
//
// Replaces the TPU kernel somatic_sniper_tpu/ops/pallas_glfgen.py,
// accumulate / _kernel.  Per pileup column (one row of D slot words
// mapQ | baseQ<<8 | base16<<16 | strand<<20 | is_del<<21, the first
// depth[b] of them occupied, deletions still among them) it computes for
// the four base classes esum = sum(w * eff), fsum = sum(w), c = count,
// plus rms = sum of min(mapQ & 0x7F, cap)^2 and n = the count of
// non-deleted lanes (reference sniper_maqcns.c:144-176).  The decode is
// accumulate32's (class_rank.cuh slot_key): '=' (base code 0) is the
// reference base, ambiguity codes fall into class A, eff = min(baseQ,
// mapQ) raised to 4 when below 4 and baseQ & 0x3F is nonzero; a lane
// takes part when eff > 0.
//
// The rank within a class follows the reference and the XLA fast path
// (somatic_sniper_tpu/models/glfgen.py _fast_accumulate): descending RAW
// min(baseQ, mapQ), then has_base, then baseQ, with the sort key
//     cls << 17 | (0x1FFFF - (raw_eff << 9 | has_base << 8 | baseQ)).
// The Pallas kernel ranks by the floored eff instead (pallas_glfgen.py:80-87),
// which moves esum for a class holding a baseQ of 64, 128 or 192 with a
// smaller mapQ next to a floored read; that slip is not carried over.
// Weights come from the host-built 256-entry f32 table, table[min(r, 255)].
//
// What bounds it on an H100: by bytes it is a memory kernel (a column of
// D = 40 is 160 bytes of slots in and 56 bytes out, each moved once), but
// a column also costs a decode, a sort and a reduction, and at the
// depths that carry the batch path (D = 32 and 40) that is some 260 to
// 400 warp instructions a column, 30 to 60 of them shuffles: instruction
// issue (four warp instructions a cycle an SM, one of them a shuffle),
// not the memory system, sets the time, at 7-10% of the byte bound.  At
// the deep buckets (1024-8192 and oversize columns) it is the per-column
// sort, O(P log^2 P) compare-exchanges with a block barrier per stage.
//
// Design: class_rank.cuh.  To P = 256 the warp layout: a warp owns a
// column, its keys live in registers (P / 32 a lane), the row is read
// contiguously with loads of up to 128 bits, the bitonic network runs on
// shuffles and in-thread exchanges, class starts come from one ballot a
// register, and the sums are a butterfly in the warp: no shared memory,
// no block barrier, 8 independent columns a block.  A counting rank (no
// sort: count the keys of my class that sort before mine, each read from
// its lane by shuffle) was weighed for P <= 64 and not built: at D = 40
// it needs 40 shuffles a column, as many as the sort's 20 lane stages
// over two registers of keys, and at D = 32 it needs 32 against the
// sort's 15, each with two compares and an add per key held where a sort
// stage has a min, a max and a select: it cannot win where instruction
// issue is the limit.  The 1 KB weight table is read through the
// read-only path (__ldg): a warp's ranks lie mostly in one 128-byte
// line, which stays in L1, and a copy in shared memory would bring back
// the layout's only block barrier.  Above P = 256 the block layout: one
// block a column (keys in dynamic shared memory to P = 16384, in a global
// scratch beyond), a shared-memory bitonic sort, rank = position - class
// start, fixed-order sums.  The TPU kernel's O(D^2) rotation loop and
// its 128-lane padding existed for the TPU's lane width and are not
// carried over; every depth the batch path produces runs here, with no
// fallback.
//
// The fused entry, sniper_glfgen (what the full-u32 batch path launches
// for D <= 255): the warp layout's rank, then the ten-genotype assembly of
// assembly10.cuh on the sums while they are still in the warp's registers.
// It replaces both accumulate / _kernel and assembly10 / _kernel_asm of
// pallas_glfgen.py there: esum, fsum and c are never written, a sample of
// a batch is one launch, and since c_tot <= D <= NK - 1 there is no error
// word to wait for.  Deeper batches keep the two launches, with the
// c_tot > 255 rescale between them.  A separate kernel: the unfused one
// keeps its registers.

#include <cuda_runtime.h>

#include "assembly10.cuh"
#include "class_rank.cuh"

namespace {

using namespace class_rank;

template <int kP>
__global__ void __launch_bounds__(kP > 0 ? kWarpThreads : kBigThreads,
                                  kP > 0 ? 1 : kBigBlocksPerSM)
accumulate_kernel(const int* __restrict__ slots, const int* __restrict__ depth,
                  const int* __restrict__ ref16,
                  const float* __restrict__ weights, float* __restrict__ esum,
                  float* __restrict__ fsum, int* __restrict__ c_out,
                  int* __restrict__ rms_out, int* __restrict__ n_out,
                  int* scratch, int B, int D, int P, int cols, bool wide,
                  int cap_mapq) {
  if constexpr (kP > 0) {
    const int col = warp_column(B);
    if (col < 0) return;
    const WarpSlotSums s = warp_slot_sums<true, kP>(
        slots + (size_t)col * D, min(depth[col], D), ref16[col], weights,
        wide, cap_mapq);
    warp_store_class_sums(s.cls, col, esum, fsum, c_out);
    if ((threadIdx.x & 31) == 0) {
      rms_out[col] = s.rms;
      n_out[col] = s.n;
    }
  } else {
    extern __shared__ int smem_keys[];
    const Geometry g(P, cols);
    int* keys = scratch != nullptr ? scratch + (size_t)blockIdx.x * g.P
                                   : smem_keys;
    const int count = g.col < B ? min(depth[g.col], D) : 0;
    const int ref = g.col < B ? ref16[g.col] : 0;
    const Sums<6> s = slot_rank_sums<true>(slots, count, ref, weights, keys,
                                           g, D, cap_mapq);
    if (g.leader() && g.col < B) {
      store_class_sums(s, g.col, esum, fsum, c_out);
      rms_out[g.col] = s.i[4];
      n_out[g.col] = s.i[5];
    }
  }
}

template <int kP>
__global__ void __launch_bounds__(kWarpThreads) glfgen_kernel(
    const int* __restrict__ slots, const int* __restrict__ depth,
    const int* __restrict__ ref16, const float* __restrict__ weights,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int* __restrict__ lk, int* __restrict__ min_lk, int* __restrict__ rms_out,
    int* __restrict__ n_out, int B, int D, int NK, bool wide, int cap_mapq) {
  const int col = warp_column(B);
  if (col < 0) return;
  const WarpSlotSums s = warp_slot_sums<true, kP>(
      slots + (size_t)col * D, min(depth[col], D), ref16[col], weights, wide,
      cap_mapq);
  if ((threadIdx.x & 31) == 0) {
    rms_out[col] = s.rms;
    n_out[col] = s.n;
  }
  assembly10::warp_sums_assembly10(s.cls.ef, s.cls.c, s.n > 0, col, coef_sub,
                                   lhet_sub, NK, lk, min_lk);
}

}  // namespace

// Global scratch ints the wrapper must pass for a [B, D] batch (0 when
// the keys fit in registers or shared memory).
extern "C" long long sniper_rank_scratch_ints(int B, int D) {
  if (B <= 0 || D <= 0) return 0;
  return layout_for(D).scratch_ints * (long long)B;
}

extern "C" int sniper_accumulate(const void* slots, const void* depth,
                                 const void* ref16, const void* weights,
                                 void* esum, void* fsum, void* c, void* rms,
                                 void* n, void* scratch,
                                 long long scratch_ints, int B, int D,
                                 int cap_mapq, void* stream) {
  if (B <= 0 || D <= 0 || D > (1 << 24)) return (int)cudaErrorInvalidValue;
  const Layout l = layout_for(D);
  if (l.scratch_ints * (long long)B > scratch_ints ||
      (l.scratch_ints > 0 && scratch == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    constexpr int kRegs = kP > 0 ? kP / 32 : 1;
    return launch(accumulate_kernel<kP>, l, B,
                  static_cast<cudaStream_t>(stream),
                  static_cast<const int*>(slots),
                  static_cast<const int*>(depth),
                  static_cast<const int*>(ref16),
                  static_cast<const float*>(weights),
                  static_cast<float*>(esum), static_cast<float*>(fsum),
                  static_cast<int*>(c), static_cast<int*>(rms),
                  static_cast<int*>(n),
                  l.scratch_ints > 0 ? static_cast<int*>(scratch) : nullptr,
                  B, D, l.P, l.cols,
                  rows_take_wide_loads<int, kRegs>(slots, D), cap_mapq);
  });
}

// accumulate and assembly10 in one launch: D <= 255 and tables of depth
// NK - 1 >= D.
extern "C" int sniper_glfgen(const void* slots, const void* depth,
                             const void* ref16, const void* weights,
                             const void* coef_sub, const void* lhet_sub,
                             void* lk, void* min_lk, void* rms, void* n,
                             int B, int D, int NK, int cap_mapq,
                             void* stream) {
  if (B <= 0 || D <= 0 || D > 255 || NK <= D || NK > 256) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout l = layout_for(D);
  return with_kp(l, [&](auto kp) {
    constexpr int kP = decltype(kp)::value;
    if constexpr (kP == 0) {
      return (int)cudaErrorInvalidValue;  // D <= 255 never gets here
    } else {
      return launch(glfgen_kernel<kP>, l, B,
                    static_cast<cudaStream_t>(stream),
                    static_cast<const int*>(slots),
                    static_cast<const int*>(depth),
                    static_cast<const int*>(ref16),
                    static_cast<const float*>(weights),
                    static_cast<const float*>(coef_sub),
                    static_cast<const float*>(lhet_sub),
                    static_cast<int*>(lk), static_cast<int*>(min_lk),
                    static_cast<int*>(rms), static_cast<int*>(n), B, D, NK,
                    rows_take_wide_loads<int, kP / 32>(slots, D), cap_mapq);
    }
  });
}
