// assembly10.cuh: the ten-genotype likelihood assembly of the MAQ model as
// a device function, a lane a genotype.
//
// Shared by assembly10.cu (the stand-alone kernel: sums read from device
// memory) and by the fused kernels of accumulate32.cu, accumulate.cu and
// accumulate16.cu (sums taken from the rank's registers).  Replaces the
// arithmetic of the TPU kernel somatic_sniper_tpu/ops/pallas_glfgen.py,
// assembly10 / _kernel_asm (reference sniper_maqcns.c:184-244).
//
// A group of 16 lanes (one half of a warp) assembles one column.  Lane
// t < 10 of the group owns genotype t = (j, k), j <= k, in glf order
// AA AC AG AT CC CG CT GG GT TT: its others-sums over the bases not in the
// genotype, bar_e = clip(floor(tmp1 / tmp3 + 0.5), 4, 63), one gather
// coef[bar_e, c_tot, tmp2] and, for a het, one gather lhet[c_j, c_k].  The
// ten (sixteen with the hets') gathers of a column are in flight together,
// where a thread a column walked them as one chain.  Lanes 10..15 of a
// group run the same instructions with every load and store switched off.
//
// Every float operation keeps the f32 order of the JAX fast path
// (somatic_sniper_tpu/models/glfgen.py:653-752) and of assembly10_plain:
// left-to-right others-sums, tmp1 + cf for a hom, (lh + tmp1) + cf for a
// het, tmp3 == 0 -> 1, no coef gather where tmp2 == 0, the clamp at 0.
// The library is built with -fmad=false, so the result equals the plain
// torch version bit for bit.
//
// Every shuffle here is executed by all 32 lanes of the warp: callers keep
// their warps whole (a column past the end of the batch takes part with
// `exists` false, never by an early return of half a warp).

#pragma once

#include <cuda_runtime.h>

namespace assembly10 {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kGroup = 16;      // lanes a column
constexpr int kGenotypes = 10;

// The j (or, with `second`, the k) of the ten genotypes, two bits each.
constexpr unsigned packed_pairs(bool second) {
  unsigned w = 0;
  int t = 0;
  for (int j = 0; j < 4; ++j) {
    for (int k = j; k < 4; ++k, ++t) {
      w |= (unsigned)(second ? k : j) << (2 * t);
    }
  }
  return w;
}
constexpr unsigned kPairJ = packed_pairs(false);
constexpr unsigned kPairK = packed_pairs(true);

__device__ inline int pick4(const int (&v)[4], int q) {
  return q == 0 ? v[0] : q == 1 ? v[1] : q == 2 ? v[2] : v[3];
}

// One column's assembly on the calling lane's group of 16.  es, fs and cc
// are the column's esum, fsum and c, whole in every lane of the group.
// `in_table`: the counts index inside the tables (0 <= c, c_tot within
// the table depth); a column that is not reads no table and gets zeros,
// as an empty one (`nz` false) does.  `exists`: the column lies inside
// the batch; nothing is stored for one that does not.  Writes
// lk[col * 10 + t] from lane t < 10 (40 contiguous bytes a column) and
// min_lk[col] from lane 0.
__device__ inline void lanes_assembly10(
    const float (&es)[4], const float (&fs)[4], const int (&cc)[4], bool nz,
    bool in_table, bool exists, int col, const float* __restrict__ coef_sub,
    const float* __restrict__ lhet_sub, int NK, int* __restrict__ lk,
    int* __restrict__ min_lk) {
  const int t = threadIdx.x & (kGroup - 1);
  const bool owner = t < kGenotypes;
  const int j = (kPairJ >> (2 * t)) & 3;  // 0 for the lanes past the ten
  const int k = (kPairK >> (2 * t)) & 3;
  const bool hom = j == k;
  const bool gather = owner && in_table && exists;

  float tmp1 = 0.f, tmp3 = 0.f;
  int tmp2 = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q != j && q != k) {
      tmp1 = tmp1 + es[q];
      tmp3 = tmp3 + fs[q];
      tmp2 = tmp2 + cc[q];
    }
  }
  const int c_tot = cc[0] + cc[1] + cc[2] + cc[3];
  const float ratio = tmp1 / (tmp3 == 0.f ? 1.f : tmp3);
  int be = (int)floorf(ratio + 0.5f);
  be = min(max(be, 4), 63);
  // both gathers leave together; c_tot = 256 (after the c_tot > 255
  // rescale, NK = 256) reads row 255
  float lhet = 0.f, cf = 0.f;
  if (gather && !hom) {
    lhet = __ldg(lhet_sub + pick4(cc, j) * NK + pick4(cc, k));
  }
  if (gather && tmp2 > 0) {
    cf = __ldg(coef_sub +
               ((size_t)(be - 4) * NK + min(c_tot, NK - 1)) * NK + tmp2);
  }
  float v = hom ? 0.f : -4.343f * lhet;
  if (tmp2 > 0) v = hom ? tmp1 + cf : (v + tmp1) + cf;
  float p = v < 0.f ? 0.f : v;  // negative clamp

  // fix p[k,k] (reference sniper_maqcns.c:216-233).  The four diagonal
  // values come from lanes 0, 4, 7 and 9 of the group, and every lane runs
  // the same serial scans: strict comparisons, the first index wins.  (A
  // warp reduction would resolve ties differently.)
  float diag[4];
  diag[0] = __shfl_sync(kFullMask, p, 0, kGroup);
  diag[1] = __shfl_sync(kFullMask, p, 4, kGroup);
  diag[2] = __shfl_sync(kFullMask, p, 7, kGroup);
  diag[3] = __shfl_sync(kFullMask, p, 9, kGroup);
  float max1 = -1.f, max2 = -1.f;
  int max_k = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float e = es[q];
    const bool gt1 = e > max1;
    const bool gt2 = !gt1 && e > max2;
    max2 = gt1 ? max1 : (gt2 ? e : max2);
    max1 = gt1 ? e : max1;
    max_k = gt1 ? q : max_k;
  }
  float min1 = 1e30f, min2 = 1e30f;
  int min_k = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float d = diag[q];
    const bool lt1 = d < min1;
    const bool lt2 = !lt1 && d < min2;
    min2 = lt1 ? min1 : (lt2 ? d : min2);
    min1 = lt1 ? d : min1;
    min_k = lt1 ? q : min_k;
  }
  const bool fix =
      max1 > max2 && (min_k != max_k || min1 + 1.0f > min2);
  const float fixed_val = min1 > 1.0f ? min1 - 1.0f : 0.f;
  if (fix && owner && hom && j == max_k) p = fixed_val;

  // min over the ten genotypes: after the clamp every p is finite and
  // >= 0 (or -0, which quantizes as +0 does), so a butterfly of fminf in
  // any order equals the left-to-right fminf over them.  Strides below 16
  // stay inside the group.
  float min_p = owner ? p : 1e30f;
#pragma unroll
  for (int o = kGroup / 2; o > 0; o >>= 1) {
    min_p = fminf(min_p, __shfl_xor_sync(kFullMask, min_p, o));
  }

  // quantization (reference sniper_maqcns.c:236-244); empty columns are
  // the calloc'd glf (reference sniper_maqcns.c:131-136)
  const bool live = nz && in_table;
  if (exists && owner) {
    const float d = p - min_p;
    const int q8 = d > 255.f ? 255 : (int)floorf(d + 0.5f);
    lk[(size_t)col * kGenotypes + t] = live ? q8 : 0;
  }
  if (exists && t == 0) {
    const int m = min_p > 255.f ? 255 : (int)floorf(min_p + 0.5f);
    min_lk[col] = live ? m : 0;
  }
}

// The assembly behind a rank of class_rank.cuh's warp layout: one column
// a warp, its sums still in the warp's registers.  `ef` in lane l is
// esum[l >> 2] for l < 16 and fsum[(l >> 2) - 4] above, `c` is whole in
// every lane (class_rank::WarpClassSums).  The lower half of the warp
// assembles; the upper half takes part in the shuffles with `exists`
// false.  The counts come from a rank over at most D <= NK - 1 lanes, so
// they index inside the tables by construction: no error word.
__device__ inline void warp_sums_assembly10(
    float ef, const int (&c)[4], bool nz, int col,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int NK, int* __restrict__ lk, int* __restrict__ min_lk) {
  float es[4], fs[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    es[q] = __shfl_sync(kFullMask, ef, 4 * q);
    fs[q] = __shfl_sync(kFullMask, ef, 16 + 4 * q);
  }
  const bool lower = (threadIdx.x & 31) < kGroup;
  lanes_assembly10(es, fs, c, nz, true, lower, col, coef_sub, lhet_sub, NK,
                   lk, min_lk);
}

}  // namespace assembly10
