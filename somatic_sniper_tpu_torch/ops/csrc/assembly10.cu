// assembly10: the ten-genotype likelihood assembly of the MAQ model.
//
// Replaces the TPU kernel somatic_sniper_tpu/ops/pallas_glfgen.py,
// assembly10 / _kernel_asm (reference sniper_maqcns.c:184-244).  Per
// column, for each genotype (j <= k) it forms the others-sums over the
// bases not in the genotype, bar_e = clip(floor(tmp1 / tmp3 + 0.5), 4, 63),
// looks up coef[bar_e, c_tot, tmp2] and, for het genotypes,
// -4.343 * lhet[c_j, c_k]; then the clamp at 0, the fix-p[k,k] scan
// (strict comparisons, first index wins) and the u8 quantization.
//
// What bounds it on an H100: memory and launch cost.  Per column it reads
// 13 words and writes 11; the table gathers hit coef[4:64, :D+1, :D+1]
// (576 KB at D = 48, 4 MB at D = 128, 15.7 MB at D = 255), which stays
// resident in the 50 MB L2.
//
// Design: one thread per column reading the table straight from global
// memory.  The gather is what the TPU could not do cheaply (its kernel
// built a one-hot MXU product per block instead, and capped the depth at
// 64); here it is one load per term, and every depth up to 255 is served.
// Every float operation follows the f32 order of the JAX fast path
// (somatic_sniper_tpu/models/glfgen.py:653-752): left-to-right
// others-sums, tmp1 + cf for hom, (lh + tmp1) + cf for het.  The library
// is built with -fmad=false, so no multiply-add is contracted and the
// result equals the plain torch version bit for bit.
//
// Precondition: 0 <= c[b, k] and c_tot <= NK - 1, which holds for sums
// produced by accumulate32 over a slab of depth NK - 1 (it counts at most
// D lanes).  The reference's c_tot > 255 rescale therefore never applies
// (NK <= 256).  A column that breaks it reads no table: it sets *err, writes
// zeros, and the wrapper raises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) assembly10_kernel(
    const float* __restrict__ esum, const float* __restrict__ fsum,
    const int* __restrict__ c, const int* __restrict__ n,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int* __restrict__ lk, int* __restrict__ min_lk, int* __restrict__ err,
    int B, int NK) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float es[4], fs[4];
  int cc[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    es[k] = esum[(size_t)b * 4 + k];
    fs[k] = fsum[(size_t)b * 4 + k];
    cc[k] = c[(size_t)b * 4 + k];
  }
  const int c_tot = cc[0] + cc[1] + cc[2] + cc[3];
  if (min(min(cc[0], cc[1]), min(cc[2], cc[3])) < 0 || c_tot > NK - 1) {
    *err = 1;  // every offender writes the same word
#pragma unroll
    for (int t = 0; t < 10; ++t) lk[(size_t)b * 10 + t] = 0;
    min_lk[b] = 0;
    return;
  }

  // genotype t = (j, k), j <= k, in glf order AA AC AG AT CC CG CT GG GT TT
  const int gj[10] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
  const int gk[10] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};
  float p[10];
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    const int j = gj[t], k = gk[t];
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
    float v;
    if (j == k) {
      v = 0.f;
    } else {
      v = -4.343f * lhet_sub[cc[j] * NK + cc[k]];
    }
    if (tmp2 > 0) {
      const float ratio = tmp1 / (tmp3 == 0.f ? 1.f : tmp3);
      int be = (int)floorf(ratio + 0.5f);
      be = min(max(be, 4), 63);
      const float cf =
          coef_sub[((size_t)(be - 4) * NK + c_tot) * NK + tmp2];
      v = (j == k) ? tmp1 + cf : (v + tmp1) + cf;
    }
    p[t] = v < 0.f ? 0.f : v;  // negative clamp
  }

  // fix p[k,k] (reference sniper_maqcns.c:216-233)
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
  const int diag[4] = {0, 4, 7, 9};
  float min1 = 1e30f, min2 = 1e30f;
  int min_k = -1;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float d = p[diag[q]];
    const bool lt1 = d < min1;
    const bool lt2 = !lt1 && d < min2;
    min2 = lt1 ? min1 : (lt2 ? d : min2);
    min1 = lt1 ? d : min1;
    min_k = lt1 ? q : min_k;
  }
  const bool fix =
      max1 > max2 && (min_k != max_k || min1 + 1.0f > min2);
  const float fixed_val = min1 > 1.0f ? min1 - 1.0f : 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (fix && max_k == q) p[diag[q]] = fixed_val;
  }

  // quantization (reference sniper_maqcns.c:236-244); empty columns are
  // the calloc'd glf (reference sniper_maqcns.c:131-136)
  float min_p = p[0];
#pragma unroll
  for (int t = 1; t < 10; ++t) min_p = fminf(min_p, p[t]);
  const bool nz = n[b] > 0;
#pragma unroll
  for (int t = 0; t < 10; ++t) {
    const float d = p[t] - min_p;
    const int v = d > 255.f ? 255 : (int)floorf(d + 0.5f);
    lk[(size_t)b * 10 + t] = nz ? v : 0;
  }
  const int m = min_p > 255.f ? 255 : (int)floorf(min_p + 0.5f);
  min_lk[b] = nz ? m : 0;
}

}  // namespace

extern "C" int sniper_assembly10(const void* esum, const void* fsum,
                                 const void* c, const void* n,
                                 const void* coef_sub, const void* lhet_sub,
                                 void* lk, void* min_lk, void* err, int B,
                                 int NK, void* stream) {
  if (B <= 0 || NK <= 0 || NK > 256) return (int)cudaErrorInvalidValue;
  const int grid = (B + kThreads - 1) / kThreads;
  assembly10_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(esum), static_cast<const float*>(fsum),
      static_cast<const int*>(c), static_cast<const int*>(n),
      static_cast<const float*>(coef_sub),
      static_cast<const float*>(lhet_sub), static_cast<int*>(lk),
      static_cast<int*>(min_lk), static_cast<int*>(err), B, NK);
  return (int)cudaGetLastError();
}
