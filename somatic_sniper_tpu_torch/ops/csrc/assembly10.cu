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
// What bounds it on an H100: the launch and one column's latency.  Per
// column it reads 13 words and writes 11, and a slab of 8192 columns is
// 1.3 MB, under half a microsecond of the memory system; the table gathers
// hit coef[4:64, :D+1, :D+1] (576 KB at D = 48, 4 MB at D = 128, 15.7 MB at
// D = 255), which stays resident in the 50 MB L2.  What a column costs is
// its chain: load the sums, gather, scan, store.
//
// Design: assembly10.cuh, a lane a genotype, 16 lanes a column, two
// columns a warp, 16 columns a block of 256 threads: a slab of 8192
// columns is 512 blocks (a thread a column made 64, under half the SMs),
// and a column's ten coef and six lhet gathers leave together from ten
// lanes instead of one after another from one thread.  Lanes 0..12 of a
// group load the column's 13 input words, one each, and hand them round
// by shuffle.  The gather is what the TPU could not do cheaply (its
// kernel built a one-hot MXU product per block instead, and capped the
// depth at 64); here it is one load per term, and every depth up to 255
// is served.  The float order and -fmad=false: see assembly10.cuh.
//
// On the paths, batches to depth 255 run the assembly fused behind their
// rank (sniper_glfgen32, sniper_glfgen, sniper_glfgen16); this kernel
// serves deeper batches, whose counts are rescaled between the two.
//
// Precondition: 0 <= c[b, k] and c_tot <= NK - 1, which holds for sums
// produced by an accumulate over a batch of depth NK - 1 <= 255 (it counts
// at most D lanes).  Deeper batches take the reference's c_tot > 255
// rescale first (models/glfgen.py rescale_counts) and the full tables,
// NK = 256; the rescale can round four exact halves up to c_tot = 256,
// which reads row 255, as the JAX package's clamping gather does (the
// reference reads past its table there).  A column that breaks the
// precondition reads no table: it sets *err, writes zeros, and the
// wrapper's check raises.

#include <cuda_runtime.h>

#include "assembly10.cuh"

namespace {

using namespace assembly10;

constexpr int kThreads = 256;
constexpr int kCols = kThreads / kGroup;  // columns a block

__global__ void __launch_bounds__(kThreads) assembly10_kernel(
    const float* __restrict__ esum, const float* __restrict__ fsum,
    const int* __restrict__ c, const int* __restrict__ n,
    const float* __restrict__ coef_sub, const float* __restrict__ lhet_sub,
    int* __restrict__ lk, int* __restrict__ min_lk, int* __restrict__ err,
    int B, int NK) {
  const int t = threadIdx.x & (kGroup - 1);
  const int b = (int)blockIdx.x * kCols + ((int)threadIdx.x / kGroup);
  const bool exists = b < B;

  // the column's 13 words: esum[4], fsum[4], c[4], n, one a lane
  unsigned word = 0;
  if (exists) {
    if (t < 4) {
      word = __float_as_uint(esum[(size_t)b * 4 + t]);
    } else if (t < 8) {
      word = __float_as_uint(fsum[(size_t)b * 4 + (t - 4)]);
    } else if (t < 12) {
      word = (unsigned)c[(size_t)b * 4 + (t - 8)];
    } else if (t == 12) {
      word = (unsigned)n[b];
    }
  }
  float es[4], fs[4];
  int cc[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    es[q] = __uint_as_float(__shfl_sync(kFullMask, word, q, kGroup));
    fs[q] = __uint_as_float(__shfl_sync(kFullMask, word, 4 + q, kGroup));
    cc[q] = (int)__shfl_sync(kFullMask, word, 8 + q, kGroup);
  }
  const int nb = (int)__shfl_sync(kFullMask, word, 12, kGroup);

  const int c_tot = cc[0] + cc[1] + cc[2] + cc[3];
  const int max_c_tot = NK == 256 ? 256 : NK - 1;
  const bool in_table =
      min(min(cc[0], cc[1]), min(cc[2], cc[3])) >= 0 && c_tot <= max_c_tot;
  if (exists && !in_table && t == 0) *err = 1;  // every offender: the same word
  lanes_assembly10(es, fs, cc, nb > 0, in_table, exists, b, coef_sub,
                   lhet_sub, NK, lk, min_lk);
}

}  // namespace

extern "C" int sniper_assembly10(const void* esum, const void* fsum,
                                 const void* c, const void* n,
                                 const void* coef_sub, const void* lhet_sub,
                                 void* lk, void* min_lk, void* err, int B,
                                 int NK, void* stream) {
  if (B <= 0 || NK <= 0 || NK > 256) return (int)cudaErrorInvalidValue;
  const int grid = (B + kCols - 1) / kCols;
  assembly10_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(esum), static_cast<const float*>(fsum),
      static_cast<const int*>(c), static_cast<const int*>(n),
      static_cast<const float*>(coef_sub),
      static_cast<const float*>(lhet_sub), static_cast<int*>(lk),
      static_cast<int*>(min_lk), static_cast<int*>(err), B, NK);
  return (int)cudaGetLastError();
}
