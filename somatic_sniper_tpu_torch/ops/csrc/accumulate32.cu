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
// What bounds it on an H100: memory and launch cost.  A slab is
// B = 8192 columns; at D = 48 one sample's lanes are 1.6 MB, read once,
// and the outputs are 13 words per column.  The per-column sort is a
// few hundred shared-memory operations, far below the card's rate.
//
// Design: a block of 256 threads handles 256 / P columns, P = the next
// power of two >= max(D, 32), one thread per lane, so every depth up to
// 255 fills whole warps and whole blocks.  Each column is sorted by a
// shared-memory bitonic network on the key
//     cls << 17 | (0x1FFFF - (raw_eff << 9 | has_base << 8 | baseQ)),
// non-participating lanes getting the past-the-end class 64 so they sort
// last.  After the sort a class is a contiguous run of lanes; the lanes at
// run boundaries record the run start in shared memory and rank = lane -
// start.  The class sums are warp-shuffle trees then an in-order sum over
// the column's warps: a fixed order, no float atomics, so repeated runs
// give the same bits.  The TPU version's 128-lane segment packing, roll-
// based bitonic network and prefix-max class start existed only for the
// TPU's lane width and are not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSubMask = (1 << 17) - 1;
constexpr int kTailClass = 64;  // past-the-end class: non-participants
constexpr int kMaxRank = 255;

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_i(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

template <int P>
__global__ void __launch_bounds__(kThreads) accumulate32_kernel(
    const int* __restrict__ slots, const int* __restrict__ n_keep,
    const int* __restrict__ ref16, const float* __restrict__ weights,
    float* __restrict__ esum, float* __restrict__ fsum,
    int* __restrict__ c_out, int* __restrict__ rms_out, int B, int D,
    int cap_mapq) {
  constexpr int kCols = kThreads / P;
  constexpr int kWarpsPerCol = P / 32;
  __shared__ int key[kThreads];
  __shared__ int start[kCols][9];  // run start per class 0..7, tail = 8
  __shared__ float part_e[kWarps][4];
  __shared__ float part_f[kWarps][4];
  __shared__ int part_i[kWarps][5];  // c[4], rms

  const int tid = threadIdx.x;
  const int seg = tid / P;
  const int lane = tid % P;
  const int col = blockIdx.x * kCols + seg;

  int n = 0, ref = 0;
  if (col < B) {
    n = min(n_keep[col], D);
    ref = ref16[col];
  }
  const bool occupied = lane < n;
  const int w = occupied ? slots[(size_t)col * D + lane] : 0;

  // decode (reference sniper_maqcns.c:144-156): '=' (base code 0) is the
  // reference base, ambiguity codes fall into class A, eff = min(baseQ,
  // mapQ) raised to 4 when below 4 and baseQ & 0x3F is nonzero
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
  const int eff0 = (eff_raw < 4 && (q & 0x3F) != 0) ? 4 : eff_raw;
  const bool upd = occupied && eff0 > 0;
  const int mq7 = min(mapq & 0x7F, cap_mapq);
  const int rms_lane = occupied ? mq7 * mq7 : 0;

  const int sub = (eff_raw << 9) | (has_base << 8) | q;
  key[tid] = upd ? (((strand * 4 + base2) << 17) | (kSubMask - sub))
                 : ((kTailClass << 17) | kSubMask);
  __syncthreads();

  // bitonic sort, ascending, within each P-lane segment (partners
  // tid ^ j with j < P never leave the segment)
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int partner = tid ^ j;
      if (partner > tid) {
        const int a = key[tid], b = key[partner];
        if ((a > b) == ((lane & k) == 0)) {
          key[tid] = b;
          key[partner] = a;
        }
      }
      __syncthreads();
    }
  }

  const int ks = key[tid];
  const int cls = ks >> 17;
  const bool valid = cls != kTailClass;
  const int ci = valid ? cls : 8;
  if (lane == 0 || (key[tid - 1] >> 17) != cls) start[seg][ci] = lane;
  __syncthreads();

  float e_l[4] = {0.f, 0.f, 0.f, 0.f};
  float f_l[4] = {0.f, 0.f, 0.f, 0.f};
  int c_l[4] = {0, 0, 0, 0};
  if (valid) {
    const int sub_s = kSubMask - (ks & kSubMask);
    const int eff_s = sub_s >> 9;
    const int q_s = sub_s & 0xFF;
    const int eff = (eff_s < 4 && (q_s & 0x3F) != 0) ? 4 : eff_s;
    const int rank = lane - start[seg][ci];
    const float fkw = weights[min(rank, kMaxRank)];
    const int k4 = cls & 3;
    e_l[k4] = fkw * (float)eff;
    f_l[k4] = fkw;
    c_l[k4] = 1;
  }

  const int warp = tid / 32;
  float e_w[4], f_w[4];
  int i_w[5];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e_w[k] = warp_sum_f(e_l[k]);
    f_w[k] = warp_sum_f(f_l[k]);
    i_w[k] = warp_sum_i(c_l[k]);
  }
  i_w[4] = warp_sum_i(rms_lane);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      part_e[warp][k] = e_w[k];
      part_f[warp][k] = f_w[k];
      part_i[warp][k] = i_w[k];
    }
    part_i[warp][4] = i_w[4];
  }
  __syncthreads();

  if (lane == 0 && col < B) {
    const int w0 = seg * kWarpsPerCol;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float e = part_e[w0][k], f = part_f[w0][k];
      int c = part_i[w0][k];
      for (int x = 1; x < kWarpsPerCol; ++x) {
        e += part_e[w0 + x][k];
        f += part_f[w0 + x][k];
        c += part_i[w0 + x][k];
      }
      esum[(size_t)col * 4 + k] = e;
      fsum[(size_t)col * 4 + k] = f;
      c_out[(size_t)col * 4 + k] = c;
    }
    int r = part_i[w0][4];
    for (int x = 1; x < kWarpsPerCol; ++x) r += part_i[w0 + x][4];
    rms_out[col] = r;
  }
}

template <int P>
void launch(const int* slots, const int* n_keep, const int* ref16,
            const float* weights, float* esum, float* fsum, int* c, int* rms,
            int B, int D, int cap_mapq, cudaStream_t stream) {
  constexpr int kCols = kThreads / P;
  const int grid = (B + kCols - 1) / kCols;
  accumulate32_kernel<P><<<grid, kThreads, 0, stream>>>(
      slots, n_keep, ref16, weights, esum, fsum, c, rms, B, D, cap_mapq);
}

}  // namespace

extern "C" int sniper_accumulate32(const void* slots, const void* n_keep,
                                   const void* ref16, const void* weights,
                                   void* esum, void* fsum, void* c,
                                   void* rms, int B, int D, int cap_mapq,
                                   void* stream) {
  if (B <= 0 || D <= 0 || D > 256) return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  auto args = [&](auto fn) {
    fn(static_cast<const int*>(slots), static_cast<const int*>(n_keep),
       static_cast<const int*>(ref16), static_cast<const float*>(weights),
       static_cast<float*>(esum), static_cast<float*>(fsum),
       static_cast<int*>(c), static_cast<int*>(rms), B, D, cap_mapq, s);
  };
  if (D <= 32) {
    args(launch<32>);
  } else if (D <= 64) {
    args(launch<64>);
  } else if (D <= 128) {
    args(launch<128>);
  } else {
    args(launch<256>);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sniper_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
