// score_columns: what the scoring step computes after glfgen, for both
// samples of a pileup column, in one launch: the consensus calls, the
// somatic score, the emission gates, the two statuses and, over raw
// kept-only lanes, the dqstats rows of both samples.
//
// Replaces no Pallas kernel.  On the TPU this work is the XLA fusions of
// the JAX package's jitted call_batch around its two Pallas calls:
// somatic_sniper_tpu/models/consensus.py:41-211 (glf2cns_batch,
// make_qadd, posteriors_batch, somatic_score_batch) and
// somatic_sniper_tpu/models/somatic.py:62-286 (_mean_499,
// _device_dqstats, the gates and statuses of call_batch).  Its plain
// version is ops/score_kernels.score_columns_plain, the port's torch ops
// for the same code (~1,230 of them a step, one kernel each).
//
// Every value is an int32 and every step the plain version's integer
// operation, so the two agree bit for bit.  What must be kept:
// * qAdd is the closed form of models/consensus.make_qadd, and its
//   argument order is the reference's: qsum = qadd(x[j], qsum) in the
//   posteriors, qadd(acc, term) in every other fold.
// * The joint-mode consensus-quality loop keeps the reference's stale-i
//   quirk: its guard is j != the tumor argmin of the 100-wide scan.
// * Two depths: glf2cns's n == 0 guard reads the batch's raw depth
//   (deletions counted, depth_t / depth_n), the SNP gate and the two depth
//   fields read glfgen's count of non-deleted reads (n_t / n_n, clamped to
//   2^24 - 1 as glfgen_batch's depth is).
// * The dqstats means are (int)(sum / occ + 0.499) made exact: the f32
//   estimate, then the integer test (1000k - 499) * occ <= 1000 * sum one
//   step each way (models/somatic._mean_499), in wrapping 32-bit
//   arithmetic like the torch int32 ops.
// Every scan takes the first minimum (strict <, genotype order; row-major
// over (normal, tumor) for the joint scan), as torch.argmin does.
//
// What bounds it on an H100: latency.  A column reads 2 x 10 likelihoods,
// seven metadata words and, for the dqstats, both samples' kept lanes
// (4 bytes each), and writes 16 fields, the emit byte and 2 x 18 dqstats
// words: ~0.7 KB at D = 48, so a slab of 8192 columns moves ~6 MB, under
// 2 us at 3.35 TB/s.  Its 1024 blocks are all resident at once on the 132
// SMs; the time is one column's chain: the serial qAdd folds (10 steps a
// sample and 10 more, or 100 + 10 in joint mode), each step a few
// dependent integer operations.
//
// Layout: a warp a column, eight columns a block of 256 threads.  The
// lanes stride the column's kept lanes for the dqstats counts and sum them
// with a shuffle butterfly, so every lane holds every sum; every lane then
// runs the consensus, the score and the gates itself on the column's 20
// likelihoods (the control flow is warp-uniform, so no lane waits and no
// value is broadcast), and lane 0 stores the fields, the emit flag and
// the two dqstats rows.  The priors are read through __ldg from the
// DeviceTables tensors.  No shared memory, no barrier, no allocation and
// no host read: the launch captures into the scoring step's CUDA graph.
// Columns past B do nothing; a column of depth 0 (the batch path's
// padding) never emits, since its consensus is 15 (no call).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColsPerBlock = kThreads / 32;
constexpr int kFields = 16;  // models/fields.COMPACT_FIELDS
constexpr int kDq = 18;      // output/dqstats row
constexpr int kMaxGlfDepth = 16777215;
// constants.py: WILDTYPE, GERMLINE, SOMATIC, LOH, UNKNOWN
constexpr int kWildtype = 0, kGermline = 1, kSomatic = 2, kLoh = 3,
              kUnknown = 4;

struct ScoreArgs {
  const int* lk_t;
  const int* lk_n;
  const int* depth_t;  // raw column depth, deletions included
  const int* depth_n;
  const int* n_t;  // glfgen's count of non-deleted reads
  const int* n_n;
  const int* ref16;
  const int* solo_prior;   // [16, 10]
  const int* joint_prior;  // [16, 10, 10], [ref16][normal][tumor]
  // raw kept-only lanes [B, D] and their counts, or all null: no dqstats
  const int* slots_t;
  const int* slots_n;
  const int* nk_t;
  const int* nk_n;
  unsigned char* emit;  // [B] bool
  int* fields;          // [B, 16], 16-byte aligned rows
  int* dq_t;            // [B, 18], or null
  int* dq_n;
  int B, D, q_r_int, min_somatic_qual;
  bool use_joint, include_loh, include_gor;
};

// constants.GLF_BASE = {1, 3, 5, 9, 2, 6, 10, 4, 12, 8}, a nibble each
__device__ __forceinline__ int glf_base(int g) {
  return (int)((0x8C4A629531ull >> (4 * g)) & 0xF);
}

// the het genotypes (AC AG AT CG CT GT) that glf2cns penalizes, a bit each
__device__ __forceinline__ int is_het(int g) { return (0x16E >> g) & 1; }

// models/consensus.make_qadd: x + qAddTable[512 + y - x] in closed form
__device__ __forceinline__ int qadd(int x, int y) {
  const int d = min(max(y - x, -512), 511);
  const int a = abs(d);
  return x + min(d, 0) - (a < 2) - (a < 4) - (a < 10);
}

struct Consensus {
  int base1, base2, score1, score2;
};

// glf2cns_batch for one sample: best, second and third of the penalized
// likelihoods, each scan skipping the earlier winners
__device__ Consensus glf2cns(const int (&lk)[10], int n_total, int q_r_int) {
  int t[10];
#pragma unroll
  for (int g = 0; g < 10; ++g) t[g] = lk[g] + is_het(g) * q_r_int;
  int i1 = 0, m1 = t[0];
#pragma unroll
  for (int g = 1; g < 10; ++g) {
    if (t[g] < m1) {
      m1 = t[g];
      i1 = g;
    }
  }
  int i2 = -1, m2 = 0x7FFFFFFF;
#pragma unroll
  for (int g = 0; g < 10; ++g) {
    if (g != i1 && t[g] < m2) {
      m2 = t[g];
      i2 = g;
    }
  }
  int m3 = 0x7FFFFFFF;
#pragma unroll
  for (int g = 0; g < 10; ++g) {
    if (g != i1 && g != i2 && t[g] < m3) m3 = t[g];
  }
  if (n_total <= 0) return {0xF, 0xF, 0, 0};
  return {glf_base(i1), glf_base(i2), min(m2 - m1, 255), min(m3 - m2, 255)};
}

// posteriors_batch for one sample; ``prior`` is solo_prior[ref16]
__device__ void posteriors(const int (&lk)[10], const int* __restrict__ prior,
                           int (&post)[10]) {
  int x[10];
#pragma unroll
  for (int g = 0; g < 10; ++g) x[g] = lk[g] + __ldg(prior + g);
  int qsum = 255;
#pragma unroll
  for (int g = 0; g < 10; ++g) qsum = qadd(x[g], qsum);  // the order kept
#pragma unroll
  for (int g = 0; g < 10; ++g) post[g] = min(x[g] - qsum, 255);
}

struct Score {
  int qps, joint_tumor, joint_normal, jcq;
};

__device__ Score somatic_score(const int (&lk_t)[10], const int (&lk_n)[10],
                               int ref, const ScoreArgs& a) {
  int qps = 255;
  if (!a.use_joint) {
    int tp[10], np[10];
    posteriors(lk_t, a.solo_prior + ref * 10, tp);
    posteriors(lk_n, a.solo_prior + ref * 10, np);
#pragma unroll
    for (int g = 0; g < 10; ++g) qps = qadd(qps, tp[g] + np[g]);
    return {qps, 0, 0, 255};
  }
  // joint_lk[i][j] = min(lk_n[i] + lk_t[j] + jp[i][j], 255), i the normal
  const int* __restrict__ jp = a.joint_prior + ref * 100;
  int best = 0x7FFFFFFF, ni = 0, tj = 0, marginal = 255;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int v = min(lk_n[i] + lk_t[j] + __ldg(jp + i * 10 + j), 255);
      if (v < best) {
        best = v;
        ni = i;
        tj = j;
      }
      marginal = qadd(marginal, v);
    }
  }
  int jcq = 255;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const int lkv =
        min(lk_n[j] + lk_t[j] + __ldg(jp + j * 11), 255) - marginal;
    qps = qadd(qps, lkv);
    if (tj != j) jcq = qadd(jcq, lkv);  // the stale-i quirk
  }
  return {qps, glf_base(tj), glf_base(ni), min(jcq, 255)};
}

__device__ __forceinline__ bool proper_subset(int a, int b) {
  return b != a && (a & b) == a;
}

// _mean_499, wrapping int32 arithmetic as the torch ops have it
__device__ int mean_499(int s, int o) {
  const int o1 = max(o, 1);
  const int k0 = (int)__fadd_rn(__fdiv_rn((float)s, (float)o1), 0.499f);
  const unsigned rhs_u = 1000u * (unsigned)s;
  const auto ok = [&](int k) {
    return (int)((1000u * (unsigned)k - 499u) * (unsigned)o1) <= (int)rhs_u;
  };
  const int k = ok(k0 + 1) ? k0 + 1 : (ok(k0) ? k0 : k0 - 1);
  return o > 0 ? k : 0;
}

// the dqstats sums of one sample's column, the same in every lane:
// tot_mq, dp4[4], then occ, bq sum and mq sum for each of the four bases
struct DqSums {
  unsigned v[17];
};

__device__ DqSums dq_sums(const int* __restrict__ row, int n, int rb4,
                          int lane) {
  DqSums s;
#pragma unroll
  for (int k = 0; k < 17; ++k) s.v[k] = 0;
  for (int j = lane; j < n; j += 32) {
    const int w = __ldg(row + j);
    const unsigned mq = w & 0xFF, bq = (w >> 8) & 0xFF;
    const int b = (w >> 16) & 0xF, st = (w >> 20) & 1;
    const int dp = (b == rb4 ? 0 : 2) + st;
    s.v[0] += mq;
#pragma unroll
    for (int k = 0; k < 4; ++k) s.v[1 + k] += (dp == k);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      // a '=' base (code 0) counts toward every base
      if ((b & (1 << v)) == b) {
        s.v[5 + 3 * v] += 1;
        s.v[6 + 3 * v] += bq;
        s.v[7 + 3 * v] += mq;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 17; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s.v[k] += __shfl_xor_sync(0xFFFFFFFFu, s.v[k], off);
    }
  }
  return s;
}

// the [18] dqstats row: mean bq, mean mq and occ of each base, dp4, the
// depth (n_keep) and the mean mapQ; means of bases not ``wanted`` are 0
__device__ void store_dq(const DqSums& s, int nk, int wanted,
                         int* __restrict__ out) {
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int occ = (int)s.v[5 + 3 * v];
    const unsigned w = (wanted >> v) & 1;
    out[v] = mean_499((int)(s.v[6 + 3 * v] * w), occ);
    out[4 + v] = mean_499((int)(s.v[7 + 3 * v] * w), occ);
    out[8 + v] = occ;
    out[12 + v] = (int)s.v[1 + v];
  }
  out[16] = nk;
  out[17] = mean_499((int)s.v[0], nk);
}

__global__ void __launch_bounds__(kThreads)
    score_columns_kernel(const ScoreArgs a) {
  const int col = blockIdx.x * kColsPerBlock + (threadIdx.x >> 5);
  if (col >= a.B) return;  // a whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int rb4 = __ldg(a.ref16 + col);
  const bool dq = a.slots_t != nullptr;
  DqSums dq_t, dq_n;
  int nk_t = 0, nk_n = 0;
  if (dq) {
    nk_t = __ldg(a.nk_t + col);
    nk_n = __ldg(a.nk_n + col);
    const size_t off = (size_t)col * a.D;
    dq_t = dq_sums(a.slots_t + off, min(nk_t, a.D), rb4, lane);
    dq_n = dq_sums(a.slots_n + off, min(nk_n, a.D), rb4, lane);
  }

  int lk_t[10], lk_n[10];
#pragma unroll
  for (int g = 0; g < 10; ++g) {
    lk_t[g] = __ldg(a.lk_t + (size_t)col * 10 + g);
    lk_n[g] = __ldg(a.lk_n + (size_t)col * 10 + g);
  }
  const Consensus ct = glf2cns(lk_t, __ldg(a.depth_t + col), a.q_r_int);
  const Consensus cn = glf2cns(lk_n, __ldg(a.depth_n + col), a.q_r_int);
  const int gd_t = min(__ldg(a.n_t + col), kMaxGlfDepth);
  const int gd_n = min(__ldg(a.n_n + col), kMaxGlfDepth);

  // outer gate (reference somatic_sniper.c:127) + SNP gate (:156)
  const bool is_snp = gd_t > 0 && gd_n > 0 && rb4 != 15 && ct.base1 != 15 &&
                      cn.base1 != 15 && ct.base1 != cn.base1;
  const int tumor_vaq =
      min(ct.base2 == rb4 ? ct.score1 : ct.score1 + ct.score2, 255);
  const int normal_vaq =
      (cn.base1 != 15 && cn.base1 != rb4)
          ? min(cn.base2 == rb4 ? cn.score1 : cn.score1 + cn.score2, 255)
          : 0;

  // the prior rows of a code past 15 would lie outside the tables
  const Score sc = somatic_score(lk_t, lk_n, rb4 & 15, a);

  // joint-aware effective genotypes (reference somatic_sniper.c:216-223)
  const int t_eff = sc.joint_tumor != 0 ? sc.joint_tumor : ct.base1;
  const int n_eff = sc.joint_normal != 0 ? sc.joint_normal : cn.base1;
  const bool loh = proper_subset(t_eff, n_eff);
  const bool gor = !proper_subset(rb4, n_eff) && (t_eff & ~n_eff) == rb4;
  const bool emit = is_snp && sc.qps >= a.min_somatic_qual &&
                    (a.include_loh || !loh) && (a.include_gor || !gor);
  // statuses (reference somatic_sniper.c:241-261)
  const int t_status = t_eff == n_eff   ? kGermline
                       : loh            ? kLoh
                       : sc.qps > 0     ? kSomatic
                                        : kUnknown;
  const int n_status = cn.base1 == rb4 ? kWildtype : kGermline;

  if (lane != 0) return;
  a.emit[col] = emit;
  int4* f = reinterpret_cast<int4*>(a.fields + (size_t)col * kFields);
  f[0] = make_int4(ct.base1, cn.base1, ct.score1, cn.score1);
  f[1] = make_int4(tumor_vaq, normal_vaq, sc.qps, sc.joint_tumor);
  f[2] = make_int4(sc.joint_normal, sc.jcq, t_status, n_status);
  f[3] = make_int4(t_eff, n_eff, gd_t, gd_n);
  if (dq) {
    const int wanted = rb4 | t_eff | n_eff;
    store_dq(dq_t, nk_t, wanted, a.dq_t + (size_t)col * kDq);
    store_dq(dq_n, nk_n, wanted, a.dq_n + (size_t)col * kDq);
  }
}

}  // namespace

// Scores B columns.  The dqstats inputs and outputs (slots_t .. nk_n,
// dq_t, dq_n) are all null, or all set with D >= 1.  B == 0 launches
// nothing.  Returns a CUDA error code, 0 on success.
extern "C" int sniper_score_columns(
    const void* lk_t, const void* lk_n, const void* depth_t,
    const void* depth_n, const void* n_t, const void* n_n,
    const void* ref16, const void* solo_prior, const void* joint_prior,
    const void* slots_t, const void* slots_n, const void* nk_t,
    const void* nk_n, void* emit, void* fields, void* dq_t, void* dq_n,
    int B, int D, int q_r_int, int use_joint, int min_somatic_qual,
    int include_loh, int include_gor, void* stream) {
  if (B < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const bool dq = slots_t != nullptr;
  if (!lk_t || !lk_n || !depth_t || !depth_n || !n_t || !n_n || !ref16 ||
      !solo_prior || !joint_prior || !emit || !fields ||
      (reinterpret_cast<size_t>(fields) & 15) != 0 ||
      (dq && (!slots_n || !nk_t || !nk_n || !dq_t || !dq_n || D < 1)) ||
      (!dq && (slots_n || nk_t || nk_n || dq_t || dq_n))) {
    return (int)cudaErrorInvalidValue;
  }
  ScoreArgs a;
  a.lk_t = static_cast<const int*>(lk_t);
  a.lk_n = static_cast<const int*>(lk_n);
  a.depth_t = static_cast<const int*>(depth_t);
  a.depth_n = static_cast<const int*>(depth_n);
  a.n_t = static_cast<const int*>(n_t);
  a.n_n = static_cast<const int*>(n_n);
  a.ref16 = static_cast<const int*>(ref16);
  a.solo_prior = static_cast<const int*>(solo_prior);
  a.joint_prior = static_cast<const int*>(joint_prior);
  a.slots_t = static_cast<const int*>(slots_t);
  a.slots_n = static_cast<const int*>(slots_n);
  a.nk_t = static_cast<const int*>(nk_t);
  a.nk_n = static_cast<const int*>(nk_n);
  a.emit = static_cast<unsigned char*>(emit);
  a.fields = static_cast<int*>(fields);
  a.dq_t = static_cast<int*>(dq_t);
  a.dq_n = static_cast<int*>(dq_n);
  a.B = B;
  a.D = dq ? D : 0;
  a.q_r_int = q_r_int;
  a.min_somatic_qual = min_somatic_qual;
  a.use_joint = use_joint != 0;
  a.include_loh = include_loh != 0;
  a.include_gor = include_gor != 0;
  const int blocks = (B + kColsPerBlock - 1) / kColsPerBlock;
  score_columns_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
