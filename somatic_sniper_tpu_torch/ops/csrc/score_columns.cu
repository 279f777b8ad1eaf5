// score_columns: what the scoring step computes after glfgen, for both
// samples of a pileup column, in one launch: the consensus calls, the
// somatic score, the emission gates, the two statuses and, over raw
// kept-only lanes, the dqstats rows of both samples.
//
// Replaces no Pallas kernel.  On the TPU this work is the XLA fusions of
// the JAX package's jitted call_batch after its glfgen
// (somatic_sniper_tpu/models/somatic.py:130, the gates and statuses, with
// _mean_499 and _device_dqstats at :62-128) and of
// somatic_sniper_tpu/models/consensus.py:41-211 (glf2cns_batch,
// make_qadd, posteriors_batch, somatic_score_batch).  Its plain version is
// ops/score_kernels.score_columns_plain, the port's torch ops for the same
// code (~1,230 of them a step, one kernel each).
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
// What bounds it on an H100: the latency and issue of a serial integer
// chain, not bytes.  A column moves ~0.7 KB at D = 48 (2 x 10
// likelihoods, seven metadata words, both samples' kept lanes in; 16
// fields, the emit byte and 2 x 18 dqstats words out): a slab of 8192
// columns is ~2 us of HBM time.  But a column's score is a chain of
// dependent integer steps that no lane can share with another: qAdd's
// closed form is not symmetric, so its folds (10 + 10 + 10 steps solo,
// 100 + 10 joint) run in order, and the scans take the first minimum.
// The time is one chain's latency times the number of waves the columns
// take on the card, plus the issue of the dqstats loop.  The layout cuts
// the waves to one and the issue to one chain a column:
// 1. A thread a column, for everything serial: both glf2cns, the
//    posteriors and every qAdd fold, the joint scan and its marginal, the
//    gates, LOH/GOR and the statuses.  No lane repeats another's chain; a
//    block of kCols = 64 columns; a slab of 8192 columns is 128 blocks and
//    a batch of 65536 is 1024, one wave on 132 SMs either way.  The price:
//    a thread also walks its column's whole rows (3. below), so a slab of
//    far fewer columns (SNIPER_SLAB_B) leaves most SMs idle while a few
//    threads walk deep rows (chip_smoke.py --score-sweep times it).
// 2. A template a mode, <kJoint, kDq>, one of four instances picked by
//    the C entry: solo runs carry no joint scan, batches no dqstats code,
//    and each instance keeps only its own registers.
// 3. The dqstats after the score: store_dq needs the effective genotypes
//    (wanted = rb4 | t_eff | n_eff), so a column's score runs first, its
//    fields are stored, and then its lanes are summed: the two sets of
//    values are never live together.  The sums run packed (four 8-bit
//    counts, two 16-bit sums a word) over chunks of at most 255 lanes, so
//    a lane costs ~29 integer operations and a row 7 registers, two
//    lanes at a time.
// 4. The block's kept lanes in shared memory by an asynchronous bulk
//    copy: its columns are consecutive, so their [cols, D] rows of
//    slots_t and slots_n are two contiguous regions.  At the top of the
//    block one thread starts cp.async.bulk (TMA, 1-D) of each region's
//    16-byte aligned middle into dynamic shared memory, completion on an
//    mbarrier; the threads load the up to three words on either side.
//    The score chains run while the copy is in flight; then each thread
//    waits and sums its own row from shared memory.  A row is walked from
//    a start skewed by its thread's index, so that the 32 rows of a warp
//    fall on 32 banks whatever D is (stride D + 1 for an even D).  Up to
//    D = 255 (kBulkDepth, the deepest raw slab); deeper rows are read
//    from device memory by their thread.
// 5. The priors in shared memory, copied once a block: the 640-byte solo
//    table, or the 6.4 KB joint table whose 100 gathers a column then
//    hit shared memory.
// 6. Coalesced I/O: the block's [cols, 10] likelihoods of each sample are
//    contiguous and loaded by all its threads together into shared
//    memory; a thread's [16] fields go out as four int4 stores, its
//    dqstats rows as nine int2 stores each.
// No allocation and no host read: the launch captures into the scoring
// step's CUDA graph.  Columns past B do nothing; a column of depth 0 (the
// batch path's padding) never emits, since its consensus is 15 (no call).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCols = 64;   // columns a block, a thread each
constexpr int kFields = 16;  // models/fields.COMPACT_FIELDS
constexpr int kDqRow = 18;   // output/dqstats row
constexpr int kMaxGlfDepth = 16777215;
constexpr int kSoloPrior = 16 * 10;
constexpr int kJointPrior = 16 * 10 * 10;
// lanes a packed dqstats sum takes before an 8-bit count could carry
constexpr int kChunk = 255;
// the deepest row copied to shared memory, and the dynamic shared memory
// that takes: an 8-byte mbarrier in 16 bytes, then a buffer a sample
constexpr int kBulkDepth = 255;
// constants.py: WILDTYPE, GERMLINE, SOMATIC, LOH, UNKNOWN
constexpr int kWildtype = 0, kGermline = 1, kSomatic = 2, kLoh = 3,
              kUnknown = 4;

// words of a shared buffer for a region of ``words`` 4-byte words that
// starts anywhere in a 16-byte chunk, rounded to whole chunks
__host__ __device__ constexpr int buffer_words(int words) {
  return (words + 3 + 3) / 4 * 4;
}

__host__ __device__ constexpr int bulk_smem_bytes(int D) {
  return 16 + 2 * 4 * buffer_words(kCols * D);
}

struct ScoreArgs {
  const int* lk_t;
  const int* lk_n;
  const int* depth_t;  // raw column depth, deletions included
  const int* depth_n;
  const int* n_t;  // glfgen's count of non-deleted reads
  const int* n_n;
  const int* ref16;
  const int* prior;  // solo [16, 10] or joint [16, 10, 10] [ref16][n][t]
  // raw kept-only lanes [B, D] and their counts (the kDq instances)
  const int* slots_t;
  const int* slots_n;
  const int* nk_t;
  const int* nk_n;
  unsigned char* emit;  // [B] bool
  int* fields;          // [B, 16], 16-byte aligned rows
  int* dq_t;            // [B, 18], 8-byte aligned rows
  int* dq_n;
  int B, D, q_r_int, min_somatic_qual;
  bool include_loh, include_gor;
  bool bulk;  // kDq: the lanes through shared memory
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
__device__ __forceinline__ Consensus glf2cns(const int (&lk)[10],
                                             int n_total, int q_r_int) {
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
__device__ __forceinline__ void posteriors(const int (&lk)[10],
                                           const int* prior,
                                           int (&post)[10]) {
  int x[10];
#pragma unroll
  for (int g = 0; g < 10; ++g) x[g] = lk[g] + prior[g];
  int qsum = 255;
#pragma unroll
  for (int g = 0; g < 10; ++g) qsum = qadd(x[g], qsum);  // the order kept
#pragma unroll
  for (int g = 0; g < 10; ++g) post[g] = min(x[g] - qsum, 255);
}

struct Score {
  int qps, joint_tumor, joint_normal, jcq;
};

// somatic_score_batch without joint priors; ``prior`` is solo_prior[ref]
__device__ __forceinline__ Score solo_score(const int (&lk_t)[10],
                                            const int (&lk_n)[10],
                                            const int* prior) {
  int tp[10], np[10];
  posteriors(lk_t, prior, tp);
  posteriors(lk_n, prior, np);
  int qps = 255;
#pragma unroll
  for (int g = 0; g < 10; ++g) qps = qadd(qps, tp[g] + np[g]);
  return {qps, 0, 0, 255};
}

// somatic_score_batch with joint priors; ``jp`` is joint_prior[ref]:
// joint_lk[i][j] = min(lk_n[i] + lk_t[j] + jp[i][j], 255), i the normal
__device__ __forceinline__ Score joint_score(const int (&lk_t)[10],
                                             const int (&lk_n)[10],
                                             const int* jp) {
  int best = 0x7FFFFFFF, ni = 0, tj = 0, marginal = 255;
#pragma unroll
  for (int i = 0; i < 10; ++i) {
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      const int v = min(lk_n[i] + lk_t[j] + jp[i * 10 + j], 255);
      if (v < best) {
        best = v;
        ni = i;
        tj = j;
      }
      marginal = qadd(marginal, v);
    }
  }
  int qps = 255, jcq = 255;
#pragma unroll
  for (int j = 0; j < 10; ++j) {
    const int lkv = min(lk_n[j] + lk_t[j] + jp[j * 11], 255) - marginal;
    qps = qadd(qps, lkv);
    if (tj != j) jcq = qadd(jcq, lkv);  // the stale-i quirk
  }
  return {qps, glf_base(tj), glf_base(ni), min(jcq, 255)};
}

__device__ __forceinline__ bool proper_subset(int a, int b) {
  return b != a && (a & b) == a;
}

// _mean_499, wrapping int32 arithmetic as the torch ops have it
__device__ __forceinline__ int mean_499(int s, int o) {
  const int o1 = max(o, 1);
  const int k0 = (int)__fadd_rn(__fdiv_rn((float)s, (float)o1), 0.499f);
  const unsigned rhs_u = 1000u * (unsigned)s;
  const auto ok = [&](int k) {
    return (int)((1000u * (unsigned)k - 499u) * (unsigned)o1) <= (int)rhs_u;
  };
  const int k = ok(k0 + 1) ? k0 + 1 : (ok(k0) ? k0 : k0 - 1);
  return o > 0 ? k : 0;
}

// the bases a lane's base code counts toward, a byte each (byte v for
// base v): a '=' base (code 0) toward every base, code 1 << v toward v,
// any other code toward none
__device__ __forceinline__ unsigned base_bytes(unsigned b) {
  const unsigned m = b == 0 ? 0xFu : ((b & (b - 1)) == 0 ? b : 0u);
  return (m * 0x00204081u) & 0x01010101u;  // bit v -> bit 8v
}

// the dqstats sums of one sample's column
struct DqSums {
  unsigned tot_mq, dp4[4], occ[4], bq[4], mq[4];
};

// The sums over the first n lanes of ``row`` (integer sums: the order is
// free), walked from lane ``start`` and wrapping at n, so that every
// thread of a warp runs one loop of its own length.  Per chunk of at most
// 255 lanes the counts run as bytes of one word (dp4, occ) and the
// quality sums as 16-bit halves (<= 255 x 255 each), then are added to
// the totals.  Two lanes an iteration: their loads are in flight together.
__device__ __forceinline__ DqSums dq_sums(const int* row, int n, int start,
                                          int rb4) {
  DqSums s = {};
  int k = start;
  for (int done = 0; done < n;) {
    const int end = min(n, done + kChunk);
    unsigned dp = 0, occ = 0, bq01 = 0, bq23 = 0, mq01 = 0, mq23 = 0;
#pragma unroll 2
    for (; done < end; ++done) {
      const unsigned w = (unsigned)row[k];
      k = k + 1 == n ? 0 : k + 1;
      const unsigned mq = w & 0xFF, bq = (w >> 8) & 0xFF;
      const unsigned b = (w >> 16) & 0xF, st = (w >> 20) & 1;
      s.tot_mq += mq;
      dp += 1u << (8 * (((int)b == rb4 ? 0 : 2) + st));
      const unsigned bytes = base_bytes(b);
      occ += bytes;
      const unsigned lo = (bytes & 1u) | ((bytes & 0x100u) << 8);
      const unsigned hi = ((bytes >> 16) & 1u) | ((bytes >> 8) & 0x10000u);
      bq01 += bq * lo;
      bq23 += bq * hi;
      mq01 += mq * lo;
      mq23 += mq * hi;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      s.dp4[v] += (dp >> (8 * v)) & 0xFF;
      s.occ[v] += (occ >> (8 * v)) & 0xFF;
    }
    s.bq[0] += bq01 & 0xFFFF;
    s.bq[1] += bq01 >> 16;
    s.bq[2] += bq23 & 0xFFFF;
    s.bq[3] += bq23 >> 16;
    s.mq[0] += mq01 & 0xFFFF;
    s.mq[1] += mq01 >> 16;
    s.mq[2] += mq23 & 0xFFFF;
    s.mq[3] += mq23 >> 16;
  }
  return s;
}

// the [18] dqstats row: mean bq, mean mq and occ of each base, dp4, the
// depth (n_keep) and the mean mapQ; means of bases not ``wanted`` are 0
__device__ __forceinline__ void store_dq(const DqSums& s, int nk, int wanted,
                                         int* __restrict__ out) {
  int r[kDqRow];
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const int occ = (int)s.occ[v];
    const unsigned w = (wanted >> v) & 1;
    r[v] = mean_499((int)(s.bq[v] * w), occ);
    r[4 + v] = mean_499((int)(s.mq[v] * w), occ);
    r[8 + v] = occ;
    r[12 + v] = (int)s.dp4[v];
  }
  r[16] = nk;
  r[17] = mean_499((int)s.tot_mq, nk);
  int2* o = reinterpret_cast<int2*>(out);
#pragma unroll
  for (int i = 0; i < kDqRow / 2; ++i) o[i] = make_int2(r[2 * i], r[2 * i + 1]);
}

// -- the bulk copy: a block's rows of a [B, D] lane array ------------------

// ``words`` contiguous 4-byte words from ``src``, placed in a 16-byte
// aligned shared buffer so that their 16-byte chunks keep their
// alignment: word i lands at buf[lead + i].  The aligned middle
// [head, tail) goes by one bulk copy; the up to three words before it and
// after it (or a region inside one chunk pair) by threads.
struct Region {
  const int* src;
  int words, lead, head, tail;
  unsigned bulk_bytes;
};

__device__ __forceinline__ Region region_of(const int* src, int words) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t e = a + 4 * (uintptr_t)words;
  const uintptr_t a16 = (a + 15) & ~(uintptr_t)15, e16 = e & ~(uintptr_t)15;
  Region r;
  r.src = src;
  r.words = words;
  r.lead = (int)((a & 15) >> 2);
  r.head = min(words, (int)((a16 - a) >> 2));
  r.tail = e16 > a16 ? (int)((e16 - a) >> 2) : r.head;
  r.bulk_bytes = e16 > a16 ? (unsigned)(e16 - a16) : 0u;
  return r;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// thread 0: the mbarrier armed for ``bytes`` and the copies started
__device__ __forceinline__ void bulk_start(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  // the barrier's initialization visible to the copy engine
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(int* buf, const Region& r,
                                          uint64_t* bar) {
  if (r.bulk_bytes == 0) return;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(buf + r.lead + r.head)),
      "l"(r.src + r.head), "r"(r.bulk_bytes), "r"(smem_addr(bar))
      : "memory");
}

// every thread: the words outside the bulk copy
__device__ __forceinline__ void edge_words(int* buf, const Region& r, int t) {
  if (t < r.head) buf[r.lead + t] = __ldg(r.src + t);
  if (t < r.words - r.tail) {
    buf[r.lead + r.tail + t] = __ldg(r.src + r.tail + t);
  }
}

__device__ __forceinline__ void bulk_wait(uint64_t* bar) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

template <bool kJoint, bool kDq>
__global__ void __launch_bounds__(kCols) score_columns_kernel(
    const ScoreArgs a) {
  constexpr int kPrior = kJoint ? kJointPrior : kSoloPrior;
  __shared__ int prior_s[kPrior];
  __shared__ int lk_s[2][kCols * 10];
  extern __shared__ __align__(16) unsigned char dyn[];  // bulk: bar, t, n
  uint64_t* bar = reinterpret_cast<uint64_t*>(dyn);
  int* buf_t = reinterpret_cast<int*>(dyn + 16);
  int* buf_n = buf_t + buffer_words(kCols * a.D);

  const int t = threadIdx.x;
  const int col0 = blockIdx.x * kCols;
  const int ncols = min(kCols, a.B - col0);
  Region rt, rn;
  if constexpr (kDq) {
    if (a.bulk) {
      const size_t off = (size_t)col0 * a.D;
      rt = region_of(a.slots_t + off, ncols * a.D);
      rn = region_of(a.slots_n + off, ncols * a.D);
      if (t == 0) {
        bulk_start(bar, rt.bulk_bytes + rn.bulk_bytes);
        bulk_copy(buf_t, rt, bar);
        bulk_copy(buf_n, rn, bar);
      }
      edge_words(buf_t, rt, t);
      edge_words(buf_n, rn, t);
    }
  }
  for (int i = t; i < kPrior; i += kCols) prior_s[i] = __ldg(a.prior + i);
  const int* lk_t_g = a.lk_t + (size_t)col0 * 10;
  const int* lk_n_g = a.lk_n + (size_t)col0 * 10;
  for (int i = t; i < ncols * 10; i += kCols) {
    lk_s[0][i] = __ldg(lk_t_g + i);
    lk_s[1][i] = __ldg(lk_n_g + i);
  }
  __syncthreads();
  if (t >= ncols) return;  // no barrier below

  const int col = col0 + t;
  int lk_t[10], lk_n[10];
#pragma unroll
  for (int g = 0; g < 10; ++g) {
    lk_t[g] = lk_s[0][t * 10 + g];
    lk_n[g] = lk_s[1][t * 10 + g];
  }
  const int rb4 = __ldg(a.ref16 + col);
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
  const Score sc = kJoint ? joint_score(lk_t, lk_n, prior_s + (rb4 & 15) * 100)
                          : solo_score(lk_t, lk_n, prior_s + (rb4 & 15) * 10);

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

  a.emit[col] = emit;
  int4* f = reinterpret_cast<int4*>(a.fields + (size_t)col * kFields);
  f[0] = make_int4(ct.base1, cn.base1, ct.score1, cn.score1);
  f[1] = make_int4(tumor_vaq, normal_vaq, sc.qps, sc.joint_tumor);
  f[2] = make_int4(sc.joint_normal, sc.jcq, t_status, n_status);
  f[3] = make_int4(t_eff, n_eff, gd_t, gd_n);

  if constexpr (kDq) {
    const int wanted = rb4 | t_eff | n_eff;
    const int nk_t = __ldg(a.nk_t + col), nk_n = __ldg(a.nk_n + col);
    const int n_t = min(nk_t, a.D), n_n = min(nk_n, a.D);
    // an odd row stride over the banks: rows of an even D walk one lane
    // further a thread
    const int skew = t * (1 - (a.D & 1));
    const int s_t = n_t > 0 ? skew % n_t : 0, s_n = n_n > 0 ? skew % n_n : 0;
    int* out_t = a.dq_t + (size_t)col * kDqRow;
    int* out_n = a.dq_n + (size_t)col * kDqRow;
    if (a.bulk) {
      bulk_wait(bar);
      const int* row_t = buf_t + rt.lead + t * a.D;
      const int* row_n = buf_n + rn.lead + t * a.D;
      store_dq(dq_sums(row_t, n_t, s_t, rb4), nk_t, wanted, out_t);
      store_dq(dq_sums(row_n, n_n, s_n, rb4), nk_n, wanted, out_n);
    } else {
      const size_t off = (size_t)col * a.D;
      store_dq(dq_sums(a.slots_t + off, n_t, s_t, rb4), nk_t, wanted, out_t);
      store_dq(dq_sums(a.slots_n + off, n_n, s_n, rb4), nk_n, wanted, out_n);
    }
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
      (dq && (!slots_n || !nk_t || !nk_n || !dq_t || !dq_n || D < 1 ||
              (reinterpret_cast<size_t>(dq_t) & 7) != 0 ||
              (reinterpret_cast<size_t>(dq_n) & 7) != 0)) ||
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
  a.prior = static_cast<const int*>(use_joint ? joint_prior : solo_prior);
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
  a.include_loh = include_loh != 0;
  a.include_gor = include_gor != 0;
  a.bulk = dq && D <= kBulkDepth;
  void (*kernel)(ScoreArgs) =
      use_joint ? (dq ? score_columns_kernel<true, true>
                      : score_columns_kernel<true, false>)
                : (dq ? score_columns_kernel<false, true>
                      : score_columns_kernel<false, false>);
  const int smem = a.bulk ? bulk_smem_bytes(D) : 0;
  if (a.bulk) {
    // without it a launch may use only 48 KB less the static shared
    // memory; one value for every launch, so that concurrent callers
    // and devices agree
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bulk_smem_bytes(kBulkDepth));
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (B + kCols - 1) / kCols;
  kernel<<<blocks, kCols, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
