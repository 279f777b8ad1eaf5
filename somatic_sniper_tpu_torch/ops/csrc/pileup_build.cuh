// pileup_build: a region load's counting pileup build and pure-reference
// flags on the card, the work of the native loader's pileup_build_tpl and
// fill_pure_flags (io/native/sniper_native.cpp) for the records of one
// contig, with the same bytes out.  The kernels (pileup_build.cu) are thin
// wrappers around the functions here, which tests/pileup_warp_emul.cpp
// compiles for the host to hold them to the native build on the CPU.
//
// The build, in four steps (the host's, one kernel each):
//   cover    a thread a read: +1 / -1 at the ends of each of its M/D runs
//            clipped to the window [lo, hi), into the coverage diff;
//   scan     one block: the prefix sums over the window's positions, each
//            covered one a column (ukeys, offsets), and the diff turned
//            into each column's first slot (its scatter cursor);
//   scatter  a warp a tile of T positions: the tile's reads go through in
//            read order, 32 at a time, a lane a read, and the warp walks
//            the positions the 32 reads cover; a lane that covers
//            position p writes its slot word at the column's cursor plus
//            its rank among the lanes that cover p (a ballot), and the
//            cursor moves past them all.  So a column's entries keep the
//            order in which the reads arrive, the host build's order,
//            with no atomic cursor.  The tile's cursors live in shared
//            memory, each read and written by one lane only (position
//            p0 + i by lane i mod 32), which hands it to the others by a
//            shuffle;
//   pure     a thread a column: the flags' serial double-precision chain
//            over the column's entries in order, as the host does it.
//
// Slot words (the host's): mapq | base qual << 8 | base code << 16 |
// strand << 20 for an aligned base, mapq | strand << 20 | 1 << 21 for a
// deletion; the base and its quality at the query position, clamped to
// the read's last base (a CIGAR longer than its sequence).

#pragma once

#include <cstdint>

namespace pileup {

constexpr unsigned kFull = 0xffffffffu;
enum { kMatch = 0, kIns = 1, kDel = 2, kSkip = 3, kSoft = 4 };

// record bytes are read a byte at a time: a record starts anywhere
__device__ __forceinline__ uint32_t ld_u16(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8);
}
__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// The fields of a record body (vendor bam.c:181: tid:0 pos:4
// l_read_name:8 mapq:9 n_cigar:12 flag:14 l_seq:16, then the name, the
// CIGAR, the 4-bit sequence and the qualities) that the build reads.
struct Read {
  long long pos;
  const uint8_t* cig;
  int n_cigar;
  const uint8_t* seq;
  const uint8_t* qual;
  long long max_q;  // the last query position a base is read from
  uint32_t mq, strand;
};

__device__ __forceinline__ Read read_at(const uint8_t* b) {
  Read r;
  r.pos = (int32_t)ld_u32(b + 4);
  r.n_cigar = (int)ld_u16(b + 12);
  r.cig = b + 32 + b[8];
  const int32_t ls = (int32_t)ld_u32(b + 16);
  r.seq = r.cig + 4 * r.n_cigar;
  r.qual = r.seq + (ls + 1) / 2;
  r.max_q = ls > 0 ? ls - 1 : 0;
  r.mq = b[9];
  r.strand = (ld_u16(b + 14) >> 4) & 1;
  return r;
}

// End of the read on the reference: its M, D and N runs (the host's
// read_end).
__device__ __forceinline__ long long read_end(const Read& r) {
  long long x = r.pos;
  for (int k = 0; k < r.n_cigar; ++k) {
    const uint32_t c = ld_u32(r.cig + 4 * k);
    const uint32_t op = c & 0xF;
    if (op == kMatch || op == kDel || op == kSkip) x += c >> 4;
  }
  return x;
}

// cover: read ``r``'s M/D runs clipped to [lo, hi) into ``diff`` (span + 1
// words, wrapping as the host's uint32 diff does); its position to pos[r].
__device__ __forceinline__ void cover_read(const uint8_t* bytes,
                                           const uint32_t* rec, int r,
                                           long long lo, long long hi,
                                           uint32_t* diff, int* pos) {
  const Read rd = read_at(bytes + rec[r]);
  pos[r] = (int)rd.pos;
  long long x = rd.pos;
  for (int k = 0; k < rd.n_cigar; ++k) {
    const uint32_t c = ld_u32(rd.cig + 4 * k);
    const uint32_t op = c & 0xF;
    const long long l = c >> 4;
    if (op == kMatch || op == kDel) {
      const long long a = x > lo ? x : lo;
      const long long b = x + l < hi ? x + l : hi;
      if (b > a) {
        atomicAdd(diff + (a - lo), 1u);
        atomicAdd(diff + (b - lo), 0xffffffffu);
      }
      x += l;
    } else if (op == kSkip) {
      x += l;
    }
  }
}

// scan, thread t of nt: its positions [first, last) of the span.
__device__ __forceinline__ void scan_range(long long span, int t, int nt,
                                           long long* first,
                                           long long* last) {
  const long long per = (span + nt - 1) / nt;
  const long long a = (long long)t * per;
  *first = a < span ? a : span;
  *last = a + per < span ? a + per : span;
}

// scan, first pass: the sum of the thread's diff words (its depth step).
__device__ __forceinline__ uint32_t scan_sum(const uint32_t* diff,
                                             long long first,
                                             long long last) {
  uint32_t s = 0;
  for (long long p = first; p < last; ++p) s += diff[p];
  return s;
}

// scan, second pass: from depth ``d`` at ``first``, the thread's covered
// positions and their entries.
__device__ __forceinline__ void scan_count(const uint32_t* diff,
                                           long long first, long long last,
                                           uint32_t d, uint32_t* n_cols,
                                           uint32_t* n_ent) {
  uint32_t c = 0, e = 0;
  for (long long p = first; p < last; ++p) {
    d += diff[p];
    if (d > 0) {
      ++c;
      e += d;
    }
  }
  *n_cols = c;
  *n_ent = e;
}

// scan, third pass: the thread's columns from column ``col`` and entry
// ``excl`` on; each diff word becomes its position's first slot.
__device__ __forceinline__ void scan_write(uint32_t* diff, long long first,
                                           long long last, uint32_t d,
                                           uint32_t col, uint32_t excl,
                                           long long lo, long long key_hi,
                                           long long* ukeys,
                                           long long* offsets) {
  for (long long p = first; p < last; ++p) {
    d += diff[p];
    diff[p] = excl;
    if (d > 0) {
      ukeys[col] = key_hi | (p + lo);
      offsets[col] = excl;
      ++col;
      excl += d;
    }
  }
}

// First index in pos[0, n) (non-decreasing) whose value is >= v.
__device__ __forceinline__ int lower_bound(const int* pos, int n,
                                           long long v) {
  int a = 0, b = n;
  while (a < b) {
    const int m = (a + b) / 2;
    if (pos[m] < v)
      a = m + 1;
    else
      b = m;
  }
  return a;
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int o = 16; o > 0; o >>= 1) {
    const long long u = __shfl_xor_sync(kFull, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// scatter, lane ``lane`` of the warp that owns the tile [p0, p1): the
// slot words of every read that covers a position of the tile, at their
// columns' cursors (``cur0``: the scan's first slot a position, from lo;
// ``cur``: the tile's T cursors in shared memory).  Reads whose position
// is at least p0 - max_len + 1 and below p1 can reach the tile.
__device__ __forceinline__ void scatter_tile(
    int lane, const uint8_t* bytes, const uint32_t* rec, const int* pos,
    int n_reads, long long lo, long long p0, long long p1, long long max_len,
    const uint32_t* cur0, uint32_t* cur, uint32_t* slots) {
  for (long long p = p0 + lane; p < p1; p += 32) cur[p - p0] = cur0[p - lo];
  const int r_lo = lower_bound(pos, n_reads, p0 - max_len + 1);
  const int r_hi = lower_bound(pos, n_reads, p1);
  const unsigned below = (1u << lane) - 1;
  for (int rb = r_lo; rb < r_hi; rb += 32) {
    const int r = rb + lane;
    Read rd{};
    long long a = p1, b = p0;  // the lane's positions in the tile
    if (r < r_hi) {
      rd = read_at(bytes + rec[r]);
      const long long e = read_end(rd);
      a = rd.pos > p0 ? rd.pos : p0;
      b = e < p1 ? e : p1;
      if (b <= a) a = p1, b = p0;
    }
    const long long pa = warp_min(a), pb = warp_max(b);
    // the lane's walk: CIGAR op k starts at reference x, query y
    int k = 0;
    long long x = rd.pos, y = 0;
    for (long long p = pa; p < pb; ++p) {
      bool covers = false;
      uint32_t w = 0;
      if (p >= a && p < b) {
        for (; k < rd.n_cigar; ++k) {
          const uint32_t c = ld_u32(rd.cig + 4 * k);
          const uint32_t op = c & 0xF;
          const long long l = c >> 4;
          if (op == kMatch || op == kDel || op == kSkip) {
            if (p < x + l) break;
            x += l;
            if (op == kMatch) y += l;
          } else if (op == kIns || op == kSoft) {
            y += l;
          }  // H/P/=/X move nothing, as samtools-0.1.6
        }
        if (k < rd.n_cigar) {
          const uint32_t op = ld_u32(rd.cig + 4 * k) & 0xF;
          if (op == kMatch) {
            long long qp = y + (p - x);
            if (qp > rd.max_q) qp = rd.max_q;
            const uint8_t sb = rd.seq[qp >> 1];
            const uint32_t base = (qp & 1) ? (sb & 0xF) : (sb >> 4);
            w = rd.mq | ((uint32_t)rd.qual[qp] << 8) | (base << 16) |
                (rd.strand << 20);
            covers = true;
          } else if (op == kDel) {
            w = rd.mq | (rd.strand << 20) | (1u << 21);
            covers = true;
          }
        }
      }
      const unsigned m = __ballot_sync(kFull, covers);
      if (m) {
        const int owner = (int)((p - p0) & 31);
        const uint32_t at =
            __shfl_sync(kFull, lane == owner ? cur[p - p0] : 0u, owner);
        if (covers) slots[at + __popc(m & below)] = w;
        if (lane == owner) cur[p - p0] = at + __popc(m);
      }
    }
  }
}

// scatter's tile width from the region's mean depth (entries over the
// span): about as many reads a tile at every depth, and more tiles, so
// more warps to hide the byte loads' latency, in deep regions.
inline int tile_width(long long n_entries, long long span) {
  const long long depth = n_entries / (span > 0 ? span : 1);
  return depth <= 48 ? 256 : depth <= 120 ? 128 : 64;
}

// pure: the host's column_pure_ref on a column's slots [b, e) with
// reference code ``rcode`` (not ACGT: not pure).  L sums fk[m] * eff in
// entry order in double precision, fused into one rounding a step where
// the host's build contracts it (``fused``), else a rounding for the
// product and one for the sum.
__device__ __forceinline__ uint8_t pure_column(const uint32_t* slots,
                                               long long b, long long e,
                                               uint32_t rcode,
                                               const double* fk,
                                               const double* gmin,
                                               double margin, bool fused) {
  if (rcode != 1 && rcode != 2 && rcode != 4 && rcode != 8) return 0;
  int m = 0;
  double L = 0.0;
  for (long long i = b; i < e; ++i) {
    const uint32_t s = slots[i];
    if ((s >> 21) & 1) continue;  // deletion
    const uint32_t b16 = (s >> 16) & 0xF;
    if (b16 != rcode && b16 != 0) return 0;
    const uint32_t q = (s >> 8) & 0xFF;
    const uint32_t mq = s & 0xFF;
    uint32_t eff = q < mq ? q : mq;
    if (eff < 4 && (q & 0x3F) != 0) eff = 4;
    if (eff > 0) {
      const double f = fk[m < 255 ? m : 255];
      L = fused ? fma(f, (double)eff, L)
                : __dadd_rn(__dmul_rn(f, (double)eff), L);
      ++m;
    }
  }
  return m >= 1 && __dadd_rn(L, gmin[m <= 255 ? m : 254]) >= margin;
}

}  // namespace pileup
