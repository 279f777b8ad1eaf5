// bgzf_inflate.cuh: one BGZF block's raw-DEFLATE stream (RFC 1951) inflated
// by one warp, its output checked against the block's ISIZE and CRC32.
//
// Replaces no TPU kernel: the JAX package inflates every BGZF block on the
// host (zlib, or libdeflate where the host has it), and so does the port
// without a card.  A region load of the windowed driver inflates about 210
// independent blocks of at most 64 KB a sample, and zlib spends about half
// of each load-pool thread's time on them, while the card is idle.
//
// What bounds it: the symbol decode is one serial chain (each code's length
// is known only once its table entry is read), so a block costs one
// shared-memory lookup and a few dependent integer operations a symbol;
// the bytes (a few MB a region) are nothing to the card.  On the H100 a
// 64 KB block of BAM records (~22,000 symbols) takes ~4.5 ms, ~400 cycles
// a symbol: the latency of the chain, one warp to a scheduler.  The design
// therefore puts one warp on each block, runs every independent block at
// once (a region's blocks in one wave: three warps an SM, 396 on 132 SMs),
// and keeps the chain short:
//  - the output (64 KB at most) stays in shared memory until the block is
//    done, so literals are shared-memory stores and back-references read
//    shared memory, never device memory;
//  - the bit reader holds 64 bits and refills 32 at a time with one aligned
//    word load, so a length/distance pair reads at most two words;
//  - a code of up to 10 bits (literal/length) or 8 bits (distance) is one
//    table lookup that yields its length, kind, extra-bit count and base;
//    longer codes, which are rare by construction, take a canonical decode;
//  - the lanes build the tables together, copy each back-reference in
//    parallel (any distance: lane k copies byte pos - dist + k mod dist),
//    copy stored blocks in parallel, and checksum the output in 32 slices
//    combined by GF(2) shifts.
// The decode itself runs warp-uniform: every lane keeps the same reader
// state and stores each literal itself, so no lane waits on another.
//
// It refuses exactly the streams zlib's raw inflate refuses (over-
// subscribed or incomplete codes, more than 286/30 codes, a repeat with no
// previous length or past the end, a missing end-of-block code, a distance
// past the output, a stored length whose complement differs, a reserved
// block type, too much or too little output), plus an output whose CRC32
// differs from the block's; the caller inflates such a block on the host.
// It reads no input word past the stream's last and writes no output byte
// past ISIZE rounded up to 16, and every loop is bounded by the output's
// or the input's size.

#pragma once

#include <stdint.h>

namespace bgzf {

constexpr int kMaxOut = 65536;  // BGZF ISIZE ceiling
constexpr int kMaxIn = 1 << 20;  // far past any BGZF block's stream (< 64 KB)
constexpr int kLitBits = 10;
constexpr int kDistBits = 8;
constexpr int kClenBits = 7;

// Per-block status, written by lane 0.
enum Status : int32_t {
  kOk = 0,
  kBadStream = 1,  // a stream zlib refuses
  kBadLength = 2,  // more or less output than ISIZE
  kBadCrc = 3,     // the output's CRC32 is not the block's
  kOverrun = 4,    // the stream ends before its final block does
  kTooLarge = 5,   // ISIZE or the stream past the BGZF ceiling
};

// A table entry: bits 0-3 the code's length, 4-6 its kind, 8-12 the extra
// bits that follow it, 16-31 its value (a literal byte, a length or
// distance base, or a code-length symbol).  A slot no code reaches holds
// kind kBad and length 0.
enum Kind : uint32_t { kLit = 0, kLen = 1, kEob = 2, kLong = 3, kBad = 4 };
enum Alphabet : int { kCodes = 0, kLens = 1, kDists = 2 };

struct Smem {
  uint8_t out[kMaxOut + 16];
  uint32_t lit[1 << kLitBits];
  uint32_t dist[1 << kDistBits];  // the code-length code's table too
  uint32_t crc_tab[256];
  uint32_t lit_cnt[16], dist_cnt[16];  // codes of each length
  uint32_t off[16], first[16], run[16];  // build scratch
  uint16_t lit_sym[288], dist_sym[32];  // symbols in code order
  uint8_t lens[320];                     // literal/length then distance
  uint8_t clens[20];
  int32_t flag;
};

// x^(2^k) modulo the CRC-32 polynomial, bit-reflected (zlib's x2n_table).
__constant__ uint32_t kX2n[32] = {
    0x40000000, 0x20000000, 0x08000000, 0x00800000, 0x00008000, 0xedb88320,
    0xb1e6b092, 0xa06a2517, 0xed627dae, 0x88d14467, 0xd7bbfe6a, 0xec447f11,
    0x8e7ea170, 0x6427800e, 0x4d47bae0, 0x09fe548f, 0x83852d0f, 0x30362f1a,
    0x7b5a9cc3, 0x31fec169, 0x9fec022a, 0x6c8dedc4, 0x15d6874d, 0x5fde7a4e,
    0xbad90e37, 0x2e4e5eef, 0x4eaba214, 0xa8a472c0, 0x429a969e, 0x148d302a,
    0xc40ba6d0, 0xc4e22c3c};

__constant__ uint8_t kClenOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                       11, 4,  12, 3, 13, 2, 14, 1, 15};

constexpr uint32_t kPoly = 0xedb88320u;

// a * b modulo the CRC-32 polynomial (zlib's multmodp).
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t m = 1u << 31, p = 0;
  for (;;) {
    if (a & m) {
      p ^= b;
      if ((a & (m - 1)) == 0) break;
    }
    m >>= 1;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// x^(8 n) modulo the polynomial: what appending n zero bytes multiplies a
// CRC register by.
__device__ __forceinline__ uint32_t x8nmodp(uint32_t n) {
  uint32_t p = 1u << 31;
  for (int k = 3; n; n >>= 1, ++k)
    if (n & 1) p = multmodp(kX2n[k & 31], p);
  return p;
}

__device__ __forceinline__ uint32_t make_entry(int alphabet, int sym, int len) {
  const uint32_t L = (uint32_t)len;
  if (alphabet == kCodes) return ((uint32_t)sym << 16) | (kLit << 4) | L;
  if (alphabet == kLens) {
    if (sym < 256) return ((uint32_t)sym << 16) | (kLit << 4) | L;
    if (sym == 256) return (kEob << 4) | L;
    if (sym > 285) return (kBad << 4) | L;
    const int i = sym - 257;
    uint32_t base, extra;
    if (i < 8) {
      base = 3 + i;
      extra = 0;
    } else if (i == 28) {
      base = 258;
      extra = 0;
    } else {
      extra = (i - 4) >> 2;
      base = ((4u + (i & 3)) << extra) + 3;
    }
    return (base << 16) | (extra << 8) | (kLen << 4) | L;
  }
  if (sym > 29) return (kBad << 4) | L;
  uint32_t base, extra;
  if (sym < 4) {
    base = 1 + sym;
    extra = 0;
  } else {
    extra = (sym - 2) >> 1;
    base = ((2u + (sym & 1)) << extra) + 1;
  }
  return (base << 16) | (extra << 8) | (kLen << 4) | L;
}

// The canonical code of lens[0, n) as a (1 << bits)-slot table, and its
// symbols in code order with the count of each length for codes longer
// than ``bits``.  False where zlib's inflate_table refuses the lengths.
// Called by all 32 lanes.
__device__ bool build_table(Smem& s, const uint8_t* lens, int n, int bits,
                            uint32_t* tab, uint32_t* cnt, uint16_t* sym,
                            int alphabet, int lane) {
  if (lane < 16) {
    uint32_t c = 0;
    if (lane > 0)
      for (int i = 0; i < n; ++i) c += lens[i] == lane;
    cnt[lane] = c;
    s.run[lane] = 0;
  }
  for (int i = lane; i < (1 << bits); i += 32) tab[i] = kBad << 4;
  __syncwarp();
  if (lane == 0) {
    int left = 1, max = 0;
    bool ok = true;
    for (int L = 1; L < 16; ++L) {
      left = (left << 1) - (int)cnt[L];
      if (cnt[L]) max = L;
      if (left < 0) {
        ok = false;
        break;
      }
    }
    // zlib: no codes at all is a table that decodes nothing; an incomplete
    // set only as a single one-bit literal/length or distance code
    if (max == 0)
      ok = true;
    else if (ok && left > 0 && (alphabet == kCodes || max != 1))
      ok = false;
    uint32_t code = 0, o = 0;
    s.off[0] = 0;
    s.first[0] = 0;
    for (int L = 1; L < 16; ++L) {
      code = (code + (L > 1 ? cnt[L - 1] : 0)) << 1;
      s.first[L] = code;
      s.off[L] = o;
      o += cnt[L];
    }
    s.flag = ok;
  }
  __syncwarp();
  const bool ok = s.flag;
  if (!ok) return false;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const int L = i < n ? lens[i] : 0;
    const unsigned same = __match_any_sync(0xffffffffu, L);
    const int rank = __popc(same & ((1u << lane) - 1));
    if (L) {
      const uint32_t idx = s.run[L] + rank;
      const uint32_t code = s.first[L] + idx;
      sym[s.off[L] + idx] = (uint16_t)i;
      if (L <= bits) {
        const uint32_t e = make_entry(alphabet, i, L);
        for (uint32_t j = __brev(code) >> (32 - L); j < (1u << bits);
             j += 1u << L)
          tab[j] = e;
      } else {
        tab[__brev(code >> (L - bits)) >> (32 - bits)] = kLong << 4;
      }
    }
    __syncwarp();
    if (L && rank == 0) s.run[L] += __popc(same);
    __syncwarp();
  }
  return true;
}

// One symbol of a code longer than the table's bits, from the low bits of
// ``bb``: its entry, or kind kBad where no code matches.
__device__ uint32_t decode_long(uint64_t bb, const uint32_t* cnt,
                                const uint16_t* sym, int alphabet) {
  int code = 0, first = 0, index = 0;
  for (int L = 1; L < 16; ++L) {
    code |= (int)((bb >> (L - 1)) & 1);
    const int c = (int)cnt[L];
    if (code - first < c)
      return make_entry(alphabet, sym[index + code - first], L);
    index += c;
    first = (first + c) << 1;
    code <<= 1;
  }
  return kBad << 4;
}

// The 64-bit LSB-first bit reader over the stream's 32-bit words; words past
// the stream read as zero, and the last word's bytes past it are masked.
struct Bits {
  const uint32_t* w;
  int nw;           // words holding the stream
  uint32_t tail;    // mask of the last word's stream bytes
  int wp;           // next word
  uint64_t bb;
  int bc;
  __device__ __forceinline__ uint32_t word(int i) const {
    if (i >= nw) return 0;
    const uint32_t v = __ldg(w + i);
    return i == nw - 1 ? v & tail : v;
  }
  __device__ __forceinline__ void refill() {
    if (bc < 32) {
      bb |= (uint64_t)word(wp++) << bc;
      bc += 32;
    }
  }
  __device__ __forceinline__ void drop(int n) {  // n < 32
    bb >>= n & 31;
    bc -= n;
  }
  __device__ __forceinline__ int64_t consumed() const {
    return (int64_t)wp * 32 - bc;
  }
};

// Inflate one block: ``in`` (4-byte aligned) holds ``in_len`` bytes of raw
// DEFLATE, ``out`` (16-byte aligned) takes ``isize`` bytes and may be
// written up to ``isize`` rounded up to 16.  Called by all 32 lanes of a
// warp with the same arguments; lane 0 writes *status.
__device__ void inflate_warp(const uint8_t* in, int in_len, uint8_t* out,
                             int isize, uint32_t crc, int32_t* status,
                             Smem& s, int lane) {
  if (isize < 0 || isize > kMaxOut || in_len < 0 || in_len > kMaxIn) {
    if (lane == 0) *status = kTooLarge;
    return;
  }
  for (int i = lane; i < 256; i += 32) {
    uint32_t c = (uint32_t)i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    s.crc_tab[i] = c;
  }
  Bits br;
  br.w = reinterpret_cast<const uint32_t*>(in);
  br.nw = (in_len + 3) >> 2;
  br.tail = (in_len & 3) ? (1u << (8 * (in_len & 3))) - 1 : 0xffffffffu;
  br.wp = 0;
  br.bb = 0;
  br.bc = 0;
  const int64_t in_bits = (int64_t)in_len * 8;
  int pos = 0;
  int st = kOk;
  bool fixed_built = false;
  bool final = false;
  while (!final && st == kOk) {
    if (br.consumed() > in_bits) {
      st = kOverrun;
      break;
    }
    br.refill();
    final = br.bb & 1;
    const int type = (int)(br.bb >> 1) & 3;
    br.drop(3);
    if (type == 0) {  // stored
      br.drop(br.bc & 7);
      br.refill();
      const uint32_t len = (uint32_t)br.bb & 0xffff;
      const uint32_t nlen = (uint32_t)(br.bb >> 16) & 0xffff;
      br.drop(16);
      br.drop(16);
      if (len != (~nlen & 0xffff)) {
        st = kBadStream;
        break;
      }
      const int64_t p = br.consumed() >> 3;
      if (p + len > in_len) {
        st = kOverrun;
        break;
      }
      if (pos + (int)len > isize) {
        st = kBadLength;
        break;
      }
      for (uint32_t k = lane; k < len; k += 32) s.out[pos + k] = in[p + k];
      pos += (int)len;
      const int64_t q = p + len;
      br.wp = (int)(q >> 2);
      br.bb = 0;
      br.bc = 0;
      if (q & 3) {
        br.bb = br.word(br.wp++) >> (8 * (q & 3));
        br.bc = 32 - 8 * (int)(q & 3);
      }
      __syncwarp();
      continue;
    }
    if (type == 3) {
      st = kBadStream;
      break;
    }
    if (type == 1) {
      if (!fixed_built) {
        for (int i = lane; i < 288; i += 32)
          s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
        for (int i = lane; i < 32; i += 32) s.lens[288 + i] = 5;
        __syncwarp();
        build_table(s, s.lens, 288, kLitBits, s.lit, s.lit_cnt, s.lit_sym,
                    kLens, lane);
        build_table(s, s.lens + 288, 32, kDistBits, s.dist, s.dist_cnt,
                    s.dist_sym, kDists, lane);
        fixed_built = true;
      }
    } else {  // dynamic
      fixed_built = false;
      br.refill();
      const int nlit = (int)(br.bb & 31) + 257;
      const int ndist = (int)((br.bb >> 5) & 31) + 1;
      const int nclen = (int)((br.bb >> 10) & 15) + 4;
      br.drop(14);
      if (nlit > 286 || ndist > 30) {
        st = kBadStream;
        break;
      }
      if (lane < 19) s.clens[lane] = 0;
      __syncwarp();
      for (int i = 0; i < nclen; ++i) {
        br.refill();
        s.clens[kClenOrder[i]] = (uint8_t)(br.bb & 7);
        br.drop(3);
      }
      __syncwarp();
      if (!build_table(s, s.clens, 19, kClenBits, s.dist, s.dist_cnt,
                       s.dist_sym, kCodes, lane)) {
        st = kBadStream;
        break;
      }
      const int total = nlit + ndist;
      int i = 0, prev = 0;
      while (i < total) {
        br.refill();
        const uint32_t e = s.dist[br.bb & ((1 << kClenBits) - 1)];
        const int L = e & 15;
        if (L == 0) {
          st = kBadStream;
          break;
        }
        br.drop(L);
        const int sym = (int)(e >> 16);
        if (sym < 16) {
          s.lens[i] = (uint8_t)sym;
          prev = sym;
          ++i;
          continue;
        }
        int rep, val = 0;
        if (sym == 16) {
          if (i == 0) {
            st = kBadStream;
            break;
          }
          val = prev;
          rep = 3 + (int)(br.bb & 3);
          br.drop(2);
        } else if (sym == 17) {
          rep = 3 + (int)(br.bb & 7);
          br.drop(3);
        } else {
          rep = 11 + (int)(br.bb & 127);
          br.drop(7);
        }
        if (i + rep > total) {
          st = kBadStream;
          break;
        }
        for (int k = lane; k < rep; k += 32) s.lens[i + k] = (uint8_t)val;
        prev = val;
        i += rep;
      }
      __syncwarp();
      if (st != kOk) break;
      // the code lengths' table is spent; the distance table takes its place
      if (s.lens[256] == 0 ||
          !build_table(s, s.lens, nlit, kLitBits, s.lit, s.lit_cnt, s.lit_sym,
                       kLens, lane) ||
          !build_table(s, s.lens + nlit, ndist, kDistBits, s.dist, s.dist_cnt,
                       s.dist_sym, kDists, lane)) {
        st = kBadStream;
        break;
      }
    }
    // the symbols of one compressed block: every lane decodes every symbol
    // and writes every literal itself (the same byte to the same address),
    // so that no lane waits on another; the lanes copy a back-reference
    // together, and synchronise after it
    for (;;) {
      br.refill();
      uint32_t e = s.lit[br.bb & ((1u << kLitBits) - 1)];
      uint32_t kind = (e >> 4) & 7;
      if (kind == kLong) {
        e = decode_long(br.bb, s.lit_cnt, s.lit_sym, kLens);
        kind = (e >> 4) & 7;
      }
      if (kind == kLit) {
        br.drop(e & 15);
        if (pos >= isize) {
          st = kBadLength;
          break;
        }
        s.out[pos++] = (uint8_t)(e >> 16);
        continue;
      }
      if (kind == kBad) {
        st = kBadStream;
        break;
      }
      br.drop(e & 15);
      if (kind == kEob) break;
      int xb = (e >> 8) & 31;
      const int len = (int)(e >> 16) + (int)(br.bb & ((1u << xb) - 1));
      br.drop(xb);
      br.refill();
      e = s.dist[br.bb & ((1u << kDistBits) - 1)];
      if (((e >> 4) & 7) == kLong)
        e = decode_long(br.bb, s.dist_cnt, s.dist_sym, kDists);
      if (((e >> 4) & 7) == kBad) {
        st = kBadStream;
        break;
      }
      br.drop(e & 15);
      xb = (e >> 8) & 31;
      const int dist = (int)(e >> 16) + (int)(br.bb & ((1u << xb) - 1));
      br.drop(xb);
      if (dist > pos) {
        st = kBadStream;
        break;
      }
      if (pos + len > isize) {
        st = kBadLength;
        break;
      }
      // lane k's byte is pos - dist + k mod dist, for any distance
      const int from = pos - dist;
      if (dist >= len) {
        for (int k = lane; k < len; k += 32) s.out[pos + k] = s.out[from + k];
      } else {
        for (int k = lane; k < len; k += 32)
          s.out[pos + k] = s.out[from + k % dist];
      }
      __syncwarp();
      pos += len;
    }
  }
  if (st == kOk && br.consumed() > in_bits) st = kOverrun;
  if (st == kOk && pos != isize) st = kBadLength;
  __syncwarp();
  if (st == kOk) {
    // 32 slices of an odd number of words each, so that the lanes' bytes
    // sit in 32 different banks; each slice's CRC register from zero,
    // combined in order by the shift of the slices after it
    int w = (isize + 127) >> 7;
    if (!(w & 1)) ++w;
    const int beg = min(lane * 4 * w, isize);
    const int end = min(beg + 4 * w, isize);
    uint32_t r = 0;
    for (int i = beg; i < end; ++i)
      r = s.crc_tab[(r ^ s.out[i]) & 0xff] ^ (r >> 8);
    const uint32_t shift = x8nmodp((uint32_t)(end - beg));
    uint32_t c = 0xffffffffu;
    for (int j = 0; j < 32; ++j) {
      const uint32_t rj = __shfl_sync(0xffffffffu, r, j);
      const uint32_t xj = __shfl_sync(0xffffffffu, shift, j);
      c = multmodp(xj, c) ^ rj;
    }
    if (~c != crc) st = kBadCrc;
  }
  if (st == kOk) {
    if (lane < 16 && isize + lane < ((isize + 15) & ~15))
      s.out[isize + lane] = 0;
    __syncwarp();
    const uint4* src = reinterpret_cast<const uint4*>(s.out);
    uint4* dst = reinterpret_cast<uint4*>(out);
    for (int k = lane; k < (isize + 15) >> 4; k += 32) dst[k] = src[k];
  }
  if (lane == 0) *status = st;
}

}  // namespace bgzf
