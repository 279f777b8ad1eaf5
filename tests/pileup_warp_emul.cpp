// The card's pileup build (ops/csrc/pileup_build.cuh) compiled for the
// host, behind the same C entry as the card's sniper_card_pileup, so that
// the native loader can hand its region builds to it on a machine without
// a card.  The steps run as the kernels run them: cover a read at a time;
// scan as the block's 1024 threads, each pass over every thread before
// the block's prefix sums; scatter a tile at a time, its warp's 32 lanes
// as 32 fibers on one thread that switch at every warp collective
// (__ballot_sync, __shfl_sync, __shfl_xor_sync); pure a column at a time.
//
// The lanes run from one collective to the next in turn, forward in even
// rounds and backward in odd ones, so a lane that reads what another lane
// wrote without a collective between them reads stale bytes in one of the
// two orders.  A collective's values sit in one of two slot arrays,
// alternately, so that each takes a single switch.  Every lane must pass
// the same collectives; a tile whose lanes do not fails the call.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC -I <csrc>
//       -o emul.so pileup_warp_emul.cpp

#include <ucontext.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace emul {

constexpr int kLanes = 32;
ucontext_t g_main, g_ctx[kLanes];
int g_cur = 0;
bool g_done[kLanes];
long g_syncs[kLanes];
uint64_t g_slot[2][kLanes];

inline void sync() {
  ++g_syncs[g_cur];
  swapcontext(&g_ctx[g_cur], &g_main);
}

// Every lane's ``v``, after one switch; ``each(slots)`` reads them.
template <typename F>
auto collect(uint64_t v, F each) {
  uint64_t* slot = g_slot[g_syncs[g_cur] & 1];
  slot[g_cur] = v;
  sync();
  return each(slot);
}

}  // namespace emul

#define __device__
#define __forceinline__ inline

inline unsigned __ballot_sync(unsigned, bool p) {
  return emul::collect(p, [](const uint64_t* s) {
    unsigned m = 0;
    for (int j = 0; j < emul::kLanes; ++j)
      if (s[j]) m |= 1u << j;
    return m;
  });
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return emul::collect(v, [src](const uint64_t* s) {
    return (unsigned)s[src];
  });
}
inline long long __shfl_xor_sync(unsigned, long long v, int o) {
  const int src = emul::g_cur ^ o;
  return emul::collect((uint64_t)v, [src](const uint64_t* s) {
    return (long long)s[src];
  });
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  const unsigned old = *p;
  *p = old + v;
  return old;
}
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
using std::fma;

#include "pileup_build.cuh"

namespace {

constexpr int kScanThreads = 1024;  // the scan kernel's block

long long g_calls = 0, g_launches = 0, g_released = 0;
int g_fused = -1;  // -1: as the caller says; 0 or 1: forced

struct Tile {
  const uint8_t* bytes;
  const uint32_t* rec;
  const int* pos;
  int n_reads;
  long long lo, p0, p1, max_len;
  const uint32_t* cur0;
  uint32_t* cur;
  uint32_t* slots;
};
Tile g_tile;

void lane_main(int lane) {
  const Tile& t = g_tile;
  pileup::scatter_tile(lane, t.bytes, t.rec, t.pos, t.n_reads, t.lo, t.p0,
                       t.p1, t.max_len, t.cur0, t.cur, t.slots);
  emul::g_done[lane] = true;
}

// One tile's warp; false when its lanes passed different collectives.
bool run_warp() {
  constexpr size_t kStack = 64 << 10;
  static char* stacks = static_cast<char*>(malloc(kStack * emul::kLanes));
  for (int l = 0; l < emul::kLanes; ++l) {
    emul::g_done[l] = false;
    emul::g_syncs[l] = 0;
    getcontext(&emul::g_ctx[l]);
    emul::g_ctx[l].uc_stack.ss_sp = stacks + kStack * l;
    emul::g_ctx[l].uc_stack.ss_size = kStack;
    emul::g_ctx[l].uc_link = &emul::g_main;
    makecontext(&emul::g_ctx[l], (void (*)())lane_main, 1, l);
  }
  for (int round = 0;; ++round) {
    int left = 0;
    for (int k = 0; k < emul::kLanes; ++k) {
      const int l = (round & 1) ? emul::kLanes - 1 - k : k;
      if (emul::g_done[l]) continue;
      emul::g_cur = l;
      swapcontext(&emul::g_main, &emul::g_ctx[l]);
      left += !emul::g_done[l];
    }
    if (!left) break;
  }
  for (int l = 1; l < emul::kLanes; ++l)
    if (emul::g_syncs[l] != emul::g_syncs[0]) return false;
  return true;
}

// Exclusive prefix sums of v, in place; returns the total.
uint32_t exclusive(std::vector<uint32_t>& v) {
  uint32_t run = 0;
  for (uint32_t& x : v) {
    const uint32_t y = x;
    x = run;
    run += y;
  }
  return run;
}

}  // namespace

// sniper_card_pileup's contract (pileup_build.cu), run on the host: the
// arrays in one malloc'd buffer (emul_card_release frees it).  Returns 0,
// or 1 where a tile's lanes passed different collectives.
extern "C" int emul_card_pileup(int, const void* bytes_v, long long n_bytes,
                                const void* rec_v, int n_reads, int tid,
                                long long lo, long long hi,
                                long long max_len, const void* ref_v,
                                long long n_ref, const void* fk_v,
                                const void* gmin_v, double margin, int fused,
                                void* out_v, void* counts_v) {
  ++g_calls;
  const long long span = hi > lo ? hi - lo : 0;
  std::vector<long long> ukeys(span), offsets(span + 1);
  std::vector<uint32_t> slots;
  std::vector<uint8_t> pure;
  long long n_cols = 0, n_entries = 0;
  if (n_reads > 0 && span > 0) {
    ++g_launches;
    const auto* rec = static_cast<const long long*>(rec_v);
    const long long base = *std::min_element(rec, rec + n_reads);
    // the bytes as the card holds them: from the first record on
    std::vector<uint8_t> bytes(static_cast<const uint8_t*>(bytes_v) + base,
                               static_cast<const uint8_t*>(bytes_v) + n_bytes);
    bytes.resize(bytes.size() + 4);
    std::vector<uint32_t> rec32(n_reads);
    for (int r = 0; r < n_reads; ++r) rec32[r] = (uint32_t)(rec[r] - base);
    std::vector<uint32_t> diff(span + 1, 0);
    std::vector<int> pos(n_reads);
    for (int r = 0; r < n_reads; ++r)
      pileup::cover_read(bytes.data(), rec32.data(), r, lo, hi, diff.data(),
                         pos.data());
    // the scan block, pass by pass
    std::vector<long long> first(kScanThreads), last(kScanThreads);
    std::vector<uint32_t> d0(kScanThreads), c0(kScanThreads),
        e0(kScanThreads);
    for (int t = 0; t < kScanThreads; ++t) {
      pileup::scan_range(span, t, kScanThreads, &first[t], &last[t]);
      d0[t] = pileup::scan_sum(diff.data(), first[t], last[t]);
    }
    exclusive(d0);
    for (int t = 0; t < kScanThreads; ++t)
      pileup::scan_count(diff.data(), first[t], last[t], d0[t], &c0[t],
                         &e0[t]);
    n_cols = exclusive(c0);
    n_entries = exclusive(e0);
    for (int t = 0; t < kScanThreads; ++t)
      pileup::scan_write(diff.data(), first[t], last[t], d0[t], c0[t], e0[t],
                         lo, (long long)tid << 40, ukeys.data(),
                         offsets.data());
    offsets[n_cols] = n_entries;
    // scatter, a warp a tile
    slots.resize(n_entries + 1);
    const int tile = pileup::tile_width(n_entries, span);
    std::vector<uint32_t> cur(tile);
    for (long long p0 = lo; p0 < hi; p0 += tile) {
      g_tile = {bytes.data(), rec32.data(), pos.data(), n_reads, lo, p0,
                std::min(p0 + tile, hi), max_len, diff.data(), cur.data(),
                slots.data()};
      if (!run_warp()) return 1;
    }
    pure.resize(n_cols);
    if (ref_v) {
      const auto* ref = static_cast<const uint8_t*>(ref_v);
      const long long n_codes = std::min(std::max(n_ref, 0LL), span);
      const bool fu = g_fused < 0 ? fused != 0 : g_fused != 0;
      for (long long c = 0; c < n_cols; ++c) {
        const long long rel = (ukeys[c] & ((1LL << 40) - 1)) - lo;
        pure[c] = pileup::pure_column(
            slots.data(), offsets[c], offsets[c + 1],
            rel < n_codes ? ref[rel] : 0, static_cast<const double*>(fk_v),
            static_cast<const double*>(gmin_v), margin, fu);
      }
    }
  }
  // the card's layout: ukeys, offsets, slots, flags, one after another
  const size_t o_off = n_cols * 8, o_slots = o_off + (n_cols + 1) * 8,
               o_pure = o_slots + n_entries * 4;
  auto* buf = static_cast<uint8_t*>(malloc(o_pure + n_cols + 8));
  std::memcpy(buf, ukeys.data(), n_cols * 8);
  std::memcpy(buf + o_off, offsets.data(), (n_cols + 1) * 8);
  std::memcpy(buf + o_slots, slots.data(), n_entries * 4);
  std::memcpy(buf + o_pure, pure.data(), n_cols);
  void** out = static_cast<void**>(out_v);
  out[0] = buf;
  out[1] = buf;
  out[2] = buf + o_off;
  out[3] = buf + o_slots;
  out[4] = buf + o_pure;
  static_cast<long long*>(counts_v)[0] = n_cols;
  static_cast<long long*>(counts_v)[1] = n_entries;
  return 0;
}

extern "C" void emul_card_release(void* buffer) {
  ++g_released;
  free(buffer);
}

// Calls, calls that ran the build, and buffers released, since the
// library was loaded.
extern "C" void emul_counts(long long* out) {
  out[0] = g_calls;
  out[1] = g_launches;
  out[2] = g_released;
}

// Force the flags' chain fused (1) or not (0), or take the caller's (-1).
extern "C" void emul_set_fused(int f) { g_fused = f; }
