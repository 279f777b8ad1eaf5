// The card's BGZF inflate decoder (ops/csrc/bgzf_inflate.cuh) compiled for
// the host: a warp's 32 lanes run as 32 fibers on one thread, switching at
// every __syncwarp, so the kernel's own source can be held to zlib on a
// machine without a card.
//
// The lanes run from one barrier to the next in turn, forward in even
// rounds and backward in odd ones: a lane that reads what another lane
// wrote without a barrier between them reads stale bytes in one of the two
// orders.  Every lane must pass the same barriers; a lane that passes a
// different number fails the call.
//
//   g++ -O2 -std=c++17 -shared -fPIC -I <csrc> -o emul.so bgzf_warp_emul.cpp

#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace emul {

constexpr int kLanes = 32;
ucontext_t g_main, g_ctx[kLanes];
int g_cur = 0;
bool g_done[kLanes];
long g_syncs[kLanes];
uint64_t g_slot[kLanes];

inline void sync() {
  ++g_syncs[g_cur];
  swapcontext(&g_ctx[g_cur], &g_main);
}

template <typename T>
T exchange(T v, int src) {
  g_slot[g_cur] = (uint64_t)v;
  sync();
  const T r = (T)g_slot[src];
  sync();
  return r;
}

}  // namespace emul

#define __device__
#define __forceinline__ inline
#define __constant__

struct uint4 {
  uint32_t x, y, z, w;
};

inline void __syncwarp(unsigned = 0xffffffffu) { emul::sync(); }
template <typename T>
inline T __shfl_sync(unsigned, T v, int src) {
  return emul::exchange(v, src & 31);
}
inline unsigned __match_any_sync(unsigned, int v) {
  emul::g_slot[emul::g_cur] = (uint64_t)(int64_t)v;
  emul::sync();
  unsigned m = 0;
  for (int j = 0; j < emul::kLanes; ++j)
    if (emul::g_slot[j] == (uint64_t)(int64_t)v) m |= 1u << j;
  emul::sync();
  return m;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline unsigned __brev(unsigned v) {
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= ((v >> i) & 1u) << (31 - i);
  return r;
}
template <typename T>
inline T __ldg(const T* p) {
  return *p;
}
using std::min;

#include "bgzf_inflate.cuh"

namespace {

struct Call {
  const uint8_t* in;
  int in_len;
  uint8_t* out;
  int isize;
  uint32_t crc;
  int32_t status;
  bgzf::Smem* smem;
};
Call g_call;

void lane_main(int lane) {
  bgzf::inflate_warp(g_call.in, g_call.in_len, g_call.out, g_call.isize,
                     g_call.crc, &g_call.status, *g_call.smem, lane);
  emul::g_done[lane] = true;
}

}  // namespace

// Inflate one block as the kernel does: ``in`` must be 4-byte aligned and
// ``out`` 16-byte aligned with room for ``isize`` rounded up to 16.
// Returns the block's status, or -1 when the lanes passed different
// numbers of barriers.
extern "C" int emul_inflate(const void* in, int in_len, void* out, int isize,
                            unsigned crc) {
  constexpr size_t kStack = 256 << 10;
  static char* stacks = static_cast<char*>(malloc(kStack * emul::kLanes));
  bgzf::Smem* smem = static_cast<bgzf::Smem*>(
      aligned_alloc(16, (sizeof(bgzf::Smem) + 15) & ~15));
  memset(smem, 0xa5, sizeof(bgzf::Smem));  // shared memory starts as garbage
  g_call = {static_cast<const uint8_t*>(in), in_len,
            static_cast<uint8_t*>(out), isize, crc, -2, smem};
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
    for (int t = 0; t < emul::kLanes; ++t) {
      const int l = (round & 1) ? emul::kLanes - 1 - t : t;
      if (emul::g_done[l]) continue;
      emul::g_cur = l;
      swapcontext(&emul::g_main, &emul::g_ctx[l]);
      left += !emul::g_done[l];
    }
    if (!left) break;
  }
  free(smem);
  for (int l = 1; l < emul::kLanes; ++l)
    if (emul::g_syncs[l] != emul::g_syncs[0]) return -1;
  return g_call.status;
}
