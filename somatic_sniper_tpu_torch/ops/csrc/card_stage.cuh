// card_stage: the per-thread stream, events and buffers that the region
// loads' card calls (bgzf_inflate.cu, pileup_build.cu) run on.
//
// The native loader's pool threads call the card at once, each on its own
// stage, so their copies and kernels overlap on the card.  A thread's
// calls run one after another (its region's inflate, then its pileup
// build), so they share its pinned buffers: the host memory a pool thread
// pins is the inflate's, whatever else it does.  A thread that exits hands
// its stage to the next one (a process-wide free list), so a new pool pins
// and allocates nothing anew.  Waits block on events made with
// cudaEventBlockingSync: the host's cores, not the card, set the pace, and
// a spinning wait would take one of them from every waiting thread.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace card {

// The inflate's batch: 256 blocks of at most 64 KiB out, 8 MiB in.
constexpr int kBatchBlocks = 256;
constexpr size_t kCapIn = 8u << 20;
constexpr size_t kCapOut = (size_t)kBatchBlocks * 65536;
// descriptors: in_off, out_off (i64), in_len, isize, crc, status (i32)
constexpr size_t kDescBytes = (size_t)kBatchBlocks * (8 + 8 + 4 + 4 + 4 + 4);

// A device buffer that grows to the largest size asked of it.
struct DevBuf {
  void* p = nullptr;
  size_t cap = 0;
};

struct Stage {
  int device = -1;
  cudaStream_t stream = nullptr;
  cudaEvent_t done = nullptr;
  // one a half of h_in: the copy that last used the half
  cudaEvent_t in_free[2] = {nullptr, nullptr};
  uint8_t *h_in = nullptr, *h_out = nullptr, *h_desc = nullptr;  // pinned
  uint8_t *d_in = nullptr, *d_out = nullptr, *d_desc = nullptr;
  unsigned in_turn = 0;  // the half of h_in that upload fills next
  DevBuf buf[12];  // the pileup build's arrays (pileup_build.cu)
};

// The calling thread's stage on ``device``: its own, one from the free
// list, or a new one.
cudaError_t stage_for(int device, Stage** out);

// ``b`` holding at least ``bytes`` (its contents are not kept).
cudaError_t grow(DevBuf& b, size_t bytes);

// ``n`` bytes from host ``src`` to device ``dst`` on the stage's stream,
// through h_in in two halves (a half is refilled once its copy is done).
// Returns with the copies queued.
cudaError_t upload(Stage* s, void* dst, const void* src, size_t n);

// Wait for everything queued on the stage's stream.
cudaError_t wait(Stage* s);

}  // namespace card
