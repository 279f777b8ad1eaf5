// bgzf_inflate: the BGZF blocks of a region load inflated on the card, a
// warp a block (the decoder and its design: bgzf_inflate.cuh).
//
// sniper_card_inflate is what the native loader calls, through the
// pointer the windowed driver registers with it (sniper_set_card_inflate):
// it stages one call's blocks in pinned memory, copies them up, inflates,
// copies the outputs and statuses back and waits, all on the calling
// thread's own stage (card_stage.cuh: its stream, events and buffers).
// The first CUDA error ends the card's part: it is returned by that call
// and by every later one, which then stage nothing.

#include <cuda_runtime.h>

#include <algorithm>
#include <atomic>
#include <cstring>
#include <vector>

#include "bgzf_inflate.cuh"
#include "card_stage.cuh"

namespace {

__global__ void __launch_bounds__(32)
    bgzf_inflate_kernel(const uint8_t* in, const long long* in_off,
                        const int* in_len, uint8_t* out,
                        const long long* out_off, const int* isize,
                        const unsigned* crc, int* status) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  bgzf::inflate_warp(in + in_off[b], in_len[b], out + out_off[b], isize[b],
                     crc[b], status + b,
                     *reinterpret_cast<bgzf::Smem*>(smem), threadIdx.x);
}

using card::kBatchBlocks;
using card::kCapIn;
using card::kCapOut;
static_assert(kCapOut == (size_t)kBatchBlocks * bgzf::kMaxOut,
              "a batch's outputs fill the stage's h_out");

std::atomic<long long> g_launches{0};  // kernel launches, for the counters
std::atomic<int> g_error{0};           // the first CUDA error, then kept

// A batch's descriptors, one array each, carved from one buffer.
struct Desc {
  long long *ioff, *ooff;
  int *ilen, *isize;
  unsigned* crc;
  int* st;
};

Desc carve(uint8_t* base) {
  Desc d;
  d.ioff = reinterpret_cast<long long*>(base);
  d.ooff = d.ioff + kBatchBlocks;
  d.ilen = reinterpret_cast<int*>(d.ooff + kBatchBlocks);
  d.isize = d.ilen + kBatchBlocks;
  d.crc = reinterpret_cast<unsigned*>(d.isize + kBatchBlocks);
  d.st = reinterpret_cast<int*>(d.crc + kBatchBlocks);
  return d;
}

inline size_t round16(size_t n) { return (n + 15) & ~(size_t)15; }

cudaError_t launch(const uint8_t* in, const long long* in_off,
                   const int* in_len, uint8_t* out, const long long* out_off,
                   const int* isize, const unsigned* crc, int* status, int n,
                   cudaStream_t stream) {
  if (n <= 0) return cudaSuccess;
  const int smem = (int)sizeof(bgzf::Smem);
  cudaError_t e = cudaFuncSetAttribute(
      bgzf_inflate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  bgzf_inflate_kernel<<<n, 32, smem, stream>>>(in, in_off, in_len, out,
                                               out_off, isize, crc, status);
  if ((e = cudaGetLastError()) == cudaSuccess) g_launches.fetch_add(1);
  return e;
}

}  // namespace

// sniper_card_inflate's work, on the calling thread's stage.
static cudaError_t inflate_blocks(int device, const void* comp,
                                  long long comp_len, int n_blocks,
                                  const void* in_off, const void* in_len,
                                  const void* isize, const void* crc,
                                  void* out, const void* out_off,
                                  void* status) {
  const uint8_t* src = static_cast<const uint8_t*>(comp);
  const long long* ioff = static_cast<const long long*>(in_off);
  const int* ilen = static_cast<const int*>(in_len);
  const int* osize = static_cast<const int*>(isize);
  const unsigned* bcrc = static_cast<const unsigned*>(crc);
  const long long* ooff = static_cast<const long long*>(out_off);
  uint8_t* dst = static_cast<uint8_t*>(out);
  int* st = static_cast<int*>(status);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  card::Stage* s;
  if ((e = card::stage_for(device, &s)) != cudaSuccess) return e;
  const Desc h = carve(s->h_desc), d = carve(s->d_desc);
  int b = 0;
  while (b < n_blocks) {
    // fill a batch: blocks past the BGZF ceilings, or outside comp, are
    // left to the caller's host inflate
    int n = 0;
    std::vector<int> which;
    size_t in_used = 0, out_used = 0;
    for (; b < n_blocks && n < kBatchBlocks; ++b) {
      if (ilen[b] < 0 || ilen[b] > bgzf::kMaxIn || osize[b] < 0 ||
          osize[b] > bgzf::kMaxOut || ioff[b] < 0 ||
          ioff[b] + ilen[b] > comp_len) {
        st[b] = bgzf::kTooLarge;
        continue;
      }
      const size_t need_in = round16((size_t)ilen[b]);
      const size_t need_out = round16((size_t)osize[b]);
      if (in_used + need_in > kCapIn || out_used + need_out > kCapOut) break;
      std::memcpy(s->h_in + in_used, src + ioff[b], (size_t)ilen[b]);
      h.ioff[n] = (long long)in_used;
      h.ooff[n] = (long long)out_used;
      h.ilen[n] = ilen[b];
      h.isize[n] = osize[b];
      h.crc[n] = bcrc[b];
      which.push_back(b);
      in_used += need_in;
      out_used += need_out;
      ++n;
    }
    if (n == 0) continue;
    // the descriptors up to the statuses, which the kernel writes
    const size_t desc = (uint8_t*)h.st - s->h_desc;
    if ((e = cudaMemcpyAsync(s->d_desc, s->h_desc, desc,
                             cudaMemcpyHostToDevice, s->stream)) ||
        (e = cudaMemcpyAsync(s->d_in, s->h_in, in_used,
                             cudaMemcpyHostToDevice, s->stream)) ||
        (e = launch(s->d_in, d.ioff, d.ilen, s->d_out, d.ooff, d.isize, d.crc,
                    d.st, n, s->stream)) ||
        (e = cudaMemcpyAsync(s->h_out, s->d_out, out_used,
                             cudaMemcpyDeviceToHost, s->stream)) ||
        (e = cudaMemcpyAsync(h.st, d.st, (size_t)n * 4,
                             cudaMemcpyDeviceToHost, s->stream)) ||
        (e = card::wait(s)))
      return e;
    for (int i = 0; i < n; ++i) {
      st[which[i]] = h.st[i];
      if (h.st[i] == bgzf::kOk)
        std::memcpy(dst + ooff[which[i]], s->h_out + h.ooff[i],
                    (size_t)h.isize[i]);
    }
  }
  return cudaSuccess;
}

// Host buffers in, host buffers out: block b's stream is in_len[b] bytes at
// comp + in_off[b], its output goes to out + out_off[b] (isize[b] bytes,
// written only where status[b] is 0).  Returns 0, or the CUDA error that
// stopped this call or an earlier one (the statuses are then not all
// written, and the caller fails its load).
extern "C" int sniper_card_inflate(int device, const void* comp,
                                   long long comp_len, int n_blocks,
                                   const void* in_off, const void* in_len,
                                   const void* isize, const void* crc,
                                   void* out, const void* out_off,
                                   void* status) {
  if (const int failed = g_error.load()) return failed;
  const cudaError_t e =
      inflate_blocks(device, comp, comp_len, n_blocks, in_off, in_len, isize,
                     crc, out, out_off, status);
  if (e != cudaSuccess) {
    int none = 0;
    g_error.compare_exchange_strong(none, (int)e);
  }
  return (int)e;
}

// Launches of bgzf_inflate_kernel since the library was loaded, counted
// where they are made (the port's STATS read it as launches_bgzf_inflate).
extern "C" long long sniper_bgzf_inflate_launches() {
  return g_launches.load();
}
