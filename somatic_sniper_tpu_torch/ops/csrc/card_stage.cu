// card_stage: the per-thread stages of the region loads' card calls (see
// card_stage.cuh).

#include "card_stage.cuh"

#include <algorithm>
#include <cstring>
#include <mutex>
#include <vector>

namespace card {
namespace {

std::mutex g_free_mu;
std::vector<Stage*> g_free;  // never freed: a process keeps its stages

struct StageHolder {
  Stage* s = nullptr;
  ~StageHolder() {
    if (s) {
      std::lock_guard<std::mutex> lk(g_free_mu);
      g_free.push_back(s);
    }
  }
};
thread_local StageHolder t_stage;

void free_stage(Stage* s) {
  if (s->stream) cudaStreamDestroy(s->stream);
  for (cudaEvent_t e : {s->done, s->in_free[0], s->in_free[1]})
    if (e) cudaEventDestroy(e);
  if (s->h_in) cudaFreeHost(s->h_in);
  if (s->h_out) cudaFreeHost(s->h_out);
  if (s->h_desc) cudaFreeHost(s->h_desc);
  if (s->d_in) cudaFree(s->d_in);
  if (s->d_out) cudaFree(s->d_out);
  if (s->d_desc) cudaFree(s->d_desc);
  for (DevBuf& b : s->buf)
    if (b.p) cudaFree(b.p);
  delete s;
}

cudaError_t make_event(cudaEvent_t* e) {
  return cudaEventCreateWithFlags(
      e, cudaEventBlockingSync | cudaEventDisableTiming);
}

cudaError_t make_stage(int device, Stage** out) {
  Stage* s = new Stage();
  s->device = device;
  cudaError_t e;
  if ((e = cudaStreamCreateWithFlags(&s->stream, cudaStreamNonBlocking)) ||
      (e = make_event(&s->done)) || (e = make_event(&s->in_free[0])) ||
      (e = make_event(&s->in_free[1])) ||
      (e = cudaMallocHost(&s->h_in, kCapIn)) ||
      (e = cudaMallocHost(&s->h_out, kCapOut)) ||
      (e = cudaMallocHost(&s->h_desc, kDescBytes)) ||
      (e = cudaMalloc(&s->d_in, kCapIn)) ||
      (e = cudaMalloc(&s->d_out, kCapOut)) ||
      (e = cudaMalloc(&s->d_desc, kDescBytes)) ||
      // the halves start free: a record on an empty stream
      (e = cudaEventRecord(s->in_free[0], s->stream)) ||
      (e = cudaEventRecord(s->in_free[1], s->stream))) {
    free_stage(s);  // the call fails, and with it the load
    return e;
  }
  *out = s;
  return cudaSuccess;
}

}  // namespace

cudaError_t stage_for(int device, Stage** out) {
  Stage*& mine = t_stage.s;
  if (mine && mine->device != device) {
    std::lock_guard<std::mutex> lk(g_free_mu);
    g_free.push_back(mine);
    mine = nullptr;
  }
  if (!mine) {
    std::lock_guard<std::mutex> lk(g_free_mu);
    for (size_t i = 0; i < g_free.size(); ++i) {
      if (g_free[i]->device == device) {
        mine = g_free[i];
        g_free.erase(g_free.begin() + i);
        break;
      }
    }
  }
  if (!mine) {
    cudaError_t e = make_stage(device, &mine);
    if (e != cudaSuccess) {
      mine = nullptr;
      return e;
    }
  }
  *out = mine;
  return cudaSuccess;
}

cudaError_t grow(DevBuf& b, size_t bytes) {
  if (bytes <= b.cap) return cudaSuccess;
  // a quarter more than asked, so that a slightly larger region later
  // allocates nothing (cudaFree waits for the whole device)
  const size_t cap = std::max<size_t>(bytes + bytes / 4, 1u << 16);
  if (b.p) {
    cudaError_t e = cudaFree(b.p);
    b.p = nullptr;
    b.cap = 0;
    if (e != cudaSuccess) return e;
  }
  cudaError_t e = cudaMalloc(&b.p, cap);
  if (e == cudaSuccess) b.cap = cap;
  return e;
}

cudaError_t upload(Stage* s, void* dst, const void* src, size_t n) {
  constexpr size_t half = kCapIn / 2;
  cudaError_t e;
  for (size_t done = 0; done < n; done += half) {
    const size_t k = std::min(half, n - done);
    const unsigned i = s->in_turn++;
    uint8_t* h = s->h_in + (i & 1) * half;
    if ((e = cudaEventSynchronize(s->in_free[i & 1]))) return e;
    std::memcpy(h, static_cast<const uint8_t*>(src) + done, k);
    if ((e = cudaMemcpyAsync(static_cast<uint8_t*>(dst) + done, h, k,
                             cudaMemcpyHostToDevice, s->stream)) ||
        (e = cudaEventRecord(s->in_free[i & 1], s->stream)))
      return e;
  }
  return cudaSuccess;
}

cudaError_t wait(Stage* s) {
  cudaError_t e = cudaEventRecord(s->done, s->stream);
  return e ? e : cudaEventSynchronize(s->done);
}

}  // namespace card
