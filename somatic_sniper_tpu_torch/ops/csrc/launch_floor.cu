// launch_floor: an empty kernel, for measuring what a launch costs.
//
// Replaces no TPU kernel and is on no path.  The glfgen kernels move about
// a megabyte per slab, which the memory system takes in under half a
// microsecond: what a small launch costs on the device (the gap between
// two kernels queued back to back, the blocks' start and drain) is the
// floor under their times, and this kernel, which does nothing, measures
// it at a grid of the same kind.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int sniper_empty_launch(int blocks, int threads, void* stream) {
  if (blocks <= 0 || threads <= 0 || threads > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
