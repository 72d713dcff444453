// Device time stamps for the traced step (sm_90a): one thread reads the
// card's %globaltimer and appends (tag, ns) to a ring in device memory.
//
// Replaces no TPU kernel. The tracer (utils/profiler.py) needs the card's
// own times at the step's module boundaries, and a step replayed as a CUDA
// graph is one launch from the host: neither torch.profiler's ranges nor
// its correlation ids reach inside it. A stamp launched on the step's
// stream runs once the work before it has finished, and under capture it
// becomes a node of the graph, so every replay writes new slots: the slot
// comes from a counter kept on the card, not from the host. (CUDA events
// recorded in a graph are the same handles on every replay, overwritten
// long before the host could read them.)
//
// What bounds it on this card: the launch (a few microseconds, one thread,
// two 8-byte stores). It runs only while tracing is on.
//
// The ring: slots (capacity, 2) int64, count (1,) int64. A stamp takes slot
// count++ (an atomic add, so stamps from several streams of one card keep
// the order they ran in); once count reaches the capacity it writes nothing
// and the count goes on, so the host reads the drops as count - capacity.

#include <cuda_runtime.h>

namespace {

__global__ void stamp_kernel(long long* slots, unsigned long long* count,
                             unsigned long long capacity, long long tag) {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  const unsigned long long i = atomicAdd(count, 1ULL);
  if (i < capacity) {
    slots[2 * i] = tag;
    slots[2 * i + 1] = (long long)ns;
  }
}

}  // namespace

extern "C" int stamp_launch(void* slots, void* count, long long capacity,
                            long long tag, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (long long*)slots, (unsigned long long*)count,
      (unsigned long long)capacity, tag);
  return (int)cudaGetLastError();
}

extern "C" const char* stamp_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
