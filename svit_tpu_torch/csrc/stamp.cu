// The device marks of utils/tracing.py: a one-thread kernel that writes the
// global nanosecond timer into a slot of a device buffer.  Captured into a
// CUDA graph, the stamp is a kernel node like any other, so every replay
// writes its slot anew; the intervals between consecutive slots are the
// device time of the owners the program labels them with.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void stamp_kernel(unsigned long long* slot) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *slot = t;
}

extern "C" int svit_stamp(void* slot, cudaStream_t stream) {
  stamp_kernel<<<1, 1, 0, stream>>>(static_cast<unsigned long long*>(slot));
  return static_cast<int>(cudaGetLastError());
}
