// One clock reading on the device's stream: a single thread writes
// %globaltimer (the GPU's global nanosecond timer, one for every SM) to
// out[slot]. Captured into a CUDA graph it is an ordinary kernel node,
// which every replay runs again; obs/device.py marks the phases of a
// training update with it.

#include <cuda_runtime.h>

namespace {

__global__ void globaltimer_kernel(unsigned long long* out) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  *out = t;
}

}  // namespace

// Plain C entry point (bound with ctypes). Launches one thread on
// `stream` that writes the timer to out[slot]; does not synchronise and
// allocates nothing. Returns cudaGetLastError() after the launch.
extern "C" int globaltimer_stamp(void* out, long long slot, void* stream) {
  globaltimer_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(out) + slot);
  return static_cast<int>(cudaGetLastError());
}
