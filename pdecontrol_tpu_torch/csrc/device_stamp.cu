// Device stamps: one thread reads the card's global nanosecond timer
// (%globaltimer) and writes it into an int64 slot, or adds it to the slot
// with a sign.  A pair of stamps, one subtracting and one adding, leaves the
// time between them in the slot; replayed N times inside a CUDA graph, the
// sum of N such times.  The kernel is queued on the caller's stream like any
// other, so it runs when the work queued before it has finished, and inside
// a stream capture it becomes a kernel node of the graph.
//
// No counterpart in the JAX package: it is the tracing of
// pdecontrol_tpu_torch/utils/profiling.py.  Plain C interface (built with
// nvcc into a shared library, called through ctypes); it returns
// cudaGetLastError() after the launch.

#include <cuda_runtime.h>

namespace {

// How a stamp writes its slot (profiling.py's SET, ADD, SUB).
constexpr int kSet = 0;
constexpr int kAdd = 1;

__global__ void device_stamp_kernel(long long* slot, int mode) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const long long v = static_cast<long long>(t);
  if (mode == kSet) {
    *slot = v;
  } else if (mode == kAdd) {
    *slot += v;
  } else {
    *slot -= v;
  }
}

}  // namespace

extern "C" int device_stamp(void* slot, int mode, void* stream) {
  device_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(slot), mode);
  return static_cast<int>(cudaGetLastError());
}
