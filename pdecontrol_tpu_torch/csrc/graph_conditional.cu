// Conditional (IF) nodes in a CUDA graph that is being captured from a
// stream.  `graph_if_begin` adds to the graph that `stream` is capturing a
// one-thread kernel that copies a bool on the card into a conditional
// handle, then an IF node on that handle, makes the node the stream's
// capture dependency, and starts capturing `body_stream` into the node's
// body graph.  Work queued on `body_stream` until `graph_if_end` forms the
// body, which each launch of the graph runs only where the bool held when
// the kernel read it.  Work queued on `stream` after the node runs after
// it, whether or not the body ran.  `graph_upload` uploads an instantiated
// graph before its first launch.
//
// No counterpart in the JAX package, where `lax.cond` or `lax.select`
// decides on the device.  PyTorch 2.11 binds no conditional node of its
// own.  Plain C interface (built with nvcc into a shared library, called
// through ctypes from pdecontrol_tpu_torch/utils/graphs.py); each function
// returns a cudaError_t, 0 on success.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const bool* cond) {
  cudaGraphSetConditional(handle, *cond ? 1u : 0u);
}

}  // namespace

extern "C" int graph_if_begin(const void* cond, void* stream, void* body_stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;

  // Reset to 0 at every launch of the graph; the kernel sets it before the
  // node runs.
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(cond));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The node depends on what the capture has reached: the kernel.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                       params.conditional.phGraph_out[0], nullptr,
                                       nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_end(void* body_stream) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &body);
}

// Uploads an executable graph on `stream`: the work its first launch would
// otherwise do.
extern "C" int graph_upload(void* exec, void* stream) {
  return cudaGraphUpload(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}
