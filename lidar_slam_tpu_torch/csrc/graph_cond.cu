// CUDA graph conditional (IF) nodes recorded during a stream capture: the
// port's counterpart of jax.lax.cond inside a jitted step
// (utils/graphs.py::cond). Not a kernel of the JAX package: the one kernel
// here sets a node's condition from a device bool.
//
// slam_if_begin(capture, child, pred), while `capture` is being captured:
//   1. a conditional handle on the graph being captured (default 0, not
//      reset between launches: the kernel below sets it on every launch);
//   2. a one-thread kernel, captured on `capture`, that sets the handle from
//      the device bool *pred when the graph runs;
//   3. an IF node after it (cudaGraphAddNode), which becomes the capture's
//      only dependency, so whatever is captured next runs after the branch;
//   4. a capture of `child` into the IF node's body graph
//      (cudaStreamBeginCaptureToGraph): work launched on `child` until
//      slam_if_end(child) runs only when *pred held.
// A body may hold only kernels, memsets, device-to-device copies and
// further conditional nodes (CUDA 12.4 and later).
//
// Both return a cudaError_t; 0 is success.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int slam_if_begin(void* capture_ptr, void* child_ptr,
                             const void* pred) {
  cudaStream_t capture = static_cast<cudaStream_t>(capture_ptr);
  cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(capture, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorIllegalState;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, capture>>>(handle,
                                      static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the set kernel is now the capture's dependency
  err = cudaStreamGetCaptureInfo(capture, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(capture, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(child, params.conditional.phGraph_out[0],
                                       nullptr, nullptr, 0,
                                       cudaStreamCaptureModeRelaxed);
}

extern "C" int slam_if_end(void* child_ptr) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child_ptr), &body);
}
