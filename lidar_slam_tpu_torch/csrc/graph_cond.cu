// CUDA graph conditional nodes recorded during a stream capture: the port's
// counterparts of jax.lax.cond (IF nodes, utils/graphs.py::cond) and of a
// lax.scan over a device count of rows (WHILE nodes,
// utils/graphs.py::while_loop) inside a jitted step. Not a kernel of the
// JAX package: the one kernel here sets a node's condition from a device
// bool.
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
// slam_while_begin(capture, child, pred, &handle) does the same with a
// WHILE node, whose body runs again for as long as the handle holds; it
// returns the handle. slam_while_end(child, handle, pred) captures the set
// kernel once more at the body's end, on `child`, so each iteration ends
// by setting the handle from *pred as the body left it (the body rewrites
// *pred in place), and then ends the body's capture. A *pred that is false
// before the node runs the body no time.
// A body may hold only kernels, memsets, device-to-device copies and
// further conditional nodes (CUDA 12.4 and later).
//
// All return a cudaError_t; 0 is success.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t conditional_begin(cudaStream_t capture, cudaStream_t child,
                              const bool* pred, cudaGraphConditionalNodeType
                              type, cudaGraphConditionalHandle* handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = cudaStreamGetCaptureInfo(capture, &status, nullptr,
                                             &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive)
    return cudaErrorIllegalState;
  err = cudaGraphConditionalHandleCreate(handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_condition<<<1, 1, 0, capture>>>(*handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the set kernel is now the capture's dependency
  err = cudaStreamGetCaptureInfo(capture, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = *handle;
  params.conditional.type = type;
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

cudaError_t body_end(cudaStream_t child) {
  cudaGraph_t body;
  return cudaStreamEndCapture(child, &body);
}

}  // namespace

extern "C" int slam_if_begin(void* capture_ptr, void* child_ptr,
                             const void* pred) {
  cudaGraphConditionalHandle handle;
  return conditional_begin(static_cast<cudaStream_t>(capture_ptr),
                           static_cast<cudaStream_t>(child_ptr),
                           static_cast<const bool*>(pred),
                           cudaGraphCondTypeIf, &handle);
}

extern "C" int slam_if_end(void* child_ptr) {
  return body_end(static_cast<cudaStream_t>(child_ptr));
}

extern "C" int slam_while_begin(void* capture_ptr, void* child_ptr,
                                const void* pred,
                                unsigned long long* handle_out) {
  cudaGraphConditionalHandle handle;
  cudaError_t err = conditional_begin(
      static_cast<cudaStream_t>(capture_ptr),
      static_cast<cudaStream_t>(child_ptr), static_cast<const bool*>(pred),
      cudaGraphCondTypeWhile, &handle);
  *handle_out = handle;
  return err;
}

extern "C" int slam_while_end(void* child_ptr, unsigned long long handle,
                              const void* pred) {
  cudaStream_t child = static_cast<cudaStream_t>(child_ptr);
  set_condition<<<1, 1, 0, child>>>(
      static_cast<cudaGraphConditionalHandle>(handle),
      static_cast<const bool*>(pred));
  cudaError_t err = cudaGetLastError();
  cudaError_t end = body_end(child);
  return err != cudaSuccess ? err : end;
}
