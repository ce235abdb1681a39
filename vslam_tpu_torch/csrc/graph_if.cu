// CUDA-graph conditional IF nodes made during a stream capture (sm_90a),
// plain C interface for ctypes. Built into the same library as
// hamming_top2.cu.
//
// vslam_if_begin opens an IF node in the graph that a stream is capturing:
// a one-thread kernel that sets the node's condition from a device bool,
// then the node itself, after everything captured on that stream so far;
// the stream's capture continues after the node. A second stream, not
// capturing, then captures into the node's body graph until vslam_if_end.
// At replay the body runs only where the bool held when the condition
// kernel ran. Needs CUDA 12.3 or later (conditional nodes and
// cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle,
                              const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

// The graph a stream is capturing and the nodes its next node depends on.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, n_deps);
#endif
  if (err == cudaSuccess && status != cudaStreamCaptureStatusActive) {
    return cudaErrorIllegalState;
  }
  return err;
}

}  // namespace

extern "C" {

// Open an IF node on *pred in the graph ``stream`` captures, and begin the
// capture of its body on ``body``. Returns a cudaError_t (0 = opened).
int vslam_if_begin(void* stream, const void* pred, void* body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_if_kernel<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal));
}

// End the body's capture that vslam_if_begin began on ``body``.
int vslam_if_end(void* body) {
  cudaGraph_t graph;
  return static_cast<int>(
      cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

// A stream of its own (non-blocking), for the bodies' captures.
int vslam_stream_create(void** stream) {
  return static_cast<int>(cudaStreamCreateWithFlags(
      reinterpret_cast<cudaStream_t*>(stream), cudaStreamNonBlocking));
}

}  // extern "C"
