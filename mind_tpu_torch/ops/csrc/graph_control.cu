// Device-side control flow for captured CUDA graphs: the condition kernel
// and the host calls that add IF and WHILE conditional nodes to the graph a
// stream is capturing (mind_tpu_torch/ops/graph_control.py binds them).
//
// It replaces no TPU kernel: it is the H100's counterpart of the control
// flow that XLA keeps on the device, lax.while_loop (the tree iLQR,
// mind_tpu/planner/ilqr.py) and lax.cond (AIME's rounds,
// mind_tpu/planner/aime_device.py; the plan's enable,
// mind_tpu/sim/episode.py), which XLA's command buffers lower to the same
// conditional nodes.
//
// set_conditional_any: one block reduces a bool mask of up to a few thousand
// bytes with __syncthreads_or and sets the node's condition to "any".
// It reads a few KB and writes 4 bytes, so its time is its launch latency
// on this card; one block is all it needs, and the graph runs it without a
// host launch.
//
// Conditional nodes need CUDA 12.4 or later in the toolkit (this file) and
// in the driver (graph_control.py checks the runtime's and the driver's
// versions after loading the library).

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "graph_control.cu needs the CUDA toolkit 12.4 or later (conditional graph nodes)"
#endif

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
set_conditional_any_kernel(cudaGraphConditionalHandle handle, const unsigned char* __restrict__ mask,
                           int n, unsigned long long* executions) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += kThreads) any |= mask[i];
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    cudaGraphSetConditional(handle, any ? 1u : 0u);
    if (executions != nullptr) *executions += 1ull;   // one thread of one block
  }
}

// The graph a stream is capturing and the nodes its next node depends on.
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, nullptr, n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureInvalidated;
}

}  // namespace

extern "C" const char* gc_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

extern "C" int gc_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaDriverGetVersion(driver);
}

// Launch the condition kernel on `stream` (a capturing one: the handle
// belongs to the graph being captured). `executions` (may be null) is a
// device counter the kernel adds one to.
extern "C" int gc_set_conditional_any(unsigned long long handle, const void* mask, int n,
                                      void* executions, void* stream) {
  set_conditional_any_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)mask, n,
      (unsigned long long*)executions);
  return (int)cudaGetLastError();
}

extern "C" int gc_begin_capture(void* stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream, cudaStreamCaptureModeThreadLocal);
}

extern "C" int gc_end_capture(void* stream, void** graph) {
  return (int)cudaStreamEndCapture((cudaStream_t)stream, (cudaGraph_t*)graph);
}

extern "C" int gc_instantiate(void* graph, void** exec) {
  return (int)cudaGraphInstantiate((cudaGraphExec_t*)exec, (cudaGraph_t)graph, 0ull);
}

extern "C" int gc_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int gc_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  if (graph != nullptr && err == cudaSuccess) err = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)err;
}

// A conditional handle of the graph `stream` is capturing (default value 0,
// set by the condition kernel before every evaluation).
extern "C" int gc_handle_create(void* stream, unsigned long long* handle) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle h;
  err = cudaGraphConditionalHandleCreate(&h, graph, 0u, 0u);
  *handle = (unsigned long long)h;
  return (int)err;
}

// Add an IF (is_while 0) or WHILE (1) node on `handle` after the work
// captured so far on `stream`, continue the capture after it, and return
// the node's empty body graph (captured next by gc_begin_body).
extern "C" int gc_add_conditional(void* stream, unsigned long long handle, int is_while,
                                  void** body) {
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t err = capture_info((cudaStream_t)stream, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  *body = (void*)params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies((cudaStream_t)stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  return (int)err;
}

// Capture what `stream` runs next into `body` (a conditional node's body
// graph), until gc_end_body.
extern "C" int gc_begin_body(void* stream, void* body) {
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)stream, (cudaGraph_t)body, nullptr,
                                            nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

extern "C" int gc_end_body(void* stream) {
  cudaGraph_t graph;
  return (int)cudaStreamEndCapture((cudaStream_t)stream, &graph);
}

// The graph as a DOT file, kernel names and conditional bodies included.
extern "C" int gc_dot_print(void* graph, const char* path) {
  return (int)cudaGraphDebugDotPrint((cudaGraph_t)graph, path, cudaGraphDebugDotFlagsVerbose);
}
