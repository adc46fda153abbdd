// A conditional (IF) node in a CUDA graph under stream capture (Hopper,
// sm_90a). Plain C interface, bound with ctypes by
// mfcnet_tpu_torch/ops/graph_cond.py, which holds the plain version (the
// flag read on the host and the body run eagerly) and the Python side of
// the capture.
//
// Replaces no TPU kernel: it is the counterpart of jax.lax.cond inside one
// compiled program, the device decode's choice of tier
// (mfcnet_tpu/track/decode_device.py:418-438), for the tracker's step
// captured as one CUDA graph (fused_dispatch). The graph keeps the choice
// on the card: a one-thread kernel reads a bool the step computed and sets
// the node's condition, and the node runs its body graph only when it is
// set. Nothing comes back to the host.
//
// What bounds it: one byte read and one launch, a few microseconds of
// latency on the graph's critical path; the body costs what its kernels
// cost when it runs and nothing when it does not.
//
// mfc_graph_if_begin adds, after the work captured so far on `stream`, the
// kernel that sets the condition from `*flag` (its negation where `negate`
// is set, the else branch of an if/else as an IF node of its own; and adds
// one to `*runs`, where given, when it is set) and the IF node after it,
// makes the node the stream's capture dependency (so later work waits for
// it), and starts capturing `body_stream` into the node's body graph: what
// is launched on `body_stream` until mfc_graph_if_end is the body. The
// graph owns the body; mfc_graph_if_end only ends its capture. `stream` may
// itself be capturing a body: the node then nests in that body, as a
// lax.cond inside a branch of another (`body_stream` must then be another
// stream than the outer body's).
//
// CUDA 12.4 or newer (conditional nodes, nested ones,
// cudaStreamBeginCaptureToGraph).

#include <cuda_runtime.h>

#define ERR_NOT_CAPTURING 30001

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const unsigned char* flag, int negate,
                                     unsigned long long* runs) {
  const bool run = (*flag != 0) != (negate != 0);
  cudaGraphSetConditional(handle, run ? 1u : 0u);
  if (run && runs != nullptr) *runs += 1;
}

extern "C" {

int mfc_graph_if_begin(const void* flag, void* runs, int negate,
                       void* stream, void* body_stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                           nullptr, &ndeps);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                           &ndeps);
#endif
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return ERR_NOT_CAPTURING;
  cudaGraphConditionalHandle handle;
  // the condition is 0 at every launch of the graph until the kernel sets it
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                       cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return (int)e;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, (const unsigned char*)flag,
                                       negate, (unsigned long long*)runs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the dependencies now end in the kernel just captured
#if CUDART_VERSION >= 13000
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, nullptr,
                               &ndeps);
#else
  e = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps, &ndeps);
#endif
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return (int)e;
  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream, body, nullptr,
                                    nullptr, 0,
                                    cudaStreamCaptureModeThreadLocal);
  return (int)e;
}

int mfc_graph_if_end(void* body_stream) {
  cudaGraph_t body = nullptr;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

}  // extern "C"
