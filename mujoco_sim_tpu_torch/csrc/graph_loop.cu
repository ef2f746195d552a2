// The device-side loop of a captured step: a conditional WHILE node of a
// CUDA graph whose predicate is reduced on the card.
//
// Replaces the predicate of the JAX package's lax.while_loop under vmap
// (mujoco_sim_tpu/ops/solver.py:269,292,314,373 and ops/gjk.py:129): XLA
// reduces the batched predicate to one "any env still running" flag on the
// device and branches there.  PyTorch captures only IF nodes, so the port
// adds the WHILE node itself:
//
//   graph_loop_begin  (on the capturing stream) launches `set_any`, which
//                     reduces the (n,) bool mask and sets the node's
//                     condition; adds a WHILE node after it; moves the
//                     stream's capture past the node; and starts capturing
//                     a second stream into the node's body graph.
//   graph_loop_end    (on that second stream) launches `set_any` again at
//                     the end of the body, so every iteration re-reads the
//                     mask the body updated in place, and ends the body's
//                     capture.
//
// Bound: the mask is B bytes (B envs) and is read once per iteration; at
// B = 4096 that is ~1 ns of memory time, so the kernel costs its launch,
// which inside a graph is a device-side launch of one block.  The design
// keeps it to one block (256 threads, a strided OR and __syncthreads_or),
// so no second pass or atomic is needed.
//
// Nested loops (the line search inside a Newton iteration) nest the same
// way: the inner begin runs on the outer body's stream, whose capture
// graph is the outer body.
//
// The plain C interface is bound with ctypes (ops/loops.py); every entry
// returns the first cudaError_t it met.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// out == nullptr: set the node's condition; else write the flag to *out
// (the check against the plain twin, mask.any()).
__global__ void set_any(cudaGraphConditionalHandle handle,
                        const unsigned char* __restrict__ mask, int n,
                        int* out) {
  int any = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) any |= mask[i] != 0;
  any = __syncthreads_or(any);
  if (threadIdx.x == 0) {
    if (out != nullptr) {
      *out = any;
    } else {
      cudaGraphSetConditional(handle, any ? 1u : 0u);
    }
  }
}

cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* st,
                         cudaGraph_t* g, const cudaGraphNode_t** deps,
                         size_t* nd) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, st, nullptr, g, deps, nullptr, nd);
#else
  return cudaStreamGetCaptureInfo(s, st, nullptr, g, deps, nd);
#endif
}

cudaError_t add_node(cudaGraphNode_t* node, cudaGraph_t g,
                     const cudaGraphNode_t* deps, size_t nd,
                     cudaGraphNodeParams* p) {
#if CUDART_VERSION >= 13000
  return cudaGraphAddNode(node, g, deps, nullptr, nd, p);
#else
  return cudaGraphAddNode(node, g, deps, nd, p);
#endif
}

cudaError_t set_deps(cudaStream_t s, cudaGraphNode_t* node) {
#if CUDART_VERSION >= 13000
  return cudaStreamUpdateCaptureDependencies(
      s, node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  return cudaStreamUpdateCaptureDependencies(
      s, node, 1, cudaStreamSetCaptureDependencies);
#endif
}

}  // namespace

#define GL_CHECK(expr)                   \
  do {                                   \
    cudaError_t e_ = (expr);             \
    if (e_ != cudaSuccess) return e_;    \
  } while (0)

extern "C" {

// A stream of its own for loop bodies (one per nesting depth).
int graph_loop_stream(void** out) {
  cudaStream_t s;
  GL_CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  *out = (void*)s;
  return cudaSuccess;
}

// Open a WHILE node on `parent` (capturing) that runs while any of the n
// bytes at `mask` is nonzero, and start capturing `child` into its body.
int graph_loop_begin(const void* mask, int n, void* parent, void* child,
                     unsigned long long* handle_out) {
  cudaStream_t ps = (cudaStream_t)parent;
  cudaStreamCaptureStatus st;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t nd;
  GL_CHECK(capture_info(ps, &st, &g, &deps, &nd));
  if (st != cudaStreamCaptureStatusActive)
    return cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle h;
  GL_CHECK(cudaGraphConditionalHandleCreate(&h, g, 0, 0));
  set_any<<<1, kThreads, 0, ps>>>(h, (const unsigned char*)mask, n, nullptr);
  GL_CHECK(cudaGetLastError());
  GL_CHECK(capture_info(ps, &st, &g, &deps, &nd));
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  GL_CHECK(add_node(&node, g, deps, nd, &p));
  GL_CHECK(set_deps(ps, &node));
  GL_CHECK(cudaStreamBeginCaptureToGraph(
      (cudaStream_t)child, p.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal));
  *handle_out = h;
  return cudaSuccess;
}

// Close the body: re-reduce the mask into the condition, end the capture.
int graph_loop_end(const void* mask, int n, unsigned long long handle,
                   void* child) {
  cudaStream_t cs = (cudaStream_t)child;
  set_any<<<1, kThreads, 0, cs>>>(handle, (const unsigned char*)mask, n,
                                  nullptr);
  GL_CHECK(cudaGetLastError());
  cudaGraph_t body;
  GL_CHECK(cudaStreamEndCapture(cs, &body));
  return cudaSuccess;
}

// The predicate reduction alone, writing its flag to `out` (an int on the
// card): what chip_smoke.py holds against mask.any().
int graph_loop_any(const void* mask, int n, int* out, void* stream) {
  set_any<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      0, (const unsigned char*)mask, n, out);
  return cudaGetLastError();
}

// The driver's version (e.g. 12080), for the record.
int graph_loop_driver_version(int* out) {
  return cudaDriverGetVersion(out);
}

}  // extern "C"
