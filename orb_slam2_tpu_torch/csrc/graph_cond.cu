// CUDA graph conditional IF nodes for stream capture: the device side of
// core/control.py's `cond` under capture (the counterpart of `lax.cond`
// inside a jitted JAX program).
//
// `graph_cond_begin_if(pred, parent, child)` adds an IF node to the
// graph that `parent` is capturing into, with a one-thread kernel before it
// that sets the node's condition from the bool at `pred` at replay time, and
// starts capturing `child` into the node's body; the caller then issues the
// body's work on `child` and ends it with `graph_cond_end(child)`.  Nested
// IF nodes capture into the body of the enclosing one.  Needs CUDA >= 12.4
// (conditional nodes, cudaStreamBeginCaptureToGraph).  Each function
// returns a cudaError_t.

#include <cuda_runtime.h>

__global__ void graph_cond_set_kernel(cudaGraphConditionalHandle h,
                                      const bool* pred) {
  cudaGraphSetConditional(h, *pred ? 1u : 0u);
}

extern "C" int graph_cond_begin_if(const void* pred, void* parent,
                                   void* child) {
  cudaStream_t ps = (cudaStream_t)parent, cs = (cudaStream_t)child;
  cudaStreamCaptureStatus st;
  cudaGraph_t g;
  const cudaGraphNode_t* deps;
  size_t nd;
  cudaError_t e = cudaStreamGetCaptureInfo(ps, &st, nullptr, &g, &deps, &nd);
  if (e != cudaSuccess) return (int)e;
  if (st != cudaStreamCaptureStatusActive)
    return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle h;
  e = cudaGraphConditionalHandleCreate(&h, g, 0, 0);
  if (e != cudaSuccess) return (int)e;
  graph_cond_set_kernel<<<1, 1, 0, ps>>>(h, (const bool*)pred);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(ps, &st, nullptr, &g, &deps, &nd);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, g, deps, nd, &p);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(ps, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      cs, p.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeGlobal);
}

extern "C" int graph_cond_end(void* child) {
  cudaGraph_t g;
  return (int)cudaStreamEndCapture((cudaStream_t)child, &g);
}
