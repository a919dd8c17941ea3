// Phase markers: one empty kernel per device phase of the program's work
// (utils/profiling.py: PHASES, in the same order). A marker launched on the
// stream a step runs on cuts the device timeline into phases on the device
// trace's own clock, inside a replayed CUDA graph too, where no host range
// is replayed. Each kernel is extern "C", so its name in a trace is exactly
// skv_span_<phase>. Beside them, the upload of a captured graph.

#include <cuda_runtime.h>

extern "C" {

__global__ void skv_span_embed() {}
__global__ void skv_span_qkv() {}
__global__ void skv_span_select() {}
__global__ void skv_span_refresh() {}
__global__ void skv_span_attn() {}
__global__ void skv_span_tail() {}
__global__ void skv_span_head() {}
__global__ void skv_span_lowrank() {}
__global__ void skv_span_store() {}
__global__ void skv_span_end() {}
__global__ void skv_span_route() {}
__global__ void skv_span_experts() {}
__global__ void skv_span_swa() {}

// Launch the marker of phase ``phase`` (its index in PHASES) on ``stream``;
// returns the launch's CUDA error code.
int shadowkv_span(int phase, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (phase) {
    case 0: skv_span_embed<<<1, 1, 0, s>>>(); break;
    case 1: skv_span_qkv<<<1, 1, 0, s>>>(); break;
    case 2: skv_span_select<<<1, 1, 0, s>>>(); break;
    case 3: skv_span_refresh<<<1, 1, 0, s>>>(); break;
    case 4: skv_span_attn<<<1, 1, 0, s>>>(); break;
    case 5: skv_span_tail<<<1, 1, 0, s>>>(); break;
    case 6: skv_span_head<<<1, 1, 0, s>>>(); break;
    case 7: skv_span_lowrank<<<1, 1, 0, s>>>(); break;
    case 8: skv_span_store<<<1, 1, 0, s>>>(); break;
    case 9: skv_span_end<<<1, 1, 0, s>>>(); break;
    case 10: skv_span_route<<<1, 1, 0, s>>>(); break;
    case 11: skv_span_experts<<<1, 1, 0, s>>>(); break;
    case 12: skv_span_swa<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Upload an instantiated graph to the device now, on ``stream``: its first
// replay would otherwise do it, which for the marked twin falls inside the
// first traced step.
int shadowkv_graph_upload(void* graph_exec, void* stream) {
  return static_cast<int>(
      cudaGraphUpload(static_cast<cudaGraphExec_t>(graph_exec),
                      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
