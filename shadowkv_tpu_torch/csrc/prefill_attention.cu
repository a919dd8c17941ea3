// Causal GQA attention for prefill: dense (kernel B) and attention sink +
// sliding window (kernel C), one Hopper kernel for both.
//
// Kernel B replaces the TPU library kernels reached from
// shadowkv_tpu/core/attention.py: causal_prefill_splash (-> _splash_mqa ->
// splash_attention_kernel make_splash_mqa_single_device) and
// causal_prefill_flash (-> Pallas flash_attention). out[b, s, h] =
// softmax(q[b, s, h] . k[b, :s+1, h/G]^T * scale) @ v[b, :s+1, h/G], bf16 in
// and out, f32 accumulation.
//
// Kernel C replaces sparse_prefill_splash (shadowkv_tpu/core/attention.py:158
// -> _splash_mqa :250 with the SinkLocalMask): the same function where key kv
// is visible to query q iff kv <= q and (kv < sink or q - kv < window). B is
// C with window = seq and sink = 0.
//
// What bounds them on an H100: tensor-core operations. B does 2*S^2*H*Dh
// multiply-adds per sequence and layer (causal half of 4*S^2*H*Dh flops);
// at S=32K that is ~8.8e12 operations against ~50 MB of q/k/v/out bytes, far
// above the card's operation-to-byte ratio. C does the same work over the
// active pairs only, about S*(window+sink)*H*Dh*4 operations, still far
// above that ratio at window 8192.
//
// What the design does about it: the tile-plan loop of flash_sm90.cuh
// (wgmma m64n128k16 with S, P and O in registers, a TMA/mbarrier K/V ring
// fed by a producer warpgroup to two consumer warpgroups, two passes so P
// is rounded after normalising, as the plain version does), over this
// kernel's plan:
// - The tile plan (kernels/prefill_attention.py::prefill_tile_plan states
//   it in Python and is tested against the dense mask; WindowPlan
//   transcribes it) visits the sink tiles [0, n_sink) and the window tiles
//   [first_win, last] and skips the rest. A visited tile whose every
//   (row, key) pair is active is full and takes no per-pair test; the
//   others (the diagonal tile, the sink's and window's edge tiles) are
//   masked. Keys at or past seq are in masked tiles only.
// - The tensor maps are 4-D (head_dim, heads, seq, batch) with the real
//   strides: a tile past a sequence's end is zero-filled by TMA, not read
//   from the next batch row.
// - Grid (heads, batch, query blocks), the last (heaviest) query blocks
//   first; the G query heads of a KV group are adjacent in launch order, so
//   the heads sharing a K/V tile find it in L2 (K and V are never repeated
//   in memory).
// Ragged sequences (S < 64, S not a multiple of 128, a window or sink off
// a tile edge) take the same kernel: TMA zero-fills the rows past seq, the
// mask drops their keys, and the epilogue writes only rows below seq.
//
// The query-offset form of B (shadowkv_prefill_attention_offset) replaces
// the blockwise attention of sp_causal_prefill_attention
// (shadowkv_tpu/core/attention.py:501): S_q query rows that sit at key
// positions [offset, offset + S_q) of T_k >= offset + S_q keys, the local
// rows of one sequence-parallel rank against the gathered K/V. The plan
// and the mask count in key positions (q0 and q1 carry the offset), the
// query map and the output in local rows: a query block at local row r0
// visits the key tiles up to (offset + r0 + 127) / 128 and skips the rest.

#include "flash_sm90.cuh"

namespace {

using sm90::kD;
using sm90::kTileRows;

// Which key tiles a query block visits (kernels/prefill_attention.py::
// prefill_tile_plan): the sink tiles [0, n_sink), then [first_win, last],
// the tiles holding a key inside the window of some row. q1 is the
// block's last row below seq.
struct WindowPlan {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int kv_head;
  int batch;
  int q0;      // key position of the block's first query row
  int q1;      // key position of its last row below S_q
  int offset;  // key position of local query row 0
  int seq;     // keys (T_k)
  int window;
  int sink;
  int n_sink;
  int first_win;
  int last;

  // The keys of one row that count: kp <= qp, below seq, and a sink key or
  // inside the window.
  struct Row {
    int qp;
    int k0;
    int seq;
    int window;
    int sink;
    __device__ bool operator()(int c) const {
      const int kp = k0 + c;
      return kp <= qp && kp < seq && (kp < sink || qp - kp < window);
    }
  };

  __device__ int count() const {
    return n_sink + max(0, last - first_win + 1);
  }
  __device__ int tile(int i) const {
    return i < n_sink ? i : first_win + (i - n_sink);
  }
  __device__ sm90::KvTile kv(int i) const {
    return {k, v, kv_head, tile(i) * kTileRows, batch};
  }
  // Every pair of rows [q0, q1] and keys [k0, k0 + 127] is active: all keys
  // at or below the block's first row, and each either a sink key or
  // within the window of the block's last row.
  __device__ bool full(int i) const {
    const int k0 = tile(i) * kTileRows;
    const int k1 = k0 + kTileRows - 1;
    return k1 <= q0 && (k1 < sink || q1 - max(k0, sink) < window);
  }
  // qp is a local query row; its key position is qp + offset.
  __device__ void mask(int i, float (&s)[64], int qp) const {
    const int k0 = tile(i) * kTileRows;
    qp += offset;
    sm90::mask_rows(s, Row{qp, k0, seq, window, sink},
                    Row{qp + 8, k0, seq, window, sink});
  }
};

__global__ void __launch_bounds__(sm90::kThreads, 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         __nv_bfloat16* __restrict__ out, int s_q, int seq,
                         int offset, int heads, int kv_heads, float scale_log2,
                         int window, int sink) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * kTileRows;  // local row
  WindowPlan plan;
  plan.k = &k_map;
  plan.v = &v_map;
  plan.kv_head = h / (heads / kv_heads);
  plan.batch = b;
  plan.q0 = offset + r0;
  plan.q1 = offset + min(s_q, r0 + kTileRows) - 1;
  plan.offset = offset;
  plan.seq = seq;
  plan.window = window;
  plan.sink = sink;
  plan.last = plan.q1 / kTileRows;
  plan.n_sink = min(plan.last + 1, (sink + kTileRows - 1) / kTileRows);
  plan.first_win = plan.last + 1;
  if (window > 0) {
    // A tile at k0 holds a window key of some row iff
    // k0 + kTileRows - 1 > q0 - window.
    const int x = plan.q0 - window - (kTileRows - 2);
    plan.first_win = max(plan.n_sink,
                         x <= 0 ? 0 : (x + kTileRows - 1) / kTileRows);
  }
  const size_t row_stride = (size_t)heads * kD;
  sm90::attend(plan, sm90::loop_base(smem_raw), &q_map, h, r0, b, scale_log2,
               out + ((size_t)b * s_q + r0) * row_stride + (size_t)h * kD,
               row_stride, s_q - r0);
}

// s_q query rows at key positions [offset, offset + s_q) of seq keys.
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int s_q, int seq, int offset, int heads, int kv_heads, int head_dim,
           float scale, int window, int sink, void* stream) {
  const int q_blocks = (s_q + kTileRows - 1) / kTileRows;
  if (head_dim != kD || kv_heads <= 0 || heads % kv_heads != 0 || s_q <= 0 ||
      offset < 0 || offset + s_q > seq || batch <= 0 || batch > 65535 ||
      q_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm90::encode_rows(&q_map, q, batch, s_q, heads);
  if (err == cudaSuccess) {
    err = sm90::encode_rows(&k_map, k, batch, seq, kv_heads);
  }
  if (err == cudaSuccess) {
    err = sm90::encode_rows(&v_map, v, batch, seq, kv_heads);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(prefill_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sm90::kLoopSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, batch, q_blocks);
  const float scale_log2 = scale * 1.4426950408889634f;
  prefill_attention_kernel<<<grid, sm90::kThreads, sm90::kLoopSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), s_q, seq, offset,
      heads, kv_heads, scale_log2, window, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shadowkv_prefill_attention(const void* q, const void* k,
                                          const void* v, void* out, int batch,
                                          int seq, int heads, int kv_heads,
                                          int head_dim, float scale,
                                          void* stream) {
  return launch(q, k, v, out, batch, seq, seq, 0, heads, kv_heads, head_dim,
                scale, seq, 0, stream);
}

// q [batch, s_q, heads, 128] at key positions [offset, offset + s_q) of k/v
// [batch, t_k, kv_heads, 128]: kernel B with a query offset.
extern "C" int shadowkv_prefill_attention_offset(
    const void* q, const void* k, const void* v, void* out, int batch, int s_q,
    int t_k, int offset, int heads, int kv_heads, int head_dim, float scale,
    void* stream) {
  return launch(q, k, v, out, batch, s_q, t_k, offset, heads, kv_heads,
                head_dim, scale, t_k, 0, stream);
}

// window and sink are clamped to [0, seq] by the caller.
extern "C" int shadowkv_sparse_prefill_attention(
    const void* q, const void* k, const void* v, void* out, int batch, int seq,
    int heads, int kv_heads, int head_dim, float scale, int window, int sink,
    void* stream) {
  if (window < 0 || sink < 0) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, out, batch, seq, seq, 0, heads, kv_heads, head_dim,
                scale, window, sink, stream);
}
