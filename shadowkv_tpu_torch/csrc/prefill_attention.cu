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
// What the design does about it (building blocks in flash_sm90.cuh):
// - A block owns 128 query rows of one head and walks 128-key tiles of the
//   KV head h / G. It has three warpgroups: warpgroup 0 is the producer
//   (one thread issues every TMA load; its registers drop to 40 with
//   setmaxnreg), warpgroups 1 and 2 are consumers of 64 query rows each
//   (registers raised to 232).
// - Q is loaded once by TMA. K and V go through a ring of kStages stages
//   (32 KB of K and 32 KB of V each), with a full mbarrier for K, one for
//   V and an empty mbarrier per stage; the producer fills stage i % kStages
//   while the consumers work on the stages before it. 32 KB of Q and two
//   stages come to 160 KB, so one block runs per SM.
// - The tensor maps are 4-D (head_dim, heads, seq, batch) with the real
//   strides: a tile past a sequence's end is zero-filled by TMA, not read
//   from the next batch row.
// - S = Q K^T and O += P V are wgmma m64n128k16 (8 k-steps each); S, P and
//   O live in registers (P as the register A operand), and the softmax
//   scale is folded into exp2.
// - Two passes over the plan's tiles: the first computes each row's max and
//   sum, the second rounds the normalised probabilities to bf16, as the
//   plain version does, and accumulates P V (flash_sm90.cuh says why).
//   The ring carries K alone in the first pass, K and V in the second.
// - The tile plan (kernels/prefill_attention.py::prefill_tile_plan states
//   it in Python and is tested against the dense mask; TilePlan transcribes
//   it) visits the sink tiles [0, n_sink) and the window tiles
//   [first_win, last] and skips the rest. A visited tile whose every
//   (row, key) pair is active is full and takes no per-pair test; the
//   others (the diagonal tile, the sink's and window's edge tiles) are
//   masked. Keys at or past seq are in masked tiles only.
// - Grid (heads, batch, query blocks), the last (heaviest) query blocks
//   first; the G query heads of a KV group are adjacent in launch order, so
//   the heads sharing a K/V tile find it in L2 (K and V are never repeated
//   in memory).
// Ragged sequences (S < 64, S not a multiple of 128, a window or sink off
// a tile edge) take the same kernel: TMA zero-fills the rows past seq, the
// mask drops their keys, and the epilogue writes only rows below seq.

#include "flash_sm90.cuh"

namespace {

using sm90::kD;
using sm90::kTileBytes;
using sm90::kTileRows;

constexpr int kStages = 2;
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
// Q, kStages x (K, V), the barriers (q, kStages x (full K, full V,
// empty)), and 1024 B to align the swizzled tiles by hand.
constexpr uint32_t kBarBytes = 8 * (1 + 3 * kStages);
constexpr size_t kSmemBytes =
    1024 + (size_t)kTileBytes * (1 + 2 * kStages) + kBarBytes;

// Which key tiles a query block visits (kernels/prefill_attention.py::
// prefill_tile_plan): the sink tiles [0, n_sink), then [first_win, last],
// the tiles holding a key inside the window of some row. q1 is the
// block's last row below seq.
struct TilePlan {
  int n_sink;
  int first_win;
  int last;

  __device__ TilePlan(int q0, int q1, int window, int sink) {
    last = q1 / kTileRows;
    n_sink = min(last + 1, (sink + kTileRows - 1) / kTileRows);
    first_win = last + 1;
    if (window > 0) {
      // A tile at k0 holds a window key of some row iff
      // k0 + kTileRows - 1 > q0 - window.
      const int x = q0 - window - (kTileRows - 2);
      first_win = max(n_sink, x <= 0 ? 0 : (x + kTileRows - 1) / kTileRows);
    }
  }
  __device__ int count() const {
    return n_sink + max(0, last - first_win + 1);
  }
  __device__ int tile(int i) const {
    return i < n_sink ? i : first_win + (i - n_sink);
  }
  // Every pair of rows [q0, q1] and keys [k0, k0 + 127] is active: all keys
  // at or below the block's first row, and each either a sink key or
  // within the window of the block's last row.
  __device__ static bool full(int t, int q0, int q1, int window, int sink) {
    const int k0 = t * kTileRows;
    const int k1 = k0 + kTileRows - 1;
    return k1 <= q0 && (k1 < sink || q1 - max(k0, sink) < window);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         __nv_bfloat16* __restrict__ out, int seq, int heads,
                         int kv_heads, float scale_log2, int window, int sink) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (sm90::smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + kTileBytes * (1 + 2 * kStages);
  const uint32_t q_bar = bars;
  auto k_s = [&](int st) { return base + kTileBytes * (1 + 2 * st); };
  auto v_s = [&](int st) { return base + kTileBytes * (2 + 2 * st); };
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTileRows;
  const int q1 = min(seq, q0 + kTileRows) - 1;
  const int kvh = h / (heads / kv_heads);
  const TilePlan plan(q0, q1, window, sink);
  const int n_visit = plan.count();

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(full_k(st), 1);
      sm90::mbar_init(full_v(st), 1);
      sm90::mbar_init(empty(st), kConsumerWarps);
    }
    sm90::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    sm90::regs_dec<40>();
    if (threadIdx.x == 0) {
      sm90::tma_load_tile(q_s, &q_map, q_bar, h, q0, b);
      // The ring carries the plan's tiles twice: K alone for the first
      // pass (full_v still completes a phase, so both barriers of a stage
      // keep one parity), K and V for the second.
      for (int i = 0; i < 2 * n_visit; ++i) {
        const int st = i % kStages;
        sm90::mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const bool second = i >= n_visit;
        const int k0 = plan.tile(second ? i - n_visit : i) * kTileRows;
        sm90::tma_load_tile(k_s(st), &k_map, full_k(st), kvh, k0, b);
        if (second) {
          sm90::tma_load_tile(v_s(st), &v_map, full_v(st), kvh, k0, b);
        } else {
          sm90::mbar_arrive(full_v(st));
        }
      }
    }
    return;
  }

  sm90::regs_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cw..
  const int lane = threadIdx.x % 32;
  const int r0 = 64 * cw + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const uint64_t q_desc = sm90::desc_k_major(q_s + cw * 64 * 128);
  sm90::Acc acc;
  acc.init();
  sm90::mbar_wait(q_bar, 0);
  // S of ring entry i (the plan's tile i % n_visit), masked unless full.
  auto tile_scores = [&](int i, float (&s)[64]) {
    const int st = i % kStages;
    const int t = plan.tile(i % n_visit);
    const int k0 = t * kTileRows;
    sm90::mbar_wait(full_k(st), (i / kStages) & 1);
    sm90::scores(s, q_desc, k_s(st));
    if (!TilePlan::full(t, q0, q1, window, sink)) {
      sm90::mask(s, [&](int dr, int c) {
        const int qp = q0 + r0 + dr;
        const int kp = k0 + c;
        return kp <= qp && kp < seq && (kp < sink || qp - kp < window);
      });
    }
  };
  for (int i = 0; i < n_visit; ++i) {  // first pass: row max and sum
    float s[64];
    tile_scores(i, s);
    if (lane == 0) sm90::mbar_arrive(empty(i % kStages));
    sm90::add_stats(acc, s, scale_log2);
  }
  sm90::finish_stats(acc);
  for (int i = n_visit; i < 2 * n_visit; ++i) {  // second pass: O = P V
    const int st = i % kStages;
    float s[64];
    tile_scores(i, s);
    sm90::add_pv(acc, s, scale_log2, v_s(st), full_v(st), (i / kStages) & 1);
    if (lane == 0) sm90::mbar_arrive(empty(st));
  }

  const size_t row_stride = (size_t)heads * kD;
  __nv_bfloat16* row =
      out + ((size_t)b * seq + q0 + r0) * row_stride + (size_t)h * kD;
  sm90::store_rows(acc, row, q0 + r0 < seq, row + 8 * row_stride,
                   q0 + r0 + 8 < seq);
}

int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int heads, int kv_heads, int head_dim, float scale,
           int window, int sink, void* stream) {
  const int q_blocks = (seq + kTileRows - 1) / kTileRows;
  if (head_dim != kD || kv_heads <= 0 || heads % kv_heads != 0 || seq <= 0 ||
      batch <= 0 || batch > 65535 || q_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm90::encode_rows(&q_map, q, batch, seq, heads);
  if (err == cudaSuccess) {
    err = sm90::encode_rows(&k_map, k, batch, seq, kv_heads);
  }
  if (err == cudaSuccess) {
    err = sm90::encode_rows(&v_map, v, batch, seq, kv_heads);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(prefill_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kSmemBytes);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(heads, batch, q_blocks);
  const float scale_log2 = scale * 1.4426950408889634f;
  prefill_attention_kernel<<<grid, kThreads, kSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), seq, heads,
      kv_heads, scale_log2, window, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shadowkv_prefill_attention(const void* q, const void* k,
                                          const void* v, void* out, int batch,
                                          int seq, int heads, int kv_heads,
                                          int head_dim, float scale,
                                          void* stream) {
  return launch(q, k, v, out, batch, seq, heads, kv_heads, head_dim, scale,
                seq, 0, stream);
}

// window and sink are clamped to [0, seq] by the caller.
extern "C" int shadowkv_sparse_prefill_attention(
    const void* q, const void* k, const void* v, void* out, int batch, int seq,
    int heads, int kv_heads, int head_dim, float scale, int window, int sink,
    void* stream) {
  if (window < 0 || sink < 0) return (int)cudaErrorInvalidValue;
  return launch(q, k, v, out, batch, seq, heads, kv_heads, head_dim, scale,
                window, sink, stream);
}
