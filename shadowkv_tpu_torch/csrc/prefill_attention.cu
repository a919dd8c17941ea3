// Causal GQA attention for prefill: dense (kernel B) and attention sink +
// sliding window (kernel C).
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
// is visible to query q iff kv <= q and (kv < sink or q - kv < window).
//
// What bounds them on an H100: tensor-core operations. B does 2*S^2*H*Dh
// multiply-adds per sequence and layer (causal half of 4*S^2*H*Dh flops);
// at S=32K that is ~8.8e12 operations against ~50 MB of q/k/v/out bytes, far
// above the card's operation-to-byte ratio. C does the same work over the
// active pairs only, about S*(window+sink)*H*Dh*4 operations, still far
// above that ratio at window 8192.
// What the design does about it: the flash loop of flash_tile.cuh. One block
// owns 64 query rows of one head and walks the 64-key tiles of the matching
// KV head (h / G: K and V are never repeated in memory; the G query heads of
// a group read the same tiles through L2), skipping every tile above the
// diagonal; C also skips every tile that lies wholly outside both the sink
// and the window (it visits the sink tiles, then the window's tiles) and
// masks the edge tiles by token. Blocks run heaviest (last) query tiles
// first to balance the causal triangle. The f32 accumulator in shared
// memory, the lack of wgmma, TMA and a pipelined K/V ring are what a later,
// faster version removes.

#include "flash_tile.cuh"

namespace {

using flash::kBM;
using flash::kBN;
using flash::kD;

template <bool kSparse>
__global__ void __launch_bounds__(flash::kThreads)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ out, int seq, int heads,
                         int kv_heads, float scale_log2, int window, int sink) {
  extern __shared__ __align__(128) unsigned char smem[];
  const flash::Smem sm = flash::carve(smem);

  const int mb = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (heads / kv_heads);
  const int q0 = mb * kBM;
  const size_t q_stride = (size_t)heads * kD;
  const size_t kv_stride = (size_t)kv_heads * kD;
  const __nv_bfloat16* qb = q + (size_t)b * seq * q_stride + (size_t)h * kD;
  const __nv_bfloat16* kb = k + (size_t)b * seq * kv_stride + (size_t)kvh * kD;
  const __nv_bfloat16* vb = v + (size_t)b * seq * kv_stride + (size_t)kvh * kD;

  flash::load_rows(sm.q, qb + (size_t)q0 * q_stride, q_stride, seq - q0);
  flash::Rows st;
  flash::begin(sm, st);

  // Tiles 0..last hold a causal key of some row; C visits the tiles
  // [0, n_sink) that hold sink keys and [first_win, last], whose keys lie
  // inside the window of some row (a tile at k0 does iff
  // k0 + 63 > q0 - window).
  const int last = (min(seq, q0 + kBM) - 1) / kBN;
  int n_sink = last + 1;
  int first_win = last + 1;
  if (kSparse) {
    n_sink = min(last + 1, (sink + kBN - 1) / kBN);
    if (window > 0) {
      const int x = q0 - window - (kBN - 2);
      first_win = max(n_sink, x <= 0 ? 0 : (x + kBN - 1) / kBN);
    }
  }
  auto visit = [&](int t) {
    const int k0 = t * kBN;
    flash::load_kv(sm, kb + (size_t)k0 * kv_stride, vb + (size_t)k0 * kv_stride,
                   kv_stride, seq - k0);
    flash::tile(sm, st, scale_log2, [&](int r, int c) {
      const int qp = q0 + r;
      const int kp = k0 + c;
      bool ok = kp <= qp && kp < seq;
      if (kSparse) ok = ok && (kp < sink || qp - kp < window);
      return ok;
    });
  };
  for (int t = 0; t < n_sink; ++t) visit(t);
  for (int t = first_win; t <= last; ++t) visit(t);

  flash::finish(sm, st, out + ((size_t)b * seq + q0) * q_stride + (size_t)h * kD,
                q_stride, seq - q0);
}

template <bool kSparse>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int seq, int heads, int kv_heads, int head_dim, float scale,
           int window, int sink, void* stream) {
  if (head_dim != kD || kv_heads <= 0 || heads % kv_heads != 0 || seq <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      prefill_attention_kernel<kSparse>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)flash::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((seq + kBM - 1) / kBM, heads, batch);
  const float scale_log2 = scale * 1.4426950408889634f;
  prefill_attention_kernel<kSparse>
      <<<grid, flash::kThreads, flash::kSmemBytes,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q),
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v),
          static_cast<__nv_bfloat16*>(out), seq, heads, kv_heads, scale_log2,
          window, sink);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int shadowkv_prefill_attention(const void* q, const void* k,
                                          const void* v, void* out, int batch,
                                          int seq, int heads, int kv_heads,
                                          int head_dim, float scale,
                                          void* stream) {
  return launch<false>(q, k, v, out, batch, seq, heads, kv_heads, head_dim,
                       scale, seq, 0, stream);
}

// window and sink are clamped to [0, seq] by the caller.
extern "C" int shadowkv_sparse_prefill_attention(
    const void* q, const void* k, const void* v, void* out, int batch, int seq,
    int heads, int kv_heads, int head_dim, float scale, int window, int sink,
    void* stream) {
  if (window < 0 || sink < 0) return (int)cudaErrorInvalidValue;
  return launch<true>(q, k, v, out, batch, seq, heads, kv_heads, head_dim,
                      scale, window, sink, stream);
}
