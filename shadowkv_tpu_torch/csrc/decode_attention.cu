// Decode attention over a head-major cache for one layer: the compact
// buffer of the ShadowKV decode step, or the full cache.
//
// Replaces no TPU kernel. The JAX package computes decode attention as plain
// einsum math (shadowkv_tpu/core/attention.py::decode_attention_hm), and the
// port's plain version (kernels/decode_attention.py::decode_attention_plain)
// upcast the whole bf16 K and V buffer of each layer to f32 and ran two f32
// products, a mask and a softmax over score tensors in device memory. This
// kernel computes the same function with the plain version's roundings:
//   * scores = f32 sums of bf16 q * bf16 K products, times `scale`;
//   * key rows past q_abs = kv_len - s_new + s masked to the f32 minimum
//     (kv_len a 0-d or [B] int32 on the device, or a value);
//   * softmax in f32, P rounded to bf16 after it is normalised, P V summed
//     in f32, the output rounded once to bf16, [B, S_new, H, Dh].
// Key rows past a batch row's last valid position have P exactly 0 in the
// plain version (exp of the f32 minimum), so they are not read. A row whose
// every key is masked (kv_len < s_new) gets the plain version's uniform
// weights over the whole capacity.
//
// What bounds it on an H100: bytes. K and V are read once: at the glm4 cell
// (B 8, 4 KV heads, 2624 rows of 128) 43 MB a layer, 12.8 us at 3.35 TB/s;
// the products (2 x 8 query rows a KV row) are a few hundred MFLOP, far
// below the tensor cores' rate.
//
// What the design does about it:
// - Every (batch row, KV head) and group of at most 16 query rows (its G
//   heads x S_new tokens; more rows take more groups, which read K and V
//   again) is a thread-block cluster of N CTAs. CTA i of the cluster owns
//   the i-th of N contiguous ranges of the batch row's valid keys (read on
//   the device), rounded to 64-row tiles.
// - N follows from the shapes alone: enough CTAs to cover the SMs,
//   floor(SMs / (B * K * groups)), at most 8 (the portable cluster size) and
//   no range shorter than 4 tiles. At the decode cells (B * K = 32) N = 4:
//   128 CTAs, one wave.
// - Each CTA streams its range's K tiles, then its V tiles, through one
//   4-stage cp.async ring (3 tiles of 16 KB in flight; rows of 2 Dh + 16
//   bytes, so ldmatrix reads them without bank conflicts). The first V tiles
//   load while the last K tiles and the exchange below run.
// - Pass 1 (K): each of the 4 warps owns 16 keys of a tile and computes
//   S^T = K Q^T on mma.sync m16n8k16 (keys as the 16 rows, query rows as
//   the n8 columns, so G = 8 at S_new = 1 wastes no lanes), f32 sums,
//   scale, mask, and keeps each row's running max and sum. The scores stay
//   in shared memory.
// - Exchange: every CTA publishes its warps' (max, sum) per row; after a
//   cluster barrier each CTA reads all of them over distributed shared
//   memory and combines them in one fixed order, so every CTA holds the
//   same global (max, sum).
// - Pass 2 (V): each warp forms P = bf16(exp(s - max) / sum) for its 16
//   keys straight into mma B fragments and accumulates O^T = V^T P^T in
//   f32 registers (V^T by ldmatrix.trans).
// - The 4 warps' partial O are added in shared memory, then the cluster's N
//   partial O over distributed shared memory, each CTA a share of the
//   output elements, in rank order, written as bf16. Every sum runs in a
//   fixed order: the result does not depend on timing.
// - Spill: where a range's scores do not fit in shared memory beside the
//   ring (the full cache's long ranges at large B * K), they go to a scratch
//   tensor that the wrapper allocates, one slice per CTA, written and read
//   back by the same warp (mostly from L2). That costs 8 bytes a key and
//   query row against re-reading K's 2 Dh bytes a key.
// The kernel allocates nothing and never synchronises with the host, so a
// decode step's CUDA graph captures it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;          // key rows of one ring stage, 16 a warp
constexpr int kStages = 4;         // ring depth
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMinTiles = 4;       // no CTA range shorter than this
constexpr int kScorePad = 8;       // floats past a score row (banks)
constexpr float kF32Min = -3.40282347e38f;  // torch.finfo(float32).min

struct Args {
  const __nv_bfloat16* q;  // [B, S_new, H, Dh], strides below
  const __nv_bfloat16* k;  // [B, K, T, Dh]
  const __nv_bfloat16* v;  // [B, K, T, Dh]
  const int* kv_len;       // 0-d or [B], or null: kv_len_value
  __nv_bfloat16* out;      // [B, S_new, H, Dh]
  float* scratch;          // scores, one slice per CTA, or null
  long long q_sb, q_ss, q_sh;  // q strides in elements
  int kv_heads, groups, s_new, t_cap;
  int kv_len_value, kv_len_batched;
  int sc_stride;  // floats per score row
  int off_q, off_ml, off_row, off_sc;  // shared-memory offsets in bytes
  float scale;
};

// The launch's shape and shared memory, from the problem's shapes and the
// card's SM count and shared-memory limit.
struct Plan {
  int cluster, nt, row_groups, sc_stride;
  int off_q, off_ml, off_row, off_sc, smem;
  long long scratch_floats;
};

Plan make_plan(int batch, int kv_heads, int rows, int t_cap, int dh, int sms,
               int smem_max) {
  Plan p;
  p.nt = rows <= 8 ? 1 : 2;
  const int rows_cta = 8 * p.nt;
  p.row_groups = (rows + rows_cta - 1) / rows_cta;
  const long long pairs = (long long)batch * kv_heads * p.row_groups;
  long long n = sms / pairs;
  const int tiles = (t_cap + kTile - 1) / kTile;
  const int by_len = tiles / kMinTiles;
  if (n > kMaxCluster) n = kMaxCluster;
  if (n > by_len) n = by_len;
  if (n < 1) n = 1;
  p.cluster = (int)n;
  const int per = (t_cap + p.cluster - 1) / p.cluster;
  const int range_max = (per + kTile - 1) / kTile * kTile;
  p.sc_stride = range_max + kScorePad;
  const int row_bytes = dh * 2 + 16;
  p.off_q = kStages * kTile * row_bytes;
  p.off_ml = p.off_q + rows_cta * row_bytes;
  p.off_row = p.off_ml + kWarps * rows_cta * (int)sizeof(float2);
  p.off_sc = p.off_row + rows_cta * (int)sizeof(float2);
  const long long sc_bytes = (long long)rows_cta * p.sc_stride * 4;
  if (p.off_sc + sc_bytes <= smem_max) {
    p.smem = (int)(p.off_sc + sc_bytes);
    p.scratch_floats = 0;
  } else {
    p.smem = p.off_sc;
    p.scratch_floats = (long long)p.cluster * batch * kv_heads *
                       p.row_groups * rows_cta * p.sc_stride;
  }
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0,
                                        uint32_t& r1) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += A B for one 16 x 8 x 16 step, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (m, l) of two parts of one row: the larger max, the sums rescaled to it.
__device__ __forceinline__ void combine(float& m, float& l, float m2,
                                        float l2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;  // both parts empty
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// kDh: head_dim (a multiple of 16, at most 128); kNT: n8 tiles of query
// rows per CTA (8 * kNT rows).
template <int kDh, int kNT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kRowsCta = 8 * kNT;
  constexpr int kRowBytes = kDh * 2 + 16;
  constexpr int kChunks = kDh / 8;      // 16-byte pieces of a row
  constexpr int kSteps = kDh / 16;      // k16 steps of a row
  constexpr int kRedStride = kDh + 4;   // floats of a reduced output row

  cg::cluster_group cluster = cg::this_cluster();
  const int n_cta = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;
  const int qd = lane % 4;
  const int bk = blockIdx.y;
  const int b = bk / a.kv_heads;
  const int kh = bk - b * a.kv_heads;
  const int r0 = blockIdx.z * kRowsCta;
  const int rows = min(kRowsCta, a.groups * a.s_new - r0);
  const int heads = a.kv_heads * a.groups;

  // This batch row's keys, and this CTA's range of them.
  const int kv = a.kv_len ? a.kv_len[a.kv_len_batched ? b : 0]
                          : a.kv_len_value;
  const int q_lo = kv - a.s_new;  // the position of token s = 0
  const int n_keys = q_lo < 0 ? a.t_cap : min(kv, a.t_cap);
  int per = (n_keys + n_cta - 1) / n_cta;
  per = (per + kTile - 1) / kTile * kTile;
  const int k0 = rank * per;
  const int k1 = min(n_keys, k0 + per);
  const int n_tiles = k1 > k0 ? (k1 - k0 + kTile - 1) / kTile : 0;
  const int total = 2 * n_tiles;  // K tiles, then V tiles

  const size_t head = (size_t)bk * a.t_cap * kDh;
  const __nv_bfloat16* k_head = a.k + head;
  const __nv_bfloat16* v_head = a.v + head;
  unsigned char* ring = smem;

  auto load_tile = [&](int i) {
    const bool is_k = i < n_tiles;
    const __nv_bfloat16* src = is_k ? k_head : v_head;
    const int key0 = k0 + (is_k ? i : i - n_tiles) * kTile;
    unsigned char* dst = ring + (size_t)(i % kStages) * kTile * kRowBytes;
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int idx = it * kThreads + tid;
      const int row = idx / kChunks;
      const int c = idx - row * kChunks;
      const int key = key0 + row;
      const bool ok = key < k1;
      cp_async16(smem_u32(dst + row * kRowBytes + c * 16),
                 src + (size_t)(ok ? key : 0) * kDh + c * 8, ok);
    }
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < total) load_tile(i);
    cp_async_commit();
  }

  // Query rows r0 .. r0 + rows (row r is token r / G of query head
  // kh * G + r % G) -> shared memory, zeros past `rows`.
  unsigned char* s_q = smem + a.off_q;
  for (int idx = tid; idx < kRowsCta * kChunks; idx += kThreads) {
    const int rl = idx / kChunks;
    const int c = idx - rl * kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (rl < rows) {
      const int r = r0 + rl;
      const int s = r / a.groups;
      const int h = kh * a.groups + (r - s * a.groups);
      val = *reinterpret_cast<const uint4*>(a.q + b * a.q_sb + s * a.q_ss +
                                            h * a.q_sh + c * 8);
    }
    *reinterpret_cast<uint4*>(s_q + rl * kRowBytes + c * 16) = val;
  }
  __syncthreads();
  // Q^T as mma B fragments: n8 tile j, k16 step kk.
  uint32_t qf[kSteps][kNT][2];
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
      ldsm_x2(smem_u32(s_q + (8 * j + lane % 8) * kRowBytes + kk * 32 +
                       16 * ((lane / 8) & 1)),
              qf[kk][j][0], qf[kk][j][1]);

  // This thread's rows in pass 1: 8 j + 2 qd + e.
  int q_abs[kNT][2];
  float m_run[kNT][2], l_run[kNT][2];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      q_abs[j][e] = q_lo + (r0 + 8 * j + 2 * qd + e) / a.groups;
      m_run[j][e] = -INFINITY;
      l_run[j][e] = 0.f;
    }

  float* sc = a.scratch
                  ? a.scratch + ((size_t)(blockIdx.z * gridDim.y + blockIdx.y) *
                                     gridDim.x + blockIdx.x) *
                                    kRowsCta * a.sc_stride
                  : reinterpret_cast<float*>(smem + a.off_sc);
  const int st = a.sc_stride;

  int it = 0;  // ring position
  auto next_tile = [&]() -> const unsigned char* {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nxt = it + kStages - 1;
    if (nxt < total) load_tile(nxt);
    cp_async_commit();
    return ring + (size_t)(it % kStages) * kTile * kRowBytes;
  };

  // Pass 1: scores of this warp's 16 keys of each K tile.
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const unsigned char* tile = next_tile();
    float acc[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const uint32_t a_base =
        smem_u32(tile) +
        (16 * warp + lane % 8 + 8 * ((lane / 8) & 1)) * kRowBytes +
        16 * (lane / 16);
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      uint32_t af[4];
      ldsm_x4(a_base + kk * 32, af);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(acc[j], af, qf[kk][j][0], qf[kk][j][1]);
    }
    // acc[j]: keys g (e 0, 1) and g + 8 (e 2, 3), rows 8 j + 2 qd + e % 2.
    const int kl = t * kTile + 16 * warp + g;
    const int key = k0 + kl;
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qa = q_abs[j][e];
        float s0 = acc[j][e] * a.scale;
        float s1 = acc[j][2 + e] * a.scale;
        s0 = key >= k1 ? -INFINITY : (key > qa ? kF32Min : s0);
        s1 = key + 8 >= k1 ? -INFINITY : (key + 8 > qa ? kF32Min : s1);
        float* row = sc + (8 * j + 2 * qd + e) * st + kl;
        row[0] = s0;
        row[8] = s1;
        const float mn = fmaxf(m_run[j][e], fmaxf(s0, s1));
        if (mn != -INFINITY) {
          l_run[j][e] = l_run[j][e] * expf(m_run[j][e] - mn) +
                        expf(s0 - mn) + expf(s1 - mn);
          m_run[j][e] = mn;
        }
      }
  }

  // Exchange: each row's (max, sum) over the warps and the cluster.
  float2* s_ml = reinterpret_cast<float2*>(smem + a.off_ml);  // [warp][row]
  float2* s_row = reinterpret_cast<float2*>(smem + a.off_row);
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float m = m_run[j][e];
      float l = l_run[j][e];
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
        const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
        combine(m, l, m2, l2);
      }
      if (g == 0) s_ml[warp * kRowsCta + 8 * j + 2 * qd + e] = make_float2(m, l);
    }
  cluster.sync();
  if (tid < kRowsCta) {
    float m = -INFINITY;
    for (int rk = 0; rk < n_cta; ++rk) {
      const float2* part = cluster.map_shared_rank(s_ml, rk);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) m = fmaxf(m, part[w * kRowsCta + tid].x);
    }
    float l = 0.f;
    for (int rk = 0; rk < n_cta; ++rk) {
      const float2* part = cluster.map_shared_rank(s_ml, rk);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 x = part[w * kRowsCta + tid];
        if (x.y > 0.f) l += x.y * expf(x.x - m);
      }
    }
    s_row[tid] = make_float2(m, l);
  }
  __syncthreads();

  // Pass 2: O^T += V^T P^T over this warp's 16 keys of each V tile.
  float p_m[kNT], p_l[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const float2 x = s_row[8 * j + g];
    p_m[j] = x.x;
    p_l[j] = x.y;
  }
  float o[kSteps][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kSteps; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][j][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const unsigned char* tile = next_tile();
    // P^T fragments: row 8 j + g, keys 2 qd + {0, 1} and 2 qd + {8, 9}.
    const int kl = t * kTile + 16 * warp + 2 * qd;
    uint32_t pb[kNT][2];
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const float* row = sc + (8 * j + g) * st + kl;
      const float2 x = *reinterpret_cast<const float2*>(row);
      const float2 y = *reinterpret_cast<const float2*>(row + 8);
      pb[j][0] = pack_bf16(expf(x.x - p_m[j]) / p_l[j],
                           expf(x.y - p_m[j]) / p_l[j]);
      pb[j][1] = pack_bf16(expf(y.x - p_m[j]) / p_l[j],
                           expf(y.y - p_m[j]) / p_l[j]);
    }
    const uint32_t v_base =
        smem_u32(tile) + (16 * warp + lane % 8 + 8 * (lane / 16)) * kRowBytes +
        16 * ((lane / 8) & 1);
#pragma unroll
    for (int mt = 0; mt < kSteps; ++mt) {
      uint32_t af[4];
      ldsm_x4_t(v_base + mt * 32, af);
#pragma unroll
      for (int j = 0; j < kNT; ++j) mma_bf16(o[mt][j], af, pb[j][0], pb[j][1]);
    }
  }

  // The warps' partial O (dh 16 mt + g (+8), rows 8 j + 2 qd (+1)) into
  // shared memory over the ring, then their sum in warp 0's slot.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [warp][row][kRedStride]
#pragma unroll
  for (int mt = 0; mt < kSteps; ++mt)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = 8 * j + 2 * qd + (e & 1);
        const int d = 16 * mt + g + 8 * (e >> 1);
        red[(warp * kRowsCta + rl) * kRedStride + d] = o[mt][j][e];
      }
  __syncthreads();
  for (int idx = tid; idx < kRowsCta * kDh; idx += kThreads) {
    const int rl = idx / kDh;
    const int d = idx - rl * kDh;
    float s = red[rl * kRedStride + d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[(w * kRowsCta + rl) * kRedStride + d];
    red[rl * kRedStride + d] = s;
  }
  cluster.sync();

  // This CTA's share of the output: 4 lanes of a row at a time, summed over
  // the cluster in rank order.
  constexpr int kQuads = kDh / 4;
  const int units = rows * kQuads;
  const int share = (units + n_cta - 1) / n_cta;
  const int u1 = min(units, (rank + 1) * share);
  for (int u = rank * share + tid; u < u1; u += kThreads) {
    const int rl = u / kQuads;
    const int c = u - rl * kQuads;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int rk = 0; rk < n_cta; ++rk) {
      const float* part = cluster.map_shared_rank(red, rk);
      const float4 x =
          *reinterpret_cast<const float4*>(part + rl * kRedStride + 4 * c);
      s.x += x.x;
      s.y += x.y;
      s.z += x.z;
      s.w += x.w;
    }
    const int r = r0 + rl;
    const int tok = r / a.groups;
    const int h = kh * a.groups + (r - tok * a.groups);
    __nv_bfloat16* dst =
        a.out + (((size_t)b * a.s_new + tok) * heads + h) * kDh + 4 * c;
    uint2 packed;
    packed.x = pack_bf16(s.x, s.y);
    packed.y = pack_bf16(s.z, s.w);
    *reinterpret_cast<uint2*>(dst) = packed;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <int kDh, int kNT>
cudaError_t launch(const Args& a, const Plan& p, int batch, cudaStream_t s) {
  auto kernel = decode_attention_kernel<kDh, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, batch * a.kv_heads, p.row_groups);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kDh>
cudaError_t launch_nt(const Args& a, const Plan& p, int batch,
                      cudaStream_t s) {
  return p.nt == 1 ? launch<kDh, 1>(a, p, batch, s)
                   : launch<kDh, 2>(a, p, batch, s);
}

cudaError_t plan_for(int batch, int kv_heads, int rows, int t_cap, int dh,
                     Plan* p) {
  if (batch < 1 || kv_heads < 1 || rows < 1 || t_cap < 1 || dh < 16 ||
      dh > 128 || dh % 16) {
    return cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  *p = make_plan(batch, kv_heads, rows, t_cap, dh, sms, smem_max);
  return p->smem <= smem_max ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// out: cluster size N, n8 row tiles per CTA, row groups, dynamic shared
// memory bytes, scratch floats (0: the scores stay in shared memory).
extern "C" int shadowkv_decode_attention_plan(int batch, int kv_heads,
                                              int rows, int t_cap,
                                              int head_dim, long long* out) {
  Plan p;
  const cudaError_t err = plan_for(batch, kv_heads, rows, t_cap, head_dim, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cluster;
  out[1] = p.nt;
  out[2] = p.row_groups;
  out[3] = p.smem;
  out[4] = p.scratch_floats;
  return 0;
}

extern "C" int shadowkv_decode_attention(
    const void* q, const void* k, const void* v, const void* kv_len, void* out,
    void* scratch, long long q_sb, long long q_ss, long long q_sh, int batch,
    int kv_heads, int groups, int s_new, int t_cap, int head_dim,
    int kv_len_value, int kv_len_batched, float scale, void* stream) {
  Plan p;
  const cudaError_t err =
      plan_for(batch, kv_heads, groups * s_new, t_cap, head_dim, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.scratch_floats > 0 && scratch == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.kv_len = static_cast<const int*>(kv_len);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.scratch = p.scratch_floats > 0 ? static_cast<float*>(scratch) : nullptr;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.kv_heads = kv_heads;
  a.groups = groups;
  a.s_new = s_new;
  a.t_cap = t_cap;
  a.kv_len_value = kv_len_value;
  a.kv_len_batched = kv_len_batched;
  a.sc_stride = p.sc_stride;
  a.off_q = p.off_q;
  a.off_ml = p.off_ml;
  a.off_row = p.off_row;
  a.off_sc = p.off_sc;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch_nt<16>(a, p, batch, s);
    case 32: return (int)launch_nt<32>(a, p, batch, s);
    case 48: return (int)launch_nt<48>(a, p, batch, s);
    case 64: return (int)launch_nt<64>(a, p, batch, s);
    case 80: return (int)launch_nt<80>(a, p, batch, s);
    case 96: return (int)launch_nt<96>(a, p, batch, s);
    case 112: return (int)launch_nt<112>(a, p, batch, s);
    default: return (int)launch_nt<128>(a, p, batch, s);
  }
}
