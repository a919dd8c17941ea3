// Landmark selection of the ShadowKV decode step for one layer: scores,
// top-S and the slot-stable assignment in one launch.
//
// Replaces no TPU kernel. The JAX package selects with plain jnp
// (shadowkv_tpu/core/selection.py: score_and_select, assign_slots_stable),
// and the port's plain version (kernels/select.py::select_slots_plain, the
// same two functions of core/selection.py) upcast each layer's landmark
// table to f32, ran an f32 GEMM, ~25 small launches (scale, mask, softmax,
// sum, max), torch.topk with its sort, and an int sort for the assignment.
// This kernel computes the same function:
//   * scores = f32 sums of q * landmark products over head_dim, divided by
//     sqrt(128), times the landmark row's f32 scale (int8 tables), -inf at
//     outlier chunks (mask false);
//   * per query row (g, q) a softmax over the C chunks; probs summed over
//     q, then the max over g; times (1 + hysteresis) at resident chunks;
//   * the S chunks of largest prob. Probs are >= 0, so their f32 bits
//     order as unsigned ints; the key of a chunk is its prob's bits + 1, 0
//     at an outlier, so an outlier never wins a tie with a chunk of equal
//     prob. A radix select over 8-bit digits (4 passes of histograms) finds
//     the S-th key T; every key above T is chosen, and keys equal to T in
//     ascending chunk id until S are chosen. No sort.
//   * the slot-stable assignment (assign_slots_stable) from bitmaps over
//     C: a slot stays where the new set holds its previous id; the incoming
//     ids (new bits not in the previous ids' bitmap) go in ascending id,
//     ranked by a prefix popcount, to the vacated slots in ascending slot
//     order. So the miss list stays sorted in slot and chunk space.
//     Forced ids (debug_hit_rate) replace the chosen set after the scores
//     and the top-S are computed, so such a step pays for them.
// Output: slot_ids [B, K, S] int32, stay [B, K, S] bool, stay_count [B, K].
//
// What bounds it on an H100: bytes. Each landmark byte is read once in its
// stored dtype: at the glm4 cell (B 8, 4 KV heads, C 4088, 128 lanes of
// bf16) 33.5 MB a layer, 10 us at 3.35 TB/s. The products (8 query rows a
// landmark row) are ~8 MFLOP a (b, KV head).
//
// What the design does about it:
// - Every (batch row, KV head) is a thread-block cluster of N CTAs; CTA i
//   owns the i-th of N contiguous ranges of chunks, a multiple of 64. N
//   follows from the shapes alone: floor(SMs / (B * K)), at most 8 (the
//   portable cluster size), no range under 4 tiles (kernels/select.py::plan
//   computes it and the shared-memory layout).
// - Each CTA streams its range through a cp.async ring of 64-row tiles (4
//   stages of bf16, 6 of int8; the first group also brings the query rows,
//   the range's mask bytes and row scales and the previous ids, so no
//   global load waits inside a loop; C a multiple of 4 keeps the mask's
//   4-byte copies aligned) and computes S^T = L Q^T on mma.sync
//   m16n8k16 (landmark rows as the 16 rows, query rows as the n8 columns);
//   int8 rows become bf16 fragments in registers (exact), their scale
//   multiplies the f32 score. Scores stay in shared memory, or in the
//   wrapper's scratch where a range's rows do not fit (1M contexts).
// - Each row's (max, sum) goes over distributed shared memory; every CTA
//   combines the cluster's in rank order, then computes its chunks' keys.
// - The radix select's histograms (double-buffered, one cluster barrier a
//   pass) are summed over the cluster in rank order by every CTA (each
//   thread a bin), so all make the same choice. The last pass's histogram
//   bin at T is each CTA's count of keys equal to T, which fixes its share
//   of the ties.
// - Each CTA writes its range's chosen bits into CTA 0's bitmap over
//   distributed shared memory; CTA 0 writes the assignment.
// Every sum runs in a fixed order: the result does not depend on timing.
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
constexpr int kTile = 64;  // landmark rows of one ring stage, 16 a warp
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kBins = 256;
constexpr int kPasses = 4;  // 8-bit digits of a 32-bit key
constexpr float kInvSqrt128 = 0.088388347648318440f;  // 1 / sqrt(128)

struct Args {
  const __nv_bfloat16* q;  // [B, K, G, Q, Dh], strides below
  const void* lm;          // [B, K, C, Dh] bf16 or int8
  const float* lm_scale;   // [B, K, C] or null
  const uint8_t* mask;     // [B, K, C] bool
  const int* prev;         // [B, K, S]
  const int* forced;       // [S] (stride 0) or [B, K, S], or null
  int* slot_ids;           // [B, K, S]
  uint8_t* stay;           // [B, K, S] bool
  int* stay_count;         // [B, K]
  float* scratch;          // scores, one slice per CTA, or null
  long long q_sb, q_sk, q_sg, q_sq, forced_stride;
  int kv_heads, groups, q_len, chunks, select_sets;
  int rows_pad, per, sc_stride, words;
  // shared-memory offsets in bytes (kernels/select.py::plan)
  int off_q, off_mask, off_scale, off_prev, off_pbm, off_nbm, off_hist,
      off_stats, off_misc, off_rw, off_slots, off_sc;
  float hyst_factor;  // 1 + hysteresis in f32, or 0: no hysteresis
};

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

// 4 bytes global -> shared.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
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

// d += A B for one 16 x 8 x 16 step, bf16 in, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two int8 values (the lower address in the low half) as a bf16 pair:
// exact, since |v| <= 128.
__device__ __forceinline__ uint32_t int8x2_bf16x2(const unsigned char* p) {
  const uint16_t v = *reinterpret_cast<const uint16_t*>(p);
  const __nv_bfloat162 r = __floats2bfloat162_rn(
      (float)(int8_t)(v & 0xff), (float)(int8_t)(v >> 8));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Counts each valid lane in h[bin]: one shared-memory atomic per distinct
// bin of the warp.
__device__ __forceinline__ void hist_add(uint32_t* h, bool valid,
                                         uint32_t bin) {
  const unsigned act = __ballot_sync(0xffffffffu, valid);
  if (valid) {
    const unsigned peers = __match_any_sync(act, bin);
    if ((threadIdx.x % 32) == __ffs(peers) - 1)
      atomicAdd(&h[bin], __popc(peers));
  }
}

// In-place exclusive prefix sum of a[0, n) by the whole block; returns the
// total. `tmp` holds kWarps ints.
__device__ int block_exclusive_scan(int* a, int n, int* tmp) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, tid * per), hi = min(n, lo + per);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  int inc = s;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const int v = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += v;
  }
  if (lane == 31) tmp[warp] = inc;
  __syncthreads();
  int run = inc - s, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) run += tmp[w];
    total += tmp[w];
  }
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
  return total;
}

__device__ __forceinline__ bool bit_at(const uint32_t* bm, int c) {
  return (bm[c >> 5] >> (c & 31)) & 1u;
}

// kDh: head_dim (a multiple of 16, at most 128); kInt8: int8 landmarks.
template <int kDh, bool kInt8>
__global__ void __launch_bounds__(kThreads) select_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kEsz = kInt8 ? 1 : 2;
  constexpr int kStages = kInt8 ? 6 : 4;
  constexpr int kRowBytes = kDh * kEsz + 16;
  constexpr int kChunks = kDh * kEsz / 16;  // 16-byte pieces of a row
  constexpr int kQRowBytes = kDh * 2 + 16;
  constexpr int kQChunks = kDh / 8;
  constexpr int kSteps = kDh / 16;  // k16 steps of a row

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
  const int n_chunks = a.chunks;
  const int n_sel = a.select_sets;
  const int rows = a.groups * a.q_len;
  const int c0 = rank * a.per;
  const int n = max(0, min(n_chunks, c0 + a.per) - c0);  // chunks here
  const int n_tiles = (n + kTile - 1) / kTile;
  const size_t head = (size_t)bk * n_chunks;

  const unsigned char* lm =
      static_cast<const unsigned char*>(a.lm) + (head + c0) * kDh * kEsz;
  unsigned char* ring = smem;
  auto load_tile = [&](int t) {
    unsigned char* dst = ring + (size_t)(t % kStages) * kTile * kRowBytes;
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int row = idx / kChunks;
      const int c = idx - row * kChunks;
      const int key = t * kTile + row;
      const bool ok = key < n;
      cp_async16(smem_u32(dst + row * kRowBytes + c * 16),
                 lm + (size_t)(ok ? key : 0) * kDh * kEsz + c * 16, ok);
    }
  };

  // The first commit group: the query rows (row r is head g = r / Q of
  // the group, token r % Q; zeros past `rows`), this range's mask bytes and
  // row scales, the previous ids, and tile 0. Then the ring's other tiles.
  unsigned char* s_q = smem + a.off_q;
  uint8_t* s_mask = smem + a.off_mask;
  float* s_scale = reinterpret_cast<float*>(smem + a.off_scale);
  int* s_prev = reinterpret_cast<int*>(smem + a.off_prev);
  for (int idx = tid; idx < a.rows_pad * kQChunks; idx += kThreads) {
    const int rl = idx / kQChunks;
    const int c = idx - rl * kQChunks;
    const int gi = rl < rows ? rl / a.q_len : 0;
    const int qi = rl < rows ? rl - gi * a.q_len : 0;
    cp_async16(smem_u32(s_q + rl * kQRowBytes + c * 16),
               a.q + b * a.q_sb + kh * a.q_sk + gi * a.q_sg + qi * a.q_sq +
                   c * 8,
               rl < rows);
  }
  for (int i = 4 * tid; i < n; i += 4 * kThreads)
    cp_async4(smem_u32(s_mask + i), a.mask + head + c0 + i);
  if (a.lm_scale)
    for (int i = 4 * tid; i < n; i += 4 * kThreads)
      cp_async16(smem_u32(s_scale + i), a.lm_scale + head + c0 + i, true);
  const int* prev = a.prev + (size_t)bk * n_sel;
  for (int i = tid; i < n_sel; i += kThreads)
    cp_async4(smem_u32(s_prev + i), prev + i);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }
  uint32_t* pbm = reinterpret_cast<uint32_t*>(smem + a.off_pbm);
  uint32_t* nbm = reinterpret_cast<uint32_t*>(smem + a.off_nbm);
  uint32_t* hist = reinterpret_cast<uint32_t*>(smem + a.off_hist);
  for (int i = tid; i < a.words; i += kThreads) {
    pbm[i] = 0u;
    nbm[i] = 0u;
  }
  for (int i = tid; i < 2 * kBins; i += kThreads) hist[i] = 0u;

  float* sc = a.scratch
                  ? a.scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                    a.rows_pad * a.sc_stride
                  : reinterpret_cast<float*>(smem + a.off_sc);
  const int st = a.sc_stride;
  const bool scaled = a.lm_scale != nullptr;
  const uint32_t q_base = smem_u32(s_q) + (lane % 8) * kQRowBytes +
                          16 * ((lane / 8) & 1);

  // Scores of this warp's 16 landmark rows of each tile, all query rows.
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    const unsigned char* tile =
        ring + (size_t)(t % kStages) * kTile * kRowBytes;
    uint32_t af[kSteps][4];
    if constexpr (kInt8) {
      const unsigned char* r0 = tile + (16 * warp + g) * kRowBytes + 2 * qd;
      const unsigned char* r1 = r0 + 8 * kRowBytes;
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        af[kk][0] = int8x2_bf16x2(r0 + 16 * kk);
        af[kk][1] = int8x2_bf16x2(r1 + 16 * kk);
        af[kk][2] = int8x2_bf16x2(r0 + 16 * kk + 8);
        af[kk][3] = int8x2_bf16x2(r1 + 16 * kk + 8);
      }
    } else {
      const uint32_t a_base =
          smem_u32(tile) +
          (16 * warp + lane % 8 + 8 * ((lane / 8) & 1)) * kRowBytes +
          16 * (lane / 16);
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) ldsm_x4(a_base + kk * 32, af[kk]);
    }
    // acc: landmark rows g (e 0, 1) and g + 8 (e 2, 3), query rows
    // 8 j + 2 qd + e % 2; even and odd k16 steps in two sums.
    const int kl = t * kTile + 16 * warp + g;
    const bool on0 = kl < n && s_mask[kl];
    const bool on1 = kl + 8 < n && s_mask[kl + 8];
    const float f0 = scaled && kl < n ? s_scale[kl] : 1.f;
    const float f1 = scaled && kl + 8 < n ? s_scale[kl + 8] : 1.f;
    for (int j = 0; j < a.rows_pad / 8; ++j) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        uint32_t b0, b1;
        ldsm_x2(q_base + 8 * j * kQRowBytes + kk * 32, b0, b1);
        mma_bf16(acc[kk & 1], af[kk], b0, b1);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s0 = (acc[0][e] + acc[1][e]) * kInvSqrt128;
        float s1 = (acc[0][2 + e] + acc[1][2 + e]) * kInvSqrt128;
        if (scaled) {
          s0 *= f0;
          s1 *= f1;
        }
        float* row = sc + (8 * j + 2 * qd + e) * st + kl;
        row[0] = on0 ? s0 : -INFINITY;
        row[8] = on1 ? s1 : -INFINITY;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < n_sel; i += kThreads) {
    const int p = s_prev[i];
    if (p >= 0 && p < n_chunks) atomicOr(&pbm[p >> 5], 1u << (p & 31));
  }

  // Each row's (max, sum of exp) over this range, then over the cluster:
  // (max, 1 / sum) of every row in s_row.
  float2* s_ml = reinterpret_cast<float2*>(smem + a.off_stats);
  float2* s_row = s_ml + a.rows_pad;
  for (int r = warp; r < rows; r += kWarps) {
    const float* row = sc + r * st;
    float m4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    for (int c = lane; c < n; c += 128)
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c + 32 * u < n) m4[u] = fmaxf(m4[u], row[c + 32 * u]);
    float m = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l4[4] = {0.f, 0.f, 0.f, 0.f};
    if (m != -INFINITY)
      for (int c = lane; c < n; c += 128)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (c + 32 * u < n) l4[u] += expf(row[c + 32 * u] - m);
    float l = (l4[0] + l4[1]) + (l4[2] + l4[3]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) s_ml[r] = make_float2(m, l);
  }
  cluster.sync();
  for (int r = tid; r < rows; r += kThreads) {
    float2 part[kMaxCluster];
    float m = -INFINITY;
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk) {
      if (rk < n_cta) {
        part[rk] = cluster.map_shared_rank(s_ml, rk)[r];
        m = fmaxf(m, part[rk].x);
      }
    }
    float l = 0.f;
#pragma unroll
    for (int rk = 0; rk < kMaxCluster; ++rk)
      if (rk < n_cta && part[rk].y > 0.f)
        l += part[rk].y * expf(part[rk].x - m);
    s_row[r] = make_float2(m, 1.f / l);
  }
  __syncthreads();

  // Keys (into row 0 of the scores: column c is read and written by one
  // thread) and the first pass's histogram; four chunks a thread at once.
  uint32_t* keys = reinterpret_cast<uint32_t*>(sc);
  for (int base = 0; base < n; base += 4 * kThreads) {
    float best[4] = {0.f, 0.f, 0.f, 0.f};
    for (int gi = 0; gi < a.groups; ++gi) {
      float sum[4] = {0.f, 0.f, 0.f, 0.f};
      for (int qi = 0; qi < a.q_len; ++qi) {
        const int r = gi * a.q_len + qi;
        const float2 ml = s_row[r];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = base + u * kThreads + tid;
          if (c < n) sum[u] += expf(sc[r * st + c] - ml.x) * ml.y;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        best[u] = gi == 0 ? sum[u] : fmaxf(best[u], sum[u]);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = base + u * kThreads + tid;
      const bool valid = c < n;
      uint32_t key = 0u;
      if (valid) {
        float p = best[u];
        if (a.hyst_factor != 0.f && bit_at(pbm, c0 + c)) p *= a.hyst_factor;
        key = s_mask[c] ? __float_as_uint(p) + 1u : 0u;
        keys[c] = key;
      }
      hist_add(hist, valid, key >> 24);
    }
  }

  // Radix select of the S-th largest key T, 8 bits a pass from the top;
  // `need` counts the keys still to choose among those matching the
  // prefix found so far.
  int* misc = reinterpret_cast<int*>(smem + a.off_misc);
  uint32_t* total = hist + 2 * kBins;
  uint32_t prefix = 0u, pmask = 0u;
  int need = n_sel;
  uint32_t digit = 0u;
  for (int pass = 0; pass < kPasses; ++pass) {
    const int shift = 24 - 8 * pass;
    uint32_t* h = hist + (pass & 1) * kBins;
    if (pass > 0) {
      for (int base = 0; base < n; base += kThreads) {
        const int c = base + tid;
        const uint32_t key = c < n ? keys[c] : 0u;
        hist_add(h, c < n && (key & pmask) == prefix, (key >> shift) & 255u);
      }
    }
    cluster.sync();
    // The cluster's histogram, each bin summed over the ranks in order.
    for (int bin = tid; bin < kBins; bin += kThreads) {
      uint32_t s = 0u;
#pragma unroll
      for (int rk = 0; rk < kMaxCluster; ++rk)
        if (rk < n_cta) s += cluster.map_shared_rank(h, rk)[bin];
      total[bin] = s;
    }
    __syncthreads();
    if (warp == 0) {
      // Lane L holds bins 255 - 8 L - i, i = 0 .. 7 (descending).
      uint32_t cnt[8];
      uint32_t tot = 0u;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cnt[i] = total[255 - 8 * lane - i];
        tot += cnt[i];
      }
      uint32_t inc = tot;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const uint32_t v = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += v;
      }
      const uint32_t above = inc - tot;
      const unsigned here = __ballot_sync(
          0xffffffffu, above < (uint32_t)need && (uint32_t)need <= inc);
      if (here == 0u && lane == 0) {
        misc[0] = 0;  // fewer keys than S: cannot happen (C >= S)
        misc[1] = 0;
      }
      if (here != 0u && lane == __ffs(here) - 1) {
        uint32_t acc = above;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (acc + cnt[i] >= (uint32_t)need) {
            misc[0] = 255 - 8 * lane - i;
            misc[1] = (int)acc;
            break;
          }
          acc += cnt[i];
        }
      }
    }
    __syncthreads();
    digit = (uint32_t)misc[0];
    need -= misc[1];
    prefix |= digit << shift;
    pmask |= 255u << shift;
    if (pass + 1 < kPasses) {
      // The other buffer was last read by the cluster before this pass's
      // barrier.
      uint32_t* h2 = hist + ((pass + 1) & 1) * kBins;
      for (int i = tid; i < kBins; i += kThreads) h2[i] = 0u;
      __syncthreads();
    }
  }
  // T = prefix. The last pass's bin `digit` counts each CTA's keys equal to
  // T; ties are taken in ascending chunk id, so CTA rank takes what the
  // lower ranks leave of `need`.
  uint32_t* h_last = hist + ((kPasses - 1) & 1) * kBins;
  int before = 0;
  for (int rk = 0; rk < rank; ++rk)
    before += (int)cluster.map_shared_rank(h_last, rk)[digit];
  const int my_eq = (int)h_last[digit];
  const int take = max(0, min(my_eq, need - before));

  // This range's chosen bits, word w covering chunks c0 + 32 w ...
  const int n_words = (n + 31) / 32;
  uint32_t* gt_w = reinterpret_cast<uint32_t*>(smem + a.off_rw);
  uint32_t* eq_w = gt_w + a.per / 32;
  int* eq_pre = reinterpret_cast<int*>(eq_w + a.per / 32);
  for (int w = warp; w < n_words; w += kWarps) {
    const int c = 32 * w + lane;
    const uint32_t key = c < n ? keys[c] : 0u;
    const unsigned gt = __ballot_sync(0xffffffffu, c < n && key > prefix);
    const unsigned eq = __ballot_sync(0xffffffffu, c < n && key == prefix);
    if (lane == 0) {
      gt_w[w] = gt;
      eq_w[w] = eq;
      eq_pre[w] = __popc(eq);
    }
  }
  __syncthreads();
  const bool partial = take > 0 && take < my_eq;
  if (partial) block_exclusive_scan(eq_pre, n_words, misc + 4);
  uint32_t* nbm0 = cluster.map_shared_rank(nbm, 0);
  for (int w = tid; w < n_words; w += kThreads) {
    uint32_t e = take == 0 ? 0u : eq_w[w];
    if (partial) {
      const int k = take - eq_pre[w];
      if (k <= 0) {
        e = 0u;
      } else if (k < __popc(e)) {
        uint32_t kept = 0u;
        for (int i = 0; i < k; ++i) {
          const uint32_t low = e & (0u - e);
          kept |= low;
          e ^= low;
        }
        e = kept;
      }
    }
    nbm0[(c0 >> 5) + w] = gt_w[w] | e;
  }
  cluster.sync();
  if (rank != 0) return;

  // CTA 0: the assignment.
  if (a.forced) {
    for (int i = tid; i < a.words; i += kThreads) nbm[i] = 0u;
    __syncthreads();
    const int* fr = a.forced + (size_t)bk * a.forced_stride;
    for (int s = tid; s < n_sel; s += kThreads) {
      const int f = fr[s];
      if (f >= 0 && f < n_chunks) atomicOr(&nbm[f >> 5], 1u << (f & 31));
    }
    __syncthreads();
  }
  int* vac = reinterpret_cast<int*>(smem + a.off_slots);  // a slot's rank
  int* vac_slot = vac + n_sel;                            // a rank's slot
  int* inc_pre = vac_slot + n_sel;                        // per word
  for (int s = tid; s < n_sel; s += kThreads) {
    const int p = s_prev[s];
    vac[s] = !(p >= 0 && p < n_chunks && bit_at(nbm, p));
  }
  for (int w = tid; w < a.words; w += kThreads)
    inc_pre[w] = __popc(nbm[w] & ~pbm[w]);
  __syncthreads();
  const int n_vac = block_exclusive_scan(vac, n_sel, misc + 4);
  block_exclusive_scan(inc_pre, a.words, misc + 4);
  int* slot_ids = a.slot_ids + (size_t)bk * n_sel;
  uint8_t* stay = a.stay + (size_t)bk * n_sel;
  for (int s = tid; s < n_sel; s += kThreads) {
    const int p = s_prev[s];
    const bool kept = p >= 0 && p < n_chunks && bit_at(nbm, p);
    stay[s] = kept;
    // a vacated slot left without an incoming id keeps the plain
    // version's pad (only a set of fewer than S ids leaves one)
    slot_ids[s] = kept ? p : (1 << 30);
    if (!kept) vac_slot[vac[s]] = s;
  }
  __syncthreads();
  for (int w = tid; w < a.words; w += kThreads) {
    uint32_t bits = nbm[w] & ~pbm[w];
    int r = inc_pre[w];
    while (bits) {
      const int i = __ffs(bits) - 1;
      bits &= bits - 1u;
      if (r < n_vac) slot_ids[vac_slot[r]] = 32 * w + i;
      ++r;
    }
  }
  if (tid == 0) a.stay_count[bk] = n_sel - n_vac;
}

template <int kDh, bool kInt8>
cudaError_t launch(const Args& a, int cluster, int pairs, int smem,
                   cudaStream_t s) {
  auto kernel = select_kernel<kDh, kInt8>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, pairs, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kDh>
cudaError_t launch_dtype(const Args& a, int int8, int cluster, int pairs,
                         int smem, cudaStream_t s) {
  return int8 ? launch<kDh, true>(a, cluster, pairs, smem, s)
              : launch<kDh, false>(a, cluster, pairs, smem, s);
}

}  // namespace

// out: the SM count and the largest dynamic shared memory a block may opt
// into, of the current device (the plan's inputs).
extern "C" int shadowkv_select_device(int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[0], cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&out[1],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// layout: cluster, per, sc_stride, words, smem, then the offsets off_q ..
// off_sc of Args (kernels/select.py::plan).
extern "C" int shadowkv_select(
    const void* q, const void* lm, const void* lm_scale, const void* mask,
    const void* prev, const void* forced, void* slot_ids, void* stay,
    void* stay_count, void* scratch, long long q_sb, long long q_sk,
    long long q_sg, long long q_sq, long long forced_stride, int batch,
    int kv_heads, int groups, int q_len, int chunks, int select_sets,
    int head_dim, int int8, const int* layout, float hyst_factor,
    void* stream) {
  if (batch < 1 || kv_heads < 1 || groups < 1 || q_len < 1 || chunks < 1 ||
      select_sets < 1 || select_sets > chunks || chunks % 4 || head_dim < 16 ||
      head_dim > 128 || head_dim % 16 || layout[0] < 1 || layout[0] > 8) {
    return (int)cudaErrorInvalidValue;
  }
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.lm = lm;
  a.lm_scale = static_cast<const float*>(lm_scale);
  a.mask = static_cast<const uint8_t*>(mask);
  a.prev = static_cast<const int*>(prev);
  a.forced = static_cast<const int*>(forced);
  a.slot_ids = static_cast<int*>(slot_ids);
  a.stay = static_cast<uint8_t*>(stay);
  a.stay_count = static_cast<int*>(stay_count);
  a.scratch = static_cast<float*>(scratch);
  a.q_sb = q_sb;
  a.q_sk = q_sk;
  a.q_sg = q_sg;
  a.q_sq = q_sq;
  a.forced_stride = forced_stride;
  a.kv_heads = kv_heads;
  a.groups = groups;
  a.q_len = q_len;
  a.chunks = chunks;
  a.select_sets = select_sets;
  a.rows_pad = (groups * q_len + 7) / 8 * 8;
  const int cluster = layout[0];
  a.per = layout[1];
  a.sc_stride = layout[2];
  a.words = layout[3];
  const int smem = layout[4];
  a.off_q = layout[5];
  a.off_mask = layout[6];
  a.off_scale = layout[7];
  a.off_prev = layout[8];
  a.off_pbm = layout[9];
  a.off_nbm = layout[10];
  a.off_hist = layout[11];
  a.off_stats = layout[12];
  a.off_misc = layout[13];
  a.off_rw = layout[14];
  a.off_slots = layout[15];
  a.off_sc = layout[16];
  a.hyst_factor = hyst_factor;
  const int pairs = batch * kv_heads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return (int)launch_dtype<16>(a, int8, cluster, pairs, smem, s);
    case 32: return (int)launch_dtype<32>(a, int8, cluster, pairs, smem, s);
    case 48: return (int)launch_dtype<48>(a, int8, cluster, pairs, smem, s);
    case 64: return (int)launch_dtype<64>(a, int8, cluster, pairs, smem, s);
    case 80: return (int)launch_dtype<80>(a, int8, cluster, pairs, smem, s);
    case 96: return (int)launch_dtype<96>(a, int8, cluster, pairs, smem, s);
    case 112: return (int)launch_dtype<112>(a, int8, cluster, pairs, smem, s);
    default: return (int)launch_dtype<128>(a, int8, cluster, pairs, smem, s);
  }
}
