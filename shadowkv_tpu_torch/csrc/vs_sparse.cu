// Block-sparse flash attention over vertical/slash block metadata (kernel G).
//
// Replaces shadowkv_tpu/kernels/vs_sparse.py:39 _vs_kernel (called through
// vs_sparse_attention :168), the vs_impl="walk" execution of MInference
// sparse prefill. For row r of [B*H] and query block qb the active key
// blocks are
//     active[qb, kb] = kb <= qb & (col_flag[kb] | diag_flag[qb - kb]),
// and token causality and k < seq_len mask the pairs inside a block; each
// active pair counts once. The metadata (VSMeta) gives col_flag [BH, nK]
// and the active diagonal offsets as a sorted list diag_ids [BH, nQ] with
// cumulative counts diag_cnt [BH, nQ]. q [BH, S_pad, 128], k/v [BKV, S_pad,
// 128] bf16; kv_map[r] names row r's K/V row.
//
// What bounds it on an H100: tensor-core operations over the active pairs,
// 4 * Dh per (query, key) pair (QK^T and PV), against the bytes of q, k, v
// and out read or written once.
// What the design does about it: the tile-plan loop of flash_sm90.cuh
// (wgmma, TMA/mbarrier K/V ring, S, P and O in registers, two passes) over
// BlockPlan, which kernels/vs_sparse.py::vs_walk_plan states in Python (the
// CPU tests hold it against the dense mask):
// - The row's column flags and its diagonal flags (scattered from
//   diag_ids[:diag_cnt[r, nQ - 1]]) go to shared memory as bytes, and one
//   warp writes the block's tile list there before the warpgroups split, so
//   the producer and the consumers walk the same tiles.
// - A 128-key tile at or below the block's last row is visited iff a
//   (query block, key block) pair that overlaps it is active and holds a
//   causal pair, in ascending order (the JAX walk's order, columns then
//   diagonals, changes only the f32 summation order). It is full (no
//   per-pair test) iff every overlapping pair is active, its last key is at
//   or below the block's first row and below seq_len. A tile spans at most
//   two query blocks and two key blocks (block 64: 2 x 2; block 128: one
//   pair; larger multiples of 64: one or two of each).
// - In a masked tile a row works out its query block and the activity of
//   the (at most two) key blocks once per tile, so a pair costs compares.
// - One launch covers all B*H rows (the TPU kernel's per-batch launch loop
//   was a scalar-memory limit). Grid (B*H rows, query blocks), rows fastest,
//   so the query heads of a KV group share K/V tiles in L2; the last
//   (heaviest) query blocks go first.

#include "flash_sm90.cuh"

namespace {

using sm90::kD;
using sm90::kTileRows;

constexpr int kFull = 1 << 30;  // tile list flag: every pair active
constexpr int kIndex = kFull - 1;

struct BlockPlan {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int kv_row;
  const unsigned char* col;   // shared: this row's n_blk column flags
  const unsigned char* diag;  // shared: this row's n_blk diagonal flags
  const int* list;            // shared: the visited tiles
  int n;
  int block;
  int seq_len;

  __device__ bool active(int qb, int kb) const {
    return kb <= qb && (col[kb] || diag[qb - kb]);
  }

  // One row of a masked tile: key column c counts iff c <= cmax (causal,
  // below seq_len) and its key block is active for the row's query block:
  // a below column cb, b from there (the tile's second key block).
  struct Row {
    int cmax;
    int cb;
    bool a;
    bool b;
    __device__ bool operator()(int c) const {
      return c <= cmax && (c < cb ? a : b);
    }
  };

  __device__ Row row(int k0, int qp) const {
    Row r{-1, 0, false, false};
    if (qp >= seq_len || qp < k0) return r;  // garbage row, or above the tile
    const int qb = qp / block;
    const int kb = k0 / block;
    r.cmax = min(qp - k0, seq_len - 1 - k0);
    r.cb = (kb + 1) * block - k0;
    r.a = active(qb, kb);
    r.b = r.cb < kTileRows && active(qb, kb + 1);
    return r;
  }

  __device__ int count() const { return n; }
  __device__ sm90::KvTile kv(int i) const {
    return {k, v, 0, (list[i] & kIndex) * kTileRows, kv_row};
  }
  __device__ bool full(int i) const { return (list[i] & kFull) != 0; }
  __device__ void mask(int i, float (&s)[64], int qp) const {
    const int k0 = (list[i] & kIndex) * kTileRows;
    sm90::mask_rows(s, row(k0, qp), row(k0, qp + 8));
  }
};

__global__ void __launch_bounds__(sm90::kThreads, 1)
vs_sparse_kernel(const __grid_constant__ CUtensorMap q_map,
                 const __grid_constant__ CUtensorMap k_map,
                 const __grid_constant__ CUtensorMap v_map,
                 const int* __restrict__ col_flag,
                 const int* __restrict__ diag_ids,
                 const int* __restrict__ diag_cnt,
                 const int* __restrict__ kv_map,
                 __nv_bfloat16* __restrict__ out, int s_pad, int block,
                 int seq_len, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  const int q1 = min(q0 + kTileRows, seq_len) - 1;  // last row that counts
  const int n_blk = s_pad / block;
  int* list = reinterpret_cast<int*>(sm90::plan_smem(smem_raw));
  // list[0] is the count; at most one entry per key tile follows; then the
  // column and the diagonal flags.
  unsigned char* col = reinterpret_cast<unsigned char*>(
      list + 1 + (s_pad + kTileRows - 1) / kTileRows);
  unsigned char* diag = col + n_blk;

  BlockPlan plan;
  plan.k = &k_map;
  plan.v = &v_map;
  plan.kv_row = kv_map[row];
  plan.col = col;
  plan.diag = diag;
  plan.list = list + 1;
  plan.block = block;
  plan.seq_len = seq_len;

  const size_t meta = (size_t)row * n_blk;
  for (int i = threadIdx.x; i < n_blk; i += sm90::kThreads) {
    col[i] = col_flag[meta + i] != 0;
    diag[i] = 0;
  }
  __syncthreads();
  // diag_cnt is cumulative: its last entry counts every active diagonal.
  const int n_diag = min(diag_cnt[meta + n_blk - 1], n_blk);
  for (int i = threadIdx.x; i < n_diag; i += sm90::kThreads) {
    const int d = diag_ids[meta + i];
    if (d >= 0 && d < n_blk) diag[d] = 1;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int n = 0;
    if (q0 < seq_len) {  // rows past seq_len are garbage (zeros here)
      const int qa = q0 / block;
      const int qz = q1 / block;
      n = sm90::warp_compact(list + 1, n, q1 / kTileRows + 1, [&](int t) {
        const int k0 = t * kTileRows;
        const int k1 = k0 + kTileRows - 1;
        const int kz = min(k1, s_pad - 1) / block;
        bool visit = false;
        bool all = true;
        for (int qb = qa; qb <= qz; ++qb) {
          for (int kb = k0 / block; kb <= kz; ++kb) {
            const bool act = plan.active(qb, kb);
            all = all && act;
            // a causal pair: the pair's first key at or below its last row
            visit = visit || (act && max(k0, kb * block) <=
                                         min(q1, qb * block + block - 1));
          }
        }
        if (!visit) return -1;
        return t | (all && k1 <= q0 && k1 < seq_len ? kFull : 0);
      });
    }
    if (threadIdx.x == 0) list[0] = n;
  }
  __syncthreads();
  plan.n = list[0];
  sm90::attend(plan, sm90::loop_base(smem_raw), &q_map, 0, q0, row,
               scale_log2, out + ((size_t)row * s_pad + q0) * kD, kD,
               s_pad - q0);
}

// Shared memory of one block: the loop's, then the tile list (count, one
// entry per key tile) and the column and diagonal flags.
size_t vs_sparse_smem(int s_pad, int block) {
  return sm90::kLoopSmemBytes +
         4 * (1 + (size_t)(s_pad + kTileRows - 1) / kTileRows) +
         2 * (size_t)(s_pad / block);
}

}  // namespace

extern "C" int shadowkv_vs_sparse_attention(
    const void* q, const void* k, const void* v, const void* col_flag,
    const void* diag_ids, const void* diag_cnt, const void* kv_map, void* out,
    int rows, int kv_rows, int s_pad, int block, int seq_len, float scale,
    void* stream) {
  const int q_blocks = (s_pad + kTileRows - 1) / kTileRows;
  if (rows <= 0 || kv_rows <= 0 || block <= 0 || block % 64 != 0 ||
      s_pad % block != 0 || seq_len <= 0 || seq_len > s_pad ||
      q_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = vs_sparse_smem(s_pad, block);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap q_map, k_map, v_map;
  cudaError_t err = sm90::encode_rows(&q_map, q, rows, s_pad, 1);
  if (err == cudaSuccess) err = sm90::encode_rows(&k_map, k, kv_rows, s_pad, 1);
  if (err == cudaSuccess) err = sm90::encode_rows(&v_map, v, kv_rows, s_pad, 1);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(vs_sparse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(rows, q_blocks);
  vs_sparse_kernel<<<grid, sm90::kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<const int*>(col_flag),
      static_cast<const int*>(diag_ids), static_cast<const int*>(diag_cnt),
      static_cast<const int*>(kv_map), static_cast<__nv_bfloat16*>(out), s_pad,
      block, seq_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
