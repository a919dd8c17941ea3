// Block-sparse flash attention over vertical/slash block metadata (kernel G).
//
// Replaces shadowkv_tpu/kernels/vs_sparse.py:39 _vs_kernel (called through
// vs_sparse_attention :168), the vs_impl="walk" execution of MInference
// sparse prefill. For row r of [B*H] and query block qb the active key
// blocks are
//     active[qb, kb] = causal & (col_flag[kb] | diag_flag[qb - kb]),
// given as sorted id lists with causal prefix counts (VSMeta): the column
// blocks col_ids[r, :col_cnt[r, qb]] and the diagonal blocks
// qb - diag_ids[r, :diag_cnt[r, qb]]; a diagonal block that is also a column
// is skipped, so every active block counts once. Token causality and
// k < seq_len mask the pairs inside a block. q [BH, S_pad, 128], k/v
// [BKV, S_pad, 128] bf16; kv_map[r] names row r's K/V row.
//
// What bounds it on an H100: tensor-core operations over the active pairs,
// 4 * Dh per (query, key) pair (QK^T and PV), against the bytes of q, k, v
// and out read or written once.
// What the design does about it: one block of the flash loop in
// flash_tile.cuh per 64 query rows of a row (half of a 128 block), walking
// only the active blocks as 64-key tiles, skipping tiles above the diagonal
// and past seq_len; the metadata is read from device memory by every
// thread (uniform loads). One launch covers all B*H rows: the TPU kernel's
// per-batch launch loop was a scalar-memory limit. Blocks run heaviest
// (last) query tiles first.

#include "flash_tile.cuh"

namespace {

using flash::kBM;
using flash::kBN;
using flash::kD;

__global__ void __launch_bounds__(flash::kThreads)
vs_sparse_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ col_ids, const int* __restrict__ col_cnt,
                 const int* __restrict__ col_flag,
                 const int* __restrict__ diag_ids,
                 const int* __restrict__ diag_cnt,
                 const int* __restrict__ kv_map, __nv_bfloat16* __restrict__ out,
                 int s_pad, int block, int seq_len, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const flash::Smem sm = flash::carve(smem);

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int row = blockIdx.y;
  const int n_blk = s_pad / block;
  const int qb = q0 / block;
  const size_t base = (size_t)row * n_blk;
  const __nv_bfloat16* kr = k + (size_t)kv_map[row] * s_pad * kD;
  const __nv_bfloat16* vr = v + (size_t)kv_map[row] * s_pad * kD;

  flash::load_rows(sm.q, q + ((size_t)row * s_pad + q0) * kD, kD, kBM);
  flash::Rows st;
  flash::begin(sm, st);

  auto visit_block = [&](int kb) {
    kb = min(max(kb, 0), n_blk - 1);  // a bad id reads a wrong block, never
                                      // out of bounds
    for (int k0 = kb * block; k0 < (kb + 1) * block; k0 += kBN) {
      if (k0 > q0 + kBM - 1 || k0 >= seq_len) break;  // causal / past S
      flash::load_kv(sm, kr + (size_t)k0 * kD, vr + (size_t)k0 * kD, kD, kBN);
      flash::tile(sm, st, scale_log2, [&](int r, int c) {
        const int kp = k0 + c;
        return kp <= q0 + r && kp < seq_len;
      });
    }
  };
  if (q0 < seq_len) {  // rows past seq_len are garbage (zeros here)
    const int n1 = col_cnt[base + qb];
    for (int i = 0; i < n1; ++i) visit_block(col_ids[base + i]);
    const int n2 = diag_cnt[base + qb];
    for (int i = 0; i < n2; ++i) {
      const int kb = qb - diag_ids[base + i];
      if (kb < 0 || kb >= n_blk || col_flag[base + kb]) continue;
      visit_block(kb);
    }
  }
  flash::finish(sm, st, out + ((size_t)row * s_pad + q0) * kD, kD, kBM);
}

}  // namespace

extern "C" int shadowkv_vs_sparse_attention(
    const void* q, const void* k, const void* v, const void* col_ids,
    const void* col_cnt, const void* col_flag, const void* diag_ids,
    const void* diag_cnt, const void* kv_map, void* out, int rows, int kv_rows,
    int s_pad, int block, int seq_len, float scale, void* stream) {
  if (rows <= 0 || kv_rows <= 0 || block <= 0 || block % kBN != 0 ||
      s_pad % block != 0 || seq_len <= 0 || seq_len > s_pad) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      vs_sparse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)flash::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s_pad / kBM, rows);
  vs_sparse_kernel<<<grid, flash::kThreads, flash::kSmemBytes,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(col_ids),
      static_cast<const int*>(col_cnt), static_cast<const int*>(col_flag),
      static_cast<const int*>(diag_ids), static_cast<const int*>(diag_cnt),
      static_cast<const int*>(kv_map), static_cast<__nv_bfloat16*>(out), s_pad,
      block, seq_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
