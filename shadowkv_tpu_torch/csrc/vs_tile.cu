// Vertical + slash sparse prefill attention (kernel F).
//
// Replaces shadowkv_tpu/kernels/vs_tile.py:48 _vs_tile_kernel (called
// through vs_tile_attention :269), the default vs_impl="tile" execution of
// MInference sparse prefill. For row r of [B*H]:
//     active(q, k) = k <= q & k < seq_len
//                    & (diag_flag[r, (q - k) / block] | k in verticals[r])
// with one online softmax, each active pair counted once: a diagonal phase
// over the key tiles of q's active bands that skips vertical tokens, then a
// vertical phase over the gathered vertical K/V rows, masked by causality
// only. q [BH, S_pad, 128], k/v [BKV, S_pad, 128] bf16; the host prepares
// (kernels/vs_tile.py::prepare_verticals) k_sel/v_sel [BH, NV, 128] (each
// row's deduplicated vertical tokens, ascending, pads last), vpos [BH, NV]
// int32 (their positions, pads 2 * S_pad), vflag [BH, S_pad] uint8 (token is
// a vertical) and dflag [BH, nK] uint8 (band flags).
//
// What bounds it on an H100: tensor-core operations over the active pairs,
// 4 * Dh per (query, key) pair, against q, k, v and out read or written
// once plus the gathered vertical rows.
// What the design does about it: one block of the flash loop in
// flash_tile.cuh per 64 query rows of a row. The row's band flags sit in
// shared memory; the diagonal phase visits a 64-key tile only if one of the
// bands its pairs fall in (at most three at block 128) is active, so the
// TPU's 512-wide diagonal groups and their XLA-side group lists are not
// needed, and tests the band of each pair only in a tile where some band
// is off; the vertical phase stops at the first tile whose smallest
// position lies past the block's last query. Blocks run heaviest (last)
// query tiles first.

#include "flash_tile.cuh"

namespace {

using flash::kBM;
using flash::kBN;
using flash::kD;

__global__ void __launch_bounds__(flash::kThreads)
vs_tile_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const __nv_bfloat16* __restrict__ k_sel,
               const __nv_bfloat16* __restrict__ v_sel,
               const int* __restrict__ vpos,
               const unsigned char* __restrict__ vflag,
               const unsigned char* __restrict__ dflag,
               const int* __restrict__ kv_map, __nv_bfloat16* __restrict__ out,
               int s_pad, int nv, int nk, int block, int seq_len,
               float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const flash::Smem sm = flash::carve(smem);
  unsigned char* bands = sm.extra;  // this row's nk band flags

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBM;
  const int row = blockIdx.y;
  const __nv_bfloat16* kr = k + (size_t)kv_map[row] * s_pad * kD;
  const __nv_bfloat16* vr = v + (size_t)kv_map[row] * s_pad * kD;
  const unsigned char* vf = vflag + (size_t)row * s_pad;
  const int* vp = vpos + (size_t)row * nv;

  flash::load_rows(sm.q, q + ((size_t)row * s_pad + q0) * kD, kD, kBM);
  flash::Rows st;
  flash::begin(sm, st);
  for (int i = threadIdx.x; i < nk; i += flash::kThreads) {
    bands[i] = dflag[(size_t)row * nk + i];
  }
  __syncthreads();

  const int last = min(q0 + kBM, seq_len) - 1;  // last key any row may see
  if (q0 < seq_len) {  // rows past seq_len are garbage (zeros here)
    // Diagonal phase: the pairs of the tile at k0 lie in the distances
    // [max(0, q0 - k0 - 63), q0 + 63 - k0].
    for (int k0 = 0; k0 <= last; k0 += kBN) {
      const int b_lo = max(0, q0 - k0 - (kBN - 1)) / block;
      const int b_hi = min((q0 + kBM - 1 - k0) / block, nk - 1);
      int n_on = 0;
      for (int bb = b_lo; bb <= b_hi; ++bb) n_on += bands[bb] != 0;
      if (n_on == 0) continue;
      flash::load_kv(sm, kr + (size_t)k0 * kD, vr + (size_t)k0 * kD, kD, kBN,
                     [&](int c) { return (int)vf[k0 + c]; });
      // Where every band of the tile is on, the band test is true for all
      // its causal pairs (the common case inside slash runs).
      if (n_on == b_hi - b_lo + 1) {
        flash::tile(sm, st, scale_log2, [&](int r, int c) {
          const int kp = k0 + c;
          return kp <= q0 + r && kp < seq_len && sm.col[c] == 0;
        });
        continue;
      }
      flash::tile(sm, st, scale_log2, [&](int r, int c) {
        const int qp = q0 + r;
        const int kp = k0 + c;
        return kp <= qp && kp < seq_len && sm.col[c] == 0 &&
               bands[(qp - kp) / block] != 0;
      });
    }
    // Vertical phase: positions ascend, pads (2 * S_pad) come last.
    for (int j0 = 0; j0 < nv; j0 += kBN) {
      if (vp[j0] > last) break;
      const size_t off = ((size_t)row * nv + j0) * kD;
      flash::load_kv(sm, k_sel + off, v_sel + off, kD, kBN,
                     [&](int c) { return vp[j0 + c]; });
      flash::tile(sm, st, scale_log2, [&](int r, int c) {
        const int kp = sm.col[c];
        return kp <= q0 + r && kp < seq_len;
      });
    }
  }
  flash::finish(sm, st, out + ((size_t)row * s_pad + q0) * kD, kD, kBM);
}

}  // namespace

extern "C" int shadowkv_vs_tile_attention(
    const void* q, const void* k, const void* v, const void* k_sel,
    const void* v_sel, const void* vpos, const void* vflag, const void* dflag,
    const void* kv_map, void* out, int rows, int kv_rows, int s_pad, int nv,
    int nk, int block, int seq_len, float scale, void* stream) {
  if (rows <= 0 || kv_rows <= 0 || block <= 0 || s_pad % kBM != 0 ||
      nv % kBN != 0 || nk != (s_pad + block - 1) / block || seq_len <= 0 ||
      seq_len > s_pad) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = flash::kSmemBytes + ((size_t)nk + 15) / 16 * 16;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vs_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(s_pad / kBM, rows);
  vs_tile_kernel<<<grid, flash::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(k_sel),
      static_cast<const __nv_bfloat16*>(v_sel), static_cast<const int*>(vpos),
      static_cast<const unsigned char*>(vflag),
      static_cast<const unsigned char*>(dflag), static_cast<const int*>(kv_map),
      static_cast<__nv_bfloat16*>(out), s_pad, nv, nk, block, seq_len,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
