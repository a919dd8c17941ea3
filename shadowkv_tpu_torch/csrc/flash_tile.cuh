// The flash-attention tile loop shared by the sparse prefill kernels F
// (vs_tile.cu) and G (vs_sparse.cu); B and C (prefill_attention.cu) moved
// to the Hopper building blocks of flash_sm90.cuh.
//
// One block of 4 warps owns 64 query rows of one head (16 rows per warp)
// and visits the 64-key tiles its kernel picks; which tiles a kernel visits
// and which (row, key) pairs of a visited tile are active is all that tells
// the kernels apart. Scores and P @ V run on bf16 tensor cores through
// 16x16x16 wmma fragments with f32 accumulation; the online softmax keeps
// each row's max and sum in the warp's registers (every lane holds all 16
// rows' values); the f32 output accumulator lives in shared memory so the
// softmax rescale can address it by row. A row that no active pair reached
// is written as zeros.
//
// Use: carve(); load_rows(sm.q, ...); begin(); then per visited tile
// load_kv() and tile(); finally finish(). Every call is made by all threads
// of the block (the loads synchronise the block).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace flash {

using namespace nvcuda;

constexpr int kBM = 64;  // query rows per block (16 per warp)
constexpr int kBN = 64;  // keys per tile
constexpr int kD = 128;  // head_dim served
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdT = kD + 8;   // bf16 q/k/v tiles
constexpr int kLdS = kBN + 4;  // f32 scores
constexpr int kLdP = kBN + 8;  // bf16 probabilities
constexpr int kLdO = kD + 4;   // f32 output accumulator

// Shared memory of the tile loop; a kernel's own data may follow it.
constexpr size_t kSmemBytes =
    3 * kBM * kLdT * sizeof(__nv_bfloat16) + kBM * kLdS * sizeof(float) +
    kBM * kLdP * sizeof(__nv_bfloat16) + kBM * kLdO * sizeof(float) +
    kBM * sizeof(float) + kBN * sizeof(int);

struct Smem {
  __nv_bfloat16* q;
  __nv_bfloat16* k;
  __nv_bfloat16* v;
  float* s;
  __nv_bfloat16* p;
  float* o;
  float* row;  // per-row rescale factor, then 1 / sum
  int* col;    // per-key value a kernel stores with its tile (load_kv)
  unsigned char* extra;  // the kernel's own data, past kSmemBytes
};

__device__ inline Smem carve(unsigned char* base) {
  Smem m;
  m.q = reinterpret_cast<__nv_bfloat16*>(base);
  m.k = m.q + kBM * kLdT;
  m.v = m.k + kBN * kLdT;
  m.s = reinterpret_cast<float*>(m.v + kBN * kLdT);
  m.p = reinterpret_cast<__nv_bfloat16*>(m.s + kBM * kLdS);
  m.o = reinterpret_cast<float*>(m.p + kBM * kLdP);
  m.row = m.o + kBM * kLdO;
  m.col = reinterpret_cast<int*>(m.row + kBM);
  m.extra = reinterpret_cast<unsigned char*>(m.col + kBN);
  return m;
}

// Copies 64 rows of kD bf16 from src + r * stride into dst (leading
// dimension kLdT) as 16-byte vectors; rows r >= n_valid become zeros.
__device__ inline void load_rows(__nv_bfloat16* dst,
                                 const __nv_bfloat16* __restrict__ src,
                                 size_t stride, int n_valid) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int idx = threadIdx.x; idx < kBM * (kD / 8); idx += kThreads) {
    const int r = idx / (kD / 8);
    const int c8 = idx - r * (kD / 8);
    uint4 val = zero;
    if (r < n_valid) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c8 * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * kLdT + c8 * 8) = val;
  }
}

struct Rows {
  float m[16];  // running max (log2 units) of the warp's 16 rows
  float l[16];  // running sum
};

// Zeroes the output accumulator and the row statistics.
__device__ inline void begin(const Smem& sm, Rows& st) {
  for (int idx = threadIdx.x; idx < kBM * kLdO; idx += kThreads) sm.o[idx] = 0.f;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    st.m[r] = -INFINITY;
    st.l[r] = 0.f;
  }
}

// Loads one 64-key tile of K and V (rows past n_valid zero) and stores
// col(c) for each of its 64 keys in sm.col, between two block barriers.
template <class ColFn>
__device__ inline void load_kv(const Smem& sm, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, size_t stride,
                               int n_valid, ColFn col) {
  __syncthreads();  // every warp is done with the previous tile
  load_rows(sm.k, k, stride, n_valid);
  load_rows(sm.v, v, stride, n_valid);
  if (threadIdx.x < kBN) sm.col[threadIdx.x] = col(threadIdx.x);
  __syncthreads();
}

__device__ inline void load_kv(const Smem& sm, const __nv_bfloat16* k,
                               const __nv_bfloat16* v, size_t stride,
                               int n_valid) {
  load_kv(sm, k, v, stride, n_valid, [](int) { return 0; });
}

// One tile: S = Q K^T for the warp's 16 rows, the online softmax over the
// pairs with active(row, key) (row and key index the block's 64 rows and
// the tile's 64 keys), O = O * alpha + P V.
template <class Active>
__device__ inline void tile(const Smem& sm, Rows& st, float scale_log2,
                            Active active) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;

#pragma unroll
  for (int nf = 0; nf < kBN / 16; ++nf) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sm.q + row0 * kLdT + kk * 16, kLdT);
      wmma::load_matrix_sync(fb, sm.k + nf * 16 * kLdT + kk * 16, kLdT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sm.s + row0 * kLdS + nf * 16, acc, kLdS,
                            wmma::mem_row_major);
  }
  __syncwarp();

  // Online softmax: two keys per lane and row, reduced across the warp.
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = row0 + r;
    float s0 = sm.s[row * kLdS + lane] * scale_log2;
    float s1 = sm.s[row * kLdS + lane + 32] * scale_log2;
    if (!active(row, lane)) s0 = -INFINITY;
    if (!active(row, lane + 32)) s1 = -INFINITY;
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float m_new = fmaxf(st.m[r], mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float p0 = exp2f(s0 - m_use);
    const float p1 = exp2f(s1 - m_use);
    float sum = p0 + p1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    const float alpha = exp2f(st.m[r] - m_use);
    st.l[r] = st.l[r] * alpha + sum;
    st.m[r] = m_new;
    sm.p[row * kLdP + lane] = __float2bfloat16(p0);
    sm.p[row * kLdP + lane + 32] = __float2bfloat16(p1);
    if (lane == 0) sm.row[row] = alpha;
  }
  __syncwarp();

  for (int idx = lane; idx < 16 * kD; idx += 32) {
    const int r = idx / kD;
    const int c = idx - r * kD;
    sm.o[(row0 + r) * kLdO + c] *= sm.row[row0 + r];
  }
  __syncwarp();

#pragma unroll
  for (int df = 0; df < kD / 16; ++df) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, sm.o + row0 * kLdO + df * 16, kLdO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sm.p + row0 * kLdP + kk * 16, kLdP);
      wmma::load_matrix_sync(fb, sm.v + kk * 16 * kLdT + df * 16, kLdT);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(sm.o + row0 * kLdO + df * 16, acc, kLdO,
                            wmma::mem_row_major);
  }
  __syncwarp();
}

// Writes the block's rows r < n_valid as bf16 O / sum to out + r * stride.
__device__ inline void finish(const Smem& sm, const Rows& st,
                              __nv_bfloat16* out, size_t stride, int n_valid) {
  __syncthreads();  // the accumulator was zeroed by all threads
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row0 = warp * 16;
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (lane == r) sm.row[row0 + r] = st.l[r] > 0.f ? 1.f / st.l[r] : 0.f;
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * (kD / 8); idx += 32) {
    const int r = idx / (kD / 8);
    const int c8 = idx - r * (kD / 8);
    const int row = row0 + r;
    if (row >= n_valid) continue;
    const float inv = sm.row[row];
    __align__(16) __nv_bfloat16 vals[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      vals[e] = __float2bfloat16(sm.o[row * kLdO + c8 * 8 + e] * inv);
    }
    *reinterpret_cast<uint4*>(out + (size_t)row * stride + c8 * 8) =
        *reinterpret_cast<const uint4*>(vals);
  }
}

}  // namespace flash
