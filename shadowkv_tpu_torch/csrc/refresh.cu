// Fused sparse-buffer refresh for one layer of the ShadowKV decode step.
//
// Replaces the TPU kernel shadowkv_tpu/kernels/reconstruct.py::_refresh_kernel
// (wrapper sparse_refresh). For every (batch, kv head) it walks the compacted
// miss list (miss_chunk[:miss_cnt], ascending, no duplicates) and, for each
// missed chunk cid written into sparse slot s:
//   * rebuilds K rows = (U[cid rows] @ SV[b, k]) * u_scale with f32
//     accumulation, applies RoPE at positions cid*cs + i (neox rotate-half or
//     glm interleaved pairs over the first rope_dim lanes, f32 trig from
//     inv_freq_full) and stores bf16 rows to k_buf[b, k, sparse_start + s*cs];
//   * dequantizes V rows (int8 * bf16 per-token scale, rounded to bf16 as the
//     TPU kernel's bf16 multiply does) or copies them (bf16 stores) into v_buf.
// Hit slots move no bytes.
//
// The V store may lie in pinned host memory (CacheConfig mode
// "shadow_offload"; the TPU kernel's host_v variant): the kernel then reads
// the missed chunks' V rows in place over the host link, through the mapped
// address that shadowkv_kernel_pointer (gather.cu) checks and returns. All
// other operands, the V scales included, stay in device memory.
//
// What bounds it on an H100: device-memory bytes. Per missed chunk it reads
// cs*rank U bytes and cs*Dh V bytes and writes 2*cs*Dh bf16 rows; the product
// is cs*rank*Dh multiply-adds, far below the card's operation rate per byte.
// At high hit rates most (b, k) cells have few or no misses, so launch and
// per-block setup dominate instead. With V on the host, the missed chunks'
// V bytes over the host link bound it (2 KB per int8 chunk, ~50 GB/s).
// What the design does about it: one block per (b, k, group of 64/cs misses);
// blocks past the miss count return before touching memory, so all-hit heads
// cost a launch slot only. Each block stages SV[b, k] (rank x Dh bf16) and its
// U rows in shared memory once and computes the [64 x Dh] product with
// register-tiled scalar FMAs (no tensor cores: the product is too small per
// block to pay for them in this first version). V rows move as 16-byte
// vectors, loaded into registers right after the block's miss list is known
// and stored after the K epilogue, so a V read's latency (1-2 us over the
// host link) overlaps the U staging and the product instead of adding to them.
// Scale and RoPE are fused into the epilogue, so K never round-trips through
// device memory in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;       // token rows per block
constexpr int kThreads = 256;   // 16 x 16 thread tile
constexpr int kDh = 128;        // head_dim served by this kernel
constexpr int kUStride = kRows + 4;  // f32 words per rank row of staged U
constexpr int kVSegs = kDh / 16;     // 16-element V segments per row
constexpr int kVIters = kRows * kVSegs / kThreads;  // V segments per thread

struct RefreshArgs {
  const void* u;              // [B, n_rows, rank] int8 | bf16
  const __nv_bfloat16* u_scale;  // [B, n_rows] (int8 only)
  const __nv_bfloat16* sv;    // [B, K, rank, Dh]
  const void* v;              // [B, K, n_rows, Dh] int8 | bf16
  const __nv_bfloat16* v_scale;  // [B, K, n_rows] (int8 only)
  const float* inv_freq;      // [Dh]
  const int* miss_chunk;      // [B, K, S]
  const int* miss_slot;       // [B, K, S]
  const int* miss_cnt;        // [B, K]
  __nv_bfloat16* k_buf;       // [B, K, cap, Dh]
  __nv_bfloat16* v_buf;       // [B, K, cap, Dh]
  int kv_heads, n_rows, rank, select_sets, cap;
  int chunk_size, sparse_start, rope_dim, glm;
};

size_t region_bytes(int rank) {
  size_t u_stage = (size_t)rank * kUStride * sizeof(float);
  size_t out_tile = (size_t)kRows * kDh * sizeof(float);
  return u_stage > out_tile ? u_stage : out_tile;
}

size_t smem_bytes(int rank) {
  return 5 * kRows * sizeof(int) + (size_t)rank * kDh * sizeof(__nv_bfloat16) +
         region_bytes(rank);
}

template <bool kQuant>
__global__ void __launch_bounds__(kThreads) refresh_kernel(RefreshArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bk = blockIdx.y;
  const int b = bk / a.kv_heads;
  const int n = a.miss_cnt[bk];
  const int cs = a.chunk_size;
  const int chunks_per_block = kRows / cs;
  const int j0 = blockIdx.x * chunks_per_block;
  if (j0 >= n) return;  // all-hit (or short-list) cells end here

  int* s_src = reinterpret_cast<int*>(smem);        // source row in U / V
  int* s_dst = s_src + kRows;                      // destination buffer row
  float* s_pos = reinterpret_cast<float*>(s_dst + kRows);
  float* s_usc = s_pos + kRows;
  float* s_vsc = s_usc + kRows;
  __nv_bfloat16* s_sv = reinterpret_cast<__nv_bfloat16*>(s_vsc + kRows);
  float* s_u = reinterpret_cast<float*>(s_sv + (size_t)a.rank * kDh);
  float* s_out = s_u;  // reused after the product: [kRows][kDh] f32

  const int tid = threadIdx.x;
  if (tid < kRows) {
    const int j = j0 + tid / cs;
    const int i = tid % cs;
    if (j < n) {
      const int cid = a.miss_chunk[bk * a.select_sets + j];
      const int slot = a.miss_slot[bk * a.select_sets + j];
      const int src = cid * cs + i;
      s_src[tid] = src;
      s_dst[tid] = a.sparse_start + slot * cs + i;
      s_pos[tid] = (float)cid * (float)cs + (float)i;
      if (kQuant) {
        s_usc[tid] = __bfloat162float(a.u_scale[(size_t)b * a.n_rows + src]);
        s_vsc[tid] = __bfloat162float(a.v_scale[(size_t)bk * a.n_rows + src]);
      } else {
        s_usc[tid] = 1.f;
        s_vsc[tid] = 1.f;
      }
    } else {
      s_src[tid] = -1;
      s_dst[tid] = -1;
    }
  }

  // SV[b, k] -> shared memory as 16-byte vectors.
  {
    const uint4* src = reinterpret_cast<const uint4*>(
        a.sv + (size_t)bk * a.rank * kDh);
    uint4* dst = reinterpret_cast<uint4*>(s_sv);
    const int n_vec = a.rank * kDh / 8;
    for (int idx = tid; idx < n_vec; idx += kThreads) dst[idx] = src[idx];
  }
  __syncthreads();

  // V rows -> registers: segment it*kThreads + tid of the block's rows, 16
  // elements each (one 16-byte vector of int8, two of bf16).
  constexpr int kVLoads = kQuant ? 1 : 2;
  uint4 v_raw[kVIters][kVLoads];
#pragma unroll
  for (int it = 0; it < kVIters; ++it) {
    const int idx = tid + it * kThreads;
    const int row = idx / kVSegs;
    const int src = s_src[row];
    if (src < 0) continue;
    const size_t off = ((size_t)bk * a.n_rows + src) * kDh + (idx % kVSegs) * 16;
    const uint4* in = kQuant
        ? reinterpret_cast<const uint4*>(reinterpret_cast<const int8_t*>(a.v) + off)
        : reinterpret_cast<const uint4*>(
              reinterpret_cast<const __nv_bfloat16*>(a.v) + off);
#pragma unroll
    for (int e = 0; e < kVLoads; ++e) v_raw[it][e] = in[e];
  }

  // U rows -> shared memory, transposed to [rank][row] f32 (zeros for rows
  // past the miss count).
  for (int idx = tid; idx < kRows * a.rank; idx += kThreads) {
    const int i = idx / a.rank;
    const int r = idx - i * a.rank;
    const int src = s_src[i];
    float val = 0.f;
    if (src >= 0) {
      const size_t off = ((size_t)b * a.n_rows + src) * a.rank + r;
      if (kQuant) {
        val = (float)reinterpret_cast<const int8_t*>(a.u)[off];
      } else {
        val = __bfloat162float(
            reinterpret_cast<const __nv_bfloat16*>(a.u)[off]);
      }
    }
    s_u[r * kUStride + i] = val;
  }
  __syncthreads();

  // [kRows x rank] @ [rank x kDh]: thread (ty, tx) owns rows ty*4..ty*4+3 and
  // columns tx + 16*jj.
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][8];
#pragma unroll
  for (int ii = 0; ii < 4; ++ii)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[ii][jj] = 0.f;
  for (int r = 0; r < a.rank; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(&s_u[r * kUStride + ty * 4]);
    float bv[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) bv[jj] = __bfloat162float(s_sv[r * kDh + tx + 16 * jj]);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      acc[0][jj] = fmaf(av.x, bv[jj], acc[0][jj]);
      acc[1][jj] = fmaf(av.y, bv[jj], acc[1][jj]);
      acc[2][jj] = fmaf(av.z, bv[jj], acc[2][jj]);
      acc[3][jj] = fmaf(av.w, bv[jj], acc[3][jj]);
    }
  }
  __syncthreads();  // every thread is done reading s_u before s_out reuses it
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int row = ty * 4 + ii;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      s_out[row * kDh + tx + 16 * jj] = acc[ii][jj] * s_usc[row];
    }
  }
  __syncthreads();

  // RoPE epilogue and K store (row-contiguous, coalesced).
  const int half = a.rope_dim / 2;
  for (int idx = tid; idx < kRows * kDh; idx += kThreads) {
    const int row = idx / kDh;
    const int c = idx - row * kDh;
    const int dst = s_dst[row];
    if (dst < 0) continue;
    const float x = s_out[idx];
    float out = x;
    if (c < a.rope_dim) {
      int pc;
      float sign;
      if (a.glm) {
        pc = c ^ 1;
        sign = (c & 1) ? 1.f : -1.f;
      } else {
        pc = c < half ? c + half : c - half;
        sign = c < half ? -1.f : 1.f;
      }
      const float p = s_out[row * kDh + pc];
      const float ang = s_pos[row] * a.inv_freq[c];
      float sn, cn;
      sincosf(ang, &sn, &cn);  // precise: angles reach ~1e5 rad at 128K
      out = x * cn + (p * sign) * sn;
    }
    a.k_buf[((size_t)bk * a.cap + dst) * kDh + c] = __float2bfloat16(out);
  }

  // V rows from registers: dequantize int8 segments, store 16-byte vectors.
#pragma unroll
  for (int it = 0; it < kVIters; ++it) {
    const int idx = tid + it * kThreads;
    const int row = idx / kVSegs;
    const int dst = s_dst[row];
    if (dst < 0) continue;
    const size_t dst_off = ((size_t)bk * a.cap + dst) * kDh + (idx % kVSegs) * 16;
    uint4* out = reinterpret_cast<uint4*>(a.v_buf + dst_off);
    if constexpr (kQuant) {
      const int8_t* q = reinterpret_cast<const int8_t*>(&v_raw[it][0]);
      const float sc = s_vsc[row];
      __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        // int8 * bf16 is exact in f32; one rounding to bf16 equals the TPU
        // kernel's bf16 multiply.
        vals[e] = __float2bfloat16((float)q[e] * sc);
      }
      out[0] = reinterpret_cast<const uint4*>(vals)[0];
      out[1] = reinterpret_cast<const uint4*>(vals)[1];
    } else {
      out[0] = v_raw[it][0];
      out[1] = v_raw[it][1];
    }
  }
}

}  // namespace

extern "C" int shadowkv_kernel_pointer(const void* p, const void** out);

extern "C" int shadowkv_sparse_refresh(
    const void* u, const void* u_scale, const void* sv, const void* v,
    const void* v_scale, const void* inv_freq, const void* miss_chunk,
    const void* miss_slot, const void* miss_cnt, void* k_buf, void* v_buf,
    int batch, int kv_heads, int n_rows, int rank, int head_dim,
    int select_sets, int cap, int chunk_size, int sparse_start, int rope_dim,
    int glm, int quant, void* stream) {
  if (head_dim != kDh || kRows % chunk_size != 0 || rank <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const void* v_dev = nullptr;  // v may be pinned host memory
  const int rc = shadowkv_kernel_pointer(v, &v_dev);
  if (rc) return rc;
  RefreshArgs a;
  a.u = u;
  a.u_scale = static_cast<const __nv_bfloat16*>(u_scale);
  a.sv = static_cast<const __nv_bfloat16*>(sv);
  a.v = v_dev;
  a.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  a.inv_freq = static_cast<const float*>(inv_freq);
  a.miss_chunk = static_cast<const int*>(miss_chunk);
  a.miss_slot = static_cast<const int*>(miss_slot);
  a.miss_cnt = static_cast<const int*>(miss_cnt);
  a.k_buf = static_cast<__nv_bfloat16*>(k_buf);
  a.v_buf = static_cast<__nv_bfloat16*>(v_buf);
  a.kv_heads = kv_heads;
  a.n_rows = n_rows;
  a.rank = rank;
  a.select_sets = select_sets;
  a.cap = cap;
  a.chunk_size = chunk_size;
  a.sparse_start = sparse_start;
  a.rope_dim = rope_dim;
  a.glm = glm;

  const size_t smem = smem_bytes(rank);
  const int chunks_per_block = kRows / chunk_size;
  dim3 grid((select_sets + chunks_per_block - 1) / chunks_per_block,
            batch * kv_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (quant) {
    err = cudaFuncSetAttribute(refresh_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    refresh_kernel<true><<<grid, kThreads, smem, s>>>(a);
  } else {
    err = cudaFuncSetAttribute(refresh_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    refresh_kernel<false><<<grid, kThreads, smem, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" long long shadowkv_sparse_refresh_smem_bytes(int rank) {
  return (long long)smem_bytes(rank);
}
