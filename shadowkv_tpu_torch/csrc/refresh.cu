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
// What bounds it on an H100: bytes. Per missed row it reads rank U bytes and
// Dh V bytes and writes two bf16 rows of Dh; the product is rank*Dh
// multiply-adds a row (~0.84 GFLOP at the slice's mix), which the tensor
// cores finish in under a microsecond. With V on the host, the V bytes over
// the host link bound it (2 KB per int8 chunk, ~50 GB/s).
//
// What the design does about it:
// - A block owns one (b, k) and a run of kRows = 64 of its missed rows
//   (rows of the concatenated missed chunks, so any chunk size works); blocks
//   past the head's missed rows return before touching memory, so all-hit
//   heads cost a launch slot only. SV[b, k] is staged once per block, from
//   L2 after the first. Each block's phases (dependent loads of the miss
//   list, product, RoPE, stores) run in turn, so the time is about one
//   block's span times the number of waves, not device-memory bytes:
//   blocks of 64 rows timed fastest of 32, 64, 128 and 256 on an H100
//   (tools/time_refresh.py, PERF.md), and the shared memory is cut to
//   ~54 KB so that four blocks fit on an SM and a fully missed layer (512
//   blocks at the slice's shapes) runs in one wave.
// - V first: every thread issues the loads of its share of the block's V
//   rows into registers before anything else, and stores them last, so a
//   host read's latency (1-2 us) runs under the whole K path and the link is
//   busy from the first microsecond. (Blocks that only copy V would take the
//   K blocks' dynamic shared memory too, since one launch has one size.)
// - Tensor cores: each of the 4 warps owns 16 rows and computes their
//   [16 x rank] @ [rank x 128] product with mma.sync.m16n8k16 (bf16 in, f32
//   sums: products of int8 or bf16 values with bf16 are exact in f32, so
//   only the order of the f32 sums differs from the plain version). U rows
//   arrive by cp.async (16-, 8- or 4-byte vectors, whatever the row length
//   allows) into a per-warp region; SV by cp.async into rows of 272 B, read
//   by ldmatrix.trans without bank conflicts. Rank is padded to a multiple
//   of 16 with zero U columns and zero SV rows.
// - int8 U: a thread's A fragment of a k-step needs k = 2q, 2q+1, 2q+8, 2q+9
//   (q = lane % 4). The k order within each 16 is permuted so that these are
//   bytes 4q..4q+3 of the row: one 32-bit shared load gives both fragment
//   registers, and SV's rows are staged in the same permuted order.
// - Epilogue in registers: the accumulator gives a thread columns
//   8j + 2q + {0, 1}, so a neox pair (c, c + 64) is tiles j and j + 8 and a
//   glm pair (c, c + 1) is one tile's two columns: the u_scale multiply and
//   RoPE take one precise sincosf per pair (angles reach ~1e5 rad at 128K).
//   The bf16 rows go through the warp's region (reused once its U rows are
//   read), half a row at a time so that the region stays the size of the U
//   rows, and leave as 16-byte vectors; K never touches device memory in
//   f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kGroup = 16;               // rows of one warp's product
constexpr int kRows = kWarps * kGroup;   // missed rows of one block
constexpr int kDh = 128;                 // head_dim served by this kernel
constexpr int kRowStride = kDh * 2 + 16; // bytes per staged SV row
constexpr int kHalfStride = kDh + 16;     // bytes per staged half K row

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
  int rank_pad;   // rank rounded up to 16
  int u_stride;   // bytes per staged U row
  int region;     // bytes of one warp's region (U rows, then K half rows)
};

// Shared memory: SV (rank_pad rows of kRowStride) and kWarps regions.
struct Geometry {
  int rank_pad, u_stride, region;
  size_t smem;
};

Geometry geometry(int rank, bool quant) {
  Geometry g;
  g.rank_pad = (rank + 15) / 16 * 16;
  // An odd number of 16-byte units per U row: the 8 rows a fragment load
  // reads then start in 8 different 4-bank groups.
  int units = (g.rank_pad * (quant ? 1 : 2) + 15) / 16;
  units |= 1;
  g.u_stride = 16 * units;
  g.region = kGroup * (g.u_stride > kHalfStride ? g.u_stride : kHalfStride);
  g.smem = (size_t)g.rank_pad * kRowStride + (size_t)kWarps * g.region;
  return g;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies kBytes from global memory to shared memory asynchronously, or
// writes kBytes of zeros when `valid` is false (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? kBytes : 0;
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
                 "l"(src), "n"(kBytes), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Four 8x8 bf16 matrices, transposed: the B fragments of two n8 tiles.
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t& r0,
                                          uint32_t& r1, uint32_t& r2,
                                          uint32_t& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
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

// Four int8 values -> bf16 pairs (bytes 0, 1) and (bytes 2, 3); exact.
__device__ __forceinline__ void s8x4_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  lo = pack_bf16((float)(int8_t)(w & 0xff), (float)(int8_t)((w >> 8) & 0xff));
  hi = pack_bf16((float)(int8_t)((w >> 16) & 0xff), (float)(int8_t)(w >> 24));
}

// The staged row of SV row p within its 16 (int8 U's k permutation): byte
// 4a + 2h + e of a U row's 16 carries k = 8h + 2a + e of the fragments.
__device__ __forceinline__ int permuted_row(int p) {
  return (p & ~15) | (8 * ((p >> 1) & 1) + 2 * ((p >> 2) & 3) + (p & 1));
}

template <bool kQuant, int kUVec>
__global__ void __launch_bounds__(kThreads, kQuant ? 4 : 2)
    refresh_kernel(RefreshArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kESize = kQuant ? 1 : 2;
  const int bk = blockIdx.y;
  const int b = bk / a.kv_heads;
  const int cs = a.chunk_size;
  const int n_miss_rows = a.miss_cnt[bk] * cs;
  const int r0 = blockIdx.x * kRows;
  if (r0 >= n_miss_rows) return;  // all-hit (or short-list) heads end here
  const int* chunk = a.miss_chunk + (size_t)bk * a.select_sets;
  const int* slot = a.miss_slot + (size_t)bk * a.select_sets;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // 1. V rows -> registers, before anything else: vector it * kThreads + tid
  // of the block's rows, 16 bytes each.
  constexpr int kVVecs = kDh * kESize / 16;          // vectors per V row
  constexpr int kVIters = kRows * kVVecs / kThreads;  // vectors per thread
  uint4 v_raw[kVIters];
  float v_sc[kVIters];
  int v_dst[kVIters];
#pragma unroll
  for (int it = 0; it < kVIters; ++it) {
    const int idx = it * kThreads + tid;
    const int hr = r0 + idx / kVVecs;
    v_dst[it] = -1;
    if (hr < n_miss_rows) {
      const int j = hr / cs;
      const int i = hr - j * cs;
      const int src = chunk[j] * cs + i;
      v_dst[it] = a.sparse_start + slot[j] * cs + i;
      const size_t row = (size_t)bk * a.n_rows + src;
      v_raw[it] = *reinterpret_cast<const uint4*>(
          static_cast<const unsigned char*>(a.v) + row * kDh * kESize +
          (idx % kVVecs) * 16);
      if (kQuant) v_sc[it] = __bfloat162float(a.v_scale[row]);
    }
  }

  // 2. SV[b, k] -> shared memory; rows past rank are zeros.
  unsigned char* s_sv = smem;
  {
    const unsigned char* sv =
        reinterpret_cast<const unsigned char*>(a.sv + (size_t)bk * a.rank * kDh);
    for (int idx = tid; idx < a.rank_pad * 16; idx += kThreads) {
      const int p = idx / 16;
      const int c = idx % 16;
      const int srow = kQuant ? permuted_row(p) : p;
      const bool ok = p < a.rank;
      cp_async<16>(smem_u32(s_sv + srow * kRowStride + c * 16),
                   ok ? sv + (size_t)p * kDh * 2 + c * 16 : sv, ok);
    }
  }

  // 3. This warp's 16 U rows -> its region. Lane r < 16 holds row r's
  // source row, destination row and u_scale.
  unsigned char* s_w = smem + (size_t)a.rank_pad * kRowStride +
                       (size_t)warp * a.region;
  const int g0 = r0 + warp * kGroup;
  const bool live = g0 < n_miss_rows;  // the same for the whole warp
  int my_src = 0;
  int my_dst = -1;
  float my_usc = 1.f;
  if (lane < kGroup && g0 + lane < n_miss_rows) {
    const int j = (g0 + lane) / cs;
    const int i = g0 + lane - j * cs;
    my_src = chunk[j] * cs + i;
    my_dst = a.sparse_start + slot[j] * cs + i;
    if (kQuant) {
      my_usc = __bfloat162float(a.u_scale[(size_t)b * a.n_rows + my_src]);
    }
  }
  const int row_bytes = a.rank * kESize;
  if (live) {
    const unsigned char* u = static_cast<const unsigned char*>(a.u) +
                             (size_t)b * a.n_rows * row_bytes;
    const int vecs = row_bytes / kUVec;
    for (int base = 0; base < kGroup * vecs; base += 32) {
      const int idx = base + lane;
      const int row = idx / vecs;
      const int src = __shfl_sync(0xffffffffu, my_src, row % kGroup);
      const int dst = __shfl_sync(0xffffffffu, my_dst, row % kGroup);
      if (idx < kGroup * vecs) {
        const int c = idx - row * vecs;
        const bool ok = dst >= 0;
        cp_async<kUVec>(smem_u32(s_w + row * a.u_stride + c * kUVec),
                        ok ? u + (size_t)src * row_bytes + c * kUVec : u, ok);
      }
    }
    const int pad_words = (a.rank_pad * kESize - row_bytes) / 4;
    for (int idx = lane; idx < kGroup * pad_words; idx += 32) {
      const int row = idx / pad_words;
      *reinterpret_cast<uint32_t*>(s_w + row * a.u_stride + row_bytes +
                                   4 * (idx - row * pad_words)) = 0u;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  if (live) {
    // 4. [16 x rank_pad] @ [rank_pad x 128] on the tensor cores: n8 tile j
    // of this warp's rows in acc[j]; rows g and g + 8, columns 8j + 2q + e.
    const int g = lane / 4;
    const int q = lane % 4;
    float acc[16][4];
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const unsigned char* u0 = s_w + g * a.u_stride;
    const unsigned char* u8 = u0 + 8 * a.u_stride;
    // ldmatrix: lane l addresses row (l / 8 & 1) * 8 + l % 8 of the k-step
    // and n8 tile 2jp + l / 16.
    const int m = lane / 8;
    const uint32_t b_base = smem_u32(s_sv) +
                            ((m & 1) * 8 + lane % 8) * kRowStride + (m >> 1) * 16;
    for (int kk = 0; kk < a.rank_pad / 16; ++kk) {
      uint32_t af[4];
      if constexpr (kQuant) {
        s8x4_to_bf16(*reinterpret_cast<const uint32_t*>(u0 + 16 * kk + 4 * q),
                     af[0], af[2]);
        s8x4_to_bf16(*reinterpret_cast<const uint32_t*>(u8 + 16 * kk + 4 * q),
                     af[1], af[3]);
      } else {
        af[0] = *reinterpret_cast<const uint32_t*>(u0 + 32 * kk + 4 * q);
        af[1] = *reinterpret_cast<const uint32_t*>(u8 + 32 * kk + 4 * q);
        af[2] = *reinterpret_cast<const uint32_t*>(u0 + 32 * kk + 16 + 4 * q);
        af[3] = *reinterpret_cast<const uint32_t*>(u8 + 32 * kk + 16 + 4 * q);
      }
      const uint32_t b_k = b_base + kk * 16 * kRowStride;
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_t(b_k + jp * 32, b0, b1, b2, b3);
        mma_bf16(acc[2 * jp], af, b0, b1);
        mma_bf16(acc[2 * jp + 1], af, b2, b3);
      }
    }

    // 5. Epilogue: u_scale, RoPE with one sincosf per pair, bf16.
    float usc[2], pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      usc[r] = __shfl_sync(0xffffffffu, my_usc, g + 8 * r);
      pos[r] = (float)__shfl_sync(0xffffffffu, my_src, g + 8 * r);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= usc[e / 2];
    if (!a.glm) {  // neox over all 128 lanes: (c, c + 64) = tiles j, j + 8
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float f = __ldg(a.inv_freq + 8 * j + 2 * q + e);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float sn, cn;
            sincosf(pos[r] * f, &sn, &cn);
            const float x = acc[j][2 * r + e];
            const float y = acc[j + 8][2 * r + e];
            acc[j][2 * r + e] = x * cn + (-y) * sn;
            acc[j + 8][2 * r + e] = y * cn + x * sn;
          }
        }
      }
    } else {  // glm: (c, c + 1) over the first rope_dim lanes
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = 8 * j + 2 * q;
        if (c < a.rope_dim) {
          const float f = __ldg(a.inv_freq + c);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float sn, cn;
            sincosf(pos[r] * f, &sn, &cn);
            const float x = acc[j][2 * r];
            const float y = acc[j][2 * r + 1];
            acc[j][2 * r] = x * cn + (-y) * sn;
            acc[j][2 * r + 1] = y * cn + x * sn;
          }
        }
      }
    }

    // 6. K rows through the warp's region (its U rows are read), one half
    // of the columns at a time (64 bf16 = 128 B a row), then out as 16-byte
    // vectors, eight to a half row.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          *reinterpret_cast<uint32_t*>(s_w + (g + 8 * r) * kHalfStride +
                                       (8 * j + 2 * q) * 2) =
              pack_bf16(acc[8 * h + j][2 * r], acc[8 * h + j][2 * r + 1]);
        }
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kGroup / 4; ++t) {
        const int row = 4 * t + lane / 8;
        const int dst = __shfl_sync(0xffffffffu, my_dst, row);
        if (dst >= 0) {
          const int c = lane % 8;
          reinterpret_cast<uint4*>(a.k_buf + ((size_t)bk * a.cap + dst) * kDh +
                                   64 * h)[c] =
              *reinterpret_cast<const uint4*>(s_w + row * kHalfStride + c * 16);
        }
      }
    }
  }

  // 7. V rows from registers: dequantize int8 vectors, store 16 bytes.
#pragma unroll
  for (int it = 0; it < kVIters; ++it) {
    if (v_dst[it] < 0) continue;
    const int seg = (it * kThreads + tid) % kVVecs;
    __nv_bfloat16* out = a.v_buf + ((size_t)bk * a.cap + v_dst[it]) * kDh;
    if constexpr (kQuant) {
      const int8_t* qv = reinterpret_cast<const int8_t*>(&v_raw[it]);
      __align__(16) __nv_bfloat16 vals[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        // int8 * bf16 is exact in f32; one rounding to bf16 equals the TPU
        // kernel's bf16 multiply.
        vals[e] = __float2bfloat16((float)qv[e] * v_sc[it]);
      }
      reinterpret_cast<uint4*>(out + seg * 16)[0] =
          reinterpret_cast<const uint4*>(vals)[0];
      reinterpret_cast<uint4*>(out + seg * 16)[1] =
          reinterpret_cast<const uint4*>(vals)[1];
    } else {
      reinterpret_cast<uint4*>(out + seg * 8)[0] = v_raw[it];
    }
  }
}

template <bool kQuant, int kUVec>
cudaError_t launch(const RefreshArgs& a, dim3 grid, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      refresh_kernel<kQuant, kUVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  refresh_kernel<kQuant, kUVec><<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

template <bool kQuant>
cudaError_t launch_vec(const RefreshArgs& a, int vec, dim3 grid, size_t smem,
                       cudaStream_t s) {
  if (vec == 16) return launch<kQuant, 16>(a, grid, smem, s);
  if (vec == 8) return launch<kQuant, 8>(a, grid, smem, s);
  return launch<kQuant, 4>(a, grid, smem, s);
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
  if (head_dim != kDh || rank <= 0 || chunk_size <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // The widest cp.async vector that divides a U row and its alignment.
  const int row_bytes = rank * (quant ? 1 : 2);
  int vec = 16;
  while (vec >= 4 &&
         (row_bytes % vec || reinterpret_cast<uintptr_t>(u) % vec)) {
    vec /= 2;
  }
  if (vec < 4) return (int)cudaErrorInvalidValue;
  const void* v_dev = nullptr;  // v may be pinned host memory
  const int rc = shadowkv_kernel_pointer(v, &v_dev);
  if (rc) return rc;
  const Geometry geo = geometry(rank, quant != 0);
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
  a.rank_pad = geo.rank_pad;
  a.u_stride = geo.u_stride;
  a.region = geo.region;

  const long long rows = (long long)select_sets * chunk_size;
  dim3 grid((unsigned)((rows + kRows - 1) / kRows), batch * kv_heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      quant ? launch_vec<true>(a, vec, grid, geo.smem, s)
            : launch_vec<false>(a, vec, grid, geo.smem, s);
  return (int)err;
}

extern "C" long long shadowkv_sparse_refresh_smem_bytes(int rank, int quant) {
  return (long long)geometry(rank, quant != 0).smem;
}
