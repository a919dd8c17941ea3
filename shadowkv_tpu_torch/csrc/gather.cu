// Chunk gather for the XLA-gather decode branch of one ShadowKV layer.
//
// Replaces the TPU kernels shadowkv_tpu/kernels/gather.py::_gather_kernel
// (stores in device memory) and ::_u_gather_kernel + ::_v_host_kernel (the V
// store in pinned host memory), all reached through gather_chunks. For every
// (batch b, kv head k) and every selected chunk cid = ids[b, k, j] it copies
//   * U rows      u[b, cid*cs : cid*cs+cs, :]        -> u_out[b, k, j*cs.., :]
//   * V rows      v[b, k, cid*cs : cid*cs+cs, :]     -> v_out[b, k, j*cs.., :]
//   * for int8 stores, the bf16 per-row scales u_scale[b, rows] and
//     v_scale[b, k, rows] -> u_sc_out[b, k, j*cs..], v_sc_out[b, k, j*cs..]
// so each output is token-major [B, K, S*cs, ...]. Dequantization, the
// U x SV product and RoPE stay in tensor code, as in the JAX package.
//
// One kernel serves both placements of V. On Hopper a kernel reads pinned
// host memory in place through unified virtual addressing, so the TPU's
// split into a device-only U ring and a host V ring of 4096-byte units
// (a Mosaic host-DMA rule) has no counterpart here. A host operand must be
// page-locked and mapped; shadowkv_kernel_pointer checks that before every
// launch, since a pageable pointer would fault or read garbage.
//
// What bounds it on an H100: bytes. Device stores: each selected chunk's U,
// V and scale rows are read once and written once (about 19 MB a layer at
// the slice's shapes, ~6 us at 3.35 TB/s). Host V: the V rows cross the host
// link (4 MB a layer for int8 at those shapes), so the link rate bounds it.
// What the design does about it: chunk cid's rows are contiguous in the
// port's flat stores, so a chunk is one contiguous run of bytes and the
// gather is a set of chunk-sized copies. One block serves one (b, k) and
// kChunksPerBlock selected chunks; its threads walk the chunks' bytes as
// 16-byte vectors, neighbouring threads on neighbouring addresses, and each
// thread issues kUnroll loads before its first store so that enough reads
// are in flight to cover host-link latency (~1-2 us). V is copied first so
// that its slow reads start before the device-side streams.
//
// The ids come from assign_slots_stable (core/selection.py), so every id is
// a valid chunk of the store; the kernel does not bounds-check them.
//
// gather_v_rows_kernel (below) is the port's own kernel for the XLA-gather
// branch over a bf16 V store in pinned host memory (the JAX HostVStore
// path): V rows only, and only those of the chunks that MISSED. The JAX
// package has no Pallas kernel there; its decode program calls back to the
// host per layer (io_callback) and gathers with native/host_gather.cpp,
// skipping the slots whose chunk stayed (gather_rows(skip=stay)). Here the
// card reads the pinned rows in place, so the step never leaves the device
// and stays inside the captured decode graph. One block per selected chunk:
// a block whose stay flag is set returns at once, so only missed chunks
// cross the host link (the reference's "skip the hit prefix"); the rows of
// those slots in the output are left unwritten.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunksPerBlock = 8;
constexpr int kUnroll = 4;
constexpr int kStreams = 4;  // V, U, V scales, U scales

struct Stream {
  const uint4* src;        // this layer's store, 16-byte vectors
  uint4* dst;              // [B*K, S, chunk_vecs]
  long long stride_b;      // vectors between batch rows of src
  long long stride_k;      // vectors between kv heads of src (0: shared)
  int chunk_vecs;          // vectors per chunk (0: stream unused)
};

struct GatherArgs {
  Stream s[kStreams];
  const int* ids;          // [B*K, S]
  int kv_heads, select_sets;
};

__global__ void __launch_bounds__(kThreads)
    gather_kernel(const __grid_constant__ GatherArgs a) {
  __shared__ int s_cid[kChunksPerBlock];
  const int bk = blockIdx.y;
  const int b = bk / a.kv_heads;
  const int k = bk - b * a.kv_heads;
  const int j0 = blockIdx.x * kChunksPerBlock;
  const int nj = min(kChunksPerBlock, a.select_sets - j0);
  if (threadIdx.x < nj) {
    s_cid[threadIdx.x] = a.ids[(size_t)bk * a.select_sets + j0 + threadIdx.x];
  }
  __syncthreads();

#pragma unroll
  for (int t = 0; t < kStreams; ++t) {
    const int cv = a.s[t].chunk_vecs;
    if (cv == 0) continue;
    const uint4* __restrict__ src =
        a.s[t].src + b * a.s[t].stride_b + k * a.s[t].stride_k;
    uint4* __restrict__ dst =
        a.s[t].dst + ((long long)bk * a.select_sets + j0) * cv;
    const int total = nj * cv;
    for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
      uint4 r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total) {
          const int j = idx / cv;
          r[u] = src[(long long)s_cid[j] * cv + (idx - j * cv)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = base + u * kThreads;
        if (idx < total) dst[idx] = r[u];
      }
    }
  }
}

constexpr int kVThreads = 128;

struct VRowsArgs {
  const uint4* src;        // this layer's V store [B*K, n_rows * row_vecs]
  uint4* dst;              // [B*K, S, chunk_vecs]
  const int* ids;          // [B*K, S]
  const uint8_t* stay;     // [B*K, S] 0/1
  long long head_vecs;     // vectors between (b, k) heads of src
  int chunk_vecs;          // vectors per chunk
  int select_sets;
};

// grid (S, B*K): block (j, bk) copies chunk ids[bk, j] unless it stayed.
__global__ void __launch_bounds__(kVThreads)
    gather_v_rows_kernel(const __grid_constant__ VRowsArgs a) {
  const long long slot = (long long)blockIdx.y * a.select_sets + blockIdx.x;
  if (a.stay[slot]) return;
  const int cv = a.chunk_vecs;
  const uint4* __restrict__ src =
      a.src + blockIdx.y * a.head_vecs + (long long)a.ids[slot] * cv;
  uint4* __restrict__ dst = a.dst + slot * cv;
  for (int base = threadIdx.x; base < cv; base += kVThreads * kUnroll) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kVThreads;
      if (idx < cv) r[u] = src[idx];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * kVThreads;
      if (idx < cv) dst[idx] = r[u];
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int set_stream(Stream* st, const void* src, void* dst, long long chunk_bytes,
               long long stride_b, long long stride_k) {
  if (chunk_bytes % 16 || stride_b % 16 || stride_k % 16 ||
      !aligned16(src) || !aligned16(dst)) {
    return (int)cudaErrorMisalignedAddress;
  }
  st->src = static_cast<const uint4*>(src);
  st->dst = static_cast<uint4*>(dst);
  st->stride_b = stride_b / 16;
  st->stride_k = stride_k / 16;
  st->chunk_vecs = (int)(chunk_bytes / 16);
  return 0;
}

}  // namespace

// The address through which a kernel reads `p`: device memory as it is; host
// memory only if it is page-locked and mapped (cudaMemoryTypeHost with a
// device pointer, which PyTorch's pinned allocator gives under unified
// addressing). Anything else, pageable memory above all, is an error.
extern "C" int shadowkv_kernel_pointer(const void* p, const void** out) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, p);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that no later launch reports it
    return (int)err;
  }
  if (attr.type == cudaMemoryTypeDevice || attr.type == cudaMemoryTypeManaged) {
    *out = p;
    return 0;
  }
  if (attr.type == cudaMemoryTypeHost && attr.devicePointer != nullptr) {
    *out = attr.devicePointer;
    return 0;
  }
  return (int)cudaErrorInvalidHostPointer;
}

// u [B, n_rows, u_row_bytes], v [B, K, n_rows, v_row_bytes] (this layer's
// slices; v may be pinned host memory), u_scale [B, n_rows] and v_scale
// [B, K, n_rows] bf16 or both null, ids [B, K, S] int32; outputs as above.
extern "C" int shadowkv_gather_chunks(
    const void* u, const void* u_scale, const void* v, const void* v_scale,
    const void* ids, void* u_out, void* u_sc_out, void* v_out,
    void* v_sc_out, int batch, int kv_heads, int n_rows, int select_sets,
    int chunk_size, int u_row_bytes, int v_row_bytes, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || select_sets <= 0 || chunk_size <= 0 ||
      n_rows % chunk_size || (u_scale == nullptr) != (v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const void* v_dev = nullptr;
  int rc = shadowkv_kernel_pointer(v, &v_dev);
  if (rc) return rc;
  GatherArgs a = {};
  const long long cs = chunk_size, rows = n_rows;
  const long long v_head = rows * v_row_bytes;
  rc = set_stream(&a.s[0], v_dev, v_out, cs * v_row_bytes, kv_heads * v_head,
                  v_head);
  if (rc) return rc;
  rc = set_stream(&a.s[1], u, u_out, cs * u_row_bytes, rows * u_row_bytes, 0);
  if (rc) return rc;
  if (u_scale != nullptr) {
    rc = set_stream(&a.s[2], v_scale, v_sc_out, cs * 2, kv_heads * rows * 2,
                    rows * 2);
    if (rc) return rc;
    rc = set_stream(&a.s[3], u_scale, u_sc_out, cs * 2, rows * 2, 0);
    if (rc) return rc;
  }
  a.ids = static_cast<const int*>(ids);
  a.kv_heads = kv_heads;
  a.select_sets = select_sets;
  dim3 grid((select_sets + kChunksPerBlock - 1) / kChunksPerBlock,
            batch * kv_heads);
  gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// v [B, K, n_rows, v_row_bytes] (this layer's slice; device or pinned host
// memory), ids [B, K, S] int32, stay [B, K, S] bool; v_out [B, K, S, cs,
// v_row_bytes], written only at the slots whose stay flag is clear.
extern "C" int shadowkv_gather_v_rows(
    const void* v, const void* ids, const void* stay, void* v_out,
    int batch, int kv_heads, int n_rows, int select_sets, int chunk_size,
    int v_row_bytes, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || select_sets <= 0 || chunk_size <= 0 ||
      n_rows % chunk_size || batch * kv_heads > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const void* v_dev = nullptr;
  int rc = shadowkv_kernel_pointer(v, &v_dev);
  if (rc) return rc;
  const long long chunk_bytes = (long long)chunk_size * v_row_bytes;
  const long long head_bytes = (long long)n_rows * v_row_bytes;
  if (chunk_bytes % 16 || head_bytes % 16 || !aligned16(v_dev) ||
      !aligned16(v_out)) {
    return (int)cudaErrorMisalignedAddress;
  }
  VRowsArgs a;
  a.src = static_cast<const uint4*>(v_dev);
  a.dst = static_cast<uint4*>(v_out);
  a.ids = static_cast<const int*>(ids);
  a.stay = static_cast<const uint8_t*>(stay);
  a.head_vecs = head_bytes / 16;
  a.chunk_vecs = (int)(chunk_bytes / 16);
  a.select_sets = select_sets;
  dim3 grid(select_sets, batch * kv_heads);
  gather_v_rows_kernel<<<grid, kVThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
