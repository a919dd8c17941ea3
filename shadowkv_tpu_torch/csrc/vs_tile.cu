// Vertical + slash sparse prefill attention (kernel F).
//
// Replaces shadowkv_tpu/kernels/vs_tile.py:48 _vs_tile_kernel (called
// through vs_tile_attention :269), the default vs_impl="tile" execution of
// MInference sparse prefill. For row r of [B*H]:
//     active(q, k) = k <= q & k < seq_len
//                    & (band[r, (q - k) / block] | k in verticals[r])
// with one softmax, each active pair counted once: a diagonal phase over
// the key tiles counts the pairs whose band is on, a vertical phase over
// the gathered vertical K/V rows counts the verticals whose band is off;
// their union is the function's mask. q [BH, S_pad, 128], k/v [BKV, S_pad,
// 128] bf16; the host prepares (kernels/vs_tile.py::prepare_verticals)
// k_sel/v_sel [BH, NV, 128] (each row's deduplicated vertical tokens,
// ascending, pads last, NV a multiple of 128) and vpos [BH, NV] int32 (their
// positions, pads 2 * S_pad); dflag [BH, nK] uint8 holds the band flags.
//
// What bounds it on an H100: tensor-core operations over the active pairs,
// 4 * Dh per (query, key) pair, against q, k, v and out read or written
// once plus the gathered vertical rows.
// What the design does about it: the tile-plan loop of flash_sm90.cuh
// (wgmma, TMA/mbarrier K/V ring, S, P and O in registers, two passes) over
// BandPlan, which kernels/vs_tile.py::vs_tile_plan states in Python (the
// CPU tests hold it against the dense masks):
// - The row's band flags go to shared memory, and one warp writes the
//   block's tile list there before the warpgroups split, so the producer
//   and the consumers walk the same tiles.
// - Diagonal phase: a 128-key tile at or below the block's last row is
//   visited iff one of the bands its pairs fall in is on, and full (no
//   per-pair test) iff all of them are on, its last key is at or below the
//   block's first row and below seq_len. Otherwise a pair counts if causal,
//   below seq_len and its band is on; a row works out its (at most three)
//   bands once per tile, so a pair costs compares only.
// - Vertical phase: the tiles of the vertical list whose smallest position
//   lies at or below the block's last row, skipped where every band their
//   pairs could fall in is on (those pairs were counted already); always
//   masked.
// - Grid (B*H rows, query blocks), rows fastest, so the query heads of a
//   KV group run together and share K/V tiles in L2; the last (heaviest)
//   query blocks go first. Maps are (head_dim, 1, rows, B*H): TMA
//   zero-fills past S_pad, and the epilogue writes rows below S_pad only,
//   so S_pad needs only be a multiple of 64.

#include "flash_sm90.cuh"

namespace {

using sm90::kD;
using sm90::kTileRows;

// Tile list entries: the tile's index, and these flags.
constexpr int kVertical = 1 << 30;  // a tile of the vertical list
constexpr int kFull = 1 << 29;      // every pair active: no mask
constexpr int kIndex = kFull - 1;

struct BandPlan {
  const CUtensorMap* k;
  const CUtensorMap* v;
  const CUtensorMap* k_sel;
  const CUtensorMap* v_sel;
  int kv_row;  // this row's K/V row
  int row;
  const int* vpos;             // this row's NV vertical positions
  const unsigned char* bands;  // shared: this row's nk band flags
  const int* list;             // shared: the visited tiles
  int n;
  int nk;
  int block;
  int seq_len;

  __device__ bool on(int b) const {
    return b >= 0 && bands[min(b, nk - 1)] != 0;
  }

  // Diagonal phase, one row: key column c of the tile at k0 counts iff
  // c <= cmax (causal, below seq_len) and its band is on. The row's
  // distance to key c is d0 - c: band b0 for c <= r0, b0 - 1 up to
  // r0 + block, b0 - 2 beyond (a 128-key row spans three bands at most).
  struct BandRow {
    int cmax;
    int r0;
    int r1;
    bool f0;
    bool f1;
    bool f2;
    __device__ bool operator()(int c) const {
      return c <= cmax && (c <= r0 ? f0 : (c <= r1 ? f1 : f2));
    }
  };

  __device__ BandRow band_row(int k0, int qp) const {
    BandRow r;
    const int d0 = max(qp - k0, 0);
    const int b0 = d0 / block;
    r.cmax = qp < seq_len ? min(qp - k0, seq_len - 1 - k0) : -1;
    r.r0 = d0 - b0 * block;
    r.r1 = r.r0 + block;
    r.f0 = on(b0);
    r.f1 = on(b0 - 1);
    r.f2 = on(b0 - 2);
    return r;
  }

  __device__ int count() const { return n; }
  __device__ sm90::KvTile kv(int i) const {
    const int e = list[i];
    const int pos = (e & kIndex) * kTileRows;
    if (e & kVertical) return {k_sel, v_sel, 0, pos, row};
    return {k, v, 0, pos, kv_row};
  }
  __device__ bool full(int i) const { return (list[i] & kFull) != 0; }
  __device__ void mask(int i, float (&s)[64], int qp) const {
    const int e = list[i];
    const int t = e & kIndex;
    if (!(e & kVertical)) {
      sm90::mask_rows(s, band_row(t * kTileRows, qp),
                      band_row(t * kTileRows, qp + 8));
      return;
    }
    // Vertical phase: the key at column c is vertical p; it counts for a
    // row q iff p <= q, p < seq_len and the band of q - p is off.
    const int* vp = vpos + t * kTileRows;
    const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int p = __ldg(vp + 8 * n8 + c0 + e2);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = qp + 8 * r;
          const bool act = p <= q && p < seq_len && q < seq_len &&
                           !on((q - p) / block);
          if (!act) s[4 * n8 + 2 * r + e2] = -INFINITY;
        }
      }
    }
  }
};

__global__ void __launch_bounds__(sm90::kThreads, 1)
vs_tile_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __grid_constant__ CUtensorMap ks_map,
               const __grid_constant__ CUtensorMap vs_map,
               const int* __restrict__ vpos,
               const unsigned char* __restrict__ dflag,
               const int* __restrict__ kv_map, __nv_bfloat16* __restrict__ out,
               int s_pad, int nv, int nk, int block, int seq_len,
               float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int row = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTileRows;
  const int q1 = min(q0 + kTileRows, seq_len) - 1;  // last row that counts
  const int n_vt = nv / kTileRows;
  int* list = reinterpret_cast<int*>(sm90::plan_smem(smem_raw));
  // list[0] is the count; the entries follow, at most one per key tile and
  // one per vertical tile; the band flags after them.
  unsigned char* bands = reinterpret_cast<unsigned char*>(
      list + 1 + (s_pad + kTileRows - 1) / kTileRows + n_vt);

  BandPlan plan;
  plan.k = &k_map;
  plan.v = &v_map;
  plan.k_sel = &ks_map;
  plan.v_sel = &vs_map;
  plan.kv_row = kv_map[row];
  plan.row = row;
  plan.vpos = vpos + (size_t)row * nv;
  plan.bands = bands;
  plan.list = list + 1;
  plan.nk = nk;
  plan.block = block;
  plan.seq_len = seq_len;

  for (int i = threadIdx.x; i < nk; i += sm90::kThreads) {
    bands[i] = dflag[(size_t)row * nk + i];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int n = 0;
    if (q0 < seq_len) {  // rows past seq_len are garbage (zeros here)
      // Diagonal tiles at or below the last row: the pairs of tile t lie
      // at distances [max(0, q0 - k1), q1 - k0].
      n = sm90::warp_compact(list + 1, n, q1 / kTileRows + 1, [&](int t) {
        const int k0 = t * kTileRows;
        const int k1 = k0 + kTileRows - 1;
        const int b_lo = max(0, q0 - k1) / block;
        const int b_hi = min((q1 - k0) / block, nk - 1);
        int n_on = 0;
        for (int b = b_lo; b <= b_hi; ++b) n_on += bands[b] != 0;
        if (n_on == 0) return -1;
        const bool full = n_on == b_hi - b_lo + 1 && k1 <= q0 && k1 < seq_len;
        return t | (full ? kFull : 0);
      });
      // Vertical tiles whose first position is at or below the last row,
      // unless every band between the nearest and the farthest of their
      // pairs is on.
      n = sm90::warp_compact(list + 1, n, n_vt, [&](int j) {
        const int v_lo = plan.vpos[j * kTileRows];
        if (v_lo > q1) return -1;
        const int v_hi = min(plan.vpos[j * kTileRows + kTileRows - 1], q1);
        const int b_lo = max(0, q0 - v_hi) / block;
        const int b_hi = min((q1 - v_lo) / block, nk - 1);
        for (int b = b_lo; b <= b_hi; ++b) {
          if (bands[b] == 0) return j | kVertical;
        }
        return -1;
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
// entry per key tile and per vertical tile) and the band flags.
size_t vs_tile_smem(int s_pad, int nv, int nk) {
  const size_t list = 4 * (1 + (size_t)(s_pad + kTileRows - 1) / kTileRows +
                           nv / kTileRows);
  return sm90::kLoopSmemBytes + list + nk;
}

}  // namespace

extern "C" int shadowkv_vs_tile_attention(
    const void* q, const void* k, const void* v, const void* k_sel,
    const void* v_sel, const void* vpos, const void* dflag,
    const void* kv_map, void* out, int rows, int kv_rows, int s_pad, int nv,
    int nk, int block, int seq_len, float scale, void* stream) {
  const int q_blocks = (s_pad + kTileRows - 1) / kTileRows;
  if (rows <= 0 || kv_rows <= 0 || block <= 0 || s_pad % 64 != 0 ||
      nv <= 0 || nv % kTileRows != 0 || nk != (s_pad + block - 1) / block ||
      seq_len <= 0 || seq_len > s_pad || q_blocks > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = vs_tile_smem(s_pad, nv, nk);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  const void* ptrs[5] = {q, k, v, k_sel, v_sel};
  const int n_rows[5] = {rows, kv_rows, kv_rows, rows, rows};
  const int seqs[5] = {s_pad, s_pad, s_pad, nv, nv};
  cudaError_t err = cudaSuccess;
  for (int m = 0; m < 5 && err == cudaSuccess; ++m) {
    err = sm90::encode_rows(&maps[m], ptrs[m], n_rows[m], seqs[m], 1);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        vs_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
  }
  if (err != cudaSuccess) return (int)err;
  dim3 grid(rows, q_blocks);
  vs_tile_kernel<<<grid, sm90::kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4],
      static_cast<const int*>(vpos), static_cast<const unsigned char*>(dflag),
      static_cast<const int*>(kv_map), static_cast<__nv_bfloat16*>(out), s_pad,
      nv, nk, block, seq_len, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
