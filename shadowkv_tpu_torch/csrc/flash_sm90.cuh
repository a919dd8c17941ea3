// Hopper (sm_90a) building blocks of the prefill attention kernels: TMA
// loads into 128-byte-swizzled shared memory that complete on mbarriers,
// wgmma descriptors and m64n128k16 products, the pieces of a
// flash-attention visit of one 128-key tile whose scores, probabilities
// and output accumulator stay in registers, and the loop over a tile plan
// that kernels B/C (prefill_attention.cu), F (vs_tile.cu) and G
// (vs_sparse.cu) instantiate (attend).
//
// Shared-memory tile. A 128-row x 128-column bf16 tile (query rows or
// keys x head_dim) is two TMA boxes of 128 rows x 64 columns: a bf16 row
// of 128 is 256 B, wider than the 128-byte swizzle span, so box c holds
// columns 64c..64c+63 at byte offset c * kBoxBytes. Inside a box row r
// starts at r * 128 B and its 16-byte chunk j lies at chunk j ^ (r % 8).
// The swizzle repeats every 8 rows (1024 B) and is computed from address
// bits, so TMA's and wgmma's views of a box agree only when the box starts
// on a 1024-byte boundary: the kernel aligns its dynamic shared memory by
// hand and asks for 1024 B more than it uses.
//
// wgmma operands (descriptor fields in 16-byte units; layout 1 = 128-byte
// swizzle, base offset 0 because every box is 1024-aligned):
// - Q (A of S = Q K^T) and K (B of it) are K-major: a k-step of 16 columns
//   moves the start address 32 B along the 128-byte row, and the fifth
//   k-step moves to the second box. SBO = 1024 B (one 8-row group to the
//   next); LBO is unused for swizzled K-major operands and set to 16 B.
// - V (B of O = P V) is MN-major (head_dim contiguous, transpose bit set):
//   a k-step of 16 keys moves 16 rows = 2048 B; SBO = 1024 B (8 keys to
//   the next 8), LBO = kBoxBytes (head_dim 0-63 to 64-127, the next box).
//
// Register fragments (the place most likely to go plausibly wrong). The
// f32 accumulator of m64nNk16 gives warp w of the warpgroup rows
// 16w..16w+15; lane l holds, for each 8-column group n8, d[4 n8 + 0, 1] at
// row 16w + l/4, columns 8 n8 + 2 (l%4) + {0, 1}, and d[4 n8 + 2, 3] at
// row 16w + l/4 + 8, same columns. The bf16 A fragment of k-step kk of a
// register-A wgmma is a[0] = (row l/4, k 2(l%4) + {0,1}), a[1] = (row +8,
// same k), a[2] = (row l/4, k + 8), a[3] = (row + 8, k + 8): so a[j] of
// k-step kk packs d[8 kk + 2j] (low half) and d[8 kk + 2j + 1] (high
// half) of the score accumulator, and P never leaves the registers. A
// wrong pairing permutes keys within a row and gives plausible but wrong
// rows; the per-row 2^-6 check of the tests catches it, a max-abs check
// from the largest output does not.
//
// Each thread holds parts of 2 rows (l/4 and l/4 + 8) of its warpgroup's
// 64, 32 values of each per 128-key tile; a row's max reduces over the 4
// lanes of a quad (two shuffles), and its sum is kept per thread and
// reduced once, between the passes.
//
// Two passes over the key tiles. The first computes each row's max and
// sum; the second forms the normalised probabilities, rounds them to bf16
// and accumulates P V, so the kernel rounds P where the plain version
// (core/attention.py::mha: softmax in f32, then bf16) does. The one-pass
// flash form (unnormalised bf16 P, divided by the sum at the end) is as
// close to the exact result, but its roundings differ from the plain
// version's, and the engine check of a two-layer toy model amplifies that
// difference past its 2 % logit bound (chip_smoke.py's toy engines). The
// second pass costs one more S = Q K^T and exp2 per pair; O needs no
// rescaling.
//
// Hangs: a wrong expected-transaction byte count or mbarrier phase waits
// forever. mbar_wait gives up after kSpinLimit polls and traps, so such a
// fault ends the launch with an error instead of holding the card.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kTileRows = 128;  // query rows or keys of a tile
constexpr int kD = 128;         // head_dim served
constexpr int kBoxCols = 64;    // 128 B of bf16: the 128-byte swizzle span
constexpr uint32_t kBoxBytes = kTileRows * kBoxCols * 2;  // 16384
constexpr uint32_t kTileBytes = 2 * kBoxBytes;            // 32768
constexpr uint32_t kSpinLimit = 1u << 26;  // polls before a wait traps

// ---------------------------------------------------------------------------
// Shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ inline void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA data for this phase.
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` has completed. A fresh barrier
// is in phase 0, so waiting on parity 1 passes at once (the producer's
// first pass over an empty ring).
__device__ inline void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

// One TMA box of a 4-D map (coordinates innermost first) into shared
// memory at `dst`; completes `bytes` of the barrier's transaction count.
__device__ inline void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                   uint32_t bar, int c0, int c1, int c2,
                                   int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Loads a whole 128 x 128 tile (both boxes) at row `row` of head `head`
// and batch row `batch`; rows at or past the map's sequence length are
// zero-filled by TMA, never read from the next batch row.
__device__ inline void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                     uint32_t bar, int head, int row,
                                     int batch) {
  mbar_expect_tx(bar, kTileBytes);
  tma_load_4d(dst, map, bar, 0, head, row, batch);
  tma_load_4d(dst + kBoxBytes, map, bar, kBoxCols, head, row, batch);
}

// ---------------------------------------------------------------------------
// Warpgroup register budget
// ---------------------------------------------------------------------------

template <int N>
__device__ inline void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ inline void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle.
__device__ inline uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                      uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ inline uint64_t desc_k_major(uint32_t addr) {
  return desc_sw128(addr, 16, 1024);
}

__device__ inline uint64_t desc_mn_major(uint32_t addr) {
  return desc_sw128(addr, kBoxBytes, 1024);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products that own it.
__device__ inline void reg_fence(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define SM90_D64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

#define SM90_D64_OPERANDS(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),    \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),           \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),       \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),       \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),       \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),       \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),       \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),       \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),       \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),       \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),       \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),       \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B for a 64 x 128 x 16 step, A and B K-major in shared memory;
// d is overwritten when `accumulate` is 0.
__device__ inline void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b,
                                int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D64_OPERANDS(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A B for a 64 x 128 x 16 step, A (bf16 pairs) in registers and B
// MN-major in shared memory.
__device__ inline void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SM90_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef SM90_D64
#undef SM90_D64_OPERANDS

// ---------------------------------------------------------------------------
// Flash-attention tile in registers
// ---------------------------------------------------------------------------

__device__ inline float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// What one consumer warpgroup carries for its 64 query rows: the f32
// output accumulator and, for this thread's two rows (l/4 and l/4 + 8 of
// its warp's 16), the row max in log2 units and the row sum: this
// thread's share of it during the first pass, 1 / the whole sum after
// finish_stats (0 for a row that no active pair reached).
struct Acc {
  float o[64];
  float m[2];
  float l[2];

  __device__ inline void init() {
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -INFINITY;
      l[r] = 0.f;
    }
  }
};

// S = Q K^T of one 128-key tile for the warpgroup's 64 rows, from shared
// memory (`q`: the descriptor of the warpgroup's Q rows in box 0, `k_tile`
// the tile's address); returns once the product has landed in s.
__device__ inline void scores(float (&s)[64], uint64_t q, uint32_t k_tile) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(s, q + (off >> 4), desc_k_major(k_tile + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(s);
}

// Sets the scores of inactive pairs to -inf: the pair (row, key) counts
// only if row0(c) (this thread's row l/4 of its warp's 16) or row8(c) (row
// l/4 + 8) holds, c the key's column in the tile. A row functor computes
// what depends on its row once per tile, so a pair costs a few compares.
// Full tiles skip it.
template <class Row>
__device__ inline void mask_rows(float (&s)[64], const Row& row0,
                                 const Row& row8) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int c = 8 * (i / 4) + c0 + (i & 1);
    if (!((i & 2) ? row8(c) : row0(c))) s[i] = -INFINITY;
  }
}

// First pass: the rows' running max and this thread's share of the sum of
// 2^(s * scale_log2 - max).
__device__ inline void add_stats(Acc& acc, const float (&s)[64],
                                 float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      mx = fmaxf(mx, fmaxf(s[4 * n8 + 2 * r], s[4 * n8 + 2 * r + 1]));
    }
    const float m_new = fmaxf(acc.m[r], quad_max(mx) * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float sum = 0.f;
#pragma unroll
    for (int n8 = 0; n8 < 16; ++n8) {
      sum += ex2(fmaf(s[4 * n8 + 2 * r], scale_log2, -m_use)) +
             ex2(fmaf(s[4 * n8 + 2 * r + 1], scale_log2, -m_use));
    }
    acc.l[r] = acc.l[r] * ex2(acc.m[r] - m_use) + sum;
    acc.m[r] = m_new;
  }
}

// Between the passes: each row's whole sum over its quad, inverted.
__device__ inline void finish_stats(Acc& acc) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = quad_sum(acc.l[r]);
    acc.l[r] = l > 0.f ? 1.f / l : 0.f;
    if (acc.m[r] == -INFINITY) acc.m[r] = 0.f;
  }
}

// Second pass: P = bf16(2^(s * scale_log2 - max) / sum), the normalised
// probabilities rounded as the plain version rounds them, packed straight
// into the register A fragments; then, once `v_bar` shows V has landed,
// O += P V.
__device__ inline void add_pv(Acc& acc, const float (&s)[64],
                              float scale_log2, uint32_t v_tile,
                              uint32_t v_bar, uint32_t v_parity) {
  uint32_t p[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = 8 * kk + 2 * j;
      const int r = j & 1;  // d[i], d[i + 1] lie on row l/4 (+8 if r)
      p[kk][j] = pack_bf16(
          ex2(fmaf(s[i], scale_log2, -acc.m[r])) * acc.l[r],
          ex2(fmaf(s[i + 1], scale_log2, -acc.m[r])) * acc.l[r]);
    }
  }
  mbar_wait(v_bar, v_parity);
  wgmma_fence();
  reg_fence(acc.o);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    wgmma_rs(acc.o, p[kk], desc_mn_major(v_tile + kk * 16 * 128));
  }
  wgmma_commit();
  wgmma_wait_all();
  reg_fence(acc.o);
}

// Writes this thread's two rows of O as bf16: row l/4 of the warp's 16 at
// `row0` (a pointer to column 0 of that row) and row l/4 + 8 at `row8`,
// each only if it lies below the sequence end. A row that no active pair
// reached is zeros.
__device__ inline void store_rows(const Acc& acc, __nv_bfloat16* row0,
                                  bool valid0, __nv_bfloat16* row8,
                                  bool valid8) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int n8 = 0; n8 < 16; ++n8) {
    if (valid0) {
      *reinterpret_cast<uint32_t*>(row0 + 8 * n8 + c0) =
          pack_bf16(acc.o[4 * n8], acc.o[4 * n8 + 1]);
    }
    if (valid8) {
      *reinterpret_cast<uint32_t*>(row8 + 8 * n8 + c0) =
          pack_bf16(acc.o[4 * n8 + 2], acc.o[4 * n8 + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// The attention loop over a tile plan
// ---------------------------------------------------------------------------
//
// A block owns 128 query rows and visits the 128-key tiles its plan names.
// It has three warpgroups: warpgroup 0 is the producer (one thread issues
// every TMA load; its registers drop to 40 with setmaxnreg), warpgroups 1
// and 2 are consumers of 64 query rows each (registers raised to 232).
// Q is loaded once by TMA. K and V go through a ring of kStages stages (32
// KB of K and 32 KB of V each) with a full mbarrier for K, one for V and an
// empty mbarrier per stage; the producer fills stage i % kStages while the
// consumers work on the stages before it. 32 KB of Q and two stages come to
// 160 KB, so one block runs per SM.
//
// Two passes over the plan's tiles: the first computes each row's max and
// sum, the second rounds the normalised probabilities to bf16, as the plain
// versions do, and accumulates P V. The ring carries K alone in the first
// pass (full_v still completes a phase, so both barriers of a stage keep
// one parity), K and V in the second.
//
// A plan is what tells the kernels apart. It is a per-thread object with
//   int count() const;                 tiles visited
//   KvTile kv(int i) const;            where tile i's K and V come from
//   bool full(int i) const;            every pair of tile i is active
//   void mask(int i, float (&s)[64], int qp) const;
//                                      -inf on tile i's inactive pairs of
//                                      this thread's rows qp and qp + 8
// and every thread of the block must see the same count and tiles. A plan
// that keeps its tile list in shared memory has it written, after a
// __syncthreads, before attend() is called; attend() must be the last
// statement of the kernel (the producer returns early, and the two
// warpgroups' paths must not reconverge for setmaxnreg to hold).

constexpr int kStages = 2;
constexpr int kThreads = 3 * 128;
constexpr int kConsumerWarps = 8;
// Q, kStages x (K, V), the barriers (q, kStages x (full K, full V, empty)).
constexpr uint32_t kBarBytes = 8 * (1 + 3 * kStages);
constexpr uint32_t kLoopBytes = kTileBytes * (1 + 2 * kStages) + kBarBytes;
// What the loop asks of dynamic shared memory, with 1024 B to align the
// swizzled tiles by hand; a plan's own data may follow (plan_smem).
constexpr size_t kLoopSmemBytes = 1024 + (size_t)kLoopBytes;

// Where one tile's K and V rows come from: row `row` of head `head` and
// batch row `batch` of the maps k and v.
struct KvTile {
  const CUtensorMap* k;
  const CUtensorMap* v;
  int head;
  int row;
  int batch;
};

// The 1024-aligned shared address of the loop's tiles.
__device__ __forceinline__ uint32_t loop_base(unsigned char* smem_raw) {
  return (smem_u32(smem_raw) + 1023) & ~1023u;
}

// A plan's own shared memory, past the loop's (8-byte aligned).
__device__ __forceinline__ unsigned char* plan_smem(unsigned char* smem_raw) {
  return smem_raw + (loop_base(smem_raw) - smem_u32(smem_raw)) + kLoopBytes;
}

// O for the 128 rows of Q at (q_head, q_row, q_batch) of q_map, over the
// plan's tiles; row r (0..127) goes to out + r * row_stride if r < n_rows.
// q_row is also the position of the block's first query row.
template <class Plan>
__device__ __forceinline__ void attend(const Plan& plan, uint32_t base,
                                       const CUtensorMap* q_map, int q_head,
                                       int q_row, int q_batch,
                                       float scale_log2, __nv_bfloat16* out,
                                       size_t row_stride, int n_rows) {
  const uint32_t q_s = base;
  const uint32_t bars = base + kTileBytes * (1 + 2 * kStages);
  const uint32_t q_bar = bars;
  auto k_s = [&](int st) { return base + kTileBytes * (1 + 2 * st); };
  auto v_s = [&](int st) { return base + kTileBytes * (2 + 2 * st); };
  auto full_k = [&](int st) { return bars + 8 * (1 + st); };
  auto full_v = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + 2 * kStages + st); };
  const int n_visit = plan.count();

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    regs_dec<40>();
    if (threadIdx.x == 0) {
      tma_load_tile(q_s, q_map, q_bar, q_head, q_row, q_batch);
      for (int i = 0; i < 2 * n_visit; ++i) {
        const int st = i % kStages;
        mbar_wait(empty(st), ((i / kStages) & 1) ^ 1);
        const bool second = i >= n_visit;
        const KvTile t = plan.kv(second ? i - n_visit : i);
        tma_load_tile(k_s(st), t.k, full_k(st), t.head, t.row, t.batch);
        if (second) {
          tma_load_tile(v_s(st), t.v, full_v(st), t.head, t.row, t.batch);
        } else {
          mbar_arrive(full_v(st));
        }
      }
    }
    return;
  }

  regs_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: rows 64 cw..
  const int lane = threadIdx.x % 32;
  const int r0 = 64 * cw + 16 * ((threadIdx.x / 32) % 4) + lane / 4;
  const uint64_t q_desc = desc_k_major(q_s + cw * 64 * 128);
  Acc acc;
  acc.init();
  mbar_wait(q_bar, 0);
  // S of ring entry i (the plan's tile i % n_visit), masked unless full.
  auto tile_scores = [&](int i, float (&s)[64]) {
    const int st = i % kStages;
    const int j = i % n_visit;
    mbar_wait(full_k(st), (i / kStages) & 1);
    scores(s, q_desc, k_s(st));
    if (!plan.full(j)) plan.mask(j, s, q_row + r0);
  };
  for (int i = 0; i < n_visit; ++i) {  // first pass: row max and sum
    float s[64];
    tile_scores(i, s);
    if (lane == 0) mbar_arrive(empty(i % kStages));
    add_stats(acc, s, scale_log2);
  }
  finish_stats(acc);
  for (int i = n_visit; i < 2 * n_visit; ++i) {  // second pass: O = P V
    const int st = i % kStages;
    float s[64];
    tile_scores(i, s);
    add_pv(acc, s, scale_log2, v_s(st), full_v(st), (i / kStages) & 1);
    if (lane == 0) mbar_arrive(empty(st));
  }
  store_rows(acc, out + r0 * row_stride, r0 < n_rows,
             out + (r0 + 8) * row_stride, r0 + 8 < n_rows);
}

// Appends to list[count..], in order, eval(c) for each candidate c in [0,
// n) where it is not negative; returns the new count. Called by all 32
// lanes of one warp (the lists stay in candidate order for every thread).
template <class Eval>
__device__ inline int warp_compact(int* list, int count, int n, Eval eval) {
  const int lane = threadIdx.x % 32;
  for (int b = 0; b < n; b += 32) {
    const int e = b + lane < n ? eval(b + lane) : -1;
    const unsigned m = __ballot_sync(0xffffffffu, e >= 0);
    if (e >= 0) list[count + __popc(m & ((1u << lane) - 1))] = e;
    count += __popc(m);
  }
  return count;
}

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled is a driver entry point; the library is linked
// without -lcuda, so it is fetched from the runtime once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) {
      return cudaErrorNotSupported;
    }
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The map of a contiguous [batch, seq, heads, 128] bf16 tensor as 4-D
// (head_dim, heads, seq, batch) with its real strides, in boxes of
// 64 x 1 x 128 x 1 (one swizzle-wide half of a 128-row tile of one head),
// 128-byte swizzle, zero fill past each dimension's end. `ptr` must be
// 16-byte aligned.
inline cudaError_t encode_rows(CUtensorMap* map, const void* ptr, int batch,
                               int seq, int heads) {
  EncodeTiled encode;
  cudaError_t err = encode_tiled(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t row = kD * sizeof(__nv_bfloat16);
  const cuuint64_t dims[4] = {(cuuint64_t)kD, (cuuint64_t)heads,
                              (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, kTileRows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
