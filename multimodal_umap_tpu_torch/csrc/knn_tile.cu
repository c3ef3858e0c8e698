// Fused distance panel + per-tile top-k for exact kNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_knn_tile_kernel` launched by `knn_pallas`
// (multimodal_umap_tpu/ops/knn_pallas.py:48-117, pallas_call at :189).
//
// What it computes, for one block of query rows q (Q, D) against all
// reference rows r (N, D):
//   panel[i, j] = max((-2 * q_i . r_j + |q_i|^2) + |r_j|^2, 0)
// with column j >= N and, under exclude_self, j == row_offset + i set to
// +inf; then, for every (row, 256-column tile), the tile_k smallest
// entries in ascending order, ties to the lowest column id, each column
// taken at most once. Output: (num_col_tiles, Q, tile_k) f32 squared
// distances and int32 global column ids. The cross-tile merge and the f32
// re-score stay in the PyTorch wrapper (ops/knn_tile.py), as they were
// XLA outside the kernel on the TPU.
//
// Bound on an H100 SXM: bf16 mode does 2*Q*N*D operations at the
// 989 TFLOP/s dense bf16 rate (2.154 ms for the 8,192 x 31,744 x 4,096
// fit block, 0.404 ms at D=768, 0.269 ms for the 1,024-row transform
// block) while its inputs, norms and outputs move ~0.59 GB (0.18 ms at
// 3.35 TB/s), so it is bound by operations.
//
// bf16 mode (the main path), designed for Hopper:
//   * norm pre-pass: `rownorm_bf16_kernel` computes |x|^2 in f32 of the
//     bf16 rows once per call (one warp per row), so the panel is the
//     exact squared distance of the rounded vectors and no block
//     recomputes the norms of its rows;
//   * one block per 128 x 256 output tile (1-D grid, row tiles grouped
//     16 at a time so that a wave's q and r tiles stay in the 50 MB L2);
//     384 threads: two consumer warpgroups (64 rows x 256 columns each)
//     and one producer warpgroup, whose one thread keeps a ring of 4
//     stages full. A stage is one 64-wide D slice of the q tile (16 KB)
//     and of the r tile (32 KB), loaded by TMA with the 128-byte swizzle;
//     TMA's zero fill covers ragged Q and N edges (D is padded to 64 by
//     the wrapper); full / empty mbarriers pace the ring;
//   * the product is q . r^T with both operands K-major in shared
//     memory: `wgmma.mma_async m64n256k16` bf16 -> f32, 4 per stage per
//     consumer warpgroup, 128 accumulators a thread; one wgmma group
//     stays in flight while the previous stage is released. Every warp
//     keeps the launch's 168 registers, which hold the main loop's
//     accumulators without a spill. No `setmaxnreg`: a warp's
//     `setmaxnreg.inc` waits until registers come free, and with other
//     processes time-sliced on the card the kernel hung (every run of
//     three processes on one H100 hung in its first kNN, and a lone run
//     now and then);
//   * epilogue: the 128 x 256 panel goes to shared memory (aliasing the
//     ring, which is dead by then) and all 12 warps select, one warp per
//     row (8 columns a lane), two rows at a time, with a threshold search
//     instead of tile_k argmin rounds: the tile_k-th smallest key T is
//     found by bisection on the f32 bit patterns (distances are >= 0 and
//     -0 is made +0, so bits order like values) between the row's
//     minimum and its largest finite key, one `__reduce_add_sync` count
//     per step (each lane counts its 8 keys from the sign bits of
//     mid - key), stopping early at a count of exactly tile_k (at most 31
//     steps); the keys <= T (with ties at T: the keys < T and the
//     lowest-column keys == T) are compacted with ballots in column order
//     as unique 64-bit (key << 8 | column) words, and each survivor's
//     output slot is its rank among the tile_k survivors, read from
//     shared memory. Per (row, tile): no warp shuffle at all; at most 34
//     warp reductions and 8 ballots (32 with ties at T). The first
//     version's argmin rounds took 320 shuffles per (row, 128-column tile).
//
// Measured on an H100 80GB HBM3 (700 W), chip_smoke.py and
// compare_knn_tile.py: 4.0-4.3 ms for the fit block above (the first
// version: 20.4 ms). The selection, not the main loop, is what keeps the
// kernel from its bound: it is instruction-issue bound (hence the
// branch-free bisection update) and does not overlap the tensor cores
// (see PERF.md).
//
// f32 mode (explicit only: the `pallas` and `approx` engines), the same
// contract with full-f32 inputs, redesigned for Hopper as split-precision
// (3xTF32) tensor-core products, as the TPU kernel's f32 mode is a
// multi-pass bf16 emulation of f32 on its matrix unit:
//   * bound on an H100 SXM: 3 passes of 2*Q*N*D operations at the 495
//     TFLOP/s dense TF32 rate, 12.91 ms for the 8,192 x 31,744 x 4,096
//     block (the CUDA cores' 67 TFLOP/s f32 FMA pipe: 31.80 ms); the
//     app's 16 x 131,072, D=64 launch is bound by its 33.6 MB of r;
//   * one block per 64 x 256 output tile (the bf16 mode's grouped 1-D
//     raster); 384 threads: two consumer warpgroups (all 64 rows x 128
//     columns each) and one producer warpgroup, whose first thread keeps
//     a ring of 5 stages full with TMA loads of raw f32 slices (16 wide:
//     64-byte rows, 64-byte swizzle, zero fill past Q and N; D is padded
//     to 16 by the wrapper). full (TMA), ready (split) and empty
//     (consumed) mbarriers pace the ring; every warp keeps the launch's
//     registers, as in bf16 mode;
//   * the split is done in the kernel, by the 256 consumer threads while
//     the tensor cores run the previous stage: hi = tf32_rna(x) in place
//     and lo = tf32_rna(x - hi) in a second buffer of the same layout
//     (the split is elementwise, so the swizzle does not matter to it),
//     each row's |x|^2 summed in f32 from the f32 values on the way. No
//     pre-pass writes split copies of the tables (1.04 GB for the
//     31,744 x 4,096 table, and 3x the bytes of the bytes-bound D=64
//     launch). A first version split in 3 warps of the producer
//     warpgroup and took 13.5 ms per 1,024 of D at the block above (4.1
//     with the split left out): the split, not the tensor cores, set the
//     pace, and the consumers' mbarrier polling shared its warps' issue
//     slots;
//   * per 16-wide slice, each consumer warpgroup issues `wgmma.mma_async
//     m64n128k8` tf32 -> f32, both operands K-major: lo_q.hi_r, then
//     hi_q.lo_r, then hi_q.hi_r (lo.lo, about 2^-22 of |q||r|, is
//     dropped), 6 per slice into a partial that starts at 0; the partial
//     is then added into a total in round-to-nearest f32 FADDs. The
//     tensor cores' f32 sums do not round to nearest: summed over all of
//     D = 4096 on them (cuBLAS, TF32 on), the same three passes miss the
//     float64 panel by 2.8e-5 of the cancelled terms, against 3.6e-6 for
//     this kernel and 4.6e-6 for the plain f32 panel. Partial + total
//     (128 registers a thread) is why a block has 64 rows and not 128;
//   * the epilogue is the bf16 mode's: the 64 x 256 panel to shared
//     memory (aliasing the dead ring) and `select_rows`, all 12 warps.
//
// Measured on an H100 80GB HBM3 (700 W), chip_smoke.py and
// compare_knn_tile.py: 26.7 ms for the 8,192 x 31,744 x 4,096 block (48 %
// of the TF32 bound; the first version's CUDA-core FMA panel: 96.5 ms;
// the library chain, f32 torch.matmul + per-tile topk: 62.3 ms), 6.0 ms
// at D=768 and 0.041 ms for the app's 16 x 131,072, D=64 launch (0.068
// before). Its main loop runs at about half the TF32 rate, 6.2 ms per
// 1,024 of D; taking A from registers (no split of q in shared memory)
// or letting each warpgroup split and sync only its own half of r did
// not change that (PERF.md).
//
// C entry points, bound with ctypes; they launch on the given stream,
// never synchronize, allocate nothing and return cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_C = 256;           // column tile of the output contract
constexpr int KPL = TILE_C / 32;      // panel columns per lane in selection
constexpr int PANEL_LD = TILE_C + 8;  // f32 panel row stride
constexpr int SEL_ROWS = 2;           // rows a warp selects at once
// survivor scratch: TILE_C 64-bit entries per row in flight
constexpr int SCR_WORDS = 2 * TILE_C;
static_assert(TILE_C <= 256, "columns in a tile must fit 8 bits");
constexpr uint32_t INF_BITS = 0x7f800000u;
// Both modes: 2 consumer warpgroups + 1 producer warpgroup, and all
// warps select.
constexpr int THREADS = 384;
constexpr int SEL_WARPS = THREADS / 32;
constexpr int GROUP_M = 16;  // row tiles per raster group

// ---- bf16 mode geometry ----
constexpr int BM = 128;                     // rows per block
constexpr int BK = 64;                      // D slice: 128 bytes of bf16
constexpr int STAGES = 4;
constexpr int Q_STAGE_BYTES = BM * BK * 2;      // 16 KB
constexpr int R_STAGE_BYTES = TILE_C * BK * 2;  // 32 KB
constexpr int STAGE_BYTES = Q_STAGE_BYTES + R_STAGE_BYTES;
constexpr int RING_BYTES = STAGES * STAGE_BYTES;
constexpr int BAR_OFF = RING_BYTES;
constexpr int QN_OFF = BAR_OFF + 2 * STAGES * 8;
constexpr int RN_OFF = QN_OFF + BM * 4;
constexpr int BF_END = RN_OFF + TILE_C * 4;
constexpr int BF_SCR_OFF = BM * PANEL_LD * 4;  // after the panel, in the ring
constexpr int BF_SMEM_BYTES = BF_END + 1024;   // + slack for 1 KB alignment
static_assert(BF_SCR_OFF + SEL_WARPS * SEL_ROWS * SCR_WORDS * 4 <= RING_BYTES,
              "epilogue > ring");

// ---- f32 mode geometry ----
constexpr int FM = 64;                 // rows per block
constexpr int FK = 16;                 // D slice: 64 bytes of f32
constexpr int F_STAGES = 5;
constexpr int F_ROWS = FM + TILE_C;    // q then r rows of a stage: 320
constexpr int F_Q_BYTES = FM * FK * 4;        // 4 KB
constexpr int F_X_BYTES = F_ROWS * FK * 4;    // 20 KB: TMA lands, hi in place
constexpr int F_STAGE_BYTES = 2 * F_X_BYTES;  // + lo
constexpr int F_RING_BYTES = F_STAGES * F_STAGE_BYTES;
constexpr int F_BAR_OFF = F_RING_BYTES;       // full, ready, empty
constexpr int F_QN_OFF = F_BAR_OFF + 3 * F_STAGES * 8;
constexpr int F_RN_OFF = F_QN_OFF + FM * 4;
constexpr int F_END = F_RN_OFF + TILE_C * 4;
constexpr int F_SCR_OFF = FM * PANEL_LD * 4;  // after the panel, in the ring
constexpr int F_SMEM_BYTES = F_END + 1024;    // + slack for 1 KB alignment
// chunks of 16 bytes that each consumer thread splits per stage
constexpr int F_SPLIT_CHUNKS = F_ROWS * FK * 4 / 16 / 256;
static_assert(F_SCR_OFF + SEL_WARPS * SEL_ROWS * SCR_WORDS * 4 <= F_RING_BYTES,
              "epilogue > ring");
static_assert(F_SMEM_BYTES <= 232448, "f32 mode shared memory");
static_assert(F_SPLIT_CHUNKS * 256 * 16 == F_X_BYTES &&
                  F_SPLIT_CHUNKS * 64 == F_ROWS,
              "consumer thread t splits the chunks t + 256 i, of rows "
              "(t >> 2) + 64 i");

__device__ __forceinline__ float sumsq_bf16x8(uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    s = fmaf(f.x, f.x, s);
    s = fmaf(f.y, f.y, s);
  }
  return s;
}

// ---------------------------------------------------------------------------
// Selection: rows of a shared-memory panel of raw dot products, one warp per
// SEL_ROWS rows at a time (independent searches interleaved, to hide the
// latency of the warp reductions). Lane `lane` holds columns s*32 + lane,
// s = 0..7, of each row.
__device__ __forceinline__ void select_rows(
    const float* panel, const float* q_sq, const float* r_sq, int rows,
    int warp, int nwarps, uint64_t* scr, int row0, int col0, int ct, int Q,
    int N, int tile_k, int row_offset, int exclude_self,
    float* __restrict__ d_out, int* __restrict__ i_out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int tk2 = (tile_k + 1) & ~1;
  float rn[KPL];  // the lane's column norms: the same for every row
#pragma unroll
  for (int s = 0; s < KPL; ++s) rn[s] = r_sq[s * 32 + lane];
  for (int rb = warp * SEL_ROWS; rb < rows; rb += nwarps * SEL_ROWS) {
    if (row0 + rb >= Q) break;  // warp-uniform; later rows are padding too
    uint32_t key[SEL_ROWS][KPL], lo[SEL_ROWS], hi[SEL_ROWS], cnt[SEL_ROWS];
#pragma unroll
    for (int r = 0; r < SEL_ROWS; ++r) {
      const int rr = rb + r, grow = row_offset + row0 + rr;
      const float qq = q_sq[rr];
      uint32_t kmin = INF_BITS, kmax_fin = 0u, nfin = KPL;
      // Masks reach a row only in the last column tile or the self tile.
      const bool masked = col0 + TILE_C > N ||
                          (exclude_self && (unsigned)(grow - col0) < TILE_C);
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        const float x =
            fmaxf((-2.f * panel[rr * PANEL_LD + s * 32 + lane] + qq) + rn[s],
                  0.f);
        key[r][s] = __float_as_uint(x) & 0x7fffffffu;  // -0 -> +0
      }
      if (masked) {
        nfin = 0u;
#pragma unroll
        for (int s = 0; s < KPL; ++s) {
          const int gc = col0 + s * 32 + lane;
          if (gc >= N || (exclude_self && gc == grow)) key[r][s] = INF_BITS;
          if (key[r][s] < INF_BITS) {
            kmax_fin = max(kmax_fin, key[r][s]);
            ++nfin;
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < KPL; ++s) kmax_fin = max(kmax_fin, key[r][s]);
      }
#pragma unroll
      for (int s = 0; s < KPL; ++s) kmin = min(kmin, key[r][s]);
      lo[r] = __reduce_min_sync(full, kmin);
      hi[r] = __reduce_max_sync(full, kmax_fin);
      // Too few finite keys: the finite ones and then +inf columns.
      if (__reduce_add_sync(full, nfin) < (uint32_t)tile_k)
        lo[r] = hi[r] = INF_BITS;
    }
    // Bisection for T: the smallest key value with #(key <= T) >= tile_k,
    // or any value with #(key <= T) == tile_k, which ends it early.
    for (;;) {
      bool open = false;
#pragma unroll
      for (int r = 0; r < SEL_ROWS; ++r) open |= lo[r] < hi[r];
      if (!open) break;
      uint32_t mid[SEL_ROWS], c[SEL_ROWS];
#pragma unroll
      for (int r = 0; r < SEL_ROWS; ++r) {
        mid[r] = lo[r] + ((hi[r] - lo[r]) >> 1);
        // Keys are < 2^31: mid - key is negative exactly when key > mid,
        // so its sign bit counts the keys above mid (two chains for ILP).
        uint32_t c0 = KPL, c1 = 0u;
#pragma unroll
        for (int s = 0; s < KPL; s += 2) {
          c0 -= (mid[r] - key[r][s]) >> 31;
          c1 += (mid[r] - key[r][s + 1]) >> 31;
        }
        c[r] = c0 - c1;
      }
#pragma unroll
      for (int r = 0; r < SEL_ROWS; ++r) cnt[r] = __reduce_add_sync(full, c[r]);
      // No branch and no guard for a settled row (lo == hi == T): there
      // count(<= T) >= tile_k, so neither update moves it.
#pragma unroll
      for (int r = 0; r < SEL_ROWS; ++r) {
        if (cnt[r] >= (uint32_t)tile_k) hi[r] = mid[r];
        if (cnt[r] <= (uint32_t)tile_k)
          lo[r] = mid[r] + (cnt[r] != (uint32_t)tile_k);
      }
    }
#pragma unroll
    for (int r = 0; r < SEL_ROWS; ++r) {
      const uint32_t t = lo[r];
      // The survivors, compacted in column order as (key << 8 | column in
      // the tile): unique, ordered like the output. Without ties at T they
      // are the keys <= T; with them, the keys < T and the lowest-column
      // keys == T.
      uint64_t* sk = scr + r * TILE_C;
      unsigned take[KPL];  // ballots of the survivors, slot by slot
      int n_le = 0;
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        take[s] = __ballot_sync(full, key[r][s] <= t);
        n_le += __popc(take[s]);
      }
      if (n_le != tile_k) {  // ties at T (warp-uniform)
        int need = tile_k;   // keys == T to take, lowest columns first
#pragma unroll
        for (int s = 0; s < KPL; ++s)
          need -= __popc(__ballot_sync(full, key[r][s] < t));
        int eq_run = 0;
#pragma unroll
        for (int s = 0; s < KPL; ++s) {
          const bool eq = key[r][s] == t;
          const unsigned be = __ballot_sync(full, eq);
          take[s] = __ballot_sync(
              full,
              key[r][s] < t || (eq && eq_run + __popc(be & lt_mask) < need));
          eq_run += __popc(be);
        }
      }
      int pos_run = 0;
#pragma unroll
      for (int s = 0; s < KPL; ++s) {
        if ((take[s] >> lane) & 1u)
          sk[pos_run + __popc(take[s] & lt_mask)] =
              (uint64_t)key[r][s] << 8 | (uint32_t)(s * 32 + lane);
        pos_run += __popc(take[s]);
      }
      // Pad to an even count with a word above every key (< 2^39).
      if (lane < tk2 - tile_k) sk[tile_k + lane] = 1ull << 62;
    }
    __syncwarp();
    // Each survivor's slot is its rank among the tile_k survivors.
#pragma unroll
    for (int r = 0; r < SEL_ROWS; ++r) {
      const int qrow = row0 + rb + r;
      if (qrow >= Q) break;
      const uint64_t* sk = scr + r * TILE_C;
      float* drow = d_out + ((size_t)ct * Q + qrow) * tile_k;
      int* irow = i_out + ((size_t)ct * Q + qrow) * tile_k;
      for (int j = lane; j < tile_k; j += 32) {
        const uint64_t v = sk[j];
        // Words are < 2^39, so w - v wraps to its top bit exactly when
        // w < v: two independent sums, no predicate chain.
        uint32_t rank0 = 0u, rank1 = 0u;
#pragma unroll 4
        for (int i = 0; i < tk2; i += 2) {
          const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(sk + i);
          rank0 += (uint32_t)((w.x - v) >> 63);
          rank1 += (uint32_t)((w.y - v) >> 63);
        }
        const uint32_t rank = rank0 + rank1;
        drow[rank] = __uint_as_float((uint32_t)(v >> 8));
        irow[rank] = col0 + (int)(v & 0xffu);
      }
    }
    __syncwarp();
  }
}

// ---------------------------------------------------------------------------
// bf16 mode: PTX helpers.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// K-major operand, 128-byte rows swizzled by TMA: 8-row groups 1 KB apart.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t a,
                                                 uint64_t b) {
#define F8(i)                                                        \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),    \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56),
        F8(64), F8(72), F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
      : "l"(a), "l"(b), "r"(1));
#undef F8
}

template <int N = TILE_C / 2>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// f32 mode: K-major operand, 64-byte rows swizzled by TMA: 8-row groups
// 512 bytes apart.
__device__ __forceinline__ uint64_t wgmma_desc_sw64(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d (+)= a . b^T for a 64 x 8 tf32 tile a and a 128 x 8 tile b, both
// K-major in shared memory; scale_d == 0 overwrites d.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float* d, uint64_t a,
                                                     uint64_t b, int scale_d) {
#define F8(i)                                                        \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),    \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(a), "l"(b), "r"(scale_d));
#undef F8
}

// cvt.rna.tf32.f32 of a finite x: x rounded to TF32 (10 explicit mantissa
// bits; the low 13 bits 0) to nearest, ties away from zero, in two integer
// operations (half a TF32 ulp added to the magnitude bits, then
// truncation) instead of the four of the instruction's lowering.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__global__ void rownorm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                                    float* __restrict__ out, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * D);
  float s = 0.f;
  for (int i = lane; i < D / 8; i += 32) s += sumsq_bf16x8(p[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) out[row] = s;
}

__global__ void __launch_bounds__(THREADS, 1)
knn_tile_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_r,
                     const float* __restrict__ q_sq,
                     const float* __restrict__ r_sq, float* __restrict__ d_out,
                     int* __restrict__ i_out, int Q, int N, int nk, int tile_k,
                     int row_offset, int exclude_self, int n_row, int n_col) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Align to 1 KB (the 128-byte swizzle) by an offset, not through an
  // integer cast, so the compiler keeps shared-memory loads and stores.
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t full_bar = base + BAR_OFF;
  const uint32_t empty_bar = full_bar + STAGES * 8;

  // Grouped raster: GROUP_M row tiles walk the column tiles together.
  const int group = GROUP_M * n_col;
  const int first = (blockIdx.x / group) * GROUP_M;
  const int gsz = min(n_row - first, GROUP_M);
  const int in_group = blockIdx.x % group;
  const int row0 = (first + in_group % gsz) * BM;
  const int ct = in_group / gsz;
  const int col0 = ct * TILE_C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* panel = reinterpret_cast<float*>(smem);
  float* qn = reinterpret_cast<float*>(smem + QN_OFF);
  float* rn = reinterpret_cast<float*>(smem + RN_OFF);
  uint64_t* scr = reinterpret_cast<uint64_t*>(smem + BF_SCR_OFF) +
                  warp * SEL_ROWS * TILE_C;
  // Each role runs to the end in its own branch; the selection is the same
  // code in both.
  if (wg == 2) {
    // ---- producer warpgroup: one thread issues the TMA loads ----
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1u);
        const uint32_t fb = full_bar + 8 * stage;
        mbar_expect_tx(fb, STAGE_BYTES);
        const uint32_t dq = base + stage * STAGE_BYTES;
        tma_load_2d(dq, &tm_q, kb * BK, row0, fb);
        tma_load_2d(dq + Q_STAGE_BYTES, &tm_r, kb * BK, col0, fb);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    select_rows(panel, qn, rn, BM, warp, SEL_WARPS, scr, row0, col0, ct, Q, N,
                tile_k, row_offset, exclude_self, d_out, i_out);
  } else {
    // ---- consumer warpgroups: rows wg*64 .. wg*64+63 of the tile ----
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(full_bar + 8 * stage, phase);
      const uint32_t sq = base + stage * STAGE_BYTES;
      const uint64_t da = wgmma_desc(sq + wg * (64 * BK * 2));
      const uint64_t db = wgmma_desc(sq + Q_STAGE_BYTES);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)  // 32 bytes per k step
        wgmma_m64n256k16(acc, da + 2 * k, db + 2 * k);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_acc(acc);
      if (kb > 0) mbar_arrive(empty_bar + 8 * prev);
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1u;
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);

    // Both consumer warpgroups are done with the ring: it becomes the panel.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    {
      const int prow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
      const int pcol = (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        float* p0 = panel + prow * PANEL_LD + j * 8 + pcol;
        *reinterpret_cast<float2*>(p0) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(p0 + 8 * PANEL_LD) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    const int ctid = threadIdx.x;  // 0..255
    if (ctid < BM) qn[ctid] = row0 + ctid < Q ? q_sq[row0 + ctid] : 0.f;
    rn[ctid] = col0 + ctid < N ? r_sq[col0 + ctid] : 0.f;
    asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    select_rows(panel, qn, rn, BM, warp, SEL_WARPS, scr, row0, col0, ct, Q, N,
                tile_k, row_offset, exclude_self, d_out, i_out);
  }
}

// ---------------------------------------------------------------------------
// f32 mode: split-precision (3xTF32) products on the tensor cores. Each
// f32 value x becomes hi = tf32(x) and lo = tf32(x - hi), and
// q . r ~= lo_q . hi_r + hi_q . lo_r + hi_q . hi_r (lo . lo, ~2^-22 of
// |q||r|, is dropped). Block: 64 rows x 256 columns; consumer warpgroup
// w computes columns w*128 .. w*128+127 of all 64 rows.

// Splits one landed stage, in place (hi) and into the lo buffer: thread t
// of the 256 consumers takes the 16-byte chunks t + 256 i, all of row
// (t >> 2) + 64 i (the swizzle permutes chunks within a 64-byte row, and a
// warp's 32 chunks are 512 contiguous bytes, so no bank conflicts), and
// adds their squares to that row's norm.
__device__ __forceinline__ void split_stage(unsigned char* stage, int t,
                                            float* nrm) {
  float4* x = reinterpret_cast<float4*>(stage);
  float4* lo = x + F_X_BYTES / 16;
#pragma unroll
  for (int i = 0; i < F_SPLIT_CHUNKS; ++i) {
    const int c = t + 256 * i;
    const float4 v = x[c];
    nrm[i] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z,
                                                 fmaf(v.w, v.w, nrm[i]))));
    float4 h, l;
    h.x = tf32_rna(v.x);
    h.y = tf32_rna(v.y);
    h.z = tf32_rna(v.z);
    h.w = tf32_rna(v.w);
    l.x = tf32_rna(v.x - h.x);
    l.y = tf32_rna(v.y - h.y);
    l.z = tf32_rna(v.z - h.z);
    l.w = tf32_rna(v.w - h.w);
    x[c] = h;
    lo[c] = l;
  }
  // Generic-proxy writes, read next by wgmma (the async proxy).
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1)
knn_tile_f32_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_r,
                    float* __restrict__ d_out, int* __restrict__ i_out, int Q,
                    int N, int nk, int tile_k, int row_offset, int exclude_self,
                    int n_row, int n_col) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t full_bar = base + F_BAR_OFF;  // TMA landed
  const uint32_t ready_bar = full_bar + F_STAGES * 8;  // hi / lo written
  const uint32_t empty_bar = ready_bar + F_STAGES * 8;  // consumers done

  // The bf16 mode's grouped raster, with FM-row tiles.
  const int group = GROUP_M * n_col;
  const int first = (blockIdx.x / group) * GROUP_M;
  const int gsz = min(n_row - first, GROUP_M);
  const int in_group = blockIdx.x % group;
  const int row0 = (first + in_group % gsz) * FM;
  const int ct = in_group / gsz;
  const int col0 = ct * TILE_C;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(ready_bar + 8 * s, 2 * 128);
      mbar_init(empty_bar + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x >> 7;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* panel = reinterpret_cast<float*>(smem);
  float* qn = reinterpret_cast<float*>(smem + F_QN_OFF);
  float* rn = reinterpret_cast<float*>(smem + F_RN_OFF);
  uint64_t* scr = reinterpret_cast<uint64_t*>(smem + F_SCR_OFF) +
                  warp * SEL_ROWS * TILE_C;
  if (wg == 2) {
    // ---- producer warpgroup: one thread keeps the ring of raw f32
    // slices full ----
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(empty_bar + 8 * stage, phase ^ 1u);
        const uint32_t fb = full_bar + 8 * stage;
        mbar_expect_tx(fb, F_X_BYTES);
        const uint32_t dst = base + stage * F_STAGE_BYTES;
        tma_load_2d(dst, &tm_q, kb * FK, row0, fb);
        tma_load_2d(dst + F_Q_BYTES, &tm_r, kb * FK, col0, fb);
        if (++stage == F_STAGES) {
          stage = 0;
          phase ^= 1u;
        }
      }
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    select_rows(panel, qn, rn, FM, warp, SEL_WARPS, scr, row0, col0, ct, Q, N,
                tile_k, row_offset, exclude_self, d_out, i_out);
  } else {
    // ---- consumer warpgroups. While a stage's products run on the
    // tensor cores, the 256 consumer threads split the next stage. Each
    // stage's three passes go into a partial that starts at 0 (the
    // tensor cores' f32 sums do not round to nearest, and over D = 4096
    // their error would pass 1e-5 of the cancelled terms); the partial is
    // then added, rounding to nearest, into the total. The small terms go
    // first.
    const int t = threadIdx.x;  // 0..255
    float nrm[F_SPLIT_CHUNKS];
    float part[64], tot[64];
#pragma unroll
    for (int i = 0; i < F_SPLIT_CHUNKS; ++i) nrm[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) part[i] = tot[i] = 0.f;
    const uint32_t b_off = F_Q_BYTES + wg * (TILE_C / 2) * FK * 4;
    mbar_wait(full_bar, 0);
    split_stage(smem, t, nrm);
    mbar_arrive(ready_bar);
    int stage = 0;
    uint32_t phase = 0;
    for (int kb = 0; kb < nk; ++kb) {
      mbar_wait(ready_bar + 8 * stage, phase);
      const uint32_t sx = base + stage * F_STAGE_BYTES;
      const uint64_t a_hi = wgmma_desc_sw64(sx);
      const uint64_t a_lo = wgmma_desc_sw64(sx + F_X_BYTES);
      const uint64_t b_hi = wgmma_desc_sw64(sx + b_off);
      const uint64_t b_lo = wgmma_desc_sw64(sx + F_X_BYTES + b_off);
      fence_acc<64>(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < FK / 8; ++k)  // 32 bytes per k step
        wgmma_m64n128k8_tf32(part, a_lo + 2 * k, b_hi + 2 * k, k);
#pragma unroll
      for (int k = 0; k < FK / 8; ++k)
        wgmma_m64n128k8_tf32(part, a_hi + 2 * k, b_lo + 2 * k, 1);
#pragma unroll
      for (int k = 0; k < FK / 8; ++k)
        wgmma_m64n128k8_tf32(part, a_hi + 2 * k, b_hi + 2 * k, 1);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      const int next = stage + 1 == F_STAGES ? 0 : stage + 1;
      if (kb + 1 < nk) {
        mbar_wait(full_bar + 8 * next, next == 0 ? phase ^ 1u : phase);
        split_stage(smem + next * F_STAGE_BYTES, t, nrm);
        mbar_arrive(ready_bar + 8 * next);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc<64>(part);
      mbar_arrive(empty_bar + 8 * stage);
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += part[i];
      if (next == 0) phase ^= 1u;
      stage = next;
    }
    // Row norms: the 4 threads of a quad hold the 4 chunks of its rows.
#pragma unroll
    for (int i = 0; i < F_SPLIT_CHUNKS; ++i) {
      nrm[i] += __shfl_xor_sync(0xffffffffu, nrm[i], 1);
      nrm[i] += __shfl_xor_sync(0xffffffffu, nrm[i], 2);
    }
    if ((t & 3) == 0) {
      qn[t >> 2] = nrm[0];
#pragma unroll
      for (int i = 1; i < F_SPLIT_CHUNKS; ++i)
        rn[(t >> 2) + FM * (i - 1)] = nrm[i];
    }

    // Both consumer warpgroups are done with the ring: it becomes the panel.
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    {
      const int prow = (warp & 3) * 16 + (lane >> 2);
      const int pcol = wg * (TILE_C / 2) + (lane & 3) * 2;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        float* p0 = panel + prow * PANEL_LD + j * 8 + pcol;
        *reinterpret_cast<float2*>(p0) = make_float2(tot[4 * j], tot[4 * j + 1]);
        *reinterpret_cast<float2*>(p0 + 8 * PANEL_LD) =
            make_float2(tot[4 * j + 2], tot[4 * j + 3]);
      }
    }
    asm volatile("bar.sync 2, %0;\n" ::"n"(THREADS) : "memory");
    select_rows(panel, qn, rn, FM, warp, SEL_WARPS, scr, row0, col0, ct, Q, N,
                tile_k, row_offset, exclude_self, d_out, i_out);
  }
}

// A 2-D tensor map over (rows, D) row-major: boxes of one D slice by
// `box_rows` rows, swizzled as the mode's wgmma descriptors expect, with
// zero fill past the last row.
int make_map(CUtensorMap* map, const void* ptr, int rows, int D, int box_rows,
             bool f32) {
  cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)D * (f32 ? 4 : 2)};
  cuuint32_t box[2] = {(cuuint32_t)(f32 ? FK : BK), (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  CUresult res = cuTensorMapEncodeTiled(
      map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<void*>(ptr), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      f32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int knn_tile_smem_bytes(int bf16) {
  return bf16 ? BF_SMEM_BYTES : F_SMEM_BYTES;
}

extern "C" int knn_rownorm_launch(const void* x, void* out, int rows, int D,
                                  void* stream) {
  if (rows <= 0 || D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int per_block = 8;  // rows (warps) per 256-thread block
  rownorm_bf16_kernel<<<(rows + per_block - 1) / per_block, 32 * per_block, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(x), reinterpret_cast<float*>(out),
      rows, D);
  return (int)cudaGetLastError();
}

extern "C" int knn_tile_launch(const void* q, const void* r, const void* q_sq,
                               const void* r_sq, void* d_out, void* i_out,
                               int Q, int N, int D, int tile_k, int row_offset,
                               int exclude_self, int bf16, void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || tile_k <= 0 || tile_k > TILE_C)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int n_col = (N + TILE_C - 1) / TILE_C;
  const bool f32 = !bf16;
  if (D % (f32 ? FK : BK) != 0 || (!f32 && (q_sq == nullptr || r_sq == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int rows = f32 ? FM : BM;
  CUtensorMap tm_q, tm_r;
  int err = make_map(&tm_q, q, Q, D, rows, f32);
  if (!err) err = make_map(&tm_r, r, N, D, TILE_C, f32);
  if (err) return err;
  const int n_row = (Q + rows - 1) / rows;
  if (f32) {
    err = (int)cudaFuncSetAttribute(knn_tile_f32_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    F_SMEM_BYTES);
    if (err) return err;
    knn_tile_f32_kernel<<<n_row * n_col, THREADS, F_SMEM_BYTES, s>>>(
        tm_q, tm_r, reinterpret_cast<float*>(d_out),
        reinterpret_cast<int*>(i_out), Q, N, D / FK, tile_k, row_offset,
        exclude_self, n_row, n_col);
  } else {
    err = (int)cudaFuncSetAttribute(knn_tile_bf16_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    BF_SMEM_BYTES);
    if (err) return err;
    knn_tile_bf16_kernel<<<n_row * n_col, THREADS, BF_SMEM_BYTES, s>>>(
        tm_q, tm_r, reinterpret_cast<const float*>(q_sq),
        reinterpret_cast<const float*>(r_sq), reinterpret_cast<float*>(d_out),
        reinterpret_cast<int*>(i_out), Q, N, D / BK, tile_k, row_offset,
        exclude_self, n_row, n_col);
  }
  return (int)cudaGetLastError();
}
