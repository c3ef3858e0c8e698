// Fused distance panel + per-tile top-k for exact kNN, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_knn_tile_kernel` launched by `knn_pallas`
// (multimodal_umap_tpu/ops/knn_pallas.py:48-117, pallas_call at :189).
//
// What it computes, for one block of query rows q (Q, D) against all
// reference rows r (N, D):
//   panel[i, j] = max((-2 * q_i . r_j + |q_i|^2) + |r_j|^2, 0)
// with column j >= N and, under exclude_self, j == row_offset + i set to
// +inf; then, for every (row, 128-column tile), the tile_k smallest
// entries in ascending order, ties to the lowest column id, each column
// taken at most once. Output: (num_col_tiles, Q, tile_k) f32 squared
// distances and int32 global column ids. The cross-tile merge and the f32
// re-score stay in the PyTorch wrapper (ops/knn_tile.py), as they were
// XLA outside the kernel on the TPU.
//
// Design for this card (not a block-by-block copy of the Pallas kernel):
//   * the grid is (row tiles of 64, column tiles of 128); the TPU's
//     sequential D grid axis is a loop inside the block, staging 32-wide
//     D slices of q and r in shared memory and keeping the 64x128 panel
//     in registers (8 warps, 32x32 each);
//   * bf16 mode: mma.sync m16n8k16 bf16 -> f32 on the tensor cores;
//     f32 mode: f32 FMA on the CUDA cores (never TF32, which keeps only
//     ~3 decimal digits). Both modes accumulate the row squared norms in
//     the same loop from the values loaded, i.e. the bf16-rounded values
//     in bf16 mode, so the bf16 panel is the exact squared distance of
//     the rounded vectors;
//   * epilogue: the panel goes through shared memory (aliasing the
//     staging buffers); one warp per row runs tile_k warp-shuffle argmin
//     rounds over the row's 128 entries (4 per lane).
//
// Bound on an H100 SXM: bf16 mode does 2*Q*N*D operations at the
// 989 TFLOP/s dense bf16 rate (8.4 ms for the 31,744^2 D=4096 fit graph,
// 1.6 ms at D=768) while its inputs are ~260 MB of bf16 (~0.08 ms at
// 3.35 TB/s), so it is bound by operations. This first version is the
// simple form (synchronous staging, mma.sync); wgmma and TMA come later.
//
// C entry point `knn_tile_launch`, bound with ctypes; it launches on the
// given stream, never synchronizes, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE_R = 64;
constexpr int TILE_C = 128;
constexpr int TILE_D = 32;
constexpr int THREADS = 256;
constexpr int PANEL_LD = TILE_C + 1;   // f32 panel row stride
constexpr int BF_LD = TILE_D + 8;      // bf16 staging row stride (80 bytes)
constexpr int F_LDQ = TILE_R + 4;      // f32 staging, d-major
constexpr int F_LDR = TILE_C + 4;

constexpr int PANEL_BYTES = TILE_R * PANEL_LD * 4;
constexpr int BF_STAGE_BYTES = (TILE_R + TILE_C) * BF_LD * 2;
constexpr int F_STAGE_BYTES = TILE_D * (F_LDQ + F_LDR) * 4;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BYTES =
    cmax(PANEL_BYTES, cmax(BF_STAGE_BYTES, F_STAGE_BYTES));

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

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Dot products q_i . r_j of the block's 64x128 tile, bf16 tensor cores.
// Leaves them in `panel` and the squared norms in q_sq / r_sq.
__device__ __forceinline__ void panel_bf16(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ r,
    int Q, int N, int D, int row0, int col0, unsigned char* smem,
    float* q_sq, float* r_sq) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* rs = qs + TILE_R * BF_LD;
  const int lrow = tid >> 2;          // staging row 0..63
  const int lchunk = (tid & 3) * 8;   // 8 bf16 = 16 bytes
  const int gq = row0 + lrow, gr0 = col0 + lrow, gr1 = col0 + 64 + lrow;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tg = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
  float qn = 0.f, rn0 = 0.f, rn1 = 0.f;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  for (int d0 = 0; d0 < D; d0 += TILE_D) {
    uint4 vq = zero, vr0 = zero, vr1 = zero;
    if (gq < Q)
      vq = *reinterpret_cast<const uint4*>(q + (size_t)gq * D + d0 + lchunk);
    if (gr0 < N)
      vr0 = *reinterpret_cast<const uint4*>(r + (size_t)gr0 * D + d0 + lchunk);
    if (gr1 < N)
      vr1 = *reinterpret_cast<const uint4*>(r + (size_t)gr1 * D + d0 + lchunk);
    qn += sumsq_bf16x8(vq);
    rn0 += sumsq_bf16x8(vr0);
    rn1 += sumsq_bf16x8(vr1);
    *reinterpret_cast<uint4*>(qs + lrow * BF_LD + lchunk) = vq;
    *reinterpret_cast<uint4*>(rs + lrow * BF_LD + lchunk) = vr0;
    *reinterpret_cast<uint4*>(rs + (64 + lrow) * BF_LD + lchunk) = vr1;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TILE_D; kk += 16) {
      uint32_t af[2][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* base = qs + (wm * 32 + mi * 16 + g) * BF_LD + kk + tg * 2;
        af[mi][0] = ld32(base);
        af[mi][1] = ld32(base + 8 * BF_LD);
        af[mi][2] = ld32(base + 8);
        af[mi][3] = ld32(base + 8 * BF_LD + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* base = rs + (wn * 32 + ni * 8 + g) * BF_LD + kk + tg * 2;
        bfr[ni][0] = ld32(base);
        bfr[ni][1] = ld32(base + 8);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();
  }

  // Norms: the 4 lanes sharing a staging row hold its partial sums.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    qn += __shfl_xor_sync(0xffffffffu, qn, off);
    rn0 += __shfl_xor_sync(0xffffffffu, rn0, off);
    rn1 += __shfl_xor_sync(0xffffffffu, rn1, off);
  }
  if ((tid & 3) == 0) {
    q_sq[lrow] = qn;
    r_sq[lrow] = rn0;
    r_sq[64 + lrow] = rn1;
  }
  float* panel = reinterpret_cast<float*>(smem);  // staging is dead now
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int rr = wm * 32 + mi * 16 + g;
      const int cc = wn * 32 + ni * 8 + tg * 2;
      panel[rr * PANEL_LD + cc] = acc[mi][ni][0];
      panel[rr * PANEL_LD + cc + 1] = acc[mi][ni][1];
      panel[(rr + 8) * PANEL_LD + cc] = acc[mi][ni][2];
      panel[(rr + 8) * PANEL_LD + cc + 1] = acc[mi][ni][3];
    }
}

// The same tile in full f32 on the CUDA cores (4x8 outputs per thread).
__device__ __forceinline__ void panel_f32(
    const float* __restrict__ q, const float* __restrict__ r, int Q, int N,
    int D, int row0, int col0, unsigned char* smem, float* q_sq, float* r_sq) {
  const int tid = threadIdx.x;
  float* qs = reinterpret_cast<float*>(smem);   // [TILE_D][F_LDQ]
  float* rs = qs + TILE_D * F_LDQ;              // [TILE_D][F_LDR]
  const int ty = tid >> 4, tx = tid & 15;
  const int vrow = tid >> 3, vd = (tid & 7) * 4;  // float4 staging slot

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float qn[2] = {0.f, 0.f}, rn[4] = {0.f, 0.f, 0.f, 0.f};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int d0 = 0; d0 < D; d0 += TILE_D) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = vrow + 32 * j, gq = row0 + row;
      float4 x = zero;
      if (gq < Q) x = *reinterpret_cast<const float4*>(q + (size_t)gq * D + d0 + vd);
      qn[j] = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, qn[j]))));
      qs[(vd + 0) * F_LDQ + row] = x.x;
      qs[(vd + 1) * F_LDQ + row] = x.y;
      qs[(vd + 2) * F_LDQ + row] = x.z;
      qs[(vd + 3) * F_LDQ + row] = x.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = vrow + 32 * j, gr = col0 + row;
      float4 x = zero;
      if (gr < N) x = *reinterpret_cast<const float4*>(r + (size_t)gr * D + d0 + vd);
      rn[j] = fmaf(x.x, x.x, fmaf(x.y, x.y, fmaf(x.z, x.z, fmaf(x.w, x.w, rn[j]))));
      rs[(vd + 0) * F_LDR + row] = x.x;
      rs[(vd + 1) * F_LDR + row] = x.y;
      rs[(vd + 2) * F_LDR + row] = x.z;
      rs[(vd + 3) * F_LDR + row] = x.w;
    }
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < TILE_D; ++d) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[d * F_LDQ + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = rs[d * F_LDR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Norms: the 8 lanes sharing a staging row hold its partial sums.
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) {
#pragma unroll
    for (int j = 0; j < 2; ++j) qn[j] += __shfl_xor_sync(0xffffffffu, qn[j], off);
#pragma unroll
    for (int j = 0; j < 4; ++j) rn[j] += __shfl_xor_sync(0xffffffffu, rn[j], off);
  }
  if ((tid & 7) == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) q_sq[vrow + 32 * j] = qn[j];
#pragma unroll
    for (int j = 0; j < 4; ++j) r_sq[vrow + 32 * j] = rn[j];
  }
  float* panel = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      panel[(ty * 4 + i) * PANEL_LD + tx + 16 * j] = acc[i][j];
}

template <bool BF16>
__global__ void __launch_bounds__(THREADS)
knn_tile_kernel(const void* __restrict__ q_ptr, const void* __restrict__ r_ptr,
                float* __restrict__ d_out, int* __restrict__ i_out, int Q,
                int N, int D, int tile_k, int row_offset, int exclude_self) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];
  __shared__ float q_sq[TILE_R];
  __shared__ float r_sq[TILE_C];
  const int row0 = blockIdx.x * TILE_R;
  const int col0 = blockIdx.y * TILE_C;

  if (BF16)
    panel_bf16(reinterpret_cast<const __nv_bfloat16*>(q_ptr),
               reinterpret_cast<const __nv_bfloat16*>(r_ptr), Q, N, D, row0,
               col0, smem, q_sq, r_sq);
  else
    panel_f32(reinterpret_cast<const float*>(q_ptr),
              reinterpret_cast<const float*>(r_ptr), Q, N, D, row0, col0,
              smem, q_sq, r_sq);
  __syncthreads();

  const float* panel = reinterpret_cast<const float*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  for (int rr = warp; rr < TILE_R; rr += THREADS / 32) {
    const int qrow = row0 + rr;
    if (qrow >= Q) break;  // warp-uniform; later rows are padding too
    const int grow = row_offset + qrow;
    const float qq = q_sq[rr];
    float v[4];
    int c[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int lc = lane + 32 * s, gc = col0 + lc;
      float x = fmaxf((-2.f * panel[rr * PANEL_LD + lc] + qq) + r_sq[lc], 0.f);
      if (gc >= N || (exclude_self && gc == grow)) x = inf;
      v[s] = x;
      c[s] = gc;
    }
    unsigned taken = 0u;
    float* drow = d_out + ((size_t)blockIdx.y * Q + qrow) * tile_k;
    int* irow = i_out + ((size_t)blockIdx.y * Q + qrow) * tile_k;
    for (int t = 0; t < tile_k; ++t) {
      float bv = inf;
      int bc = 0x7fffffff;
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const bool better = v[s] < bv || (v[s] == bv && c[s] < bc);
        if (!((taken >> s) & 1u) && better) {
          bv = v[s];
          bc = c[s];
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
        if (ov < bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
        if (c[s] == bc) taken |= 1u << s;
      if (lane == 0) {
        drow[t] = bv;
        irow[t] = bc;
      }
    }
  }
}

}  // namespace

extern "C" int knn_tile_launch(const void* q, const void* r, void* d_out,
                               void* i_out, int Q, int N, int D, int tile_k,
                               int row_offset, int exclude_self, int bf16,
                               void* stream) {
  if (Q <= 0 || N <= 0 || D <= 0 || D % TILE_D != 0 || tile_k <= 0 ||
      tile_k > TILE_C)
    return (int)cudaErrorInvalidValue;
  dim3 grid((Q + TILE_R - 1) / TILE_R, (N + TILE_C - 1) / TILE_C);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    knn_tile_kernel<true><<<grid, THREADS, 0, s>>>(
        q, r, reinterpret_cast<float*>(d_out), reinterpret_cast<int*>(i_out),
        Q, N, D, tile_k, row_offset, exclude_self);
  else
    knn_tile_kernel<false><<<grid, THREADS, 0, s>>>(
        q, r, reinterpret_cast<float*>(d_out), reinterpret_cast<int*>(i_out),
        Q, N, D, tile_k, row_offset, exclude_self);
  return (int)cudaGetLastError();
}
