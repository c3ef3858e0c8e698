// The fit layout's two graph terms, attraction and repulsion, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU these terms are XLA-fused inside
// the jitted epoch, `_fit_attraction` (multimodal_umap_tpu/models/
// layout.py:252-285) and `_fit_repulsion` (:288-333), each elementwise
// chain fused with its backward. The PyTorch port ran them as some 40
// (attraction) and 430 (repulsion) separate kernels a modality and
// epoch; here each term is one forward and one backward kernel.
//
// Attraction (K2), for anchor rows [row0, row0 + n_rows) of x = embed
// (N, D), neighbour ids nbrs (n_rows, k) and coefficients coef (n_rows, k):
//   loss = sum_{i,m} coef[i,m] * log1p(a * s^b),
//   s = max(|x_{row0+i} - x_{nbrs[i,m]}|^2, 1e-6)
// `fit_attr_fwd_kernel` writes one partial sum a row (the wrapper sums
// them in a fixed order); the (n_rows, k, D) gather never exists.
// `fit_attr_bwd_kernel` is gather-only: output row t receives its anchor
// part (its own k slots) minus its in-edge part, the slots (i, m) with
// nbrs[i,m] == t read through the transposed index of nbrs (a CSR: the
// stable sort of nbrs.flatten() and N + 1 row offsets, int32, built once
// with the fit task because the graph is fixed for all epochs).
//
// Repulsion (K3), for the same anchor rows, the permutation pi (N,), its
// inverse pi_inv and R roll offsets rolls (int64, on the device: a
// captured epoch reads each epoch's offsets there):
//   loss = sum_i rep_coef[i] * (sum_r psi(x_{row0+i}, x_{pi[(row0+i+rolls[r]) % N]}) / R),
//   psi = -log(a s^b / (1 + a s^b) + 1e-6)
// The permuted table and its rolled copies are never made. The backward
// writes each row t once: its anchor part against pi[(t + off_r) % N], and
// its negative part: t is round r's negative of the anchor
// (pi_inv[t] - off_r) mod N when that anchor lies in the row range.
//
// Gradients follow autograd of the plain PyTorch terms
// (ops/layout_terms.py): zero where |x_i - x_j|^2 < 1e-6 (clamp_min's
// mask), log1p / pow / log differentiated in closed form. Rows are summed
// in a fixed order and there are no atomics, so results are
// bit-reproducible from run to run (in another order than autograd's).
//
// Bound on an H100 SXM: bytes. Per epoch and modality at the main path's
// 31,744 x 64 table, k = 15, R = 8: the attraction reads the table, ids and
// coefficients (and in the backward the CSR) and writes the gradient,
// ~20 MB forward + backward (6 us at 3.35 TB/s); the repulsion ~26 MB.
// Each anchor-neighbour pair needs ~5 D operations and 3 transcendentals,
// far below the f32 rate. What the design does about the bytes: one warp
// per output row, the row's D values held in registers (V = D/32 a lane,
// D <= 128; a wider row is read again at each use and its gradient summed
// in place in the output row, so any D runs in bounded registers), each
// neighbour row read as coalesced 128-byte lines (the
// 8 MB table stays in the 50 MB L2, so the repeated row reads cost L2 and
// not HBM bandwidth), slots whose coefficient is 0 skipped (no read), one
// warp reduction a pair, and no intermediate in device memory. A first
// version, simple and right: no shared memory, no TMA, one edge at a time
// (a form keeping 4 of a row's edges in flight was 8-14 % slower on the
// H100). The attraction backward computes each kept edge's weight twice,
// once from each end, and a row's in-edges stay with one warp: it takes
// about 7x its forward (PERF.md).
//
// C entry points, bound with ctypes; they launch on the given stream,
// never synchronize, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // rows (warps) per 256-thread block
constexpr float CLAMP = 1e-6f;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (IEEE addition
  // commutes), so the lanes agree on s and on its mask.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One table row as a warp reads it. V > 0 (D <= 32 V): lane l holds
// columns l + 32 j, j < V, in registers, zero past D. V = 0 (any D):
// nothing is held, and each use reads the row again, 32 columns a stride
// (from L1 / L2: the row was just read).
template <int V>
struct Row {
  const float* p;
  float v[V > 0 ? V : 1];
  __device__ __forceinline__ Row(const float* __restrict__ x, int64_t row,
                                 int D, int lane)
      : p(x + row * (int64_t)D) {
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int d = lane + 32 * j;
        v[j] = d < D ? __ldg(p + d) : 0.f;
      }
    }
  }
};

// |u - w|^2 over the row: each lane's columns in order, then the warp.
template <int V>
__device__ __forceinline__ float sq_dist(const Row<V>& u, const Row<V>& w,
                                         int D, int lane) {
  float p = 0.f;
  if constexpr (V > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float e = u.v[j] - w.v[j];
      p = fmaf(e, e, p);
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      const float e = __ldg(u.p + d) - __ldg(w.p + d);
      p = fmaf(e, e, p);
    }
  }
  return warp_sum(p);
}

// The gradient row t that one warp owns and writes once. V > 0: its
// columns in registers, stored at the end. V = 0: summed in place in the
// output row (zeroed first; no other warp touches it, and each lane reads
// back only its own writes), so any D takes bounded registers.
template <int V>
struct GradRow {
  float* out;
  float v[V > 0 ? V : 1];
  __device__ __forceinline__ GradRow(float* __restrict__ grad, int64_t t,
                                     int D, int lane)
      : out(grad + t * (int64_t)D) {
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    } else {
      for (int d = lane; d < D; d += 32) out[d] = 0.f;
    }
  }
  // += w * (u - y)
  __device__ __forceinline__ void axpy(float w, const Row<V>& u,
                                       const Row<V>& y, int D, int lane) {
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = fmaf(w, u.v[j] - y.v[j], v[j]);
    } else {
      for (int d = lane; d < D; d += 32)
        out[d] = fmaf(w, __ldg(u.p + d) - __ldg(y.p + d), out[d]);
    }
  }
  __device__ __forceinline__ void store(int D, int lane) {
    if constexpr (V > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int d = lane + 32 * j;
        if (d < D) out[d] = v[j];
      }
    }
  }
};

// clamp_min(sq, 1e-6) with NaN kept, as torch.clamp_min does.
__device__ __forceinline__ float clamped(float sq) {
  return sq < CLAMP ? CLAMP : sq;
}

// d/ds log1p(a s^b)
__device__ __forceinline__ float attr_dfds(float s, float a, float b) {
  const float sb = powf(s, b);
  return a * b * powf(s, b - 1.f) / (1.f + a * sb);
}

// -log(a s^b / (1 + a s^b) + 1e-6)
__device__ __forceinline__ float rep_psi(float s, float a, float b) {
  const float u = a * powf(s, b);
  return -logf(u / (1.f + u) + 1e-6f);
}

// d/ds of rep_psi
__device__ __forceinline__ float rep_dpsids(float s, float a, float b) {
  const float u = a * powf(s, b);
  const float q = u / (1.f + u);
  const float opu = 1.f + u;
  return -(a * b * powf(s, b - 1.f)) / ((q + 1e-6f) * opu * opu);
}

__device__ __forceinline__ int64_t wrap(int64_t v, int64_t n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
    fit_attr_fwd_kernel(const float* __restrict__ x,
                        const int64_t* __restrict__ nbrs,
                        const float* __restrict__ coef,
                        float* __restrict__ partial, int n_rows, int k, int D,
                        int64_t row0, float a, float b) {
  const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (i >= n_rows) return;
  const Row<V> xi(x, row0 + i, D, lane);
  float acc = 0.f;
  for (int m = 0; m < k; ++m) {
    const int64_t e = (int64_t)i * k + m;
    const float c = coef[e];
    if (c == 0.f) continue;  // c * finite = 0: the row is not read
    const Row<V> y(x, nbrs[e], D, lane);
    const float s = clamped(sq_dist<V>(xi, y, D, lane));
    acc += c * log1pf(a * powf(s, b));
  }
  if (lane == 0) partial[i] = acc;
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
    fit_attr_bwd_kernel(const float* __restrict__ x,
                        const int64_t* __restrict__ nbrs,
                        const float* __restrict__ coef,
                        const int32_t* __restrict__ rev_order,
                        const int32_t* __restrict__ rev_offsets,
                        const float* __restrict__ grad_out,
                        float* __restrict__ grad, int64_t N, int n_rows, int k,
                        int D, int64_t row0, float a, float b) {
  const int64_t t = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= N) return;
  const float g0 = 2.f * *grad_out;  // d|u-w|^2/du = 2 (u - w)
  const Row<V> xt(x, t, D, lane);
  GradRow<V> acc(grad, t, D, lane);
  // anchor part: t's own slots
  const int64_t i = t - row0;
  if (i >= 0 && i < n_rows) {
    for (int m = 0; m < k; ++m) {
      const int64_t e = i * k + m;
      const float c = coef[e];
      if (c == 0.f) continue;
      const Row<V> y(x, nbrs[e], D, lane);
      const float sq = sq_dist<V>(xt, y, D, lane);
      if (!(sq >= CLAMP)) continue;  // clamp_min's zero gradient
      acc.axpy(g0 * c * attr_dfds(sq, a, b), xt, y, D, lane);
    }
  }
  // in-edge part: slots (i, m) with nbrs[i, m] == t, in CSR order
  const int32_t p1 = rev_offsets[t + 1];
  for (int32_t p = rev_offsets[t]; p < p1; ++p) {
    const int64_t e = rev_order[p];
    const float c = coef[e];
    if (c == 0.f) continue;
    const Row<V> y(x, row0 + e / k, D, lane);
    const float sq = sq_dist<V>(y, xt, D, lane);  // anchor - t
    if (!(sq >= CLAMP)) continue;
    acc.axpy(-(g0 * c * attr_dfds(sq, a, b)), y, xt, D, lane);
  }
  acc.store(D, lane);
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
    fit_rep_fwd_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ pi,
                       const int64_t* __restrict__ rolls,
                       const float* __restrict__ rep_coef,
                       float* __restrict__ partial, int64_t N, int n_rows,
                       int R, int D, int64_t row0, float a, float b) {
  const int il = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (il >= n_rows) return;
  const float c = rep_coef[il];
  if (c == 0.f) {  // c * finite = 0: no row is read
    if (lane == 0) partial[il] = 0.f;
    return;
  }
  const int64_t i = row0 + il;
  const Row<V> xi(x, i, D, lane);
  float acc = 0.f;
  for (int r = 0; r < R; ++r) {
    const Row<V> y(x, pi[wrap(i + rolls[r], N)], D, lane);
    acc += rep_psi(clamped(sq_dist<V>(xi, y, D, lane)), a, b);
  }
  if (lane == 0) partial[il] = c * (acc / (float)R);
}

template <int V>
__global__ void __launch_bounds__(32 * WARPS)
    fit_rep_bwd_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ pi,
                       const int64_t* __restrict__ pi_inv,
                       const int64_t* __restrict__ rolls,
                       const float* __restrict__ rep_coef,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad, int64_t N, int n_rows, int R,
                       int D, int64_t row0, float a, float b) {
  const int64_t t = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= N) return;
  const float g0 = 2.f * *grad_out / (float)R;
  const Row<V> xt(x, t, D, lane);
  GradRow<V> acc(grad, t, D, lane);
  // anchor part: t's negatives
  const int64_t il = t - row0;
  if (il >= 0 && il < n_rows) {
    const float c = rep_coef[il];
    if (c != 0.f) {
      for (int r = 0; r < R; ++r) {
        const Row<V> y(x, pi[wrap(t + rolls[r], N)], D, lane);
        const float sq = sq_dist<V>(xt, y, D, lane);
        if (!(sq >= CLAMP)) continue;
        acc.axpy(g0 * c * rep_dpsids(sq, a, b), xt, y, D, lane);
      }
    }
  }
  // negative part: t is round r's negative of anchor (pi_inv[t] - off_r)
  const int64_t jt = pi_inv[t];
  for (int r = 0; r < R; ++r) {
    const int64_t ia = wrap(jt - rolls[r], N);
    const int64_t ial = ia - row0;
    if (ial < 0 || ial >= n_rows) continue;
    const float c = rep_coef[ial];
    if (c == 0.f) continue;
    const Row<V> y(x, ia, D, lane);
    const float sq = sq_dist<V>(y, xt, D, lane);  // anchor - t
    if (!(sq >= CLAMP)) continue;
    acc.axpy(-(g0 * c * rep_dpsids(sq, a, b)), y, xt, D, lane);
  }
  acc.store(D, lane);
}

inline unsigned blocks_for(int64_t rows) {
  return (unsigned)((rows + WARPS - 1) / WARPS);
}

// The Row instance for D: values a lane holds (1, 2 or 4) for D <= 128;
// past that 0, the instance that holds none (any D).
inline int lane_values(int D) {
  return D <= 32 ? 1 : D <= 64 ? 2 : D <= 128 ? 4 : 0;
}

#define LT_DISPATCH(D_, LAUNCH)          \
  if ((D_) <= 0) return (int)cudaErrorInvalidValue; \
  switch (lane_values(D_)) {             \
    case 1: LAUNCH(1); break;            \
    case 2: LAUNCH(2); break;            \
    case 4: LAUNCH(4); break;            \
    default: LAUNCH(0); break;           \
  }

}  // namespace

extern "C" int fit_attr_fwd_launch(const void* x, const void* nbrs,
                                   const void* coef, void* partial,
                                   int n_rows, int k, int D, long long row0,
                                   float a, float b, void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(V)                                                         \
  fit_attr_fwd_kernel<V><<<blocks_for(n_rows), 32 * WARPS, 0, s>>>(       \
      (const float*)x, (const int64_t*)nbrs, (const float*)coef,         \
      (float*)partial, n_rows, k, D, (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_attr_bwd_launch(const void* x, const void* nbrs,
                                   const void* coef, const void* rev_order,
                                   const void* rev_offsets,
                                   const void* grad_out, void* grad,
                                   long long N, int n_rows, int k, int D,
                                   long long row0, float a, float b,
                                   void* stream) {
  if (N <= 0 || n_rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(V)                                                         \
  fit_attr_bwd_kernel<V><<<blocks_for(N), 32 * WARPS, 0, s>>>(            \
      (const float*)x, (const int64_t*)nbrs, (const float*)coef,         \
      (const int32_t*)rev_order, (const int32_t*)rev_offsets,            \
      (const float*)grad_out, (float*)grad, (int64_t)N, n_rows, k, D,    \
      (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_rep_fwd_launch(const void* x, const void* pi,
                                  const void* rolls, const void* rep_coef,
                                  void* partial, long long N, int n_rows,
                                  int R, int D, long long row0, float a,
                                  float b, void* stream) {
  if (N <= 0 || n_rows <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(V)                                                         \
  fit_rep_fwd_kernel<V><<<blocks_for(n_rows), 32 * WARPS, 0, s>>>(        \
      (const float*)x, (const int64_t*)pi, (const int64_t*)rolls,        \
      (const float*)rep_coef, (float*)partial, (int64_t)N, n_rows, R, D, \
      (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_rep_bwd_launch(const void* x, const void* pi,
                                  const void* pi_inv, const void* rolls,
                                  const void* rep_coef, const void* grad_out,
                                  void* grad, long long N, int n_rows, int R,
                                  int D, long long row0, float a, float b,
                                  void* stream) {
  if (N <= 0 || n_rows <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(V)                                                         \
  fit_rep_bwd_kernel<V><<<blocks_for(N), 32 * WARPS, 0, s>>>(             \
      (const float*)x, (const int64_t*)pi, (const int64_t*)pi_inv,       \
      (const int64_t*)rolls, (const float*)rep_coef,                     \
      (const float*)grad_out, (float*)grad, (int64_t)N, n_rows, R, D,    \
      (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
