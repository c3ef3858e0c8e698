// The fit layout's two graph terms, attraction and repulsion, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU these terms are XLA-fused inside
// the jitted epoch, `_fit_attraction` (multimodal_umap_tpu/models/
// layout.py:252-285) and `_fit_repulsion` (:288-333), each elementwise
// chain fused with its backward. The PyTorch port ran them as some 40
// (attraction) and 430 (repulsion) separate kernels a modality and
// epoch; here each term is one forward kernel and a backward of two
// (repulsion) or three (attraction) passes.
//
// Attraction (K2), for anchor rows [row0, row0 + n_rows) of x = embed
// (N, D), neighbour ids nbrs (n_rows, k) and coefficients coef (n_rows, k):
//   loss = sum_{i,m} coef[i,m] * log1p(a * s^b),
//   s = max(|x_{row0+i} - x_{nbrs[i,m]}|^2, 1e-6)
// `fit_attr_fwd_kernel` writes one partial sum a row (the wrapper sums
// them in a fixed order); the (n_rows, k, D) gather never exists. The
// backward's output row t is its anchor part (its own k slots) minus its
// in-edge part, the slots (i, m) with nbrs[i,m] == t, read through the
// transposed index of nbrs (a CSR: the stable sort of nbrs.flatten() and
// N + 1 row offsets, int32) and its chunk plan, both built once per fit
// (ops/layout_terms.py `reverse_index`) because the graph is fixed for
// all epochs.
//
// Repulsion (K3), for the same anchor rows, the permutation pi (N,), its
// inverse pi_inv and R roll offsets rolls (int64, on the device: a
// captured epoch reads each epoch's offsets there):
//   loss = sum_i rep_coef[i] * (sum_r psi(x_{row0+i}, x_{pi[(row0+i+rolls[r]) % N]}) / R),
//   psi = -log(a s^b / (1 + a s^b) + 1e-6)
// The permuted table and its rolled copies are never made. The backward's
// output row t is its anchor part against pi[(t + off_r) % N] plus its
// negative part: t is round r's negative of the anchor
// (pi_inv[t] - off_r) mod N when that anchor lies in the row range.
//
// Gradients follow autograd of the plain PyTorch terms
// (ops/layout_terms.py): zero where |x_i - x_j|^2 < 1e-6 (clamp_min's
// mask), log1p / pow / log differentiated in closed form. Every output
// row and every partial row has one owner, partials are summed in a fixed
// order and there are no atomics, so results are bit-reproducible from
// run to run (in another order than autograd's).
//
// Bound on an H100 SXM: bytes. Per epoch and modality at the main path's
// 31,744 x 64 table, k = 15, R = 8: the attraction reads the table, ids and
// coefficients (and in the backward the CSR) and writes the
// gradient, ~20 MB forward + backward (6 us at 3.35 TB/s); the repulsion
// ~26 MB. Each anchor-neighbour pair needs ~5 D operations and 3
// transcendentals, far below the f32 rate. The forward kernels give a warp
// a row, hold its D values in registers (V = D/32 a lane, D <= 128; a
// wider row is read again at each use), read each neighbour row as
// coalesced 128-byte lines (the 8 MB table stays in the 50 MB L2), skip
// slots whose coefficient is 0 and reduce each pair in the warp.
//
// What holds the backwards back is latency, not bytes: every pair is a
// chain of dependent loads (index, coefficient or weight, a random row
// from L2, or from HBM past 50 MB of table). A first version gave each
// output row to one warp that walked its pairs one at a time, each chain
// followed by a warp reduction and two powf; it computed every kept pair's
// weight twice (once from each end), and the attraction's hub rows (up to
// 590 in-edges, 485 kept, against a mean of 15 on the main graph) left
// one warp working 40x longer than the rest. The design now:
// * An edge pass, a group of G lanes an anchor row (16 lanes x one
//   16-byte load a row at D = 64; 4 to 32 lanes by D, 4-byte loads where
//   D % 4 != 0). It loads BATCH pairs' rows before any reduction, reduces
//   them side by side, and lane s of the group computes pair s's weight,
//   once: w[i k + m] = 2 g coef dfds(s) (attraction), w[i R + r] = 2 g / R
//   rep_coef dpsids(s) (repulsion), 0 where the coefficient is 0 (no row
//   read) or s < 1e-6, into an f32 scratch the wrapper allocates. Then it
//   writes the row's anchor part to the output row, sum w (x_i - x_j),
//   pairs in order: the attraction from the rows still in registers, the
//   repulsion from the rows read again from L1 (holding them across its
//   curve's two divisions spilled registers).
// * A gather pass of loads and FMAs: no reduction, no transcendental. Its
//   items issue BATCH pairs' index, weight and row loads before their
//   arithmetic and end the output row from its anchor part: the
//   attraction's in-edges, -= w[e_p] (x_{row0 + e_p / k} - x_t) in CSR
//   order; the repulsion's negative part, -= w (x_ia - x_t) in round order,
//   the offsets reduced to [0, N) once a block in shared memory (no 64-bit
//   division a pair). The difference form is kept: (sum w) x_t - sum w x_j
//   would cancel.
// * The attraction's work list is balanced by the chunk plan: a row of at
//   most C in-edges (ops/layout_terms.py's CHUNK_EDGES = 32, passed to the
//   gather at launch) is one item that ends its gradient row; a longer row
//   (a hub) is cut into chunks of C, each an item that writes a partial
//   row, and a finishing pass adds each such row's partials to its anchor
//   part in chunk order. The main graph's hub of 590 in-edges becomes 19
//   items that run side by side.
// Any D runs in bounded registers: the gather and finishing passes walk
// the row in tiles of G x VEC columns (at most 128); past one tile the edge
// pass sums the anchor part in the output row, each lane its own columns.
// Times (H100 80GB HBM3, 700.00 W; PERF.md, `compare_layout_terms.py`):
// at the main path's first fit-layout call the attraction backward 0.539 ms
// before, 0.087 now (edge 0.037, gather 0.045, finish 0.004); the
// repulsion backward 0.156 before, 0.056 now (edge 0.032, gather 0.022).
//
// C entry points, bound with ctypes, one a kernel (a backward's passes are
// launched by its wrapper in order, each counted); they launch on the
// given stream, never synchronize, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // forward: rows (warps) per 256-thread block
constexpr int BLOCK = 32 * WARPS;
constexpr float CLAMP = 1e-6f;
// Backward: the pairs whose loads a lane group issues before their
// arithmetic.
constexpr int BATCH = 8;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same bits (IEEE addition
  // commutes), so the lanes agree on s and on its mask.
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
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

// VEC consecutive columns of a row, as one lane of the backward's lane
// groups holds them (VEC = 4: one 16-byte load, row and column aligned).
template <int VEC>
struct Frag {
  float v[VEC];
};

template <int VEC>
__device__ __forceinline__ Frag<VEC> frag_zero() {
  Frag<VEC> f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) f.v[j] = 0.f;
  return f;
}

template <int VEC>
__device__ __forceinline__ Frag<VEC> frag_load(const float* __restrict__ p) {
  Frag<VEC> f;
  if constexpr (VEC == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    f.v[0] = q.x;
    f.v[1] = q.y;
    f.v[2] = q.z;
    f.v[3] = q.w;
  } else {
    f.v[0] = __ldg(p);
  }
  return f;
}

// A load of values written by this thread or by an earlier kernel on the
// stream (not through the read-only path: grad is written in the kernel).
template <int VEC>
__device__ __forceinline__ Frag<VEC> frag_load_own(const float* p) {
  Frag<VEC> f;
  if constexpr (VEC == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    f.v[0] = q.x;
    f.v[1] = q.y;
    f.v[2] = q.z;
    f.v[3] = q.w;
  } else {
    f.v[0] = *p;
  }
  return f;
}

template <int VEC>
__device__ __forceinline__ void frag_store(float* __restrict__ p,
                                           const Frag<VEC>& f) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2],
                                                f.v[3]);
  } else {
    *p = f.v[0];
  }
}

// acc += w * (u - y), column by column
template <int VEC>
__device__ __forceinline__ void frag_axpy(Frag<VEC>& acc, float w,
                                          const Frag<VEC>& u,
                                          const Frag<VEC>& y) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc.v[j] = fmaf(w, u.v[j] - y.v[j], acc.v[j]);
}

// p + |u - y|^2 over the fragment's columns, in order
template <int VEC>
__device__ __forceinline__ float frag_sq(float p, const Frag<VEC>& u,
                                         const Frag<VEC>& y) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    const float e = u.v[j] - y.v[j];
    p = fmaf(e, e, p);
  }
  return p;
}

// Sum over an aligned group of G lanes by an xor butterfly: every lane of
// the group ends with the same bits. Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// v[s] for a runtime s < BATCH (an unrolled select: no local memory)
__device__ __forceinline__ float pick(const float (&v)[BATCH], int s) {
  float r = 0.f;
#pragma unroll
  for (int q = 0; q < BATCH; ++q)
    if (q == s) r = v[q];
  return r;
}

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
__global__ void __launch_bounds__(BLOCK)
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

// The attraction backward's edge pass: w[i k + m] = 2 g coef[i,m]
// dfds(s) for the k slots of anchor row row0 + i, 0 where the coefficient
// is 0 (no row read) or s < 1e-6, and the row's anchor part,
// grad[row0 + i] = sum_m w (x_i - x_nbr) in slot order, from the rows
// just read. A group of G lanes an anchor row.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_bwd_weights_kernel(const float* __restrict__ x,
                                const int64_t* __restrict__ nbrs,
                                const float* __restrict__ coef,
                                const float* __restrict__ grad_out,
                                float* __restrict__ w,
                                float* __restrict__ grad, int n_rows, int k,
                                int D, int64_t row0, float a, float b) {
  constexpr int NS = (BATCH + G - 1) / G;  // slots a lane weighs a batch
  const int lane = threadIdx.x % G;
  const int64_t i = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  const bool live = i < n_rows;  // a group past the rows joins the shuffles
  const float g0 = 2.f * *grad_out;  // d|u-w|^2/du = 2 (u - w)
  const int64_t row = row0 + (live ? i : 0);
  const float* xi = x + row * D;
  float* gi = grad + row * D;
  const bool one_tile = D <= G * VEC;  // the row's values stay in registers
  const int col1 = lane * VEC;
  Frag<VEC> ga = frag_zero<VEC>();  // the anchor part of a one-tile row
  for (int m0 = 0; m0 < k; m0 += BATCH) {
    float c[BATCH];
    const float* py[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      const int64_t e = i * k + m0 + s;
      c[s] = live && m0 + s < k ? coef[e] : 0.f;
      py[s] = c[s] != 0.f ? x + nbrs[e] * D : xi;
    }
    float acc[BATCH];
    Frag<VEC> u = frag_zero<VEC>(), y[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      acc[s] = 0.f;
      y[s] = u;
    }
    for (int col = col1; col < D; col += G * VEC) {
      u = frag_load<VEC>(xi + col);
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        y[s] = c[s] != 0.f ? frag_load<VEC>(py[s] + col) : u;
#pragma unroll
      for (int s = 0; s < BATCH; ++s) acc[s] = frag_sq<VEC>(acc[s], u, y[s]);
    }
#pragma unroll
    for (int s = 0; s < BATCH; ++s) acc[s] = group_sum<G>(acc[s]);
    // lane l weighs slots l, l + G, ...: the powf of a batch side by side
    float wl[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int s = q * G + lane;
      const float sq = pick(acc, s), cs = pick(c, s);
      wl[q] = cs != 0.f && sq >= CLAMP ? g0 * cs * attr_dfds(sq, a, b) : 0.f;
      if (live && s < BATCH && m0 + s < k) w[i * k + m0 + s] = wl[q];
    }
    float wt[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s)
      wt[s] = __shfl_sync(FULL, wl[s / G], s % G, G);
    // anchor part: += w (x_i - x_nbr)
    if (one_tile) {
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        if (wt[s] != 0.f) frag_axpy<VEC>(ga, wt[s], u, y[s]);
    } else if (live) {  // summed in the output row (each lane its columns)
      for (int col = col1; col < D; col += G * VEC) {
        const Frag<VEC> uc = frag_load<VEC>(xi + col);
        Frag<VEC> g = m0 == 0 ? frag_zero<VEC>() : frag_load_own<VEC>(gi + col);
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
          if (wt[s] != 0.f)
            frag_axpy<VEC>(g, wt[s], uc, frag_load<VEC>(py[s] + col));
        frag_store<VEC>(gi + col, g);
      }
    }
  }
  if (one_tile && live && col1 < D) frag_store<VEC>(gi + col1, ga);
}

// The attraction backward's gather pass over the work list, the in-edge
// part, -= w (x_anchor - x_t) in CSR order: items [0, N) are the rows
// with at most C = chunk in-edges (each ends its gradient row, the
// anchor part the edge pass wrote there for a row in the range; a longer
// row's item does nothing), items N + q the chunks q of the longer rows
// (each writes partial row q). Chunk q belongs to row multi_row[r],
// r = chunk_multi[q], is that row's chunk j = q - multi_first[r] and
// takes its in-edges [off + j C, off + (j+1) C). The plan is cut by the
// same C (ops/layout_terms.py's CHUNK_EDGES, passed at launch).
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const int32_t* __restrict__ rev_order,
                        const int32_t* __restrict__ rev_offsets,
                        const int32_t* __restrict__ multi_row,
                        const int32_t* __restrict__ multi_first,
                        const int32_t* __restrict__ chunk_multi,
                        float* __restrict__ grad, float* __restrict__ partial,
                        int64_t N, int n_chunks, int chunk, int n_rows,
                        int k, int D, int64_t row0) {
  const int lane = threadIdx.x % G;
  const int64_t item = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  if (item >= N + n_chunks) return;
  int64_t t;
  int32_t p0, p1;
  float* out;
  bool anchor;  // out holds the row's anchor part
  if (item < N) {
    t = item;
    p0 = rev_offsets[t];
    p1 = rev_offsets[t + 1];
    if (p1 - p0 > chunk) return;  // its chunks follow
    out = grad + t * D;
    anchor = t >= row0 && t - row0 < n_rows;
  } else {
    const int q = (int)(item - N);
    const int r = chunk_multi[q];
    const int j = q - multi_first[r];
    t = multi_row[r];
    p0 = rev_offsets[t] + j * chunk;
    p1 = min(p0 + chunk, rev_offsets[t + 1]);
    out = partial + (int64_t)q * D;
    anchor = false;
  }
  const float* xt_row = x + t * D;
  for (int col0 = 0; col0 < D; col0 += G * VEC) {
    const int col = col0 + lane * VEC;
    const bool on = col < D;
    const Frag<VEC> xt = on ? frag_load<VEC>(xt_row + col) : frag_zero<VEC>();
    Frag<VEC> acc = anchor && on ? frag_load_own<VEC>(out + col)
                                 : frag_zero<VEC>();
    for (int p = p0; p < p1; p += BATCH) {
      int32_t e[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s) e[s] = p + s < p1 ? rev_order[p + s] : -1;
      float wt[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s) wt[s] = e[s] >= 0 ? w[e[s]] : 0.f;
      Frag<VEC> y[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        y[s] = wt[s] != 0.f && on
                   ? frag_load<VEC>(x + (row0 + e[s] / k) * D + col)
                   : xt;
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        if (wt[s] != 0.f) frag_axpy<VEC>(acc, -wt[s], y[s], xt);
    }
    if (on) frag_store<VEC>(out + col, acc);
  }
}

// The attraction backward's finishing pass: gradient row t = multi_row[r]
// is its anchor part (0 outside the row range) plus its chunks' partial
// rows [multi_first[r], multi_first[r+1]), in chunk order.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_bwd_finish_kernel(const float* __restrict__ partial,
                               const int32_t* __restrict__ multi_row,
                               const int32_t* __restrict__ multi_first,
                               float* __restrict__ grad, int n_multi,
                               int n_rows, int D, int64_t row0) {
  const int lane = threadIdx.x % G;
  const int64_t r = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  if (r >= n_multi) return;
  const int q0 = multi_first[r], q1 = multi_first[r + 1];
  const int64_t t = multi_row[r];
  const bool anchor = t >= row0 && t - row0 < n_rows;
  float* out = grad + t * D;
  for (int col = lane * VEC; col < D; col += G * VEC) {
    Frag<VEC> acc = anchor ? frag_load_own<VEC>(out + col) : frag_zero<VEC>();
#pragma unroll 4
    for (int q = q0; q < q1; ++q) {
      const Frag<VEC> p = frag_load<VEC>(partial + (int64_t)q * D + col);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc.v[j] += p.v[j];
    }
    frag_store<VEC>(out + col, acc);
  }
}

template <int V>
__global__ void __launch_bounds__(BLOCK)
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

// The R round offsets reduced to [0, N) into shared memory, so that the
// per-pair index arithmetic needs no 64-bit division. Every thread of the
// block calls it (a barrier).
__device__ __forceinline__ void load_offsets(int64_t* offs,
                                             const int64_t* __restrict__ rolls,
                                             int R, int64_t N) {
  for (int r = threadIdx.x; r < R; r += BLOCK) offs[r] = wrap(rolls[r], N);
  __syncthreads();
}

// (v + off) mod N and (v - off) mod N for v, off in [0, N)
__device__ __forceinline__ int64_t add_mod(int64_t v, int64_t off, int64_t N) {
  v += off;
  return v >= N ? v - N : v;
}
__device__ __forceinline__ int64_t sub_mod(int64_t v, int64_t off, int64_t N) {
  v -= off;
  return v < 0 ? v + N : v;
}

// The repulsion backward's edge pass: w[il R + r] = 2 g / R rep_coef[il]
// dpsids(s) for anchor row0 + il against its round-r negative, 0 where
// the coefficient is 0 (no row read) or s < 1e-6, and the row's anchor
// part, grad[row0 + il] = sum_r w (x_i - x_neg) in round order, from the
// rows just read (again, from L1). A group of G lanes an anchor row.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_rep_bwd_weights_kernel(const float* __restrict__ x,
                               const int64_t* __restrict__ pi,
                               const int64_t* __restrict__ rolls,
                               const float* __restrict__ rep_coef,
                               const float* __restrict__ grad_out,
                               float* __restrict__ w,
                               float* __restrict__ grad, int64_t N,
                               int n_rows, int R, int D, int64_t row0,
                               float a, float b) {
  extern __shared__ int64_t offs[];
  load_offsets(offs, rolls, R, N);
  constexpr int NS = (BATCH + G - 1) / G;
  const int lane = threadIdx.x % G;
  const int64_t il = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  const bool live = il < n_rows;  // a group past the rows joins the shuffles
  const float g0 = 2.f * *grad_out / (float)R;
  const float c = live ? rep_coef[il] : 0.f;
  const int64_t i = row0 + (live ? il : 0);
  const float* xi = x + i * D;
  float* gi = grad + i * D;
  const bool one_tile = D <= G * VEC;
  const int col1 = lane * VEC;
  Frag<VEC> ga = frag_zero<VEC>();
  for (int r0 = 0; r0 < R; r0 += BATCH) {
    const float* py[BATCH];
    bool on[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      on[s] = c != 0.f && r0 + s < R;
      py[s] = on[s] ? x + pi[add_mod(i, offs[r0 + s], N)] * D : xi;
    }
    float acc[BATCH];
    Frag<VEC> u = frag_zero<VEC>(), y[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      acc[s] = 0.f;
      y[s] = u;
    }
    for (int col = col1; col < D; col += G * VEC) {
      u = frag_load<VEC>(xi + col);
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        y[s] = on[s] ? frag_load<VEC>(py[s] + col) : u;
#pragma unroll
      for (int s = 0; s < BATCH; ++s) acc[s] = frag_sq<VEC>(acc[s], u, y[s]);
    }
#pragma unroll
    for (int s = 0; s < BATCH; ++s) acc[s] = group_sum<G>(acc[s]);
    float wl[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int s = q * G + lane;
      const float sq = pick(acc, s);
      wl[q] = c != 0.f && sq >= CLAMP ? g0 * c * rep_dpsids(sq, a, b) : 0.f;
      if (live && s < BATCH && r0 + s < R) w[il * R + r0 + s] = wl[q];
    }
    float wt[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s)
      wt[s] = __shfl_sync(FULL, wl[s / G], s % G, G);
    // anchor part: += w (x_i - x_neg), the rows read again (from L1)
    if (one_tile) {
      if (col1 < D) {
        const Frag<VEC> uc = frag_load<VEC>(xi + col1);
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
          if (wt[s] != 0.f)
            frag_axpy<VEC>(ga, wt[s], uc, frag_load<VEC>(py[s] + col1));
      }
    } else if (live) {  // summed in the output row (each lane its columns)
      for (int col = col1; col < D; col += G * VEC) {
        const Frag<VEC> uc = frag_load<VEC>(xi + col);
        Frag<VEC> g = r0 == 0 ? frag_zero<VEC>() : frag_load_own<VEC>(gi + col);
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
          if (wt[s] != 0.f)
            frag_axpy<VEC>(g, wt[s], uc, frag_load<VEC>(py[s] + col));
        frag_store<VEC>(gi + col, g);
      }
    }
  }
  if (one_tile && live && col1 < D) frag_store<VEC>(gi + col1, ga);
}

// The repulsion backward's gather pass, the negative part: a group of G
// lanes an output row t, which is round r's negative of anchor
// ia = (pi_inv[t] - off_r) mod N; where ia lies in the row range,
// -= w (x_ia - x_t), summed over the rounds in order (BATCH rounds' loads
// issued together) and added to t's anchor part (0 outside the range).
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_rep_bwd_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ pi_inv,
                       const int64_t* __restrict__ rolls,
                       const float* __restrict__ w, float* __restrict__ grad,
                       int64_t N, int n_rows, int R, int D, int64_t row0) {
  extern __shared__ int64_t offs[];
  load_offsets(offs, rolls, R, N);
  const int lane = threadIdx.x % G;
  const int64_t t = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  if (t >= N) return;
  const bool anchor = t >= row0 && t - row0 < n_rows;
  const int64_t jt = pi_inv[t];
  const float* xt_row = x + t * D;
  float* out = grad + t * D;
  for (int col0 = 0; col0 < D; col0 += G * VEC) {
    const int col = col0 + lane * VEC;
    const bool on = col < D;
    const Frag<VEC> xt = on ? frag_load<VEC>(xt_row + col) : frag_zero<VEC>();
    Frag<VEC> acc = frag_zero<VEC>();
    for (int r0 = 0; r0 < R; r0 += BATCH) {
      float wn[BATCH];
      const float* pn[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s) {
        const int r = r0 + s;
        const int64_t ia = r < R ? sub_mod(jt, offs[r], N) : 0;
        const int64_t ial = ia - row0;
        wn[s] = r < R && ial >= 0 && ial < n_rows ? w[ial * R + r] : 0.f;
        pn[s] = wn[s] != 0.f && on ? x + ia * D + col : nullptr;
      }
      Frag<VEC> yn[BATCH];
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        yn[s] = pn[s] != nullptr ? frag_load<VEC>(pn[s]) : xt;
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        if (wn[s] != 0.f) frag_axpy<VEC>(acc, -wn[s], yn[s], xt);
    }
    if (on) {
      if (anchor) {
        const Frag<VEC> ga = frag_load_own<VEC>(out + col);
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc.v[j] = ga.v[j] + acc.v[j];
      }
      frag_store<VEC>(out + col, acc);
    }
  }
}

inline unsigned blocks_for(int64_t rows) {
  return (unsigned)((rows + WARPS - 1) / WARPS);
}

// Blocks for `items` lane groups of G lanes.
inline unsigned group_blocks(int64_t items, int G) {
  return (unsigned)((items * G + BLOCK - 1) / BLOCK);
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The backward's columns a lane loads at once: 4 (one 16-byte load) when
// every row it touches is 16-byte aligned, else 1.
inline int vec_width(int D, const void* a, const void* b, const void* c) {
  return D % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) ? 4 : 1;
}

// The backward's lanes a row (4 to 32): enough that one pass of the group
// covers D when D / VEC <= 32; wider rows take several G x VEC tiles.
inline int group_lanes(int D, int vec) {
  const int cols = (D + vec - 1) / vec;
  return cols <= 4 ? 4 : cols <= 8 ? 8 : cols <= 16 ? 16 : 32;
}

#define BWD_DISPATCH(G_, VEC_, LAUNCH)                 \
  switch ((G_) * 10 + (VEC_)) {                        \
    case 41: LAUNCH(4, 1); break;                      \
    case 81: LAUNCH(8, 1); break;                      \
    case 161: LAUNCH(16, 1); break;                    \
    case 321: LAUNCH(32, 1); break;                    \
    case 44: LAUNCH(4, 4); break;                      \
    case 84: LAUNCH(8, 4); break;                      \
    case 164: LAUNCH(16, 4); break;                    \
    case 324: LAUNCH(32, 4); break;                    \
    default: return (int)cudaErrorInvalidValue;        \
  }

}  // namespace

extern "C" int fit_attr_fwd_launch(const void* x, const void* nbrs,
                                   const void* coef, void* partial,
                                   int n_rows, int k, int D, long long row0,
                                   float a, float b, void* stream) {
  if (n_rows <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(V)                                                         \
  fit_attr_fwd_kernel<V><<<blocks_for(n_rows), BLOCK, 0, s>>>(            \
      (const float*)x, (const int64_t*)nbrs, (const float*)coef,         \
      (float*)partial, n_rows, k, D, (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The attraction's backward, three passes launched in this order:
// the edge pass into w (n_rows * k floats) and the anchor rows of grad;
// the gather over the N + n_chunks work items (partial: n_chunks x D
// floats); the finishing pass over the n_multi rows of several chunks
// (none to launch when n_multi is 0).
extern "C" int fit_attr_bwd_weights_launch(
    const void* x, const void* nbrs, const void* coef, const void* grad_out,
    void* grad, void* w, int n_rows, int k, int D, long long row0, float a,
    float b, void* stream) {
  if (n_rows <= 0 || k <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, x, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                      \
  fit_attr_bwd_weights_kernel<G_, V_><<<group_blocks(n_rows, G_), BLOCK, 0, \
                                        s>>>(                               \
      (const float*)x, (const int64_t*)nbrs, (const float*)coef,           \
      (const float*)grad_out, (float*)w, (float*)grad, n_rows, k, D,       \
      (int64_t)row0, a, b)
  BWD_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_attr_bwd_gather_launch(
    const void* x, const void* w, const void* rev_order,
    const void* rev_offsets, const void* multi_row, const void* multi_first,
    const void* chunk_multi, void* grad, void* partial, long long N,
    int n_chunks, int chunk, int n_rows, int k, int D, long long row0,
    void* stream) {
  if (N <= 0 || n_chunks < 0 || chunk <= 0 || n_rows <= 0 || k <= 0 ||
      D <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, x, grad, partial);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                      \
  fit_attr_bwd_kernel<G_, V_><<<group_blocks(N + n_chunks, G_), BLOCK, 0,   \
                                s>>>(                                       \
      (const float*)x, (const float*)w, (const int32_t*)rev_order,         \
      (const int32_t*)rev_offsets, (const int32_t*)multi_row,              \
      (const int32_t*)multi_first, (const int32_t*)chunk_multi,            \
      (float*)grad, (float*)partial, (int64_t)N, n_chunks, chunk, n_rows,  \
      k, D, (int64_t)row0)
  BWD_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_attr_bwd_finish_launch(
    const void* partial, const void* multi_row, const void* multi_first,
    void* grad, int n_multi, int n_rows, int D, long long row0,
    void* stream) {
  if (n_multi <= 0 || n_rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, partial, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                      \
  fit_attr_bwd_finish_kernel<G_, V_><<<group_blocks(n_multi, G_), BLOCK, 0, \
                                       s>>>(                                \
      (const float*)partial, (const int32_t*)multi_row,                    \
      (const int32_t*)multi_first, (float*)grad, n_multi, n_rows, D,       \
      (int64_t)row0)
  BWD_DISPATCH(G, vec, LAUNCH)
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
  fit_rep_fwd_kernel<V><<<blocks_for(n_rows), BLOCK, 0, s>>>(             \
      (const float*)x, (const int64_t*)pi, (const int64_t*)rolls,        \
      (const float*)rep_coef, (float*)partial, (int64_t)N, n_rows, R, D, \
      (int64_t)row0, a, b)
  LT_DISPATCH(D, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// The repulsion's backward, two passes launched in this order: the edge
// pass into w (n_rows * R floats) and the anchor rows of grad, then the
// gather over the N rows. Both hold the R offsets, reduced to [0, N), in
// shared memory.
inline size_t offsets_smem(int R) { return (size_t)R * sizeof(int64_t); }

extern "C" int fit_rep_bwd_weights_launch(
    const void* x, const void* pi, const void* rolls, const void* rep_coef,
    const void* grad_out, void* grad, void* w, long long N, int n_rows,
    int R, int D, long long row0, float a, float b, void* stream) {
  const size_t smem = offsets_smem(R);
  if (N <= 0 || n_rows <= 0 || R <= 0 || D <= 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, x, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                     \
  fit_rep_bwd_weights_kernel<G_, V_><<<group_blocks(n_rows, G_), BLOCK,    \
                                       smem, s>>>(                         \
      (const float*)x, (const int64_t*)pi, (const int64_t*)rolls,         \
      (const float*)rep_coef, (const float*)grad_out, (float*)w,          \
      (float*)grad, (int64_t)N, n_rows, R, D, (int64_t)row0, a, b)
  BWD_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_rep_bwd_gather_launch(
    const void* x, const void* pi_inv, const void* rolls, const void* w,
    void* grad, long long N, int n_rows, int R, int D, long long row0,
    void* stream) {
  const size_t smem = offsets_smem(R);
  if (N <= 0 || n_rows <= 0 || R <= 0 || D <= 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, x, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                     \
  fit_rep_bwd_kernel<G_, V_><<<group_blocks(N, G_), BLOCK, smem, s>>>(     \
      (const float*)x, (const int64_t*)pi_inv, (const int64_t*)rolls,     \
      (const float*)w, (float*)grad, (int64_t)N, n_rows, R, D,            \
      (int64_t)row0)
  BWD_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
