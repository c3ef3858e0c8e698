// The fit layout's two graph terms, attraction and repulsion, forward and
// backward, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU these terms are XLA-fused inside
// the jitted epoch, `_fit_attraction` (multimodal_umap_tpu/models/
// layout.py:252-285) and `_fit_repulsion` (:288-333), each elementwise
// chain fused with its backward. The PyTorch port ran them as some 40
// (attraction) and 430 (repulsion) separate kernels a modality and
// epoch; here each term is one forward kernel and a backward of one
// (repulsion) or two (attraction) passes.
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
// transcendentals, far below the f32 rate.
//
// What holds them back is latency, not bytes: every pair is a chain of
// dependent loads (index, coefficient, a random row from L2, or from HBM
// past 50 MB of table) ending in a reduction and a curve. The first
// versions gave a row to one warp that walked its pairs one at a time (one
// row load in flight, a 5-level warp reduction and a curve computed by all
// 32 lanes a pair; backward, each kept pair's weight from both ends, and
// the attraction's hub rows, up to 590 in-edges against a mean of 15 on
// the main graph, left one warp working 40x longer than the rest). Now a
// group of G lanes takes a row (16 lanes x one 16-byte load at D = 64; 4
// to 32 lanes by D, 4-byte loads where D % 4 != 0 or a table is not
// 16-byte aligned), issues BATCH pairs' index loads, then their rows,
// before any reduction, reduces them side by side, and lane s of the group
// takes pair s's curve, once. No row is read for a coefficient of 0. The
// kernels:
// * The forwards: the loss terms of an anchor row's k slots (attraction)
//   or R rounds (repulsion), summed by each lane over its own pairs, then
//   by the group, into the row's partial. Where the call's gradient is
//   wanted (the GRAD instance) the same pass, from the rows already in
//   registers, also does what needs the pair's distance: lane s computes
//   pair s's weight at g = 1 beside its loss term, sharing its powf (w[i k
//   + m] = 2 coef dfds(s), attraction; w[i R + r] = 2 / R rep_coef
//   dpsids(s), repulsion; 0 where s < 1e-6) into an f32 buffer the
//   wrapper keeps for the backward, and the group writes the row's anchor
//   part, sum w (x_i - x_j) in pair order, to the gradient table the
//   wrapper keeps too: the attraction from the rows still in registers,
//   the repulsion from the rows read again from L1 (holding them across
//   its curve's divisions spilled registers). The loss only (no_grad, or
//   a table that needs no gradient) takes the instance without them. An
//   epoch so reads each kept pair's partner row twice, in the forward and
//   in the gather, where a backward that redid the distances read it
//   three times; the loss's gradient g, known only in the backward,
//   scales each row where the gather ends it (g = 1 in every fit: the
//   bits of weights formed at 2 g coef dfds(s)).
// * A backward's gather pass of loads and FMAs: no reduction, no
//   transcendental. Its items issue BATCH pairs' index, weight and row
//   loads before their arithmetic and end the output row from its anchor
//   part, in place in the forward's gradient table: the attraction's
//   in-edges, -= w[e_p] (x_{row0 + e_p / k} - x_t) in CSR order; the
//   repulsion's negative part, -= w (x_ia - x_t) in round order; then
//   times g. The difference form is kept: (sum w) x_t - sum w x_j would
//   cancel.
// * The attraction's work list is balanced by the chunk plan: a row of at
//   most C in-edges (ops/layout_terms.py's CHUNK_EDGES = 32, passed to the
//   gather at launch) is one item that ends its gradient row; a longer row
//   (a hub) is cut into chunks of C, each an item that writes a partial
//   row, and a finishing pass adds each such row's partials to its anchor
//   part in chunk order. The main graph's hub of 590 in-edges becomes 19
//   items that run side by side.
// The repulsion's kernels reduce the R offsets to [0, N) once a block in
// shared memory (no 64-bit division a pair). Any D runs in bounded
// registers: every kernel walks a row in tiles of G x VEC columns (at most
// 128), holding the anchor row in registers where one tile covers it; past
// one tile the forward sums the anchor part in the output row.
// Device ms a call at the main path's first fit-layout call (31,744 x 64,
// k = 15, R = 8; H100 80GB HBM3, 700.00 W; PERF.md), forward and backward
// together: attraction 0.119 -> 0.094 (forward 0.036, its loss alone
// 0.032; gather 0.045, finish 0.004), repulsion 0.083 -> 0.061 (forward
// 0.033, its loss alone 0.025; gather 0.020), against a backward that
// redid the distances in an edge pass (0.037 / 0.032) after a forward of
// the loss alone.
//
// C entry points, bound with ctypes, one a kernel (a backward's passes are
// launched by its wrapper in order, each counted); they launch on the
// given stream, never synchronize, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // threads a block
constexpr float CLAMP = 1e-6f;
// The pairs whose loads a lane group issues before their arithmetic.
constexpr int BATCH = 8;
constexpr unsigned FULL = 0xffffffffu;

// VEC consecutive columns of a row, as one lane of a lane group holds
// them (VEC = 4: one 16-byte load, row and column aligned).
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

// One pair's repulsion: psi(s) = -log(a s^b / (1 + a s^b) + 1e-6) added to
// acc and, with GRAD, the weight g0 c dpsi/ds(s) (0 where s < 1e-6), both
// from one a s^b; s = sq clamped at 1e-6.
template <bool GRAD>
__device__ __forceinline__ float rep_pair(float& acc, float g0c, float sq,
                                          float a, float b) {
  const float s = clamped(sq);
  const float u = a * powf(s, b);
  const float q = u / (1.f + u);
  acc += -logf(q + 1e-6f);
  if (!GRAD || !(sq >= CLAMP)) return 0.f;  // NaN too, as torch's mask
  const float opu = 1.f + u;
  return g0c * (-(a * b * powf(s, b - 1.f)) / ((q + 1e-6f) * opu * opu));
}

__device__ __forceinline__ int64_t wrap(int64_t v, int64_t n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// One pair's attraction: the loss term coef log1p(a s^b) added to acc and,
// with GRAD, the weight 2 coef dfds(s) (0 where s < 1e-6), both from one
// powf(s, b); s = sq clamped at 1e-6. The weight's expression is that of
// g0 coef dfds(s) with g0 = 2 g at g = 1, its denominator 1 + a s^b one
// fused multiply-add, as nvcc contracts it where the weight has s^b to
// itself (with a s^b also the loss's, nvcc rounds it first, and the
// weights change in their last bits).
template <bool GRAD>
__device__ __forceinline__ float attr_pair(float& acc, float cs, float sq,
                                           float a, float b) {
  const float s = clamped(sq);
  const float sb = powf(s, b);
  acc += cs * log1pf(a * sb);
  if (!GRAD || !(sq >= CLAMP)) return 0.f;  // NaN too, as torch's mask
  return 2.f * cs * (a * b * powf(s, b - 1.f) / __fmaf_rn(a, sb, 1.f));
}

// The attraction forward: partial[i] = sum_m coef[i,m] log1p(a s^b) over
// the k slots of anchor row row0 + i and, with GRAD (a call whose
// gradient is wanted), what the backward's gather needs: the weights at
// g = 1, w[i k + m] = 2 coef[i,m] dfds(s), 0 where the coefficient is 0
// (no row read) or s < 1e-6, and the row's anchor part, grad[row0 + i] =
// sum_m w (x_i - x_nbr) in slot order, from the rows just read. A group
// of G lanes a row; lane s of the group takes slot s's curve and sums its
// slots' terms in order.
template <int G, int VEC, bool GRAD>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_fwd_kernel(const float* __restrict__ x,
                        const int64_t* __restrict__ nbrs,
                        const float* __restrict__ coef,
                        float* __restrict__ partial, float* __restrict__ w,
                        float* __restrict__ grad, int n_rows, int k, int D,
                        int64_t row0, float a, float b) {
  constexpr int NS = (BATCH + G - 1) / G;  // slots a lane's curve takes
  const int lane = threadIdx.x % G;
  const int64_t i = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  const bool live = i < n_rows;  // a group past the rows joins the shuffles
  const int64_t row = row0 + (live ? i : 0);
  const float* xi = x + row * D;
  float* gi = GRAD ? grad + row * D : nullptr;
  const bool one_tile = D <= G * VEC;  // the row's values stay in registers
  const int col1 = lane * VEC;
  Frag<VEC> ga = frag_zero<VEC>();  // the anchor part of a one-tile row
  float acc = 0.f;  // this lane's terms
  for (int m0 = 0; m0 < k; m0 += BATCH) {
    float c[BATCH];
    const float* py[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      const int64_t e = i * k + m0 + s;
      c[s] = live && m0 + s < k ? coef[e] : 0.f;
      py[s] = c[s] != 0.f ? x + nbrs[e] * D : xi;  // c * finite = 0: no read
    }
    float sq[BATCH];
    Frag<VEC> u = frag_zero<VEC>(), y[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      sq[s] = 0.f;
      y[s] = u;
    }
    for (int col = col1; col < D; col += G * VEC) {
      u = frag_load<VEC>(xi + col);
#pragma unroll
      for (int s = 0; s < BATCH; ++s)
        y[s] = c[s] != 0.f ? frag_load<VEC>(py[s] + col) : u;
#pragma unroll
      for (int s = 0; s < BATCH; ++s) sq[s] = frag_sq<VEC>(sq[s], u, y[s]);
    }
#pragma unroll
    for (int s = 0; s < BATCH; ++s) sq[s] = group_sum<G>(sq[s]);
    // lane l takes slots l, l + G, ...: the powf of a batch side by side
    float wl[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int s = q * G + lane;
      const float cs = pick(c, s);  // 0 past the batch and past k
      wl[q] = cs != 0.f ? attr_pair<GRAD>(acc, cs, pick(sq, s), a, b) : 0.f;
      if (GRAD && live && s < BATCH && m0 + s < k) w[i * k + m0 + s] = wl[q];
    }
    if constexpr (GRAD) {
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
          Frag<VEC> g =
              m0 == 0 ? frag_zero<VEC>() : frag_load_own<VEC>(gi + col);
#pragma unroll
          for (int s = 0; s < BATCH; ++s)
            if (wt[s] != 0.f)
              frag_axpy<VEC>(g, wt[s], uc, frag_load<VEC>(py[s] + col));
          frag_store<VEC>(gi + col, g);
        }
      }
    }
  }
  acc = group_sum<G>(acc);
  if (live && lane == 0) partial[i] = acc;
  if (GRAD && one_tile && live && col1 < D) frag_store<VEC>(gi + col1, ga);
}

// The attraction backward's gather pass over the work list, the in-edge
// part, -= w (x_anchor - x_t) in CSR order: items [0, N) are the rows
// with at most C = chunk in-edges (each ends its gradient row: g times
// the anchor part the forward wrote there for a row in the range, 0
// outside it, plus the in-edges; a longer row's item does nothing), items
// N + q the chunks q of the longer rows (each writes partial row q, at
// g = 1). Chunk q belongs to row multi_row[r],
// r = chunk_multi[q], is that row's chunk j = q - multi_first[r] and
// takes its in-edges [off + j C, off + (j+1) C). The plan is cut by the
// same C (ops/layout_terms.py's CHUNK_EDGES, passed at launch).
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ w,
                        const float* __restrict__ grad_out,
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
  float g = 1.f;  // the loss's gradient, applied where a row ends
  if (item < N) {
    t = item;
    p0 = rev_offsets[t];
    p1 = rev_offsets[t + 1];
    if (p1 - p0 > chunk) return;  // its chunks follow
    out = grad + t * D;
    anchor = t >= row0 && t - row0 < n_rows;
    g = *grad_out;
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
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc.v[j] *= g;
    if (on) frag_store<VEC>(out + col, acc);
  }
}

// The attraction backward's finishing pass: gradient row t = multi_row[r]
// is g times its anchor part (0 outside the row range) plus its chunks'
// partial rows [multi_first[r], multi_first[r+1]), in chunk order.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_attr_bwd_finish_kernel(const float* __restrict__ partial,
                               const int32_t* __restrict__ multi_row,
                               const int32_t* __restrict__ multi_first,
                               const float* __restrict__ grad_out,
                               float* __restrict__ grad, int n_multi,
                               int n_rows, int D, int64_t row0) {
  const int lane = threadIdx.x % G;
  const int64_t r = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  if (r >= n_multi) return;
  const int q0 = multi_first[r], q1 = multi_first[r + 1];
  const int64_t t = multi_row[r];
  const bool anchor = t >= row0 && t - row0 < n_rows;
  float* out = grad + t * D;
  const float g = *grad_out;
  for (int col = lane * VEC; col < D; col += G * VEC) {
    Frag<VEC> acc = anchor ? frag_load_own<VEC>(out + col) : frag_zero<VEC>();
#pragma unroll 4
    for (int q = q0; q < q1; ++q) {
      const Frag<VEC> p = frag_load<VEC>(partial + (int64_t)q * D + col);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc.v[j] += p.v[j];
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc.v[j] *= g;
    frag_store<VEC>(out + col, acc);
  }
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

// The repulsion forward: partial[il] = rep_coef[il] (sum_r psi(s_r) / R)
// for anchor row0 + il against its R round negatives, 0 where rep_coef is
// 0 (no row read) and, with GRAD, the weights at g = 1, w[il R + r] =
// 2 / R rep_coef[il] dpsids(s), 0 where rep_coef is 0 or s < 1e-6, and the
// row's anchor part, grad[row0 + il] = sum_r w (x_i - x_neg) in round
// order, from the rows just read (again, from L1: holding them across the
// curve's divisions spilled registers). A group of G lanes a row, as in
// the attraction forward.
template <int G, int VEC, bool GRAD>
__global__ void __launch_bounds__(BLOCK)
    fit_rep_fwd_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ pi,
                       const int64_t* __restrict__ rolls,
                       const float* __restrict__ rep_coef,
                       float* __restrict__ partial, float* __restrict__ w,
                       float* __restrict__ grad, int64_t N, int n_rows,
                       int R, int D, int64_t row0, float a, float b) {
  extern __shared__ int64_t offs[];
  load_offsets(offs, rolls, R, N);
  constexpr int NS = (BATCH + G - 1) / G;
  const int lane = threadIdx.x % G;
  const int64_t il = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  const bool live = il < n_rows;  // a group past the rows joins the shuffles
  const float g0 = 2.f / (float)R;  // 2 g / R at g = 1
  const float c = live ? rep_coef[il] : 0.f;
  const int64_t i = row0 + (live ? il : 0);
  const float* xi = x + i * D;
  float* gi = GRAD ? grad + i * D : nullptr;
  const bool one_tile = D <= G * VEC;
  const int col1 = lane * VEC;
  Frag<VEC> ga = frag_zero<VEC>();
  float acc = 0.f;  // this lane's terms
  for (int r0 = 0; r0 < R; r0 += BATCH) {
    const float* py[BATCH];
    bool on[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) {
      on[s] = c != 0.f && r0 + s < R;
      py[s] = on[s] ? x + pi[add_mod(i, offs[r0 + s], N)] * D : xi;
    }
    float sq[BATCH];
#pragma unroll
    for (int s = 0; s < BATCH; ++s) sq[s] = 0.f;
    if (c != 0.f) {
      for (int col = col1; col < D; col += G * VEC) {
        const Frag<VEC> u = frag_load<VEC>(xi + col);
        Frag<VEC> y[BATCH];
#pragma unroll
        for (int s = 0; s < BATCH; ++s)
          y[s] = on[s] ? frag_load<VEC>(py[s] + col) : u;
#pragma unroll
        for (int s = 0; s < BATCH; ++s) sq[s] = frag_sq<VEC>(sq[s], u, y[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < BATCH; ++s) sq[s] = group_sum<G>(sq[s]);
    float wl[NS];
#pragma unroll
    for (int q = 0; q < NS; ++q) {
      const int s = q * G + lane;
      const bool pair = s < BATCH && r0 + s < R && c != 0.f;  // on[s]
      wl[q] = pair ? rep_pair<GRAD>(acc, g0 * c, pick(sq, s), a, b) : 0.f;
      if (GRAD && live && s < BATCH && r0 + s < R) w[il * R + r0 + s] = wl[q];
    }
    if constexpr (GRAD) {
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
          Frag<VEC> g =
              r0 == 0 ? frag_zero<VEC>() : frag_load_own<VEC>(gi + col);
#pragma unroll
          for (int s = 0; s < BATCH; ++s)
            if (wt[s] != 0.f)
              frag_axpy<VEC>(g, wt[s], uc, frag_load<VEC>(py[s] + col));
          frag_store<VEC>(gi + col, g);
        }
      }
    }
  }
  acc = group_sum<G>(acc);
  if (live && lane == 0) partial[il] = c * (acc / (float)R);
  if (GRAD && one_tile && live && col1 < D) frag_store<VEC>(gi + col1, ga);
}

// The repulsion backward's gather pass, the negative part: a group of G
// lanes an output row t, which is round r's negative of anchor
// ia = (pi_inv[t] - off_r) mod N; where ia lies in the row range,
// -= w (x_ia - x_t), summed over the rounds in order (BATCH rounds' loads
// issued together), added to t's anchor part (0 outside the range) and
// times g.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    fit_rep_bwd_kernel(const float* __restrict__ x,
                       const int64_t* __restrict__ pi_inv,
                       const int64_t* __restrict__ rolls,
                       const float* __restrict__ w,
                       const float* __restrict__ grad_out,
                       float* __restrict__ grad, int64_t N, int n_rows, int R,
                       int D, int64_t row0) {
  extern __shared__ int64_t offs[];
  load_offsets(offs, rolls, R, N);
  const int lane = threadIdx.x % G;
  const int64_t t = ((int64_t)blockIdx.x * BLOCK + threadIdx.x) / G;
  if (t >= N) return;
  const bool anchor = t >= row0 && t - row0 < n_rows;
  const int64_t jt = pi_inv[t];
  const float g = *grad_out;
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
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc.v[j] *= g;
      frag_store<VEC>(out + col, acc);
    }
  }
}

// Blocks for `items` lane groups of G lanes.
inline unsigned group_blocks(int64_t items, int G) {
  return (unsigned)((items * G + BLOCK - 1) / BLOCK);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The columns a lane loads at once: 4 (one 16-byte load) when every row
// the kernel touches is 16-byte aligned, else 1.
inline int vec_width(int D, const void* a, const void* b = nullptr,
                     const void* c = nullptr) {
  return D % 4 == 0 && aligned16(a) && aligned16(b) && aligned16(c) ? 4 : 1;
}

// The lanes a row (4 to 32): enough that one pass of the group
// covers D when D / VEC <= 32; wider rows take several G x VEC tiles.
inline int group_lanes(int D, int vec) {
  const int cols = (D + vec - 1) / vec;
  return cols <= 4 ? 4 : cols <= 8 ? 8 : cols <= 16 ? 16 : 32;
}

// The lane-group instance for (G, VEC)
#define GROUP_DISPATCH(G_, VEC_, LAUNCH)               \
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

// Shared memory for the R round offsets, reduced to [0, N), that every
// repulsion kernel holds.
inline size_t offsets_smem(int R) { return (size_t)R * sizeof(int64_t); }

}  // namespace

// The forwards: one partial a row and, given w and grad (both or
// neither), the weights (n_rows * k or n_rows * R floats) and the anchor
// rows of grad that the backward's gather ends; without them the
// loss-only instance.
extern "C" int fit_attr_fwd_launch(const void* x, const void* nbrs,
                                   const void* coef, void* partial, void* w,
                                   void* grad, int n_rows, int k, int D,
                                   long long row0, float a, float b,
                                   void* stream) {
  if (n_rows <= 0 || k <= 0 || D <= 0 || (w == nullptr) != (grad == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = grad ? vec_width(D, x, grad, grad) : vec_width(D, x);
  const int G = group_lanes(D, vec);
#define INSTANCE(G_, V_, GRAD_)                                              \
  fit_attr_fwd_kernel<G_, V_, GRAD_><<<group_blocks(n_rows, G_), BLOCK, 0,   \
                                       s>>>(                                 \
      (const float*)x, (const int64_t*)nbrs, (const float*)coef,            \
      (float*)partial, (float*)w, (float*)grad, n_rows, k, D, (int64_t)row0, \
      a, b)
#define LAUNCH(G_, V_)          \
  if (grad)                     \
    INSTANCE(G_, V_, true);     \
  else                          \
    INSTANCE(G_, V_, false)
  GROUP_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
#undef INSTANCE
  return (int)cudaGetLastError();
}

// The attraction's backward, launched in this order: the gather over the
// N + n_chunks work items (partial: n_chunks x D floats); the finishing
// pass over the n_multi rows of several chunks (none to launch when
// n_multi is 0). grad_out: the loss's gradient, one float on the device.
extern "C" int fit_attr_bwd_gather_launch(
    const void* x, const void* w, const void* grad_out, const void* rev_order,
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
      (const float*)x, (const float*)w, (const float*)grad_out,            \
      (const int32_t*)rev_order, (const int32_t*)rev_offsets,              \
      (const int32_t*)multi_row, (const int32_t*)multi_first,              \
      (const int32_t*)chunk_multi, (float*)grad, (float*)partial,          \
      (int64_t)N, n_chunks, chunk, n_rows, k, D, (int64_t)row0)
  GROUP_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_attr_bwd_finish_launch(
    const void* partial, const void* multi_row, const void* multi_first,
    const void* grad_out, void* grad, int n_multi, int n_rows, int D,
    long long row0, void* stream) {
  if (n_multi <= 0 || n_rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, partial, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                      \
  fit_attr_bwd_finish_kernel<G_, V_><<<group_blocks(n_multi, G_), BLOCK, 0, \
                                       s>>>(                                \
      (const float*)partial, (const int32_t*)multi_row,                    \
      (const int32_t*)multi_first, (const float*)grad_out, (float*)grad,   \
      n_multi, n_rows, D, (int64_t)row0)
  GROUP_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

extern "C" int fit_rep_fwd_launch(const void* x, const void* pi,
                                  const void* rolls, const void* rep_coef,
                                  void* partial, void* w, void* grad,
                                  long long N, int n_rows, int R, int D,
                                  long long row0, float a, float b,
                                  void* stream) {
  const size_t smem = offsets_smem(R);
  if (N <= 0 || n_rows <= 0 || R <= 0 || D <= 0 || smem > 48 * 1024 ||
      (w == nullptr) != (grad == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = grad ? vec_width(D, x, grad, grad) : vec_width(D, x);
  const int G = group_lanes(D, vec);
#define INSTANCE(G_, V_, GRAD_)                                              \
  fit_rep_fwd_kernel<G_, V_, GRAD_><<<group_blocks(n_rows, G_), BLOCK, smem, \
                                      s>>>(                                  \
      (const float*)x, (const int64_t*)pi, (const int64_t*)rolls,           \
      (const float*)rep_coef, (float*)partial, (float*)w, (float*)grad,     \
      (int64_t)N, n_rows, R, D, (int64_t)row0, a, b)
#define LAUNCH(G_, V_)          \
  if (grad)                     \
    INSTANCE(G_, V_, true);     \
  else                          \
    INSTANCE(G_, V_, false)
  GROUP_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
#undef INSTANCE
  return (int)cudaGetLastError();
}

// The repulsion's backward: the gather over the N rows.
extern "C" int fit_rep_bwd_gather_launch(
    const void* x, const void* pi_inv, const void* rolls, const void* w,
    const void* grad_out, void* grad, long long N, int n_rows, int R, int D,
    long long row0, void* stream) {
  const size_t smem = offsets_smem(R);
  if (N <= 0 || n_rows <= 0 || R <= 0 || D <= 0 || smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int vec = vec_width(D, x, grad, grad);
  const int G = group_lanes(D, vec);
#define LAUNCH(G_, V_)                                                     \
  fit_rep_bwd_kernel<G_, V_><<<group_blocks(N, G_), BLOCK, smem, s>>>(     \
      (const float*)x, (const int64_t*)pi_inv, (const int64_t*)rolls,     \
      (const float*)w, (const float*)grad_out, (float*)grad, (int64_t)N,  \
      n_rows, R, D, (int64_t)row0)
  GROUP_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
