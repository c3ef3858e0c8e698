// The fit layout's cross-modal InfoNCE term, forward and backward, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: on the TPU the term is XLA-fused inside the
// jitted epoch (multimodal_umap_tpu/ops/losses.py `infonce`, its rolls,
// stack and log_softmax fused with their backward). The PyTorch port ran
// it as plain torch, some 340 kernels a direction and epoch at 31,783 rows
// and 1,400 past 65,536 rows (row blocks with wrap copies, recomputed under
// checkpoint); here a direction's forward is one kernel, a call's loss one
// finishing kernel and the backward of both directions one kernel.
//
// A pair of tables E0, E1 runs both directions, E0 -> E1 and E1 -> E0
// (ops/losses.py `infonce_pair`). One direction (ops/losses.py `infonce`,
// the plain version), anchors A, partner B, num rows,
// rolls = [rot, off_0 .. off_n] (int64, on the device: a captured epoch
// reads each epoch's draws there), q the negatives' permutation:
//   slot i: anchor row a = (i + rot) % num of A, positive row a of B;
//   logit column 0 is the positive, column c >= 1 is row
//   q[(i + off_{c-1}) % num] of B, -inf where that row is a;
//   logit = <A_a / |A_a|, B_r / |B_r|> / T, |x| = sqrt(max(|x|^2, 1e-24));
//   v_i = -log_softmax(logits)[0];
//   loss = (1 / groups) sum_i v_i / count(group of i), the groups
//   group_size slots each, the last one short but weighted as a whole.
// Gradients follow autograd of that plain code, with the same clamp mask.
//
// The forward saves, per slot, ncols = n_neg + 2 coefficients
// coef[i, c] = (p_c - [c == 0]) / (T |A_a|) (p the softmax; 0 where
// masked) and the anchor's gradient in normalised space,
// ga[i] = sum_c (p_c - [c == 0]) B_r / (T |B_r|), both still to be scaled
// by the slot's constant dv_i = g / (groups count(i)). The backward then
// ends each output row j of a table in one pass, with no scatter: from the
// direction in which the table holds the anchors, dv ga[(j - rot) % num];
// from the direction in which it is the partner, the positive's
// dv coef[t, 0] A_j (t = (j - rot) % num) and each negative column's
// dv coef[t_c, c] A_{(t_c + rot) % num}, t_c = (q_inv[j] - off_{c-1}) % num
// (K3's q_inv route: row j is column c's negative of exactly that slot);
// then the normalisation's backward, g/|x| - [|x|^2 >= 1e-24]
// <g, x> x / |x|^3. Table k holds direction k's anchors and is direction
// 1 - k's partner; one launch covers both tables, so each gradient row is
// written once, by one lane group.
//
// Bound on an H100 SXM: bytes. A slot reads its anchor row and ncols
// partner rows and writes ga and coef; an output row reads itself, ga and
// ncols anchor rows of the other direction. At D = 64, n_neg = 8 that is
// some 12 rows of 256 B a row and direction forward and as many backward:
// 0.11 ms an epoch at 31,783 rows and 0.40 ms at 118,287 rows at
// 3.35 TB/s. The operations (a dot product and a norm a row, ncols exp)
// are far below the f32 rate. As in K2 / K3 (csrc/layout_terms.cu) what
// holds such a gather back is latency, so a lane group of G lanes takes a
// slot or a row (16 lanes x one 16-byte load at D = 64; 32 lanes past 16
// loads; 4-byte loads where D % 4 != 0 or a table is not 16-byte
// aligned), its lanes find the COLS columns' rows side by side, every row
// load of a batch is issued before its arithmetic, and at D <= G x 4 with
// ncols <= COLS the rows stay in registers from the logits to ga. Wider
// rows are walked in tiles of G x VEC columns, more columns in batches of
// COLS (a log-sum-exp carried across batches), the rows read again.
//
// No block waits on another: no flag, counter or grid-wide barrier, and
// every loop's bound is known at launch. The loss is summed without
// atomics: the forward writes one partial a block, the finishing kernel,
// launched next on the stream, adds them in a fixed order. Every output
// has one owner, so results are bit-reproducible from run to run.
//
// C entry points, bound with ctypes; they launch on the given stream,
// never synchronize, allocate nothing and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 256;  // threads a block
constexpr int FINISH_THREADS = 1024;
// Logit columns a batch: n_neg + 2 at the default n_neg = 8.
constexpr int COLS = 10;
constexpr float EPS_SQ = 1e-24f;  // the squared-norm floor, (1e-12)^2
constexpr unsigned FULL = 0xffffffffu;

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

// A load of values this thread wrote earlier in the kernel.
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
__device__ __forceinline__ void frag_store(float* p, const Frag<VEC>& f) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f.v[0], f.v[1], f.v[2],
                                                f.v[3]);
  } else {
    *p = f.v[0];
  }
}

// p + <u, y> over the fragment's columns, in order
template <int VEC>
__device__ __forceinline__ float frag_dot(float p, const Frag<VEC>& u,
                                          const Frag<VEC>& y) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) p = fmaf(u.v[j], y.v[j], p);
  return p;
}

// acc += w * y
template <int VEC>
__device__ __forceinline__ void frag_axpy(Frag<VEC>& acc, float w,
                                          const Frag<VEC>& y) {
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc.v[j] = fmaf(w, y.v[j], acc.v[j]);
}

// Sum over an aligned group of G lanes by an xor butterfly: every lane of
// the group ends with the same bits. Every lane of the warp calls it.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = G / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// sqrt(clamp_min(sq, 1e-24)), NaN kept as torch.clamp_min keeps it
__device__ __forceinline__ float norm_of(float sq) {
  return sqrtf(sq < EPS_SQ ? EPS_SQ : sq);
}

__device__ __forceinline__ int add_mod(int v, int off, int n) {
  v += off;
  return v >= n ? v - n : v;
}

__device__ __forceinline__ int sub_mod(int v, int off, int n) {
  v -= off;
  return v < 0 ? v + n : v;
}

// ncols roll offsets reduced to [0, num) into shared memory (every thread
// of the block calls it; the caller's barrier follows).
__device__ __forceinline__ void load_rolls(int* offs,
                                           const int64_t* __restrict__ rolls,
                                           int ncols, int num) {
  for (int c = threadIdx.x; c < ncols; c += BLOCK) {
    const int64_t v = rolls[c] % num;
    offs[c] = (int)(v < 0 ? v + num : v);
  }
}

// The slots of slot i's group: group_size, the last group what is left.
__device__ __forceinline__ int group_count(int i, int num, int group_size) {
  return min(group_size, num - (i / group_size) * group_size);
}

// d loss / d v_i for the upstream gradient g: g / (groups count)
__device__ __forceinline__ float slot_scale(float g, int i, int num,
                                            int group_size, int groups) {
  return g / (float)groups / (float)group_count(i, num, group_size);
}

// Shared memory a block of the forward holds: the rolls, and per lane group
// each column's logit, partner norm and partner row.
inline size_t fwd_smem(int ncols, int G) {
  return (size_t)ncols * sizeof(int) +
         (size_t)(BLOCK / G) * ncols * (2 * sizeof(float) + sizeof(int));
}

// The forward of one direction: per slot, v_i / count into the block's
// partial, the coefficients coef[i, :] and the anchor's gradient ga[i].
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    infonce_fwd_kernel(const float* __restrict__ A, const float* __restrict__ B,
                       const int64_t* __restrict__ q,
                       const int64_t* __restrict__ rolls,
                       float* __restrict__ coef, float* __restrict__ ga,
                       float* __restrict__ partial, int num, int ncols, int D,
                       int group_size, float temperature) {
  constexpr int GROUPS = BLOCK / G;
  extern __shared__ int smem[];
  int* offs = smem;  // rot, then the negative columns' offsets
  const int grp = threadIdx.x / G;
  float* lg = reinterpret_cast<float*>(smem + ncols) + grp * 2 * ncols;
  float* sw = lg + ncols;  // the partner rows' norms
  int* rows = smem + ncols + GROUPS * 2 * ncols + grp * ncols;  // -1: masked
  __shared__ float warp_sums[BLOCK / 32];
  load_rolls(offs, rolls, ncols, num);
  __syncthreads();

  const int lane = threadIdx.x % G;
  const int64_t slot = (int64_t)blockIdx.x * GROUPS + grp;
  const bool live = slot < num;  // a group past the slots joins the shuffles
  const int i = live ? (int)slot : 0;
  const int a = add_mod(i, offs[0], num);
  // the lanes name the columns' rows side by side
  for (int c = lane; c < ncols; c += G) {
    const int r = c == 0 ? a : (int)q[add_mod(i, offs[c], num)];
    rows[c] = c > 0 && r == a ? -1 : r;
  }
  __syncwarp();

  const float* xa = A + (int64_t)a * D;
  const bool one_tile = D <= G * VEC;
  const bool fast = one_tile && ncols <= COLS;  // rows kept in registers
  const int col1 = lane * VEC;
  const Frag<VEC> u1 = one_tile && col1 < D ? frag_load<VEC>(xa + col1)
                                            : frag_zero<VEC>();
  Frag<VEC> y[COLS];
#pragma unroll
  for (int s = 0; s < COLS; ++s) y[s] = frag_zero<VEC>();

  // Logits, COLS columns a batch; the log-sum-exp carried across batches.
  float sa = 0.f, lmax = -INFINITY, z = 0.f, l0 = 0.f;
  for (int c0 = 0; c0 < ncols; c0 += COLS) {
    int rr[COLS];
#pragma unroll
    for (int s = 0; s < COLS; ++s) rr[s] = c0 + s < ncols ? rows[c0 + s] : -1;
    float dot[COLS], sq[COLS], sqa = 0.f;
#pragma unroll
    for (int s = 0; s < COLS; ++s) dot[s] = sq[s] = 0.f;
    for (int col = col1; col < D; col += G * VEC) {
      const Frag<VEC> u = one_tile ? u1 : frag_load<VEC>(xa + col);
#pragma unroll
      for (int s = 0; s < COLS; ++s)
        y[s] = rr[s] >= 0 ? frag_load<VEC>(B + (int64_t)rr[s] * D + col)
                          : frag_zero<VEC>();
      sqa = frag_dot<VEC>(sqa, u, u);
#pragma unroll
      for (int s = 0; s < COLS; ++s) {
        dot[s] = frag_dot<VEC>(dot[s], u, y[s]);
        sq[s] = frag_dot<VEC>(sq[s], y[s], y[s]);
      }
    }
    if (c0 == 0) sa = norm_of(group_sum<G>(sqa));
    float bmax = -INFINITY;
#pragma unroll
    for (int s = 0; s < COLS; ++s) {
      dot[s] = group_sum<G>(dot[s]);
      sq[s] = norm_of(group_sum<G>(sq[s]));  // now the norm
      dot[s] = rr[s] >= 0 ? dot[s] / (sa * sq[s]) / temperature
                                : -INFINITY;  // now the logit
      if (c0 + s < ncols) bmax = fmaxf(bmax, dot[s]);
    }
    if (c0 == 0) l0 = dot[0];
    const float m = fmaxf(lmax, bmax);
    z *= expf(lmax - m);
#pragma unroll
    for (int s = 0; s < COLS; ++s)
      if (c0 + s < ncols) z += expf(dot[s] - m);
    lmax = m;
#pragma unroll
    for (int s = 0; s < COLS; ++s)
      if (c0 + s < ncols && (c0 + s) % G == lane) {
        lg[c0 + s] = dot[s];
        sw[c0 + s] = sq[s];
      }
  }
  __syncwarp();
  const float lse = lmax + logf(z);

  if (live)
    for (int c = lane; c < ncols; c += G)
      coef[(int64_t)i * ncols + c] =
          (expf(lg[c] - lse) - (c == 0 ? 1.f : 0.f)) / (temperature * sa);
  // ga = sum_c (p_c - [c == 0]) B_r / (T |B_r|), columns in order
  for (int col = col1; col < D; col += G * VEC) {
    Frag<VEC> g = frag_zero<VEC>();
    for (int c0 = 0; c0 < ncols; c0 += COLS) {
      float w[COLS];
#pragma unroll
      for (int s = 0; s < COLS; ++s) {
        const int c = c0 + s;
        const int r = c < ncols ? rows[c] : -1;
        w[s] = r >= 0 ? (expf(lg[c] - lse) - (c == 0 ? 1.f : 0.f)) /
                            (temperature * sw[c])
                      : 0.f;
        if (!fast)
          y[s] = w[s] != 0.f ? frag_load<VEC>(B + (int64_t)r * D + col)
                             : frag_zero<VEC>();
      }
#pragma unroll
      for (int s = 0; s < COLS; ++s)
        if (w[s] != 0.f) frag_axpy<VEC>(g, w[s], y[s]);
    }
    if (live) frag_store<VEC>(ga + (int64_t)i * D + col, g);
  }

  // the block's partial: its slots' v_i / count, summed in a fixed order
  float share = live && lane == 0
                    ? (lse - l0) / (float)group_count(i, num, group_size)
                    : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) share += __shfl_xor_sync(FULL, share, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = share;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < BLOCK / 32; ++w) t += warp_sums[w];
    partial[blockIdx.x] = t;
  }
}

struct FinishArgs {
  const float* partial[2];
  float* out[2];
  int n[2];
};

// out[d] = (sum of direction d's block partials, in a fixed order) / groups.
// One block a direction, two blocks.
__global__ void __launch_bounds__(FINISH_THREADS)
    infonce_finish_kernel(FinishArgs f, int groups) {
  __shared__ float buf[FINISH_THREADS];
  const int d = blockIdx.x;
  const float* p = f.partial[d];
  float acc = 0.f;
  for (int k = threadIdx.x; k < f.n[d]; k += FINISH_THREADS) acc += p[k];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int s = FINISH_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *f.out[d] = buf[0] / (float)groups;
}

// What the backward reads and writes of one direction: table k of the
// pair holds direction k's anchors, and its gradient is written here.
struct Dir {
  const float* A;          // the anchors' table
  const int64_t* q_inv;    // the inverse of the negatives' permutation
  const int64_t* rolls;    // rot, then the offsets
  const float* coef;       // (num, ncols)
  const float* ga;         // (num, D)
  const float* grad_out;   // d total / d this direction's loss
  float* grad;             // d total / d A
};

// Shared memory a block of the backward holds: both directions' rolls, and
// per lane group each column's weight and anchor row.
inline size_t bwd_smem(int ncols, int G) {
  return (size_t)2 * ncols * sizeof(int) +
         (size_t)(BLOCK / G) * ncols * (sizeof(float) + sizeof(int));
}

// The backward of a pair: gradient row j of each table, its own
// direction's anchor part, the other direction's positive and negative
// parts in column order, then the normalisation's backward.
template <int G, int VEC>
__global__ void __launch_bounds__(BLOCK)
    infonce_bwd_kernel(Dir d0, Dir d1, int num, int ncols, int D,
                       int group_size) {
  constexpr int GROUPS = BLOCK / G;
  extern __shared__ int smem[];
  const int grp = threadIdx.x / G;
  float* cw = reinterpret_cast<float*>(smem + 2 * ncols) + grp * ncols;
  int* rows = smem + 2 * ncols + GROUPS * ncols + grp * ncols;  // -1: none
  load_rolls(smem, d0.rolls, ncols, num);
  load_rolls(smem + ncols, d1.rolls, ncols, num);
  __syncthreads();

  const int groups = (num + group_size - 1) / group_size;
  const int lane = threadIdx.x % G;
  const int64_t item = (int64_t)blockIdx.x * GROUPS + grp;
  // a group past the rows reads row 0 of table 0, joins the shuffles and
  // writes nothing
  const bool live = item < 2 * (int64_t)num;
  const bool second = live && item >= num;  // table 1
  const int j = live ? (int)(item - (second ? num : 0)) : 0;
  // the directions' fields one by one (selecting a whole struct would copy
  // the parameters to the stack): own = the table's, other = the pair's
  // other direction
  const float* xr = (second ? d1.A : d0.A) + (int64_t)j * D;
  float* gr = (second ? d1.grad : d0.grad) + (int64_t)j * D;

  // own part: dv ga[(j - rot) % num]
  const int so = sub_mod(j, smem[second ? ncols : 0], num);
  const float wown = slot_scale(*(second ? d1.grad_out : d0.grad_out), so,
                                num, group_size, groups);
  const float* pga = (second ? d1.ga : d0.ga) + (int64_t)so * D;
  // other part: each column's weight and anchor row, found side by side
  const float* ea = second ? d0.A : d1.A;
  {
    const int* oe = smem + (second ? 0 : ncols);
    const float* ecoef = second ? d0.coef : d1.coef;
    const int qi = (int)(second ? d0.q_inv : d1.q_inv)[j];
    const float ge = *(second ? d0.grad_out : d1.grad_out);
    for (int c = lane; c < ncols; c += G) {
      const int t = sub_mod(c == 0 ? j : qi, oe[c], num);
      const float w = ecoef[(int64_t)t * ncols + c];
      cw[c] = w != 0.f ? w * slot_scale(ge, t, num, group_size, groups) : 0.f;
      rows[c] = w != 0.f ? (c == 0 ? j : add_mod(t, oe[0], num)) : -1;
    }
  }
  __syncwarp();

  const bool one_tile = D <= G * VEC;
  const int col1 = lane * VEC;
  Frag<VEC> x1 = frag_zero<VEC>(), gu1 = frag_zero<VEC>();
  float sqx = 0.f, gx = 0.f;
  for (int col = col1; col < D; col += G * VEC) {
    const Frag<VEC> x = frag_load<VEC>(xr + col);
    Frag<VEC> gu = frag_zero<VEC>();
    frag_axpy<VEC>(gu, wown, frag_load<VEC>(pga + col));
    for (int c0 = 0; c0 < ncols; c0 += COLS) {
      float w[COLS];
      Frag<VEC> y[COLS];
#pragma unroll
      for (int s = 0; s < COLS; ++s) {
        const int r = c0 + s < ncols ? rows[c0 + s] : -1;
        w[s] = r >= 0 ? cw[c0 + s] : 0.f;
        y[s] = r >= 0 ? frag_load<VEC>(ea + (int64_t)r * D + col)
                      : frag_zero<VEC>();
      }
#pragma unroll
      for (int s = 0; s < COLS; ++s)
        if (w[s] != 0.f) frag_axpy<VEC>(gu, w[s], y[s]);
    }
    sqx = frag_dot<VEC>(sqx, x, x);
    gx = frag_dot<VEC>(gx, gu, x);
    if (one_tile) {
      x1 = x;
      gu1 = gu;
    } else if (live) {
      frag_store<VEC>(gr + col, gu);  // ended in the second pass
    }
  }
  sqx = group_sum<G>(sqx);
  gx = group_sum<G>(gx);
  // d (x / |x|) / dx applied to gu: gu / |x| - [|x|^2 >= eps^2] <gu, x> x / |x|^3
  const float nx = norm_of(sqx);
  const float k = sqx >= EPS_SQ ? gx / (nx * nx) / nx : 0.f;
  if (!live) return;
  for (int col = col1; col < D; col += G * VEC) {
    const Frag<VEC> x = one_tile ? x1 : frag_load<VEC>(xr + col);
    Frag<VEC> g = one_tile ? gu1 : frag_load_own<VEC>(gr + col);
#pragma unroll
    for (int t = 0; t < VEC; ++t) g.v[t] = g.v[t] / nx - k * x.v[t];
    frag_store<VEC>(gr + col, g);
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// 4 columns a load (16 bytes) when D % 4 == 0 and every row table the
// kernel touches is 16-byte aligned, else 1.
inline int vec_width(int D, const void* const* ptrs, int n) {
  bool ok = D % 4 == 0;
  for (int k = 0; k < n; ++k) ok = ok && aligned16(ptrs[k]);
  return ok ? 4 : 1;
}

// 16 lanes a row where one pass of them covers D, else 32 (rows walked in
// tiles of 32 x VEC columns). Only these instances are built.
inline int group_lanes(int D, int vec) { return D <= 16 * vec ? 16 : 32; }

#define INFONCE_DISPATCH(G_, VEC_, LAUNCH)        \
  switch ((G_) * 10 + (VEC_)) {                   \
    case 161: LAUNCH(16, 1); break;               \
    case 321: LAUNCH(32, 1); break;               \
    case 164: LAUNCH(16, 4); break;               \
    case 324: LAUNCH(32, 4); break;               \
    default: return (int)cudaErrorInvalidValue;   \
  }

constexpr size_t SMEM_LIMIT = 48 * 1024;

int fwd_vec(int D, const void* A, const void* B, const void* ga) {
  const void* p[3] = {A, B, ga};
  return vec_width(D, p, 3);
}

}  // namespace

// Blocks of one direction's forward: the length of its partial vector.
extern "C" int infonce_fwd_blocks(int num, int D, const void* A,
                                  const void* B, const void* ga) {
  const int G = group_lanes(D, fwd_vec(D, A, B, ga));
  return (num + BLOCK / G - 1) / (BLOCK / G);
}

extern "C" int infonce_fwd_launch(const void* A, const void* B,
                                  const void* q, const void* rolls,
                                  void* coef, void* ga, void* partial,
                                  int num, int ncols, int D, int group_size,
                                  float temperature, void* stream) {
  if (num <= 0 || ncols < 2 || D <= 0 || group_size <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = fwd_vec(D, A, B, ga);
  const int G = group_lanes(D, vec);
  const size_t smem = fwd_smem(ncols, G);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((num + BLOCK / G - 1) / (BLOCK / G));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(G_, V_)                                                     \
  infonce_fwd_kernel<G_, V_><<<blocks, BLOCK, smem, s>>>(                  \
      (const float*)A, (const float*)B, (const int64_t*)q,                \
      (const int64_t*)rolls, (float*)coef, (float*)ga, (float*)partial,   \
      num, ncols, D, group_size, temperature)
  INFONCE_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}

// Both directions' losses from their forwards' partials.
extern "C" int infonce_finish_launch(const void* partial0, int n0,
                                     const void* partial1, int n1, void* out0,
                                     void* out1, int num, int group_size,
                                     void* stream) {
  if (n0 <= 0 || n1 <= 0 || num <= 0 || group_size <= 0)
    return (int)cudaErrorInvalidValue;
  FinishArgs f;
  f.partial[0] = (const float*)partial0;
  f.partial[1] = (const float*)partial1;
  f.out[0] = (float*)out0;
  f.out[1] = (float*)out1;
  f.n[0] = n0;
  f.n[1] = n1;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  infonce_finish_kernel<<<2, FINISH_THREADS, 0, s>>>(
      f, (num + group_size - 1) / group_size);
  return (int)cudaGetLastError();
}

// The backward of a pair: direction k's anchors A_k are table k, whose
// first num gradient rows grad_k receives.
extern "C" int infonce_bwd_launch(
    const void* A0, const void* q_inv0, const void* rolls0, const void* coef0,
    const void* ga0, const void* g0, void* grad0, const void* A1,
    const void* q_inv1, const void* rolls1, const void* coef1, const void* ga1,
    const void* g1, void* grad1, int num, int ncols, int D, int group_size,
    void* stream) {
  if (num <= 0 || ncols < 2 || D <= 0 || group_size <= 0)
    return (int)cudaErrorInvalidValue;
  const void* p[6] = {A0, ga0, grad0, A1, ga1, grad1};
  const int vec = vec_width(D, p, 6);
  const int G = group_lanes(D, vec);
  const size_t smem = bwd_smem(ncols, G);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const Dir d0{(const float*)A0,    (const int64_t*)q_inv0,
               (const int64_t*)rolls0, (const float*)coef0,
               (const float*)ga0,   (const float*)g0, (float*)grad0};
  const Dir d1{(const float*)A1,    (const int64_t*)q_inv1,
               (const int64_t*)rolls1, (const float*)coef1,
               (const float*)ga1,   (const float*)g1, (float*)grad1};
  const int64_t items = 2 * (int64_t)num;
  const unsigned blocks = (unsigned)((items + BLOCK / G - 1) / (BLOCK / G));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define LAUNCH(G_, V_)                                              \
  infonce_bwd_kernel<G_, V_><<<blocks, BLOCK, smem, s>>>(           \
      d0, d1, num, ncols, D, group_size)
  INFONCE_DISPATCH(G, vec, LAUNCH)
#undef LAUNCH
  return (int)cudaGetLastError();
}
