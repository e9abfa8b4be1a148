// Bilinear window Jacobians and residuals for Hopper (sm_90a), float32.
//
// Replaces the two Pallas kernels of directtrajopt_tpu/ops/expv_kernel.py:
//   * _kernel      (window Jacobian, wrapper _window_jac_pallas)  -> window_jac_kernel
//   * _res_kernel  (residual chain, wrapper _res_pallas)          -> residual_grid_kernel
// each instantiated at two exact shapes; every other shape within the
// Pallas kernels' caps, x_dim ≤ 8 and n_drives ≤ 8, takes the size-class
// kernels of expv_classed.cu (window_jac_classed, residual_classed), which
// the C entries here dispatch to.
//
// Per window k of lane l, with G = Gd + Σ_m u_m·Gv_m and A = Δt·G, the order-m
// Taylor action E·x is the Horner chain  y ← x + A·y / j  (j = m..1). The
// Jacobian J = ∂(E·x)/∂(x, u, Δt) comes from the tangent recurrences of the
// same chain (the E columns, ẏ_u = (Δt·Gv_m·y + A·ẏ_u)/j, ẏ_t = (G·y + A·ẏ_t)/j),
// tangents first so they see the previous y, as jax.jacfwd orders them.
// The small matrices live in registers; their sizes are template constants,
// instantiated for the two shapes the port's first paths give: x_dim=4
// with 2 drives, the bilinear benchmark, and x_dim=2 with 1 drive, the
// state-constrained family.
//
// window_jac_kernel (K3): the knot matrix read in place, as K4 reads it (the
// same (P, T, K) views, without x_next), and −J written straight into the
// z_k-wide Jacobian (P, T, K, x_dim, d): J's columns at the state's, the
// drives' and Δt's offsets in the knot, +0 in every other column. E and the
// primal chain with its tangents are independent chains, so a window may
// take two threads, one for E and one for y and the tangents. It does below
// 65,536 windows: there one thread a window leaves most SMs short of warps
// (path 1's chunk of 12,800 windows is 400 warps, against about 14 resident
// warps an SM at the kernel's register count, 1,848 on the card), and a
// second thread halves each window's chain. Above, the card is full and a
// second thread only repeats G and A, so one thread runs both. Each output
// is the same expression as before, in the same order, so the result is
// bitwise the earlier kernel's. A block holds 64 threads; its windows' rows
// are assembled in shared memory and stored as one contiguous span.
// Splitting finer (a thread per column of E, or a warp per tangent on the
// chain's y kept in shared memory) measured slower at 8192 lanes: more
// threads a window hold more registers a window, so fewer windows fit on an
// SM. Bound on the card: at path 1's chunk the launch; at 8192 lanes the
// dependent chains (x_dim·(x_dim + n_drives + [1] + 1) correctly rounded
// divisions a Taylor step, about a dozen instructions each) at the occupancy
// the registers allow, far above the output write (x_dim·d floats a
// window) that the byte bound counts.
//
// residual_grid_kernel (K4): the line search's trial grid read in place —
// u, Δt, x and x_next are strided (problems P, trial slots T, windows K)
// views of the knot matrix, as the JAX package's two-level custom_vmap
// holds them, and the generators come once per problem, read where they
// lie through the read-only cache. One thread per window, instance-major,
// so neighbouring threads read neighbouring knots; each thread finds its
// (problem, slot, window) by multiply-high division (Divisor) and its
// offsets into the views in registers, in 32-bit arithmetic (the entry
// checks that every offset fits). Bound on
// the card: the elements the views touch, each once (x and x_next are one
// slab of N knots, a fixed Δt is one scalar), the generators once per
// problem and the output (≈ 1-1.5 µs at path 1's 256 × 9 × 50 windows,
// ≈ 18-30 µs at path 2's 8192 × 12 × 50). At path 1's size one launch
// costs more than that: the wrapper's host work is the floor. At path 2's
// the kernel is bound by its instructions, which the byte bound does not
// see: each window's chain takes order·x_dim correctly rounded divisions
// (24 at order 12), a dozen instructions each. The L1 form is one launch:
// a block holds whole instances, each window puts Σ_i |r_i| (i in order)
// into shared memory, then one thread per instance sums its K partials in
// window order: a fixed order, no atomics, so line-search decisions are
// reproducible.
//
// Division is IEEE (no fast math): x/j is correctly rounded.

#include <climits>

#include "expv_common.cuh"

namespace {

using namespace expv;

// Instances per block of the L1 form: whole instances, as many as fill
// kResBlock threads with one window each.
inline int res_instances(int K) { return K < 1 ? kResBlock : (K >= kResBlock ? 1 : kResBlock / K); }

// Primal chain of window k of instance (problem q, trial slot t): writes
// r = xn − E·x to `r` unless it is null, and returns Σ_i |r_i| (i in order).
template <int XD, int ND>
__device__ __forceinline__ float window_residual(unsigned q, unsigned t, unsigned k, int order,
                                                 const Gens& g, const View& u, const View& dt,
                                                 const View& x, const View& xn, float* r) {
  const float* gd = g.gd + q * g.d[0];
  const float* gv = g.gv + q * g.v[0];
  const float h = dt.p[q * dt.s[0] + t * dt.s[1] + k * dt.s[2]];
  const float* up = u.p + (q * u.s[0] + t * u.s[1] + k * u.s[2]);
  const float* xp = x.p + (q * x.s[0] + t * x.s[1] + k * x.s[2]);
  const float* xnp = xn.p + (q * xn.s[0] + t * xn.s[1] + k * xn.s[2]);
  float um[ND];
#pragma unroll
  for (int m = 0; m < ND; ++m) {
    um[m] = up[m];
  }
  float A[XD][XD], xs[XD], y[XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    xs[i] = xp[i];
    y[i] = xs[i];
#pragma unroll
    for (int j = 0; j < XD; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < ND; ++m) {
        s += um[m] * __ldg(gv + m * g.v[1] + i * g.v[2] + j * g.v[3]);
      }
      A[i][j] = h * (__ldg(gd + i * g.d[1] + j * g.d[2]) + s);
    }
  }
  for (int kk = order; kk >= 1; --kk) {
    const float fk = (float)kk;
    float yn[XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < XD; ++j) {
        s += A[i][j] * y[j];
      }
      yn[i] = xs[i] + s / fk;
    }
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      y[i] = yn[i];
    }
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    const float ri = xnp[i] - y[i];
    if (r) r[i] = ri;
    acc += fabsf(ri);
  }
  return acc;
}

// Vector form: one thread per window, flat over the n = P·T·K windows
// (instance-major), writing res (P, T, K, XD). L1 form: a block holds `ipb`
// whole instances of the n = P·T; each window puts its Σ_i |r_i| into
// shared memory, then one thread per instance sums its K partials in window
// order into l1 (P, T).
template <int XD, int ND, bool L1>
__global__ void __launch_bounds__(kResBlock) residual_grid_kernel(
    Divisor T, Divisor K, unsigned n, unsigned ipb, int order, Gens g, View u, View dt, View x,
    View xn, float* __restrict__ out) {
  if (!L1) {
    const unsigned w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= n) return;
    const unsigned inst = K.div(w), q = T.div(inst);
    window_residual<XD, ND>(q, inst - q * T.d, w - inst * K.d, order, g, u, dt, x, xn,
                            out + (size_t)w * XD);
    return;
  }
  extern __shared__ float part[];
  const unsigned i0 = blockIdx.x * ipb;
  const unsigned n_here = n - i0 < ipb ? n - i0 : ipb;
  for (unsigned w = threadIdx.x; w < n_here * K.d; w += blockDim.x) {
    const unsigned j = K.div(w), q = T.div(i0 + j);
    part[w] = window_residual<XD, ND>(q, i0 + j - q * T.d, w - j * K.d, order, g, u, dt, x, xn,
                                      nullptr);
  }
  __syncthreads();
  if (threadIdx.x < n_here) {
    const float* p = part + threadIdx.x * K.d;
    float acc = 0.0f;
    for (unsigned k = 0; k < K.d; ++k) acc += p[k];
    out[i0 + threadIdx.x] = acc;
  }
}

// K3's blocks: kJacThreads threads; two threads a window below kJacSplitBelow
// windows, one above (see the note at the top).
constexpr int kJacThreads = 64;
constexpr unsigned kJacSplitBelow = 65536;

// G = Gd + Σ_m u_m·Gv_m and A = Δt·G of window k of instance (q, t); returns Δt.
template <int XD, int ND>
__device__ __forceinline__ float window_generator(unsigned q, unsigned t, unsigned k,
                                                  const Gens& g, const View& u, const View& dt,
                                                  float (&G)[XD][XD], float (&A)[XD][XD]) {
  const float* gd = g.gd + q * g.d[0];
  const float* gv = g.gv + q * g.v[0];
  const float h = dt.p[q * dt.s[0] + t * dt.s[1] + k * dt.s[2]];
  const float* up = u.p + (q * u.s[0] + t * u.s[1] + k * u.s[2]);
  float um[ND];
#pragma unroll
  for (int m = 0; m < ND; ++m) {
    um[m] = up[m];
  }
#pragma unroll
  for (int i = 0; i < XD; ++i) {
#pragma unroll
    for (int j = 0; j < XD; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < ND; ++m) {
        s += um[m] * __ldg(gv + m * g.v[1] + i * g.v[2] + j * g.v[3]);
      }
      G[i][j] = __ldg(gd + i * g.d[1] + j * g.d[2]) + s;
      A[i][j] = h * G[i][j];
    }
  }
  return h;
}

// E, the Taylor polynomial of A: E ← I + A·E/k, each column a chain of its
// own; −E goes to the XD columns of o from its first (row stride d).
template <int XD>
__device__ __forceinline__ void jac_e(int order, const float (&A)[XD][XD], float* o, int d) {
  float E[XD][XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
#pragma unroll
    for (int c = 0; c < XD; ++c) {
      E[i][c] = (i == c) ? 1.0f : 0.0f;
    }
  }
  for (int k = order; k >= 1; --k) {
    const float fk = (float)k;
    float En[XD][XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) {
#pragma unroll
      for (int c = 0; c < XD; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < XD; ++j) {
          s += A[i][j] * E[j][c];
        }
        En[i][c] = ((i == c) ? 1.0f : 0.0f) + s / fk;
      }
    }
#pragma unroll
    for (int i = 0; i < XD; ++i) {
#pragma unroll
      for (int c = 0; c < XD; ++c) {
        E[i][c] = En[i][c];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < XD; ++i) {
#pragma unroll
    for (int c = 0; c < XD; ++c) {
      o[i * d + c] = -E[i][c];
    }
  }
}

// The primal chain y ← x + A·y/k and its tangents ẏ_u = (Δt·Gv_m·y + A·ẏ_u)/k
// and ẏ_t = (G·y + A·ẏ_t)/k (tangents first: they see the previous y, as
// jax.jacfwd orders them); their negatives go to the drives' and Δt's
// columns of o.
template <int XD, int ND>
__device__ __forceinline__ void jac_tangents(int order, float h, const float* gv, const Gens& g,
                                             const float (&G)[XD][XD], const float (&A)[XD][XD],
                                             const float* xp, float* o, const JacCols& c) {
  const bool free_time = c.t >= 0;
  float xs[XD], y[XD], ydt[XD], ydu[ND][XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    xs[i] = xp[i];
    y[i] = xs[i];
    ydt[i] = 0.0f;
  }
#pragma unroll
  for (int m = 0; m < ND; ++m) {
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      ydu[m][i] = 0.0f;
    }
  }
  for (int k = order; k >= 1; --k) {
    const float fk = (float)k;
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      float nxt[XD];
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        float gy = 0.0f, ay = 0.0f;
#pragma unroll
        for (int j = 0; j < XD; ++j) {
          gy += __ldg(gv + m * g.v[1] + i * g.v[2] + j * g.v[3]) * y[j];
          ay += A[i][j] * ydu[m][j];
        }
        nxt[i] = (h * gy + ay) / fk;
      }
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        ydu[m][i] = nxt[i];
      }
    }
    if (free_time) {
      float nxt[XD];
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        float gy = 0.0f, ay = 0.0f;
#pragma unroll
        for (int j = 0; j < XD; ++j) {
          gy += G[i][j] * y[j];
          ay += A[i][j] * ydt[j];
        }
        nxt[i] = (gy + ay) / fk;
      }
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        ydt[i] = nxt[i];
      }
    }
    float yn[XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < XD; ++j) {
        s += A[i][j] * y[j];
      }
      yn[i] = xs[i] + s / fk;
    }
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      y[i] = yn[i];
    }
  }
#pragma unroll
  for (int i = 0; i < XD; ++i) {
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      o[i * c.d + c.u + m] = -ydu[m][i];
    }
    if (free_time) o[i * c.d + c.t] = -ydt[i];
  }
}

// K3: a block of kJacThreads threads, GS threads a window, over the n = P·T·K
// windows flat (instance-major). With GS = 2, warps of the first half run E
// and warps of the second half y and its tangents, for the same windows
// (no divergence within a warp); with GS = 1 a thread runs both. Each
// window's XD × d rows are assembled in shared memory (+0 where J has no
// column), and the block stores its windows' rows, one contiguous span of
// out (n, XD, d).
template <int XD, int ND, int GS>
__global__ void __launch_bounds__(kJacThreads) window_jac_kernel(
    Divisor T, Divisor K, unsigned n, int order, Gens g, View u, View dt, View x, JacCols c,
    float* __restrict__ out) {
  constexpr unsigned W = kJacThreads / GS;  // windows per block
  extern __shared__ float tile[];
  const unsigned w0 = blockIdx.x * W;
  const unsigned n_here = n - w0 < W ? n - w0 : W;
  const unsigned span = XD * c.d;  // output floats per window
  for (unsigned i = threadIdx.x; i < n_here * span; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();
  const unsigned role = threadIdx.x / W, lw = threadIdx.x % W;
  if (lw < n_here) {
    const unsigned w = w0 + lw, inst = K.div(w), q = T.div(inst);
    const unsigned t = inst - q * T.d, k = w - inst * K.d;
    float G[XD][XD], A[XD][XD];
    const float h = window_generator<XD, ND>(q, t, k, g, u, dt, G, A);
    float* o = tile + lw * span;
    if (GS == 1 || role == 0) jac_e<XD>(order, A, o + c.x, c.d);
    if (GS == 1 || role == 1)
      jac_tangents<XD, ND>(order, h, g.gv + q * g.v[0], g, G, A,
                           x.p + (q * x.s[0] + t * x.s[1] + k * x.s[2]), o, c);
  }
  __syncthreads();
  float* dst = out + (size_t)w0 * span;
  for (unsigned i = threadIdx.x; i < n_here * span; i += blockDim.x) dst[i] = tile[i];
}

// A block's windows, kJacThreads / GS, fill at most kJacSmem with their
// output tile (W · XD · d floats).
template <int XD, int ND>
int launch_jac(int P, int T, int K, int order, const Gens& g, const View& u, const View& dt,
               const View& x, const JacCols& c, float* out, cudaStream_t s) {
  const unsigned n = (unsigned)P * (unsigned)T * (unsigned)K;
  if (n == 0) return 0;
  const bool split = n < kJacSplitBelow;
  const unsigned W = kJacThreads / (split ? 2 : 1);
  const size_t smem = sizeof(float) * W * XD * c.d;
  if (smem > kJacSmem) return (int)cudaErrorInvalidValue;
  if (split)
    window_jac_kernel<XD, ND, 2><<<(n + W - 1) / W, kJacThreads, smem, s>>>(
        Divisor(T), Divisor(K), n, order, g, u, dt, x, c, out);
  else
    window_jac_kernel<XD, ND, 1><<<(n + W - 1) / W, kJacThreads, smem, s>>>(
        Divisor(T), Divisor(K), n, order, g, u, dt, x, c, out);
  return (int)cudaGetLastError();
}

template <int XD, int ND, bool L1>
int launch_res(int P, int T, int K, int order, const Gens& g, const View& u, const View& dt,
               const View& x, const View& xn, float* out, cudaStream_t s) {
  const unsigned n_inst = (unsigned)P * (unsigned)T;
  if (!L1) {
    const unsigned n = n_inst * (unsigned)K;
    if (n == 0) return 0;
    residual_grid_kernel<XD, ND, false><<<(n + kResBlock - 1) / kResBlock, kResBlock, 0, s>>>(
        Divisor(T), Divisor(K), n, 0, order, g, u, dt, x, xn, out);
    return (int)cudaGetLastError();
  }
  const int ipb = res_instances(K);
  const size_t smem = sizeof(float) * ipb * K;
  if (smem > kResSmem) return (int)cudaErrorInvalidValue;
  const int used = K < 1 ? kResBlock : ipb * K;
  const int threads = used >= kResBlock ? kResBlock : (used + 31) / 32 * 32;
  residual_grid_kernel<XD, ND, true><<<(n_inst + ipb - 1) / ipb, threads, smem, s>>>(
      Divisor(T), Divisor(K), n_inst, ipb, order, g, u, dt, x, xn, out);
  return (int)cudaGetLastError();
}

// Narrows a view's element strides to 32 bits, after checking that its
// largest element offset, Σ (size − 1)·stride, fits them.
bool narrow(int n, const long long* size, const long long* st, int* out) {
  long long top = 0;
  for (int i = 0; i < n; ++i) {
    if (st[i] < 0 || st[i] > INT_MAX) return false;
    top += (size[i] > 0 ? size[i] - 1 : 0) * st[i];
    if (top > INT_MAX) return false;
    out[i] = (int)st[i];
  }
  return true;
}

// Half-open column ranges [a, a + na) and [b, b + nb) share no column.
bool apart(int a, int na, int b, int nb) { return na == 0 || nb == 0 || a + na <= b || b + nb <= a; }

// The kernels' range: the Pallas kernels' caps.
bool in_range(int xd, int nd) { return xd >= 1 && xd <= kDimMax && nd >= 0 && nd <= kDimMax; }

}  // namespace

// K3 on P problems × T slots × K windows, the same views as dto_residual's
// without x_next: Gd (P, xd, xd), Gv (P, nd, xd, xd), u (P, T, K, nd), Δt
// (P, T, K), x (P, T, K, xd). `st` holds their 16 element strides (Gd 3, Gv
// 4, u 3, Δt 3, x 3), then the column map of JacCols: d, the x, u and Δt
// columns (Δt −1 for a fixed Δt). Writes −J as (P, T, K, xd, d),
// contiguous. Returns cudaErrorInvalidValue, launching nothing, where P·T·K
// or a view's element offset exceeds 2³¹ − 1, where J's columns fall outside
// [0, d) or overlap, or where (xd, nd) is outside 1 ≤ xd ≤ 8, 0 ≤ nd ≤ 8,
// or where a block's output tile exceeds kJacSmem: at the exact shapes a
// block's kJacThreads / GS windows × xd × d floats; at the others a warp's
// windows, 32 / G × xd × d floats with G the size class's threads a window
// (d ≤ 384 at x_dim 8; the size-class kernel takes fewer windows a block
// where a whole block's tile would not fit). Exact kernels at (xd, nd) =
// (4, 2) and (2, 1), as dto_residual; the size-class kernels
// (expv_classed.cu) at the others.
extern "C" int dto_window_jac(int P, int T, int K, int xd, int nd, int order, const void* Gd,
                              const void* Gv, const void* u, const void* dt, const void* x,
                              const long long* st, void* out, void* stream) {
  if (P < 1 || T < 1 || K < 0 || (long long)P * T * (K > 1 ? K : 1) > INT_MAX ||
      !in_range(xd, nd))
    return (int)cudaErrorInvalidValue;
  const long long* cm = st + 16;
  if (cm[0] < 1 || cm[0] > INT_MAX) return (int)cudaErrorInvalidValue;
  const JacCols c{(int)cm[0], (int)cm[1], (int)cm[2], (int)cm[3]};
  const bool free_time = cm[3] >= 0;
  if (cm[1] < 0 || cm[1] + xd > c.d || cm[2] < 0 || cm[2] + nd > c.d || cm[3] < -1 ||
      cm[3] >= c.d || !apart(c.x, xd, c.u, nd) ||
      (free_time && (!apart(c.x, xd, c.t, 1) || !apart(c.u, nd, c.t, 1))))
    return (int)cudaErrorInvalidValue;
  const long long gds[3] = {P, xd, xd}, gvs[4] = {P, nd, xd, xd}, one = 1;
  const long long us[4] = {P, T, K, nd}, xs[4] = {P, T, K, xd};
  const long long ust[4] = {st[7], st[8], st[9], one}, xst[4] = {st[13], st[14], st[15], one};
  Gens g{(const float*)Gd, (const float*)Gv, {}, {}};
  View vu{(const float*)u, {}}, vd{(const float*)dt, {}}, vx{(const float*)x, {}};
  if (!narrow(3, gds, st, g.d) || !narrow(4, gvs, st + 3, g.v) || !narrow(4, us, ust, vu.s) ||
      !narrow(3, us, st + 10, vd.s) || !narrow(4, xs, xst, vx.s))
    return (int)cudaErrorInvalidValue;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (xd == 4 && nd == 2) return launch_jac<4, 2>(P, T, K, order, g, vu, vd, vx, c, o, s);
  if (xd == 2 && nd == 1) return launch_jac<2, 1>(P, T, K, order, g, vu, vd, vx, c, o, s);
  return launch_jac_classed(P, T, K, order, g, vu, vd, vx, c, Dims{xd, nd}, o, s);
}

// K4 on the trial grid: P problems × T trial slots × K windows. Gd (P, xd, xd)
// and Gv (P, nd, xd, xd) with any strides; u, Δt, x, xn strided views
// (problems, slots, windows; a unit stride on the last axis; Δt has no last
// axis and may have stride 0 throughout). `st` holds the 19 element strides
// in that order: Gd 3, Gv 4, u 3, Δt 3, x 3, xn 3 (one host array, so the
// call passes 16 arguments). Writes (P, T, K, xd) (l1 = 0) or (P, T)
// (l1 = 1), contiguous. Returns cudaErrorInvalidValue, launching nothing,
// where P·T·K or an element offset of a view exceeds 2³¹ − 1, or where the
// L1 form's K partials per block exceed kResSmem, or where (xd, nd) is
// outside 1 ≤ xd ≤ 8, 0 ≤ nd ≤ 8. Exact kernels at (4, 2), the bilinear
// benchmark's 4-D state with 2 drives, and (2, 1), the state-constrained
// family's 2-D state with one drive (ops/expv_kernel.py, SUPPORTED_SHAPES);
// the size-class kernels (expv_classed.cu) at the others.
extern "C" int dto_residual(int P, int T, int K, int xd, int nd, int order, int l1,
                            const void* Gd, const void* Gv, const void* u, const void* dt,
                            const void* x, const void* xn, const long long* st, void* out,
                            void* stream) {
  if (P < 1 || T < 1 || K < 0 || (long long)P * T * (K > 1 ? K : 1) > INT_MAX ||
      !in_range(xd, nd))
    return (int)cudaErrorInvalidValue;
  const long long gds[3] = {P, xd, xd}, gvs[4] = {P, nd, xd, xd}, one = 1;
  const long long us[4] = {P, T, K, nd}, xs[4] = {P, T, K, xd};
  const long long ust[4] = {st[7], st[8], st[9], one}, xst[4] = {st[13], st[14], st[15], one},
                  nst[4] = {st[16], st[17], st[18], one};
  Gens g{(const float*)Gd, (const float*)Gv, {}, {}};
  View vu{(const float*)u, {}}, vd{(const float*)dt, {}}, vx{(const float*)x, {}},
      vn{(const float*)xn, {}};
  if (!narrow(3, gds, st, g.d) || !narrow(4, gvs, st + 3, g.v) || !narrow(4, us, ust, vu.s) ||
      !narrow(3, us, st + 10, vd.s) || !narrow(4, xs, xst, vx.s) || !narrow(4, xs, nst, vn.s))
    return (int)cudaErrorInvalidValue;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (xd == 4 && nd == 2)
    return l1 ? launch_res<4, 2, true>(P, T, K, order, g, vu, vd, vx, vn, o, s)
              : launch_res<4, 2, false>(P, T, K, order, g, vu, vd, vx, vn, o, s);
  if (xd == 2 && nd == 1)
    return l1 ? launch_res<2, 1, true>(P, T, K, order, g, vu, vd, vx, vn, o, s)
              : launch_res<2, 1, false>(P, T, K, order, g, vu, vd, vx, vn, o, s);
  return launch_res_classed(l1 != 0, P, T, K, order, g, vu, vd, vx, vn, Dims{xd, nd}, o, s);
}
