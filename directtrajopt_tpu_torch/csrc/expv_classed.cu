// Size-class window Jacobian (K3) and residual chain (K4) kernels for
// Hopper (sm_90a), float32, at every (x_dim, n_drives) within the Pallas
// kernels' caps that has no exact instance in expv_kernel.cu.
//
// Replace, at those shapes, the two Pallas kernels of
// directtrajopt_tpu/ops/expv_kernel.py: _kernel (:111; wrapper
// _window_jac_pallas, launched at :257) and _res_kernel (:293; _res_pallas,
// :351), which JAX traces at whatever x_dim ≤ 8 and n_drives ≤ 8 it is
// given. They compute what the exact kernels compute, from the same views,
// and write the same outputs.
//
// What bounds them on this card is the dependent Taylor chain, not the
// bytes or the operations: per window and Taylor step K3 runs x_dim
// chains of E's columns and x_dim + n_drives + 2 chains of y and its
// tangents, each a dot product of x_dim terms and a correctly rounded
// division (a dozen instructions) that the next step waits on; K4 runs
// y's. One thread a window (the design these replace) runs them all in a
// row, and at x_dim 8 K3 held G, A, E and eight tangents in one thread:
// 255 registers and a 4.9 KB stack frame. The design here:
//
// * A group of G threads serves a window, G the least power of two ≥ the
//   class's x_dim XC (2, 4 or 8), several windows a warp. Thread r < XC
//   owns column r of E and row r of y, ẏ_t and each ẏ_u,m, so a Taylor
//   step is G times shorter and the window's chains run side by side. A
//   step reads the previous vectors with __shfl_sync within the group; the
//   tangents see the previous y, as jax.jacfwd orders them. Each thread
//   builds row r of G and A; the group exchanges the rows once a window,
//   so that every thread holds all of A in registers for its column of E.
//   Every shuffle names the whole warp: a launch's blocks are whole warps,
//   and a group past the last window runs the last window again and stores
//   nothing, so no thread leaves a shuffle early. (With each group's own
//   lane mask nvcc wrapped every shuffle in a convergence barrier:
//   window_jac_classed<8,2> was 2,224 SASS instructions against 1,360 with
//   the whole warp's, and 7c's K3 call 0.0335 against 0.0285 ms.)
// * Gv_m's row r, for the tangents, stays in registers where the class
//   has at most 16 such entries (NDC · XC); beyond (the (4,8) and (8,8)
//   classes) it is read at each step through a pointer the compiler may
//   not hoist, as keeping it spilled.
// * Register arrays are sized by the class (XC, NDC) and indexed only by
//   loops unrolled to it; each term past the run-time x_dim or n_drives is
//   skipped by a select (fma_if), never added as a zero and never cut by a
//   branch, so the loops stay branch-free and every sum runs in the exact
//   kernels' order; E's sums run with j outermost, so that one predicate
//   serves a column of terms. Threads past x_dim own rows of zeros and
//   store nothing.
// * Classes (ops/expv_kernel.py SIZE_CLASSES, the first that holds the
//   shape): (2,2), (4,2), (6,2), (8,2), (4,8), (8,8). (6,2) holds a
//   qutrit's state as a real vector, (8,2) the scaling family's
//   state_dim 8 (path 7c) and a one-qubit unitary as a real vector, both
//   without eight drives' tangents.
// * K3 assembles each window's x_dim × d rows in shared memory (+0 where J
//   has no column) and stores the block's windows as one contiguous span;
//   a block holds up to kJacBlock / G windows, fewer where their tile
//   would pass kJacSmem, but a warp's (32 / G) at least: x_dim · d ≤
//   12,288 · G / 32 floats (d ≤ 384 at x_dim 8, 4 or 2).
// * K4's vector form is a group a window, flat; its L1 form holds whole
//   instances a block, each group puts Σ_i |r_i| (i in order, gathered by
//   shuffles at the group's first thread) into shared memory, then one
//   thread per instance sums its K partials in window order: a fixed
//   order, no atomics, so line-search decisions are reproducible.
//
// Division is IEEE (no fast math): x/j is correctly rounded.

#include "expv_common.cuh"

namespace expv {
namespace {

constexpr int kJacBlock = 128;    // K3 threads per block
constexpr int kResL1Block = 1024;  // K4's L1 form: threads per block at most

// The least power of two ≥ n: a class's group of threads a window.
__host__ __device__ constexpr int pow2_at_least(int n) { return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2); }

// acc + a·b where `on`, acc itself where not: a term past the run-time size
// is skipped, and the loop around it stays branch-free.
__device__ __forceinline__ float fma_if(bool on, float acc, float a, float b) {
  return on ? acc + a * b : acc;
}

// Every shuffle's lanes: the whole warp (see the note at the top).
constexpr unsigned kWarp = 0xffffffffu;

// Gv_m's row r, for the tangents, stays in registers where the class holds
// at most kRegGv such entries (NDC · XC); beyond, it is read at each step.
constexpr int kRegGv = 16;

// An optimization barrier: the compiler must take p as changed here, so
// loads through it are not hoisted out of the loop that holds it.
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Where window k of instance (problem q, trial slot t) reads.
struct Window {
  const float *gd, *gv, *u, *x;
  float h;
};

__device__ __forceinline__ Window locate(unsigned q, unsigned t, unsigned k, const Gens& g,
                                         const View& u, const View& dt, const View& x) {
  return Window{g.gd + q * g.d[0], g.gv + q * g.v[0],
                u.p + (q * u.s[0] + t * u.s[1] + k * u.s[2]),
                x.p + (q * x.s[0] + t * x.s[1] + k * x.s[2]),
                dt.p[q * dt.s[0] + t * dt.s[1] + k * dt.s[2]]};
}

// Row r of G = Gd + Σ_m u_m·Gv_m and of A = Δt·G, each entry as the exact
// kernels compute it (its sum over m in order); zeros where r ≥ xd and past
// column xd. Beyond two drives the drives' loop runs at run time, one drive
// at a time: unrolled, its 8 × 8 loads in flight spilled.
template <int XC, int NDC>
__device__ __forceinline__ void generator_row(int r, const Window& w, const Gens& g, int xd,
                                              int nd, float (&Grow)[XC], float (&Arow)[XC]) {
  float s[XC];
#pragma unroll
  for (int j = 0; j < XC; ++j) s[j] = 0.0f;
  auto add_drive = [&](int m) {
    const float um = w.u[m];
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const bool on = r < xd && j < xd;
      s[j] = fma_if(on, s[j], um, on ? __ldg(w.gv + m * g.v[1] + r * g.v[2] + j * g.v[3]) : 0.0f);
    }
  };
  if constexpr (NDC <= 2) {
#pragma unroll
    for (int m = 0; m < NDC; ++m)
      if (m < nd) add_drive(m);
  } else {
#pragma unroll 1
    for (int m = 0; m < nd; ++m) add_drive(m);
  }
#pragma unroll
  for (int j = 0; j < XC; ++j) {
    const bool on = r < xd && j < xd;
    Grow[j] = on ? __ldg(w.gd + r * g.d[1] + j * g.d[2]) + s[j] : 0.0f;
    Arow[j] = w.h * Grow[j];
  }
}

// The group's vector v (each thread's entry; G threads, the first XC of
// them holding entries), gathered into every thread.
template <int XC>
__device__ __forceinline__ void gather(float v, float (&out)[XC]) {
#pragma unroll
  for (int j = 0; j < XC; ++j) out[j] = __shfl_sync(kWarp, v, j, pow2_at_least(XC));
}

// K3: a block of W groups of G = pow2(XC) threads, one window each, over
// the n = P·T·K windows flat (instance-major); thread r < XC of a group
// runs column r of E and row r of y and its tangents. Each window's xd × d
// rows are assembled in shared memory (+0 where J has no column), and the
// block stores its windows' rows, one contiguous span of out (n, xd, d).
// The terms of an output's sum are skipped past xd (fma_if on j < xd);
// the outputs no thread stores (rows past xd, drives past nd) may add
// zeros.
template <int XC, int NDC>
__global__ void __launch_bounds__(kJacBlock) window_jac_classed(
    Divisor T, Divisor K, unsigned n, unsigned W, int order, Gens g, View u, View dt, View x,
    JacCols c, Dims dims, float* __restrict__ out) {
  constexpr int G = pow2_at_least(XC);
  constexpr bool reg_gv = NDC * XC <= kRegGv;
  const int xd = dims.xd, nd = dims.nd;
  extern __shared__ float tile[];
  const unsigned w0 = blockIdx.x * W;
  const unsigned n_here = n - w0 < W ? n - w0 : W;
  const unsigned span = xd * c.d;  // output floats per window
  for (unsigned i = threadIdx.x; i < n_here * span; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();
  const unsigned lw = threadIdx.x / G;
  const int r = threadIdx.x % G;
  const bool live = lw < n_here, own = r < xd, free_time = c.t >= 0;
  // a group past the block's last window runs that window again
  const unsigned wi = w0 + (live ? lw : n_here - 1), inst = K.div(wi), q = T.div(inst);
  const Window w = locate(q, inst - q * T.d, wi - inst * K.d, g, u, dt, x);
  float Grow[XC], Arow[XC], A[XC][XC];
  generator_row<XC, NDC>(r, w, g, xd, nd, Grow, Arow);
#pragma unroll
  for (int i = 0; i < XC; ++i)
#pragma unroll
    for (int j = 0; j < XC; ++j) A[i][j] = __shfl_sync(kWarp, Arow[j], i, G);
  // Gv_m's row r, where it stays in registers
  float gvr[reg_gv ? NDC : 1][reg_gv ? XC : 1];
#pragma unroll
  for (int m = 0; m < (reg_gv ? NDC : 0); ++m)
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const bool ld = own && j < xd && m < nd;
      gvr[reg_gv ? m : 0][reg_gv ? j : 0] =
          ld ? __ldg(w.gv + m * g.v[1] + r * g.v[2] + j * g.v[3]) : 0.0f;
    }
  float e[XC], ydu[NDC];
#pragma unroll
  for (int i = 0; i < XC; ++i) e[i] = (i == r) ? 1.0f : 0.0f;
#pragma unroll
  for (int m = 0; m < NDC; ++m) ydu[m] = 0.0f;
  const float xs = own ? w.x[r] : 0.0f;
  float y = xs, ydt = 0.0f;
  for (int k = order; k >= 1; --k) {
    const float fk = (float)k;
    float yb[XC], tb[XC];
    gather<XC>(y, yb);
    // the tangents ẏ_u = (Δt·Gv_m·y + A·ẏ_u)/k and ẏ_t = (G·y + A·ẏ_t)/k
    // first: they see the previous y
#pragma unroll
    for (int m = 0; m < NDC; ++m) {
      gather<XC>(ydu[m], tb);
      const float* gvm = reg_gv ? nullptr : opaque(w.gv + m * g.v[1] + r * g.v[2]);
      float gy = 0.0f, ay = 0.0f;
#pragma unroll
      for (int j = 0; j < XC; ++j) {
        const bool on = j < xd, ld = own && on && m < nd;
        const float gv = reg_gv ? gvr[reg_gv ? m : 0][reg_gv ? j : 0]
                                : (ld ? __ldg(gvm + j * g.v[3]) : 0.0f);
        gy = fma_if(on, gy, gv, yb[j]);
        ay = fma_if(on, ay, Arow[j], tb[j]);
      }
      ydu[m] = (w.h * gy + ay) / fk;
    }
    if (free_time) {
      gather<XC>(ydt, tb);
      float gy = 0.0f, ay = 0.0f;
#pragma unroll
      for (int j = 0; j < XC; ++j) {
        gy = fma_if(j < xd, gy, Grow[j], yb[j]);
        ay = fma_if(j < xd, ay, Arow[j], tb[j]);
      }
      ydt = (gy + ay) / fk;
    }
    // column r of E ← I + A·E/k, and y ← x + A·y/k; each sum over j in
    // order, j outermost so that one predicate serves a column of terms
    float s[XC], sy = 0.0f;
#pragma unroll
    for (int i = 0; i < XC; ++i) s[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const bool on = j < xd;
#pragma unroll
      for (int i = 0; i < XC; ++i) s[i] = fma_if(on, s[i], A[i][j], e[j]);
      sy = fma_if(on, sy, Arow[j], yb[j]);
    }
#pragma unroll
    for (int i = 0; i < XC; ++i) e[i] = ((i == r) ? 1.0f : 0.0f) + s[i] / fk;
    y = xs + sy / fk;
  }
  float* o = tile + lw * span;
  if (live && own) {
#pragma unroll
    for (int i = 0; i < XC; ++i)
      if (i < xd) o[i * c.d + c.x + r] = -e[i];
#pragma unroll
    for (int m = 0; m < NDC; ++m)
      if (m < nd) o[r * c.d + c.u + m] = -ydu[m];
    if (free_time) o[r * c.d + c.t] = -ydt;
  }
  __syncthreads();
  float* dst = out + (size_t)w0 * span;
  for (unsigned i = threadIdx.x; i < n_here * span; i += blockDim.x) dst[i] = tile[i];
}

// Row r of the residual xn − E·x of window k of instance (q, t), by the
// group's chain y ← x + A·y/k; 0 where r ≥ xd.
template <int XC, int NDC>
__device__ __forceinline__ float group_residual(unsigned q, unsigned t, unsigned k, int r,
                                                int order, const Gens& g, const View& u,
                                                const View& dt, const View& x, const View& xn,
                                                int xd, int nd) {
  const Window w = locate(q, t, k, g, u, dt, x);
  float Grow[XC], Arow[XC];
  generator_row<XC, NDC>(r, w, g, xd, nd, Grow, Arow);
  const bool own = r < xd;
  const float xs = own ? w.x[r] : 0.0f;
  float y = xs;
  for (int kk = order; kk >= 1; --kk) {
    float yb[XC];
    gather<XC>(y, yb);
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < XC; ++j) s = fma_if(j < xd, s, Arow[j], yb[j]);
    y = xs + s / (float)kk;
  }
  return own ? xn.p[q * xn.s[0] + t * xn.s[1] + k * xn.s[2] + r] - y : 0.0f;
}

// K4, vector form: a group of G = pow2(XC) threads a window, flat over the
// n = P·T·K windows (instance-major), writing res (P, T, K, xd). L1 form: a
// block holds `ipb` whole instances of the n = P·T; each group puts its
// window's Σ_i |r_i| into shared memory, then one thread per instance sums
// its K partials in window order into l1 (P, T). Blocks are whole warps; a
// group past the last window runs the last window again and stores
// nothing.
template <int XC, int NDC, bool L1>
__global__ void __launch_bounds__(L1 ? kResL1Block : kResBlock) residual_classed(
    Divisor T, Divisor K, unsigned n, unsigned ipb, int order, Gens g, View u, View dt, View x,
    View xn, Dims dims, float* __restrict__ out) {
  constexpr int G = pow2_at_least(XC);
  const int xd = dims.xd, nd = dims.nd;
  const int r = threadIdx.x % G;
  const unsigned groups = blockDim.x / G;
  if (!L1) {
    const unsigned w = blockIdx.x * groups + threadIdx.x / G, wc = w < n ? w : n - 1;
    const unsigned inst = K.div(wc), q = T.div(inst);
    const float ri = group_residual<XC, NDC>(q, inst - q * T.d, wc - inst * K.d, r, order, g, u,
                                             dt, x, xn, xd, nd);
    if (w < n && r < xd) out[(size_t)w * xd + r] = ri;
    return;
  }
  extern __shared__ float part[];
  const unsigned i0 = blockIdx.x * ipb;
  const unsigned n_here = n - i0 < ipb ? n - i0 : ipb;
  const unsigned nw = n_here * K.d;  // the block's windows
  for (unsigned w0 = 0; w0 < nw; w0 += groups) {
    const unsigned w = w0 + threadIdx.x / G, wc = w < nw ? w : nw - 1;
    const unsigned j = K.div(wc), q = T.div(i0 + j);
    const float ri = group_residual<XC, NDC>(q, i0 + j - q * T.d, wc - j * K.d, r, order, g, u,
                                             dt, x, xn, xd, nd);
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < XC; ++i) {
      const float v = __shfl_sync(kWarp, ri, i, G);
      acc = i < xd ? acc + fabsf(v) : acc;
    }
    if (w < nw && r == 0) part[w] = acc;
  }
  __syncthreads();
  if (threadIdx.x < n_here) {
    const float* p = part + threadIdx.x * K.d;
    float acc = 0.0f;
    for (unsigned k = 0; k < K.d; ++k) acc += p[k];
    out[i0 + threadIdx.x] = acc;
  }
}

// K3 at class (XC, NDC): kJacBlock / G windows a block, fewer where their
// output tile (W · xd · d floats) would pass kJacSmem, in whole warps.
template <int XC, int NDC>
int launch_jac_c(int P, int T, int K, int order, const Gens& g, const View& u, const View& dt,
                 const View& x, const JacCols& c, const Dims& dims, float* out, cudaStream_t s) {
  constexpr unsigned G = pow2_at_least(XC), warp_windows = 32 / G;
  const unsigned n = (unsigned)P * (unsigned)T * (unsigned)K;
  if (n == 0) return 0;
  const size_t per_window = sizeof(float) * dims.xd * c.d;
  unsigned W = kJacBlock / G;
  if (W * per_window > kJacSmem)
    W = (unsigned)(kJacSmem / per_window) / warp_windows * warp_windows;
  if (W == 0) return (int)cudaErrorInvalidValue;
  window_jac_classed<XC, NDC><<<(n + W - 1) / W, W * G, W * per_window, s>>>(
      Divisor(T), Divisor(K), n, W, order, g, u, dt, x, c, dims, out);
  return (int)cudaGetLastError();
}

// K4 at class (XC, NDC). The L1 form's block holds ipb whole instances: as
// many as give each of their windows a group within kResBlock threads, at
// least one, whose windows take a group each up to kResL1Block threads (at
// path 7c's 50 windows, 8 threads a window, one round of 416 threads in
// place of two of 256); its threads are whole warps.
template <int XC, int NDC, bool L1>
int launch_res_c(int P, int T, int K, int order, const Gens& g, const View& u, const View& dt,
                 const View& x, const View& xn, const Dims& dims, float* out, cudaStream_t s) {
  constexpr unsigned G = pow2_at_least(XC), groups = kResBlock / G;
  const unsigned n_inst = (unsigned)P * (unsigned)T;
  if (!L1) {
    const unsigned n = n_inst * (unsigned)K;
    if (n == 0) return 0;
    residual_classed<XC, NDC, false><<<(n + groups - 1) / groups, kResBlock, 0, s>>>(
        Divisor(T), Divisor(K), n, 0, order, g, u, dt, x, xn, dims, out);
    return (int)cudaGetLastError();
  }
  const int ipb = K < 1 ? kResBlock : (K >= (int)groups ? 1 : (int)groups / K);
  const size_t smem = sizeof(float) * ipb * K;
  if (smem > kResSmem) return (int)cudaErrorInvalidValue;
  const long long used = K < 1 ? kResBlock : (long long)ipb * K * G;
  const int threads = used >= kResL1Block ? kResL1Block : (int)(used + 31) / 32 * 32;
  residual_classed<XC, NDC, true><<<(n_inst + ipb - 1) / ipb, threads, smem, s>>>(
      Divisor(T), Divisor(K), n_inst, ipb, order, g, u, dt, x, xn, dims, out);
  return (int)cudaGetLastError();
}

template <int XC, int NDC>
int launch_res_l1(bool l1, int P, int T, int K, int order, const Gens& g, const View& u,
                  const View& dt, const View& x, const View& xn, const Dims& dims, float* out,
                  cudaStream_t s) {
  return l1 ? launch_res_c<XC, NDC, true>(P, T, K, order, g, u, dt, x, xn, dims, out, s)
            : launch_res_c<XC, NDC, false>(P, T, K, order, g, u, dt, x, xn, dims, out, s);
}

}  // namespace

// The size classes (XC, NDC) in ops/expv_kernel.py SIZE_CLASSES order; a
// call takes the first that holds (xd, nd).
int launch_jac_classed(int P, int T, int K, int order, const Gens& g, const View& u,
                       const View& dt, const View& x, const JacCols& c, const Dims& dims,
                       float* out, cudaStream_t s) {
  const int xd = dims.xd, nd = dims.nd;
  if (xd <= 2 && nd <= 2) return launch_jac_c<2, 2>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  if (xd <= 4 && nd <= 2) return launch_jac_c<4, 2>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  if (xd <= 6 && nd <= 2) return launch_jac_c<6, 2>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  if (xd <= 8 && nd <= 2) return launch_jac_c<8, 2>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  if (xd <= 4 && nd <= 8) return launch_jac_c<4, 8>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  if (xd <= 8 && nd <= 8) return launch_jac_c<8, 8>(P, T, K, order, g, u, dt, x, c, dims, out, s);
  return (int)cudaErrorInvalidValue;
}

int launch_res_classed(bool l1, int P, int T, int K, int order, const Gens& g, const View& u,
                       const View& dt, const View& x, const View& xn, const Dims& dims,
                       float* out, cudaStream_t s) {
  const int xd = dims.xd, nd = dims.nd;
  if (xd <= 2 && nd <= 2)
    return launch_res_l1<2, 2>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  if (xd <= 4 && nd <= 2)
    return launch_res_l1<4, 2>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  if (xd <= 6 && nd <= 2)
    return launch_res_l1<6, 2>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  if (xd <= 8 && nd <= 2)
    return launch_res_l1<8, 2>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  if (xd <= 4 && nd <= 8)
    return launch_res_l1<4, 8>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  if (xd <= 8 && nd <= 8)
    return launch_res_l1<8, 8>(l1, P, T, K, order, g, u, dt, x, xn, dims, out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace expv
