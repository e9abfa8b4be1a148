// Bilinear window Jacobians and residuals for Hopper (sm_90a), float32.
//
// Replaces the two Pallas kernels of directtrajopt_tpu/ops/expv_kernel.py:
//   * _kernel      (window Jacobian, wrapper _window_jac_pallas)  -> window_jac_kernel
//   * _res_kernel  (residual chain, wrapper _res_pallas)          -> residual_grid_kernel
//
// Per window k of lane l, with G = Gd + Σ_m u_m·Gv_m and A = Δt·G, the order-m
// Taylor action E·x is the Horner chain  y ← x + A·y / j  (j = m..1). The
// Jacobian J = ∂(E·x)/∂(x, u, Δt) comes from the tangent recurrences of the
// same chain (the E columns, ẏ_u = (Δt·Gv_m·y + A·ẏ_u)/j, ẏ_t = (G·y + A·ẏ_t)/j),
// tangents first so they see the previous y, as jax.jacfwd orders them.
// The small matrices live in registers; their sizes are template constants,
// instantiated for the two shapes the port's paths give: x_dim=4 with 2
// drives, the bilinear benchmark, and x_dim=2 with 1 drive, the
// state-constrained family.
//
// window_jac_kernel (K3): one thread per (lane, window) on contiguous
// (lanes, K, ·) inputs. Each thread reads ~(x_dim² (1 + n_drives) + x_dim +
// n_drives + 1) floats, most of them the lane's generators (served from
// L1/L2), and writes x_dim·(x_dim + n_drives + 1) floats: bound by the
// output write at large batch and by launch latency at a compact chunk.
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

#include <cuda_runtime.h>

namespace {

template <int XD, int ND>
__global__ void window_jac_kernel(int L, int K, int order, int free_time,
                                  const float* __restrict__ Gd,
                                  const float* __restrict__ Gv,
                                  const float* __restrict__ u,
                                  const float* __restrict__ dt,
                                  const float* __restrict__ x,
                                  float* __restrict__ out) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)L * K) return;
  const long l = t / K;
  const int n_th = XD + ND + (free_time ? 1 : 0);
  const float* gd = Gd + l * XD * XD;
  const float* gv = Gv + l * ND * XD * XD;
  const float h = dt[t];
  float um[ND];
#pragma unroll
  for (int m = 0; m < ND; ++m) um[m] = u[t * ND + m];
  float xs[XD], y[XD], ydt[XD];
  float G[XD][XD], A[XD][XD], E[XD][XD], ydu[ND][XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    xs[i] = x[t * XD + i];
    y[i] = xs[i];
    ydt[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < XD; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < ND; ++m) s += um[m] * gv[(m * XD + i) * XD + j];
      G[i][j] = gd[i * XD + j] + s;
      A[i][j] = h * G[i][j];
      E[i][j] = (i == j) ? 1.0f : 0.0f;
    }
  }
#pragma unroll
  for (int m = 0; m < ND; ++m)
#pragma unroll
    for (int i = 0; i < XD; ++i) ydu[m][i] = 0.0f;

  for (int k = order; k >= 1; --k) {
    const float fk = (float)k;
    // tangents first: they reference the previous y
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      float nxt[XD];
#pragma unroll
      for (int i = 0; i < XD; ++i) {
        float gy = 0.0f, ay = 0.0f;
#pragma unroll
        for (int j = 0; j < XD; ++j) {
          gy += gv[(m * XD + i) * XD + j] * y[j];
          ay += A[i][j] * ydu[m][j];
        }
        nxt[i] = (h * gy + ay) / fk;
      }
#pragma unroll
      for (int i = 0; i < XD; ++i) ydu[m][i] = nxt[i];
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
      for (int i = 0; i < XD; ++i) ydt[i] = nxt[i];
    }
    float En[XD][XD];
#pragma unroll
    for (int i = 0; i < XD; ++i)
#pragma unroll
      for (int c = 0; c < XD; ++c) {
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < XD; ++j) s += A[i][j] * E[j][c];
        En[i][c] = ((i == c) ? 1.0f : 0.0f) + s / fk;
      }
    float yn[XD];
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < XD; ++j) s += A[i][j] * y[j];
      yn[i] = xs[i] + s / fk;
    }
#pragma unroll
    for (int i = 0; i < XD; ++i) {
      y[i] = yn[i];
#pragma unroll
      for (int c = 0; c < XD; ++c) E[i][c] = En[i][c];
    }
  }
  float* o = out + t * XD * n_th;
#pragma unroll
  for (int i = 0; i < XD; ++i) {
#pragma unroll
    for (int c = 0; c < XD; ++c) o[i * n_th + c] = E[i][c];
#pragma unroll
    for (int m = 0; m < ND; ++m) o[i * n_th + XD + m] = ydu[m][i];
    if (free_time) o[i * n_th + XD + ND] = ydt[i];
  }
}

// A (P, T, K, ·) view of the knot matrix: its element strides between
// problems, trial slots and windows, then the last axis's (1, unused). The
// entry checks that every element's offset fits 32 bits.
struct View {
  const float* p;
  int s[4];
};

// The generators Gd (P, xd, xd) and Gv (P, nd, xd, xd) with their element
// strides, read where they lie (the port keeps them problems-minor).
struct Gens {
  const float* gd;
  const float* gv;
  int d[3], v[4];
};

// Division by a divisor fixed for the launch, as a multiply-high and a
// shift (Granlund and Montgomery's round-up method, as CUTLASS's FastDivmod
// does it), exact for every dividend below 2³¹.
struct Divisor {
  unsigned d, mul, shr;
  explicit Divisor(unsigned den) : d(den), mul(0), shr(0) {
    if (den > 1) {
      unsigned lg = 0;
      while ((1ull << lg) < den) ++lg;  // ⌈log₂ den⌉
      mul = (unsigned)(((1ull << (31 + lg)) + den - 1) / den);
      shr = lg - 1;
    }
  }
  __device__ __forceinline__ unsigned div(unsigned n) const {
    return d > 1 ? __umulhi(n, mul) >> shr : n;
  }
};

constexpr int kResBlock = 256;               // threads per block
constexpr size_t kResSmem = 48 * 1024;       // the L1 form's partials (no opt-in)

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
  for (int m = 0; m < ND; ++m) um[m] = up[m];
  float A[XD][XD], xs[XD], y[XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    xs[i] = xp[i];
    y[i] = xs[i];
#pragma unroll
    for (int j = 0; j < XD; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < ND; ++m)
        s += um[m] * __ldg(gv + m * g.v[1] + i * g.v[2] + j * g.v[3]);
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
      for (int j = 0; j < XD; ++j) s += A[i][j] * y[j];
      yn[i] = xs[i] + s / fk;
    }
#pragma unroll
    for (int i = 0; i < XD; ++i) y[i] = yn[i];
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

constexpr int kThreads = 256;

inline unsigned blocks_for(long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <int XD, int ND>
int launch_jac(int L, int K, int order, int free_time, const float* Gd, const float* Gv,
               const float* u, const float* dt, const float* x, float* out,
               cudaStream_t s) {
  window_jac_kernel<XD, ND><<<blocks_for((long)L * K), kThreads, 0, s>>>(
      L, K, order, free_time, Gd, Gv, u, dt, x, out);
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

}  // namespace

extern "C" int dto_window_jac(int L, int K, int xd, int nd, int order, int free_time,
                              const void* Gd, const void* Gv, const void* u,
                              const void* dt, const void* x, void* out, void* stream) {
  const float *gd = (const float*)Gd, *gv = (const float*)Gv, *uu = (const float*)u,
              *h = (const float*)dt, *xx = (const float*)x;
  cudaStream_t s = (cudaStream_t)stream;
  if (xd == 4 && nd == 2)
    return launch_jac<4, 2>(L, K, order, free_time, gd, gv, uu, h, xx, (float*)out, s);
  if (xd == 2 && nd == 1)
    return launch_jac<2, 1>(L, K, order, free_time, gd, gv, uu, h, xx, (float*)out, s);
  return (int)cudaErrorInvalidValue;
}

// K4 on the trial grid: P problems × T trial slots × K windows. Gd (P, xd, xd)
// and Gv (P, nd, xd, xd) with any strides; u, Δt, x, xn strided views
// (problems, slots, windows; a unit stride on the last axis; Δt has no last
// axis and may have stride 0 throughout). `st` holds the 19 element strides
// in that order: Gd 3, Gv 4, u 3, Δt 3, x 3, xn 3 (one host array, so the
// call passes 16 arguments). Writes (P, T, K, xd) (l1 = 0) or (P, T)
// (l1 = 1), contiguous. Returns cudaErrorInvalidValue, launching nothing,
// where P·T·K or an element offset of a view exceeds 2³¹ − 1, or where the
// L1 form's K partials per block exceed kResSmem. The (xd, nd) pairs
// instantiated: (4, 2), the bilinear benchmark's 4-D state with 2 drives,
// and (2, 1), the state-constrained family's 2-D state with one drive. The
// Python wrapper (ops/expv_kernel.py, SUPPORTED_SHAPES) raises for any other.
extern "C" int dto_residual(int P, int T, int K, int xd, int nd, int order, int l1,
                            const void* Gd, const void* Gv, const void* u, const void* dt,
                            const void* x, const void* xn, const long long* st, void* out,
                            void* stream) {
  if (P < 1 || T < 1 || K < 0 || (long long)P * T * (K > 1 ? K : 1) > INT_MAX)
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
  return (int)cudaErrorInvalidValue;
}
