// Bilinear window Jacobians and residuals for Hopper (sm_90a), float32.
//
// Replaces the two Pallas kernels of directtrajopt_tpu/ops/expv_kernel.py:
//   * _kernel      (window Jacobian, wrapper _window_jac_pallas)  -> window_jac_kernel
//   * _res_kernel  (residual chain, wrapper _res_pallas)          -> residual_kernel,
//                                                                    residual_l1_kernel
//
// Per window k of lane l, with G = Gd + Σ_m u_m·Gv_m and A = Δt·G, the order-m
// Taylor action E·x is the Horner chain  y ← x + A·y / j  (j = m..1). The
// Jacobian J = ∂(E·x)/∂(x, u, Δt) comes from the tangent recurrences of the
// same chain (the E columns, ẏ_u = (Δt·Gv_m·y + A·ẏ_u)/j, ẏ_t = (G·y + A·ẏ_t)/j),
// tangents first so they see the previous y, as jax.jacfwd orders them.
//
// Design: one thread per (lane, window); the small matrices live in
// registers (sizes are template constants, instantiated for the two shapes
// the port's paths give: x_dim=4 with 2 drives, the bilinear benchmark, and
// x_dim=2 with 1 drive, the state-constrained family). Bound on the card: each thread
// reads ~(x_dim² (1 + n_drives) + x_dim + n_drives + 1) floats, most of them
// the lane's generators shared by its K windows (served from L1/L2), and
// writes x_dim·(x_dim + n_drives + 1) floats, against ~order·x_dim²·(x_dim +
// n_drives + 2) FMAs — arithmetic intensity of a few FLOP/byte, so the
// kernel is bound by the output write at large batch and by launch latency
// at a compact chunk. The L1 form reduces Σ|·| per instance in a fixed
// order (per window over x_dim, then per lane over the windows in a second
// pass), with no atomics, so line-search decisions are reproducible.
//
// Division is IEEE (no fast math): x/j is correctly rounded.

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

// Primal chain of one window: r = xn − E·x. Writes r (when res != nullptr)
// and/or Σ_i |r_i| (when part != nullptr).
template <int XD, int ND>
__global__ void residual_kernel(int L, int K, int order,
                                const float* __restrict__ Gd,
                                const float* __restrict__ Gv,
                                const float* __restrict__ u,
                                const float* __restrict__ dt,
                                const float* __restrict__ x,
                                const float* __restrict__ xn,
                                float* __restrict__ res,
                                float* __restrict__ part) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)L * K) return;
  const long l = t / K;
  const float* gd = Gd + l * XD * XD;
  const float* gv = Gv + l * ND * XD * XD;
  const float h = dt[t];
  float um[ND];
#pragma unroll
  for (int m = 0; m < ND; ++m) um[m] = u[t * ND + m];
  float A[XD][XD], xs[XD], y[XD];
#pragma unroll
  for (int i = 0; i < XD; ++i) {
    xs[i] = x[t * XD + i];
    y[i] = xs[i];
#pragma unroll
    for (int j = 0; j < XD; ++j) {
      float s = 0.0f;
#pragma unroll
      for (int m = 0; m < ND; ++m) s += um[m] * gv[(m * XD + i) * XD + j];
      A[i][j] = h * (gd[i * XD + j] + s);
    }
  }
  for (int k = order; k >= 1; --k) {
    const float fk = (float)k;
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
    const float r = xn[t * XD + i] - y[i];
    if (res) res[t * XD + i] = r;
    acc += fabsf(r);
  }
  if (part) part[t] = acc;
}

// Σ over the K windows of one lane, in window order (second pass of the L1 form).
__global__ void lane_sum_kernel(int L, int K, const float* __restrict__ part,
                                float* __restrict__ out) {
  const long l = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k) acc += part[l * K + k];
  out[l] = acc;
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

template <int XD, int ND>
int launch_res(int L, int K, int order, const float* Gd, const float* Gv, const float* u,
               const float* dt, const float* x, const float* xn, float* res, float* part,
               cudaStream_t s) {
  residual_kernel<XD, ND><<<blocks_for((long)L * K), kThreads, 0, s>>>(
      L, K, order, Gd, Gv, u, dt, x, xn, res, part);
  return (int)cudaGetLastError();
}

}  // namespace

// The (x_dim, n_drives) pairs instantiated: (4, 2), the bilinear benchmark's
// 4-D state with 2 drives, and (2, 1), the state-constrained family's 2-D
// state with one drive (at a fixed Δt: free_time = 0 gives the 2×3 block).
// The Python wrapper (ops/expv_kernel.py, SUPPORTED_SHAPES) raises for any other.
static int res_dispatch(int L, int K, int xd, int nd, int order, const void* Gd,
                        const void* Gv, const void* u, const void* dt, const void* x,
                        const void* xn, void* res, void* part, cudaStream_t s) {
  const float *gd = (const float*)Gd, *gv = (const float*)Gv, *uu = (const float*)u,
              *h = (const float*)dt, *xx = (const float*)x, *xxn = (const float*)xn;
  if (xd == 4 && nd == 2)
    return launch_res<4, 2>(L, K, order, gd, gv, uu, h, xx, xxn, (float*)res, (float*)part, s);
  if (xd == 2 && nd == 1)
    return launch_res<2, 1>(L, K, order, gd, gv, uu, h, xx, xxn, (float*)res, (float*)part, s);
  return (int)cudaErrorInvalidValue;
}

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

extern "C" int dto_residual(int L, int K, int xd, int nd, int order, const void* Gd,
                            const void* Gv, const void* u, const void* dt, const void* x,
                            const void* xn, void* res, void* stream) {
  return res_dispatch(L, K, xd, nd, order, Gd, Gv, u, dt, x, xn, res, nullptr,
                      (cudaStream_t)stream);
}

extern "C" int dto_residual_l1(int L, int K, int xd, int nd, int order, const void* Gd,
                               const void* Gv, const void* u, const void* dt,
                               const void* x, const void* xn, void* part, void* out,
                               void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int rc = res_dispatch(L, K, xd, nd, order, Gd, Gv, u, dt, x, xn, nullptr, part, s);
  if (rc) return rc;
  lane_sum_kernel<<<blocks_for(L), kThreads, 0, s>>>(L, K, (const float*)part, (float*)out);
  return (int)cudaGetLastError();
}
