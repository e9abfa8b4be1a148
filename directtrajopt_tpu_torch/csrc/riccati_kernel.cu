// Fused Riccati KKT factor + multi-RHS solve, and resolve with stored
// factors, for Hopper (sm_90a), float32.
//
// Replaces the two Pallas kernels of directtrajopt_tpu/ops/riccati_kernel.py:
//   * _fused_kernel   (wrapper _factor_solve_pallas) -> factor_solve_kernel
//   * _resolve_kernel (wrapper _resolve_pallas)      -> resolve_kernel
//
// Per lane: a backward sweep over the N stages (PB = P·B, PA = P·A,
// Hvv = Qvv + BᵀPB, its Cholesky, Mvs = Qsvᵀ + BᵀPA, Kg = −Hvv⁻¹Mvs,
// P ← sym(Qss + AᵀPA + MvsᵀKg)) fused with the R right-hand-side backward
// recursions (w, kff, p); the masked Cholesky of P0 over the free initial
// states; and the forward sweep for dzs, dzv and λ. The `ok` certificate is
// false where any pivot of Hvv or of the masked P0 is ≤ 0 or non-finite (or
// an entry of the factor is non-finite), and the identity is substituted for
// that factor, exactly as the XLA scan (_factor_solve_xla) does.
//
// Design: one thread per lane, the stage loop inside the thread, all stage
// stacks stored lanes-minor ((N, rows, cols, L), the Pallas kernel's layout)
// so that neighbouring threads read neighbouring addresses. The stage blocks
// live in per-thread arrays sized by template constants: an exact
// instantiation for the shapes of the bilinear benchmark (n_s=8, n_v=3,
// R=3 for the factor sweep and R=2 for the fused SOC + restoration resolve),
// and a generic one (n_s ≤ 16, n_v ≤ 8, R ≤ 8) with runtime loop bounds.
// Bound on the card: the sweep is sequential in N and does
// ~N·(2n_s³ + 3n_s²n_v + …) dependent FLOPs per lane, so at a compact
// chunk of 256 lanes it runs two 128-thread blocks on 132 SMs and is bound
// by per-thread latency, not by bandwidth or FLOP rate. Spreading a lane
// over a warp (and more lanes per SM) is later work.
//
// Division and sqrt are IEEE (no fast math): correctly rounded.

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Full unrolling for the exact-size instantiations (stage blocks in
// registers); none for the generic maximum-size one (arrays in local memory),
// which keeps its compile time short.
template <int M>
struct Unroll {
  static constexpr int value = (M <= 8) ? 8 : 1;
};

// (N, r, c, L) lanes-minor stage stack
#define AT(X, k, i, j, r, c) (X)[(((long)(k) * (r) + (i)) * (c) + (j)) * L + l]

// Cholesky of the n×n leading block of H into Lf; identity on failure.
template <int M>
__device__ __forceinline__ bool chol_or_identity(const float (&H)[M][M], float (&Lf)[M][M],
                                                 int n) {
  bool ok = true;
#pragma unroll (Unroll<M>::value)
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
#pragma unroll (Unroll<M>::value)
    for (int c = 0; c < M; ++c) Lf[r][c] = 0.0f;
  }
#pragma unroll (Unroll<M>::value)
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
    float d = H[r][r];
#pragma unroll (Unroll<M>::value)
    for (int t = 0; t < M; ++t) {
      if (t >= r) break;
      d -= Lf[r][t] * Lf[r][t];
    }
    if (!(d > 0.0f)) ok = false;
    const float s = sqrtf(d);
    Lf[r][r] = s;
#pragma unroll (Unroll<M>::value)
    for (int q = 0; q < M; ++q) {
      if (q <= r) continue;
      if (q >= n) break;
      float v = H[q][r];
#pragma unroll (Unroll<M>::value)
      for (int t = 0; t < M; ++t) {
        if (t >= r) break;
        v -= Lf[q][t] * Lf[r][t];
      }
      Lf[q][r] = v / s;
    }
  }
#pragma unroll (Unroll<M>::value)
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
#pragma unroll (Unroll<M>::value)
    for (int c = 0; c < M; ++c) {
      if (c > r) break;
      if (!isfinite(Lf[r][c])) ok = false;
    }
  }
  if (!ok) {
#pragma unroll (Unroll<M>::value)
    for (int r = 0; r < M; ++r) {
      if (r >= n) break;
#pragma unroll (Unroll<M>::value)
      for (int c = 0; c < M; ++c) Lf[r][c] = (r == c) ? 1.0f : 0.0f;
    }
  }
  return ok;
}

// x ← (L Lᵀ)⁻¹ x for the n leading entries.
template <int M>
__device__ __forceinline__ void cho_solve(const float (&Lf)[M][M], float (&x)[M], int n) {
#pragma unroll (Unroll<M>::value)
  for (int i = 0; i < M; ++i) {
    if (i >= n) break;
    float s = x[i];
#pragma unroll (Unroll<M>::value)
    for (int t = 0; t < M; ++t) {
      if (t >= i) break;
      s -= Lf[i][t] * x[t];
    }
    x[i] = s / Lf[i][i];
  }
#pragma unroll (Unroll<M>::value)
  for (int i = M - 1; i >= 0; --i) {
    if (i >= n) continue;
    float s = x[i];
#pragma unroll (Unroll<M>::value)
    for (int t = 0; t < M; ++t) {
      if (t <= i) continue;
      if (t >= n) break;
      s -= Lf[t][i] * x[t];
    }
    x[i] = s / Lf[i][i];
  }
}

// Masked initial-state Cholesky: P0m = P0∘(s0 s0ᵀ) + diag(1 − s0).
template <int NS>
__device__ __forceinline__ bool initial_factor(const float (&P0)[NS][NS], unsigned s0mask,
                                               float (&L0)[NS][NS], int ns) {
  float P0m[NS][NS];
#pragma unroll (Unroll<NS>::value)
  for (int i = 0; i < NS; ++i) {
    if (i >= ns) break;
    const bool fi = (s0mask >> i) & 1u;
#pragma unroll (Unroll<NS>::value)
    for (int j = 0; j < NS; ++j) {
      if (j >= ns) break;
      const bool fj = (s0mask >> j) & 1u;
      P0m[i][j] = (fi && fj) ? P0[i][j] : ((i == j) ? 1.0f : 0.0f);
    }
  }
  return chol_or_identity<NS>(P0m, L0, ns);
}

// Shared tail of both kernels: the initial-state solve and the forward sweep.
// On entry dzs/dzv hold the stashed p_k / kff_k of the backward sweep.
template <int NS, int NV, int RM>
__device__ __forceinline__ void forward_sweep(
    int l, int L, int N, int ns, int nv, int R, unsigned s0mask,
    const float (&L0)[NS][NS], const float (&p0)[RM][NS],
    const float* __restrict__ P, const float* __restrict__ Kg,
    const float* __restrict__ A, const float* __restrict__ B,
    const float* __restrict__ rb, float* __restrict__ dzs, float* __restrict__ dzv,
    float* __restrict__ lam) {
  float s[RM][NS];
#pragma unroll (Unroll<NS>::value)
  for (int r = 0; r < RM; ++r) {
    if (r >= R) break;
    float x[NS];
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
      x[i] = ((s0mask >> i) & 1u) ? p0[r][i] : 0.0f;
    }
    cho_solve<NS>(L0, x, ns);
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
      s[r][i] = ((s0mask >> i) & 1u) ? -x[i] : 0.0f;
    }
  }
  for (int k = 0; k < N; ++k) {
#pragma unroll (Unroll<NS>::value)
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      if (k >= 1) {
#pragma unroll (Unroll<NS>::value)
        for (int i = 0; i < NS; ++i) {
          if (i >= ns) break;
          float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
          for (int j = 0; j < NS; ++j) {
            if (j >= ns) break;
            acc += AT(P, k, i, j, ns, ns) * s[r][j];
          }
          AT(lam, k - 1, r, i, R, ns) = -(acc + AT(dzs, k, r, i, R, ns));
        }
      }
      float v[NV];
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int j = 0; j < NS; ++j) {
          if (j >= ns) break;
          acc += s[r][j] * AT(Kg, k, a, j, nv, ns);
        }
        v[a] = acc + AT(dzv, k, r, a, R, nv);
      }
      float sn[NS];
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int j = 0; j < NS; ++j) {
          if (j >= ns) break;
          acc += s[r][j] * AT(A, k, i, j, ns, ns);
        }
        float acc2 = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int a = 0; a < NV; ++a) {
          if (a >= nv) break;
          acc2 += v[a] * AT(B, k, i, a, ns, nv);
        }
        sn[i] = acc + acc2 + AT(rb, k, r, i, R, ns);
      }
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        AT(dzs, k, r, i, R, ns) = s[r][i];
        s[r][i] = sn[i];
      }
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        AT(dzv, k, r, a, R, nv) = v[a];
      }
    }
  }
}

template <int NS, int NV, int RM>
__device__ __forceinline__ void factor_solve_lane(
    int l, int L, int N, int ns, int nv, int R, unsigned s0mask,
    const float* __restrict__ Qss, const float* __restrict__ Qsv,
    const float* __restrict__ Qvv, const float* __restrict__ A,
    const float* __restrict__ B, const float* __restrict__ qs,
    const float* __restrict__ qv, const float* __restrict__ rb, float* __restrict__ Pout,
    float* __restrict__ Lout, float* __restrict__ Kgout, float* __restrict__ Mvsout,
    float* __restrict__ L0out, float* __restrict__ okout, float* __restrict__ dzs,
    float* __restrict__ dzv, float* __restrict__ lam) {
  float P[NS][NS];   // P_{k+1}
  float p[RM][NS];   // p_{k+1}
#pragma unroll (Unroll<NS>::value)
  for (int i = 0; i < NS; ++i)
#pragma unroll (Unroll<NS>::value)
    for (int j = 0; j < NS; ++j) P[i][j] = 0.0f;
#pragma unroll (Unroll<NS>::value)
  for (int r = 0; r < RM; ++r)
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) p[r][i] = 0.0f;
  bool ok = true;

  for (int k = N - 1; k >= 0; --k) {
    float Ak[NS][NS], Bk[NS][NV];
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        Ak[i][j] = AT(A, k, i, j, ns, ns);
      }
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        Bk[i][a] = AT(B, k, i, a, ns, nv);
      }
    }
    float PA[NS][NS], PB[NS][NV];
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += P[i][t] * Ak[t][j];
        }
        PA[i][j] = acc;
      }
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += P[i][t] * Bk[t][a];
        }
        PB[i][a] = acc;
      }
    }
    float H[NV][NV], Mvs[NV][NS];
#pragma unroll (Unroll<NS>::value)
    for (int a = 0; a < NV; ++a) {
      if (a >= nv) break;
#pragma unroll (Unroll<NS>::value)
      for (int b = 0; b < NV; ++b) {
        if (b >= nv) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += Bk[t][a] * PB[t][b];
        }
        H[a][b] = AT(Qvv, k, a, b, nv, nv) + acc;
      }
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += Bk[t][a] * PA[t][j];
        }
        Mvs[a][j] = AT(Qsv, k, j, a, ns, nv) + acc;
      }
    }
    float Lv[NV][NV];
    ok = chol_or_identity<NV>(H, Lv, nv) && ok;
    float Kg[NV][NS];
#pragma unroll (Unroll<NS>::value)
    for (int j = 0; j < NS; ++j) {
      if (j >= ns) break;
      float col[NV];
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        col[a] = Mvs[a][j];
      }
      cho_solve<NV>(Lv, col, nv);
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        Kg[a][j] = -col[a];
      }
    }
    // right-hand sides, with P = P_{k+1} and this stage's factors
#pragma unroll (Unroll<NS>::value)
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      float w[NS];
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int j = 0; j < NS; ++j) {
          if (j >= ns) break;
          acc += AT(rb, k, r, j, R, ns) * P[i][j];
        }
        w[i] = acc + p[r][i];
      }
      float kff[NV];
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int i = 0; i < NS; ++i) {
          if (i >= ns) break;
          acc += w[i] * Bk[i][a];
        }
        kff[a] = AT(qv, k, r, a, R, nv) + acc;
      }
      cho_solve<NV>(Lv, kff, nv);
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        kff[a] = -kff[a];
        AT(dzv, k, r, a, R, nv) = kff[a];  // stash kff_k
      }
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += w[t] * Ak[t][i];
        }
        float acc2 = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int a = 0; a < NV; ++a) {
          if (a >= nv) break;
          acc2 += kff[a] * Mvs[a][i];
        }
        p[r][i] = (AT(qs, k, r, i, R, ns) + acc) + acc2;
        AT(dzs, k, r, i, R, ns) = p[r][i];  // stash p_k
      }
    }
    // P_k = sym(Qss + AᵀPA + MvsᵀKg)
    float Pn[NS][NS];
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += Ak[t][i] * PA[t][j];
        }
        float acc2 = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int a = 0; a < NV; ++a) {
          if (a >= nv) break;
          acc2 += Mvs[a][i] * Kg[a][j];
        }
        Pn[i][j] = (AT(Qss, k, i, j, ns, ns) + acc) + acc2;
      }
    }
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) {
      if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
        AT(Pout, k, i, j, ns, ns) = P[i][j];
      }
    }
#pragma unroll (Unroll<NS>::value)
    for (int a = 0; a < NV; ++a) {
      if (a >= nv) break;
#pragma unroll (Unroll<NS>::value)
      for (int b = 0; b < NV; ++b) {
        if (b >= nv) break;
        AT(Lout, k, a, b, nv, nv) = Lv[a][b];
      }
#pragma unroll (Unroll<NS>::value)
      for (int j = 0; j < NS; ++j) {
        if (j >= ns) break;
        AT(Kgout, k, a, j, nv, ns) = Kg[a][j];
        AT(Mvsout, k, a, j, nv, ns) = Mvs[a][j];
      }
    }
  }

  float L0[NS][NS];
  ok = initial_factor<NS>(P, s0mask, L0, ns) && ok;
#pragma unroll (Unroll<NS>::value)
  for (int i = 0; i < NS; ++i) {
    if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
    for (int j = 0; j < NS; ++j) {
      if (j >= ns) break;
      L0out[((long)i * ns + j) * L + l] = (j <= i) ? L0[i][j] : 0.0f;
    }
  }
  okout[l] = ok ? 1.0f : 0.0f;
  forward_sweep<NS, NV, RM>(l, L, N, ns, nv, R, s0mask, L0, p, Pout, Kgout, A, B, rb, dzs,
                            dzv, lam);
}

template <int NS, int NV, int RM>
__device__ __forceinline__ void resolve_lane(
    int l, int L, int N, int ns, int nv, int R, unsigned s0mask,
    const float* __restrict__ P, const float* __restrict__ Lvs, const float* __restrict__ Kg,
    const float* __restrict__ Mvs, const float* __restrict__ L0in,
    const float* __restrict__ A, const float* __restrict__ B, const float* __restrict__ qs,
    const float* __restrict__ qv, const float* __restrict__ rb, float* __restrict__ dzs,
    float* __restrict__ dzv, float* __restrict__ lam) {
  float p[RM][NS];
#pragma unroll (Unroll<NS>::value)
  for (int r = 0; r < RM; ++r)
#pragma unroll (Unroll<NS>::value)
    for (int i = 0; i < NS; ++i) p[r][i] = 0.0f;
  for (int k = N - 1; k >= 0; --k) {
    float Lv[NV][NV];
#pragma unroll (Unroll<NS>::value)
    for (int a = 0; a < NV; ++a) {
      if (a >= nv) break;
#pragma unroll (Unroll<NS>::value)
      for (int b = 0; b < NV; ++b) {
        if (b >= nv) break;
        Lv[a][b] = AT(Lvs, k, a, b, nv, nv);
      }
    }
#pragma unroll (Unroll<NS>::value)
    for (int r = 0; r < RM; ++r) {
      if (r >= R) break;
      float w[NS];
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        float acc = 0.0f;
        if (k < N - 1) {
#pragma unroll (Unroll<NS>::value)
          for (int j = 0; j < NS; ++j) {
            if (j >= ns) break;
            acc += AT(rb, k, r, j, R, ns) * AT(P, k + 1, i, j, ns, ns);
          }
        }
        w[i] = acc + p[r][i];
      }
      float kff[NV];
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int i = 0; i < NS; ++i) {
          if (i >= ns) break;
          acc += w[i] * AT(B, k, i, a, ns, nv);
        }
        kff[a] = AT(qv, k, r, a, R, nv) + acc;
      }
      cho_solve<NV>(Lv, kff, nv);
#pragma unroll (Unroll<NS>::value)
      for (int a = 0; a < NV; ++a) {
        if (a >= nv) break;
        kff[a] = -kff[a];
        AT(dzv, k, r, a, R, nv) = kff[a];
      }
#pragma unroll (Unroll<NS>::value)
      for (int i = 0; i < NS; ++i) {
        if (i >= ns) break;
        float acc = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int t = 0; t < NS; ++t) {
          if (t >= ns) break;
          acc += w[t] * AT(A, k, t, i, ns, ns);
        }
        float acc2 = 0.0f;
#pragma unroll (Unroll<NS>::value)
        for (int a = 0; a < NV; ++a) {
          if (a >= nv) break;
          acc2 += kff[a] * AT(Mvs, k, a, i, nv, ns);
        }
        p[r][i] = (AT(qs, k, r, i, R, ns) + acc) + acc2;
        AT(dzs, k, r, i, R, ns) = p[r][i];
      }
    }
  }
  float L0[NS][NS];
#pragma unroll (Unroll<NS>::value)
  for (int i = 0; i < NS; ++i) {
    if (i >= ns) break;
#pragma unroll (Unroll<NS>::value)
    for (int j = 0; j < NS; ++j) {
      if (j >= ns) break;
      L0[i][j] = L0in[((long)i * ns + j) * L + l];
    }
  }
  forward_sweep<NS, NV, RM>(l, L, N, ns, nv, R, s0mask, L0, p, P, Kg, A, B, rb, dzs, dzv,
                            lam);
}

// Exact-size instantiation: every loop bound is a compile-time constant.
template <int NS, int NV, int R>
__global__ void __launch_bounds__(128) factor_solve_fixed(
    int L, int N, unsigned s0mask, const float* Qss, const float* Qsv, const float* Qvv,
    const float* A, const float* B, const float* qs, const float* qv, const float* rb,
    float* P, float* Lv, float* Kg, float* Mvs, float* L0, float* ok, float* dzs,
    float* dzv, float* lam) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  factor_solve_lane<NS, NV, R>(l, L, N, NS, NV, R, s0mask, Qss, Qsv, Qvv, A, B, qs, qv, rb,
                               P, Lv, Kg, Mvs, L0, ok, dzs, dzv, lam);
}

constexpr int kNsMax = 16, kNvMax = 8, kRMax = 8;

__global__ void __launch_bounds__(128) factor_solve_generic(
    int L, int N, int ns, int nv, int R, unsigned s0mask, const float* Qss,
    const float* Qsv, const float* Qvv, const float* A, const float* B, const float* qs,
    const float* qv, const float* rb, float* P, float* Lv, float* Kg, float* Mvs,
    float* L0, float* ok, float* dzs, float* dzv, float* lam) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  factor_solve_lane<kNsMax, kNvMax, kRMax>(l, L, N, ns, nv, R, s0mask, Qss, Qsv, Qvv, A, B,
                                           qs, qv, rb, P, Lv, Kg, Mvs, L0, ok, dzs, dzv,
                                           lam);
}

template <int NS, int NV, int R>
__global__ void __launch_bounds__(128) resolve_fixed(
    int L, int N, unsigned s0mask, const float* P, const float* Lv, const float* Kg,
    const float* Mvs, const float* L0, const float* A, const float* B, const float* qs,
    const float* qv, const float* rb, float* dzs, float* dzv, float* lam) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  resolve_lane<NS, NV, R>(l, L, N, NS, NV, R, s0mask, P, Lv, Kg, Mvs, L0, A, B, qs, qv, rb,
                          dzs, dzv, lam);
}

__global__ void __launch_bounds__(128) resolve_generic(
    int L, int N, int ns, int nv, int R, unsigned s0mask, const float* P, const float* Lv,
    const float* Kg, const float* Mvs, const float* L0, const float* A, const float* B,
    const float* qs, const float* qv, const float* rb, float* dzs, float* dzv,
    float* lam) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  resolve_lane<kNsMax, kNvMax, kRMax>(l, L, N, ns, nv, R, s0mask, P, Lv, Kg, Mvs, L0, A, B,
                                      qs, qv, rb, dzs, dzv, lam);
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int dto_factor_solve(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                const void* Qss, const void* Qsv, const void* Qvv,
                                const void* A, const void* B, const void* qs,
                                const void* qv, const void* rb, void* P, void* Lv,
                                void* Kg, void* Mvs, void* L0, void* ok, void* dzs,
                                void* dzv, void* lam, void* stream) {
  if (ns < 1 || ns > kNsMax || nv < 1 || nv > kNvMax || R < 1 || R > kRMax || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((L + kThreads - 1) / kThreads);
#define ARGS                                                                             \
  (const float*)Qss, (const float*)Qsv, (const float*)Qvv, (const float*)A,             \
      (const float*)B, (const float*)qs, (const float*)qv, (const float*)rb, (float*)P, \
      (float*)Lv, (float*)Kg, (float*)Mvs, (float*)L0, (float*)ok, (float*)dzs,         \
      (float*)dzv, (float*)lam
  if (ns == 8 && nv == 3 && R == 3)
    factor_solve_fixed<8, 3, 3><<<grid, kThreads, 0, s>>>(L, N, s0mask, ARGS);
  else
    factor_solve_generic<<<grid, kThreads, 0, s>>>(L, N, ns, nv, R, s0mask, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}

extern "C" int dto_resolve(int L, int N, int ns, int nv, int R, unsigned s0mask,
                           const void* P, const void* Lv, const void* Kg, const void* Mvs,
                           const void* L0, const void* A, const void* B, const void* qs,
                           const void* qv, const void* rb, void* dzs, void* dzv, void* lam,
                           void* stream) {
  if (ns < 1 || ns > kNsMax || nv < 1 || nv > kNvMax || R < 1 || R > kRMax || N < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned grid = (unsigned)((L + kThreads - 1) / kThreads);
#define ARGS                                                                            \
  (const float*)P, (const float*)Lv, (const float*)Kg, (const float*)Mvs,              \
      (const float*)L0, (const float*)A, (const float*)B, (const float*)qs,            \
      (const float*)qv, (const float*)rb, (float*)dzs, (float*)dzv, (float*)lam
  if (ns == 8 && nv == 3 && R == 2)
    resolve_fixed<8, 3, 2><<<grid, kThreads, 0, s>>>(L, N, s0mask, ARGS);
  else
    resolve_generic<<<grid, kThreads, 0, s>>>(L, N, ns, nv, R, s0mask, ARGS);
#undef ARGS
  return (int)cudaGetLastError();
}
