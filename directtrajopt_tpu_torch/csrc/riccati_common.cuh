// Declarations shared by the Riccati kernels' sources (riccati_kernel.cu:
// the grouped and column kernels; riccati_classed_*.cu: the size-class
// kernels): the launch constants, the tensors a launch reads and writes,
// and the register Cholesky and solve.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroupBlock = 64;  // threads per block
constexpr int kBlockSmem = 227 * 1024;  // a block's shared memory on the H100
// Resident blocks per SM the register budget is cut for: 8 → 128 registers,
// so at (8,3,3) 8 blocks × 8 lanes × 132 SMs = 8,448 lanes run in one wave
// (8 × 23.8 KB of shared memory fits the SM's 227 KB). Beyond n_s = 8, 4 →
// 255 registers: at 128 they spill at n_s = 18 (a 408-byte stack frame);
// path 7's 128 lanes fill 64 blocks at n_s = 18 and 32 at 10, one an SM.
constexpr int kGroupMinBlocks = 8, kGroupMinBlocksWide = 4;
// Knot buffers in the ring (2: double-buffered). Rings of 3 and 4 gained at
// most 8 % at either shape on the H100, about the spread of two timings of
// one build (tools/torch_k1_rings.py): the sweep waits on its arithmetic,
// not on its loads.
constexpr int kStages = 2;
// K2 takes up to the Pallas resolve's 40 right-hand sides (the L-BFGS SMW
// correction sends 2m ≤ 40): resolve_columns in one launch, resolve_classed
// in tiles of its class's RC.
constexpr int kRResolveMax = 40;

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// Floats per cp.async copy (16, 8 or 4 bytes) for a block of S floats that
// starts a multiple of S floats from a 16-byte-aligned base.
__host__ __device__ constexpr int chunk_floats(int S) {
  return (S % 4 == 0) ? 4 : (S % 2 == 0) ? 2 : 1;
}

struct FactorIn {
  const float *Qss, *Qsv, *Qvv, *A, *B, *qs, *qv, *b;
};
struct FactorOut {
  float *P, *Lv, *Kg, *Mvs, *L0, *ok, *dzs, *dzv, *lam;
};

// What the forward sweep reads and writes: P_k and Kg_k (K1's outputs, or
// K2's stored factors), A_k, B_k, b_k and the stashed p_k, kff_k (in dzs,
// dzv, written by the backward sweep of the same group); it overwrites dzs
// and dzv and writes λ.
struct ForwardIO {
  const float *P, *Kg, *A, *B, *b;
  float *dzs, *dzv, *lam;
};

struct ResolveIn {
  const float *P, *Lv, *Kg, *Mvs, *L0, *A, *B, *qs, *qv, *b;
};

// Cholesky of the n×n leading block of H into Lf; identity on failure.
template <int M>
__device__ __forceinline__ bool chol_or_identity(const float (&H)[M][M], float (&Lf)[M][M],
                                                 int n) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
#pragma unroll
    for (int c = 0; c < M; ++c) Lf[r][c] = 0.0f;
  }
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
    float d = H[r][r];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      if (t >= r) break;
      d -= Lf[r][t] * Lf[r][t];
    }
    if (!(d > 0.0f)) ok = false;
    const float s = sqrtf(d);
    Lf[r][r] = s;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      if (q <= r) continue;
      if (q >= n) break;
      float v = H[q][r];
#pragma unroll
      for (int t = 0; t < M; ++t) {
        if (t >= r) break;
        v -= Lf[q][t] * Lf[r][t];
      }
      Lf[q][r] = v / s;
    }
  }
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r >= n) break;
#pragma unroll
    for (int c = 0; c < M; ++c) {
      if (c > r) break;
      if (!isfinite(Lf[r][c])) ok = false;
    }
  }
  if (!ok) {
#pragma unroll
    for (int r = 0; r < M; ++r) {
      if (r >= n) break;
#pragma unroll
      for (int c = 0; c < M; ++c) Lf[r][c] = (r == c) ? 1.0f : 0.0f;
    }
  }
  return ok;
}

// x ← (L Lᵀ)⁻¹ x for the n leading entries.
template <int M>
__device__ __forceinline__ void cho_solve(const float (&Lf)[M][M], float (&x)[M], int n) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i >= n) break;
    float s = x[i];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      if (t >= i) break;
      s -= Lf[i][t] * x[t];
    }
    x[i] = s / Lf[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    if (i >= n) continue;
    float s = x[i];
#pragma unroll
    for (int t = 0; t < M; ++t) {
      if (t <= i) continue;
      if (t >= n) break;
      s -= Lf[t][i] * x[t];
    }
    x[i] = s / Lf[i][i];
  }
}

}  // namespace
