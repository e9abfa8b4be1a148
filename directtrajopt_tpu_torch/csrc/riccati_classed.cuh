// Size-class Riccati kernels for Hopper (sm_90a), float32: K1
// (factor_solve_classed) and K2 (resolve_classed) at every shape within
// the Pallas kernels' caps that has no exact instance.
//
// Replace, at those shapes, the two Pallas kernels of
// directtrajopt_tpu/ops/riccati_kernel.py: _fused_kernel (:342; wrapper
// _factor_solve_pallas) and _resolve_kernel (:488; _resolve_pallas), which
// JAX traces at whatever shape it is given within 1 ≤ n_s, n_v ≤ 24 and
// R ≤ 40 (pallas_eligible). They compute what factor_solve_grouped and
// resolve_grouped compute (riccati_kernel.cu), on the same lane-major
// tensors, with no copy.
//
// The design is the grouped kernels' at run-time sizes. Each kernel is
// templated on a size class (NSC, NVC, RC) and takes the actual (n_s, n_v,
// R) ≤ the class at run time:
//
// * A group of G threads serves one lane, G the least power of two ≥ the
//   class's larger bound (≥ n_v, so threads can own Hvv's rows); thread i
//   owns row i of P and entry i of each p_r and s_r where i < n_s. Threads
//   of a last, ragged lane load from lane L − 1 and store nothing; threads
//   past n_s own no row; all take part in every __syncwarp.
// * Register arrays (P's row, p, and up to NVC = kRegNv = 4 the Hvv factor
//   and the kff and v vectors) are sized by the class and indexed only by
//   loops unrolled to the class bound. A term whose index is past the
//   run-time size is skipped (fma_if: the sum is kept as it was), not added
//   as a zero, so at a shape the order of summation is the exact
//   instance's (at the exact shapes the outputs are bitwise
//   factor_solve_grouped's); the loops stay branch-free, so the compiler
//   interleaves their independent chains as it does in the exact
//   instances. No register array is indexed at run time.
// * Shared memory offsets and the lane stride come from the class
//   (ClassLayout); each block is stored densely with its run-time row
//   stride. Each knot's blocks are double-buffered by cp.async in 16-, 8-
//   or 4-byte copies, the widest that the block's run-time length divides:
//   a 6 × 3 block is 72 bytes, so it starts off 16-byte alignment at every
//   other knot.
// * Beyond NVC = kRegNv (the (8,8), (16,8) and (24,24) classes; an Hvv of
//   24 × 24 would be 576 registers a thread) the group factors Hvv in the
//   lane's shared memory as it factors P0 (chol_shared_rt: every thread
//   sums each pivot, so `ok` agrees; each row's owner writes its row), and
//   solves Kg's columns and the kff and v vectors a thread each.
// * Classes (ops/riccati_kernel.py SIZE_CLASSES; the wrapper takes the
//   least that holds a shape, size_class()): (4,4), (8,4), (16,4), (8,8),
//   (16,8) and (24,24), each with RC = 8. K1 takes R ≤ 8 (the wrapper
//   splits beyond); K2 R ≤ 40 in tiles of RC over blockIdx.y, each tile a
//   full sweep of its columns, bitwise a launch of them alone. Dynamic
//   shared memory, 30.3 KB a block at (4,4,8) to 85.5 KB at (24,24,8) (two
//   lanes of 10,944 floats); the C entries check the bytes the wrapper
//   computed (classed_smem_bytes) against the class's own and refuse a call
//   beyond a block's 227 KB.
//
// Bound at path 7e's shape (the scaling family at state_dim 4): K1 at
// (6,3,3), N=51, reads each input and writes each output once, 58.8 KB a
// lane: 7.5 MB and 2.2 µs at 128 lanes (3.35 TB/s; the FLOP bound is
// lower). Like the grouped kernels it waits on each knot's dependent chain,
// not on its loads.
//
// Division and sqrt are IEEE (no fast math): correctly rounded.

#pragma once

#include "riccati_common.cuh"

namespace {

// Up to this class bound on n_v every thread of a group factors Hvv in
// registers (and solves the kff and v vectors there); beyond, the group
// factors it in the lane's shared memory. At 8 the (16,8) class took 304
// bytes of stack on the H100 (its H, kff, v and Mvs column at 8 beside P's
// row at 16); the shared path keeps every class below 255 registers.
constexpr int kRegNv = 4;

// Shared memory of one lane of the size class (NSC, NVC, RC), in floats:
// factor_solve_grouped's blocks at the class's sizes, each holding the
// run-time block densely (row stride n_s or n_v). Beyond kRegNv it adds H
// (Hvv, then its factor Lv), M (Mvs) and F (the kff vectors backward, the
// v vectors forward). Every block starts on 16 bytes; the lane stride is ≡
// max(G, 4) (mod 32 banks).
template <int NSC, int NVC, int RC>
struct ClassLayout {
  static constexpr int G = pow2_at_least(NSC > NVC ? NSC : NVC), lanes = kGroupBlock / G;
  static constexpr bool shared_v = NVC > kRegNv;
  static constexpr int Qss = 0, Qsv = align4(Qss + NSC * NSC), Qvv = align4(Qsv + NSC * NVC),
                       A = align4(Qvv + NVC * NVC), B = align4(A + NSC * NSC),
                       qs = align4(B + NSC * NVC), qv = align4(qs + RC * NSC),
                       b = align4(qv + RC * NVC), bwd = align4(b + RC * NSC);
  // K2's backward buffer: P_{k+1}, Mvs_k and Lv_k in the places of Qss, Qsv
  // and Qvv
  static constexpr int rP = Qss, rMvs = Qsv, rLv = Qvv;
  static constexpr int fP = 0, fKg = align4(fP + NSC * NSC), fA = align4(fKg + NVC * NSC),
                       fB = align4(fA + NSC * NSC), fb = align4(fB + NSC * NVC),
                       fp = align4(fb + RC * NSC), fkff = align4(fp + RC * NSC),
                       fwd = align4(fkff + RC * NVC);
  static constexpr int buf = bwd > fwd ? bwd : fwd;
  static constexpr int sv = shared_v ? 1 : 0;
  static constexpr int PA = kStages * buf, PB = align4(PA + NSC * NSC),
                       W = align4(PB + NSC * NVC), Kg = align4(W + RC * NSC),
                       Pn = align4(Kg + NVC * NSC), S = align4(Pn + NSC * NSC),
                       H = align4(S + RC * NSC), M = align4(H + sv * NVC * NVC),
                       F = align4(M + sv * NVC * NSC), end = align4(F + sv * RC * NVC);
  static constexpr int pad = G < 4 ? 4 : G;
  static constexpr int stride = end + (pad - end % 32 + 32) % 32;
  static constexpr int bytes = lanes * stride * (int)sizeof(float);
  static_assert(32 % G == 0, "a group must not straddle two warps");
  static_assert(bytes <= kBlockSmem, "a block's shared memory");
};

// The right-hand-side columns a launch (or K2's tile) sweeps: n columns
// from r0 of the R that the (L, R, N, d) stacks hold.
struct Cols {
  int R, r0, n;
};

// acc + a·b where `on`, acc itself where not: a term past the run-time size
// is skipped, and the loop around it stays branch-free.
__device__ __forceinline__ float fma_if(bool on, float acc, float a, float b) {
  return on ? acc + a * b : acc;
}

// The group's share of the cp.async copies of nseg segments of S floats (S
// and nseg at run time), `gstride` floats apart in global memory, into
// contiguous shared memory, in copies of the widest of 16, 8 and 4 bytes
// that S divides: every segment starts a multiple of S floats from a
// 16-byte-aligned base in both memories, so each copy is aligned to its
// size whatever the knot. Thread gi takes copies gi, gi + G, … of each
// segment.
template <int G>
__device__ __forceinline__ void copy_async_rt(float* dst, const float* src, int S, int nseg,
                                              long gstride, int gi) {
  const int C = chunk_floats(S), per = S / C;
  for (int r = 0; r < nseg; ++r) {
    for (int q = gi; q < per; q += G) {
      float* d = dst + r * S + q * C;
      const float* s = src + r * gstride + q * C;
      if (C == 4)
        __pipeline_memcpy_async(d, s, 16);
      else if (C == 2)
        __pipeline_memcpy_async(d, s, 8);
      else
        __pipeline_memcpy_async(d, s, 4);
    }
  }
}

// x ← (L Lᵀ)⁻¹ x in shared memory: x[i·xs] for i < n, L's lower triangle
// row-major with row stride n; cho_solve's order of summation.
__device__ __forceinline__ void cho_solve_shared(const float* Lm, float* x, int xs, int n) {
  for (int i = 0; i < n; ++i) {
    float s = x[i * xs];
    for (int t = 0; t < i; ++t) s -= Lm[i * n + t] * x[t * xs];
    x[i * xs] = s / Lm[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = x[i * xs];
    for (int t = i + 1; t < n; ++t) s -= Lm[t * n + i] * x[t * xs];
    x[i * xs] = s / Lm[i * n + i];
  }
}

// chol_or_identity in place at a run-time n ≤ M: the lower triangle of H
// becomes the factor (the identity where a pivot is ≤ 0 or an entry not
// finite), the upper triangle zero; the same operations in the same order,
// each past n skipped by a select, so the code has no branch.
template <int M>
__device__ __forceinline__ bool chol_regs(float (&H)[M][M], int n) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    float d = H[r][r];
#pragma unroll
    for (int t = 0; t < r; ++t) d -= H[r][t] * H[r][t];
    ok = ok && (r >= n || d > 0.0f);
    const float s = sqrtf(d);
    if (r < n) H[r][r] = s;
#pragma unroll
    for (int q = r + 1; q < M; ++q) {
      float v = H[q][r];
#pragma unroll
      for (int t = 0; t < r; ++t) v -= H[q][t] * H[r][t];
      if (q < n) H[q][r] = v / s;
    }
  }
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c <= r; ++c) ok = ok && (r >= n || isfinite(H[r][c]));
#pragma unroll
  for (int r = 0; r < M; ++r)
#pragma unroll
    for (int c = 0; c < M; ++c)
      H[r][c] = ok ? ((c <= r) ? H[r][c] : 0.0f) : ((r == c) ? 1.0f : 0.0f);
  return ok;
}

// cho_solve at a run-time n ≤ M, each step past n skipped by a select.
template <int M>
__device__ __forceinline__ void cho_solve_regs(const float (&Lf)[M][M], float (&x)[M], int n) {
#pragma unroll
  for (int i = 0; i < M; ++i) {
    float s = x[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s -= Lf[i][t] * x[t];
    if (i < n) x[i] = s / Lf[i][i];
  }
#pragma unroll
  for (int i = M - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int t = i + 1; t < M; ++t) s = t < n ? s - Lf[t][i] * x[t] : s;
    if (i < n) x[i] = s / Lf[i][i];
  }
}

// chol_shared at a run-time n: the n×n matrix row-major (stride n) in the
// lane's shared memory M, factored in place by the group, column by
// column; thread gi < n owns row gi. Every thread sums each pivot, so `ok`
// agrees across the group. The lower triangle then holds the factor (the
// identity on failure, whose rows are written whole).
__device__ __forceinline__ bool chol_shared_rt(float* M, int n, int gi) {
  bool ok = true;
  const bool owner = gi < n;
  for (int c = 0; c < n; ++c) {
    float d = M[c * n + c];
    for (int t = 0; t < c; ++t) d -= M[c * n + t] * M[c * n + t];
    if (!(d > 0.0f)) ok = false;
    const float s = sqrtf(d);
    float v = s;
    if (owner && gi > c) {
      float acc = M[gi * n + c];
      for (int t = 0; t < c; ++t) acc -= M[gi * n + t] * M[c * n + t];
      v = acc / s;
    }
    __syncwarp();
    if (owner && gi >= c) M[gi * n + c] = v;
    __syncwarp();
  }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j <= i; ++j)
      if (!isfinite(M[i * n + j])) ok = false;
  __syncwarp();
  if (!ok && owner) {
    for (int j = 0; j < n; ++j) M[gi * n + j] = (gi == j) ? 1.0f : 0.0f;
  }
  __syncwarp();
  return ok;
}

// Backward sweep of K1: knot k's input blocks of lane l into `buf`.
template <int NSC, int NVC, int RC>
__device__ __forceinline__ void load_backward_classed(float* buf, const FactorIn& in, int l,
                                                      int N, int k, int ns, int nv, Cols cols,
                                                      int gi) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;
  const long rh = ((long)l * cols.R + cols.r0) * N + k;
  const long rs = N;
  copy_async_rt<G>(buf + Lay::Qss, in.Qss + st * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::Qsv, in.Qsv + st * ns * nv, ns * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::Qvv, in.Qvv + st * nv * nv, nv * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::A, in.A + st * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::B, in.B + st * ns * nv, ns * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::qs, in.qs + rh * ns, ns, cols.n, rs * ns, gi);
  copy_async_rt<G>(buf + Lay::qv, in.qv + rh * nv, nv, cols.n, rs * nv, gi);
  copy_async_rt<G>(buf + Lay::b, in.b + rh * ns, ns, cols.n, rs * ns, gi);
}

// Backward sweep of K2: knot k's P_{k+1} (for k < N − 1), Mvs_k, Lv_k,
// A_k, B_k and right-hand sides of lane l into `buf`.
template <int NSC, int NVC, int RC>
__device__ __forceinline__ void load_resolve_classed(float* buf, const ResolveIn& in, int l,
                                                     int N, int k, int ns, int nv, Cols cols,
                                                     int gi) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;
  const long rh = ((long)l * cols.R + cols.r0) * N + k;
  const long rs = N;
  if (k + 1 < N) copy_async_rt<G>(buf + Lay::rP, in.P + (st + 1) * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::rMvs, in.Mvs + st * nv * ns, nv * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::rLv, in.Lv + st * nv * nv, nv * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::A, in.A + st * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::B, in.B + st * ns * nv, ns * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::qs, in.qs + rh * ns, ns, cols.n, rs * ns, gi);
  copy_async_rt<G>(buf + Lay::qv, in.qv + rh * nv, nv, cols.n, rs * nv, gi);
  copy_async_rt<G>(buf + Lay::b, in.b + rh * ns, ns, cols.n, rs * ns, gi);
}

// Forward sweep: knot k's P, Kg, A, B, b and the stashed p_k, kff_k of
// lane l into `buf`.
template <int NSC, int NVC, int RC>
__device__ __forceinline__ void load_forward_classed(float* buf, const ForwardIO& io, int l,
                                                     int N, int k, int ns, int nv, Cols cols,
                                                     int gi) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;
  const long rh = ((long)l * cols.R + cols.r0) * N + k;
  const long rs = N;
  copy_async_rt<G>(buf + Lay::fP, io.P + st * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::fKg, io.Kg + st * nv * ns, nv * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::fA, io.A + st * ns * ns, ns * ns, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::fB, io.B + st * ns * nv, ns * nv, 1, 0, gi);
  copy_async_rt<G>(buf + Lay::fb, io.b + rh * ns, ns, cols.n, rs * ns, gi);
  copy_async_rt<G>(buf + Lay::fp, io.dzs + rh * ns, ns, cols.n, rs * ns, gi);
  copy_async_rt<G>(buf + Lay::fkff, io.dzv + rh * nv, nv, cols.n, rs * nv, gi);
}

// Entry a of each kff_r = −Hvv⁻¹(qv_r + Bᵀw_r) with Hvv's factor Lf in
// registers (every thread, NVC ≤ kRegNv), and entry gi of p_r = (qs_r +
// Aᵀw_r) + Mvsᵀkff_r for the row owners; p_k and kff_k stashed in dzs,
// dzv. Mvs column gi comes from `mvs(a)`. K1 and K2 share it.
template <int NSC, int NVC, int RC, class MvsCol>
__device__ __forceinline__ void rhs_backward_regs(const float (&Lf)[NVC][NVC], float (&p)[RC],
                                                  const float* sW, const float* A, const float* B,
                                                  const float* qs, const float* qv, MvsCol mvs,
                                                  float* dzs, float* dzv, long l, int N, int k,
                                                  int ns, int nv, Cols cols, bool own,
                                                  bool store, int gi) {
  constexpr int G = ClassLayout<NSC, NVC, RC>::G;
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    if (r >= cols.n) break;
    float kff[NVC];
#pragma unroll
    for (int a = 0; a < NVC; ++a) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NSC; ++i) acc = fma_if(i < ns, acc, sW[r * ns + i], B[i * nv + a]);
      kff[a] = qv[r * nv + a] + acc;
    }
    cho_solve_regs<NVC>(Lf, kff, nv);
#pragma unroll
    for (int a = 0; a < NVC; ++a) kff[a] = -kff[a];
    const long rk = (l * cols.R + cols.r0 + r) * N + k;
    if (own) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, sW[r * ns + t], A[t * ns + gi]);
      float acc2 = 0.0f;
#pragma unroll
      for (int a = 0; a < NVC; ++a) acc2 = fma_if(a < nv, acc2, kff[a], mvs(a));
      p[r] = (qs[r * ns + gi] + acc) + acc2;
      if (store) dzs[rk * ns + gi] = p[r];  // stash p_k
    }
    if (store) {
#pragma unroll
      for (int a = 0; a < NVC; ++a)
        if (a < nv && ((r * nv + a) & (G - 1)) == gi) dzv[rk * nv + a] = kff[a];  // kff_k
    }
  }
}

// The same beyond kRegNv, by the group in the lane's shared memory: thread
// a < n_v entry a of each mv_r (in F), solved against Lv (row-major,
// stride n_v) a column a thread, then the row owners' p_r.
template <int NSC, int NVC, int RC>
__device__ __forceinline__ void rhs_backward_shared(const float* Lm, float* sF, float (&p)[RC],
                                                    const float* sW, const float* A,
                                                    const float* B, const float* qs,
                                                    const float* qv, const float* Mvs, int mvs_ld,
                                                    float* dzs, float* dzv, long l, int N, int k,
                                                    int ns, int nv, Cols cols, bool own,
                                                    bool store, int gi) {
  constexpr int G = ClassLayout<NSC, NVC, RC>::G;
  const int R = cols.n;
  if (gi < nv) {
    for (int r = 0; r < R; ++r) {
      float acc = 0.0f;
#pragma unroll
      for (int i = 0; i < NSC; ++i) acc = fma_if(i < ns, acc, sW[r * ns + i], B[i * nv + gi]);
      sF[r * nv + gi] = qv[r * nv + gi] + acc;
    }
  }
  __syncwarp();
  for (int r = gi; r < R; r += G) {
    cho_solve_shared(Lm, sF + r * nv, 1, nv);
    for (int a = 0; a < nv; ++a) sF[r * nv + a] = -sF[r * nv + a];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < RC; ++r) {
    if (r >= R) break;
    const long rk = (l * cols.R + cols.r0 + r) * N + k;
    if (own) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, sW[r * ns + t], A[t * ns + gi]);
      float acc2 = 0.0f;
      for (int a = 0; a < nv; ++a) acc2 += sF[r * nv + a] * Mvs[a * mvs_ld + gi];
      p[r] = (qs[r * ns + gi] + acc) + acc2;
      if (store) dzs[rk * ns + gi] = p[r];  // stash p_k
    }
    if (store) {
      for (int a = gi; a < nv; a += G) dzv[rk * nv + a] = sF[r * nv + a];  // stash kff_k
    }
  }
}

// initial_and_forward at run-time sizes, for the launch's columns `cols`.
// On entry thread gi < n_s holds entry gi of each p_0, the lane's masked
// initial factor L0 lies row-major in the lane's shared Pn, and the group
// has stashed p_k, kff_k in dzs, dzv. s_0 is solved in place in the lane's
// S, a column a thread.
template <int NSC, int NVC, int RC>
__device__ __forceinline__ void classed_forward(float* sh, const float (&p)[RC],
                                                const ForwardIO& io, int l, int ls, bool store,
                                                int N, int ns, int nv, Cols cols,
                                                unsigned s0mask, int gi) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G, D = kStages;
  const int R = cols.n;
  const bool own = gi < ns;
  float* const sS = sh + Lay::S;
  const float* const L0 = sh + Lay::Pn;
  if (own) {
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= R) break;
      sS[r * ns + gi] = ((s0mask >> gi) & 1u) ? p[r] : 0.0f;
    }
  }
  __syncwarp();
  for (int r = gi; r < R; r += G) {
    float* x = sS + r * ns;
    cho_solve_shared(L0, x, 1, ns);
    for (int i = 0; i < ns; ++i) x[i] = ((s0mask >> i) & 1u) ? -x[i] : 0.0f;
  }
  // the group's stores of the stashes (and of K1's P and Kg), before it
  // reads them back
  __threadfence_block();
  __syncwarp();

#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (q < N)
      load_forward_classed<NSC, NVC, RC>(sh + q * Lay::buf, io, ls, N, q, ns, nv, cols, gi);
    __pipeline_commit();
  }
  for (int k = 0; k < N; ++k) {
    const float* cur = sh + (k % D) * Lay::buf;
    if (k + D - 1 < N)
      load_forward_classed<NSC, NVC, RC>(sh + ((k + D - 1) % D) * Lay::buf, io, ls, N,
                                         k + D - 1, ns, nv, cols, gi);
    __pipeline_commit();
    __pipeline_wait_prior(D - 1);
    __syncwarp();
    const float* fP = cur + Lay::fP;
    const float* fKg = cur + Lay::fKg;
    const float* fA = cur + Lay::fA;
    const float* fB = cur + Lay::fB;
    const float* fb = cur + Lay::fb;
    const float* fp = cur + Lay::fp;
    const float* fkff = cur + Lay::fkff;
    float* const sV = sh + Lay::F;
    if constexpr (Lay::shared_v) {  // entry a of each v_r by thread a, in F
      if (gi < nv) {
        for (int r = 0; r < R; ++r) {
          const float* sr = sS + r * ns;
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, sr[j], fKg[gi * ns + j]);
          const float v = acc + fkff[r * nv + gi];
          sV[r * nv + gi] = v;
          if (store) io.dzv[(((long)l * cols.R + cols.r0 + r) * N + k) * nv + gi] = v;
        }
      }
      __syncwarp();
    }
    float sn[RC];
#pragma unroll
    for (int r = 0; r < RC; ++r) {
      if (r >= R) break;
      const float* sr = sS + r * ns;
      const long rc = (long)l * cols.R + cols.r0 + r;
      float v[Lay::shared_v ? 1 : NVC];  // v_r, every thread (NVC ≤ kRegNv)
      if constexpr (!Lay::shared_v) {
#pragma unroll
        for (int a = 0; a < NVC; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, sr[j], fKg[a * ns + j]);
          v[a] = acc + fkff[r * nv + a];
        }
      }
      if (own) {
        if (k >= 1) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, fP[gi * ns + j], sr[j]);
          if (store) io.lam[(rc * (N - 1) + k - 1) * ns + gi] = -(acc + fp[r * ns + gi]);
        }
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, sr[j], fA[gi * ns + j]);
        float acc2 = 0.0f;
        if constexpr (!Lay::shared_v) {
#pragma unroll
          for (int a = 0; a < NVC; ++a) acc2 = fma_if(a < nv, acc2, v[a], fB[gi * nv + a]);
        } else {
          for (int a = 0; a < nv; ++a) acc2 += sV[r * nv + a] * fB[gi * nv + a];
        }
        sn[r] = acc + acc2 + fb[r * ns + gi];
        if (store) io.dzs[(rc * N + k) * ns + gi] = sr[gi];
      }
      if constexpr (!Lay::shared_v) {
        if (store) {
#pragma unroll
          for (int a = 0; a < NVC; ++a)
            if (a < nv && ((r * nv + a) & (G - 1)) == gi) io.dzv[(rc * N + k) * nv + a] = v[a];
        }
      }
    }
    __syncwarp();
    if (own) {
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        if (r >= R) break;
        sS[r * ns + gi] = sn[r];
      }
    }
  }
}

// K1 at run-time (n_s, n_v, R) ≤ (NSC, NVC, RC): factor_solve_grouped's
// design and order of summation. Every class is cut for 4 blocks an SM
// (255 registers): at 8 (128 registers) the (4,4) and (8,4) classes
// spilled on the H100.
template <int NSC, int NVC, int RC>
__global__ void __launch_bounds__(kGroupBlock, kGroupMinBlocksWide)
    factor_solve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask, FactorIn in,
                         FactorOut out) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G, D = kStages;
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / G, gi = threadIdx.x % G;
  const int l = blockIdx.x * Lay::lanes + grp;
  const bool store = l < L;
  const int ls = store ? l : L - 1;
  const bool own = gi < ns;
  const Cols cols{R, 0, R};
  float* const sh = smem + grp * Lay::stride;
  float* const sPA = sh + Lay::PA;
  float* const sPB = sh + Lay::PB;
  float* const sW = sh + Lay::W;
  float* const sKg = sh + Lay::Kg;
  float* const sPn = sh + Lay::Pn;
  // the loops over n_v: to the class bound in registers, to n_v in shared
  // memory
  constexpr int NVR = Lay::shared_v ? 1 : NVC;

  float Prow[NSC];  // row gi of P_{k+1}
  float p[RC];      // entry gi of p_{k+1}, per right-hand side
#pragma unroll
  for (int j = 0; j < NSC; ++j) Prow[j] = 0.0f;
#pragma unroll
  for (int r = 0; r < RC; ++r) p[r] = 0.0f;
  bool ok = true;

#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (N - 1 - q >= 0)
      load_backward_classed<NSC, NVC, RC>(sh + q * Lay::buf, in, ls, N, N - 1 - q, ns, nv, cols,
                                          gi);
    __pipeline_commit();
  }
  for (int k = N - 1, it = 0; k >= 0; --k, ++it) {
    const float* cur = sh + (it % D) * Lay::buf;
    if (k - (D - 1) >= 0)
      load_backward_classed<NSC, NVC, RC>(sh + ((it + D - 1) % D) * Lay::buf, in, ls, N,
                                          k - (D - 1), ns, nv, cols, gi);
    __pipeline_commit();
    __pipeline_wait_prior(D - 1);
    __syncwarp();
    const float* Qss = cur + Lay::Qss;
    const float* Qsv = cur + Lay::Qsv;
    const float* Qvv = cur + Lay::Qvv;
    const float* A = cur + Lay::A;
    const float* B = cur + Lay::B;
    const float* qs = cur + Lay::qs;
    const float* qv = cur + Lay::qv;
    const float* rb = cur + Lay::b;
    const long st = (long)l * N + k;

    // row gi of PA = P·A and PB = P·B; entry gi of w_r = P·b_r + p_r. Beyond
    // n_s = 8 the outer loops of PA and of P's update unroll by 4, not
    // fully: fully unrolled, the (16,4) class took 64 bytes of stack on
    // the H100, and the (24,24) class at (18,3,3) ran 2.35 ms against 1.69
    if (own) {
#pragma unroll (NSC > 8 ? 4 : NSC)
      for (int j = 0; j < NSC; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, Prow[t], A[t * ns + j]);
        if (j < ns) sPA[gi * ns + j] = acc;
      }
#pragma unroll
      for (int a = 0; a < (Lay::shared_v ? nv : NVC); ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, Prow[t], B[t * nv + a]);
        if (a < nv) sPB[gi * nv + a] = acc;
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, rb[r * ns + j], Prow[j]);
        if (r < R) sW[r * ns + gi] = acc + p[r];
      }
    }
    __syncwarp();

    float mcol[NVR];  // column gi of Mvs (NVC ≤ kRegNv)
    if constexpr (!Lay::shared_v) {
      // Hvv = Qvv + BᵀPB (its lower triangle) and its Cholesky, every thread
      float H[NVC][NVC];
#pragma unroll
      for (int a = 0; a < NVC; ++a) {
#pragma unroll
        for (int c = 0; c <= a; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, B[t * nv + a], sPB[t * nv + c]);
          H[a][c] = Qvv[a * nv + c] + acc;
        }
      }
      ok = chol_regs<NVC>(H, nv) && ok;
      if (store) {
#pragma unroll
        for (int a = 0; a < NVC; ++a)
#pragma unroll
          for (int c = 0; c < NVC; ++c)
            if (a < nv && c < nv && ((a * nv + c) & (G - 1)) == gi)
              out.Lv[(st * nv + a) * nv + c] = H[a][c];
      }
      // column gi of Mvs = Qsvᵀ + BᵀPA and of Kg = −Hvv⁻¹Mvs
      if (own) {
        float kcol[NVC];
#pragma unroll
        for (int a = 0; a < NVC; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < NSC; ++t)
            acc = fma_if(t < ns, acc, B[t * nv + a], sPA[t * ns + gi]);
          mcol[a] = Qsv[gi * nv + a] + acc;
          kcol[a] = mcol[a];
        }
        cho_solve_regs<NVC>(H, kcol, nv);
#pragma unroll
        for (int a = 0; a < NVC; ++a) {
          if (a < nv) {
            sKg[a * ns + gi] = -kcol[a];
            if (store) {
              out.Kg[(st * nv + a) * ns + gi] = -kcol[a];
              out.Mvs[(st * nv + a) * ns + gi] = mcol[a];
            }
          }
        }
      }
      // right-hand sides: kff_r (every thread) and entry gi of p_r
      rhs_backward_regs<NSC, NVC, RC>(H, p, sW, A, B, qs, qv, [&](int a) { return mcol[a]; },
                                      out.dzs, out.dzv, l, N, k, ns, nv, cols, own, store, gi);
    } else {
      // by the group in the lane's shared memory: thread a < n_v row a of
      // Hvv's lower triangle, thread gi < n_s column gi of Mvs (in M, and in
      // Kg to be solved in place)
      float* const sH = sh + Lay::H;
      float* const sM = sh + Lay::M;
      if (gi < nv) {
        for (int c = 0; c <= gi; ++c) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < NSC; ++t)
            acc = fma_if(t < ns, acc, B[t * nv + gi], sPB[t * nv + c]);
          sH[gi * nv + c] = Qvv[gi * nv + c] + acc;
        }
      }
      if (own) {
        for (int a = 0; a < nv; ++a) {
          float acc = 0.0f;
#pragma unroll
          for (int t = 0; t < NSC; ++t)
            acc = fma_if(t < ns, acc, B[t * nv + a], sPA[t * ns + gi]);
          const float m = Qsv[gi * nv + a] + acc;
          sM[a * ns + gi] = m;
          sKg[a * ns + gi] = m;
        }
      }
      __syncwarp();
      ok = chol_shared_rt(sH, nv, gi) && ok;
      if (store) {
        for (int e = gi; e < nv * nv; e += G) {
          const int a = e / nv, c = e - a * nv;
          out.Lv[st * nv * nv + e] = (c <= a) ? sH[e] : 0.0f;
        }
      }
      // column gi of Kg = −Hvv⁻¹Mvs
      if (own) {
        cho_solve_shared(sH, sKg + gi, ns, nv);
        for (int a = 0; a < nv; ++a) {
          const float kg = -sKg[a * ns + gi];
          sKg[a * ns + gi] = kg;
          if (store) {
            out.Kg[(st * nv + a) * ns + gi] = kg;
            out.Mvs[(st * nv + a) * ns + gi] = sM[a * ns + gi];
          }
        }
      }
      rhs_backward_shared<NSC, NVC, RC>(sH, sh + Lay::F, p, sW, A, B, qs, qv, sM, ns, out.dzs,
                                        out.dzv, l, N, k, ns, nv, cols, own, store, gi);
    }
    __syncwarp();

    // row gi of P_k = sym(Qss + AᵀPA + MvsᵀKg)
    if (own) {
#pragma unroll (NSC > 8 ? 4 : NSC)
      for (int j = 0; j < NSC; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NSC; ++t) acc = fma_if(t < ns, acc, A[t * ns + gi], sPA[t * ns + j]);
        float acc2 = 0.0f;
        if constexpr (!Lay::shared_v) {
#pragma unroll
          for (int a = 0; a < NVC; ++a) acc2 = fma_if(a < nv, acc2, mcol[a], sKg[a * ns + j]);
        } else {
          const float* sM = sh + Lay::M;
          for (int a = 0; a < nv; ++a) acc2 += sM[a * ns + gi] * sKg[a * ns + j];
        }
        if (j < ns) sPn[gi * ns + j] = (Qss[gi * ns + j] + acc) + acc2;
      }
    }
    __syncwarp();
    if (own) {
#pragma unroll
      for (int j = 0; j < NSC; ++j) {
        if (j < ns) {
          Prow[j] = 0.5f * (sPn[gi * ns + j] + sPn[j * ns + gi]);
          if (store) out.P[(st * ns + gi) * ns + j] = Prow[j];
        }
      }
    }
  }

  // ---- masked Cholesky of P0 by the group (Pn), then the forward sweep ----
  __syncwarp();
  if (own) {
#pragma unroll
    for (int j = 0; j < NSC; ++j)
      if (j < ns)
        sPn[gi * ns + j] =
            (((s0mask >> gi) & (s0mask >> j) & 1u) != 0) ? Prow[j] : ((gi == j) ? 1.0f : 0.0f);
  }
  __syncwarp();
  ok = chol_shared_rt(sPn, ns, gi) && ok;
  if (store) {
    if (own) {
      for (int j = 0; j < ns; ++j)
        out.L0[((long)l * ns + gi) * ns + j] = (j <= gi) ? sPn[gi * ns + j] : 0.0f;
    }
    if (gi == 0) out.ok[l] = ok ? 1.0f : 0.0f;
  }
  const ForwardIO io{out.P, out.Kg, in.A, in.B, in.b, out.dzs, out.dzv, out.lam};
  classed_forward<NSC, NVC, RC>(sh, p, io, l, ls, store, N, ns, nv, cols, s0mask, gi);
}

// K2 at run-time sizes: resolve_grouped's design, RC columns a tile, tile
// blockIdx.y taking columns RC·y … of the R' of the launch; each tile
// sweeps its columns as a launch of them alone would.
template <int NSC, int NVC, int RC>
__global__ void __launch_bounds__(kGroupBlock, kGroupMinBlocksWide)
    resolve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask, ResolveIn in,
                    ForwardIO io) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  constexpr int G = Lay::G, D = kStages;
  extern __shared__ __align__(16) float smem[];
  const int grp = threadIdx.x / G, gi = threadIdx.x % G;
  const int l = blockIdx.x * Lay::lanes + grp;
  const bool store = l < L;
  const int ls = store ? l : L - 1;
  const bool own = gi < ns;
  const int r0 = (int)blockIdx.y * RC;
  const Cols cols{R, r0, R - r0 < RC ? R - r0 : RC};
  float* const sh = smem + grp * Lay::stride;
  float* const sW = sh + Lay::W;

  float p[RC];  // entry gi of p_{k+1}, per column of the tile
#pragma unroll
  for (int r = 0; r < RC; ++r) p[r] = 0.0f;

  // knot k's copies are committed as group N − 1 − k. Each iteration waits
  // for its knot, then (behind the __syncwarp that ends every thread's
  // reads of the previous knot) refills the buffer that knot used.
#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (N - 1 - q >= 0)
      load_resolve_classed<NSC, NVC, RC>(sh + q * Lay::buf, in, ls, N, N - 1 - q, ns, nv, cols,
                                         gi);
    __pipeline_commit();
  }
  for (int k = N - 1, it = 0; k >= 0; --k, ++it) {
    const float* cur = sh + (it % D) * Lay::buf;
    __pipeline_wait_prior(D - 2);
    __syncwarp();
    if (k - (D - 1) >= 0)
      load_resolve_classed<NSC, NVC, RC>(sh + ((it + D - 1) % D) * Lay::buf, in, ls, N,
                                         k - (D - 1), ns, nv, cols, gi);
    __pipeline_commit();
    const float* Pn = cur + Lay::rP;
    const float* Lvk = cur + Lay::rLv;
    const float* Mvs = cur + Lay::rMvs;
    const float* A = cur + Lay::A;
    const float* B = cur + Lay::B;
    const float* qs = cur + Lay::qs;
    const float* qv = cur + Lay::qv;
    const float* rb = cur + Lay::b;

    // entry gi of w_r = P_{k+1}·b_r + p_r (P_N = 0)
    if (own) {
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        float acc = 0.0f;
        if (k < N - 1) {
#pragma unroll
          for (int j = 0; j < NSC; ++j) acc = fma_if(j < ns, acc, rb[r * ns + j], Pn[gi * ns + j]);
        }
        if (r < cols.n) sW[r * ns + gi] = acc + p[r];
      }
    }
    __syncwarp();
    if constexpr (!Lay::shared_v) {
      // kff_r (every thread, Lv_k in registers) and entry gi of p_r
      float Lv[NVC][NVC];
#pragma unroll
      for (int a = 0; a < NVC; ++a)
#pragma unroll
        for (int c = 0; c <= a; ++c) Lv[a][c] = Lvk[a * nv + c];
      rhs_backward_regs<NSC, NVC, RC>(Lv, p, sW, A, B, qs, qv,
                                      [&](int a) { return Mvs[a * ns + gi]; }, io.dzs, io.dzv, l,
                                      N, k, ns, nv, cols, own, store, gi);
    } else {
      rhs_backward_shared<NSC, NVC, RC>(Lvk, sh + Lay::F, p, sW, A, B, qs, qv, Mvs, ns, io.dzs,
                                        io.dzv, l, N, k, ns, nv, cols, own, store, gi);
    }
  }

  // the stored masked initial factor (lower triangle) into the lane's Pn
  float* const sL0 = sh + Lay::Pn;
  __syncwarp();
  if (own) {
    for (int j = 0; j < ns; ++j)
      sL0[gi * ns + j] = (j <= gi) ? in.L0[((long)ls * ns + gi) * ns + j] : 0.0f;
  }
  __syncwarp();
  classed_forward<NSC, NVC, RC>(sh, p, io, l, ls, store, N, ns, nv, cols, s0mask, gi);
}

// Launch K1's class (NSC, NVC, RC) on the stream; `bytes` must be the
// class's own shared memory a block.
template <int NSC, int NVC, int RC>
int launch_factor_solve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask, int bytes,
                                const FactorIn& in, const FactorOut& out, cudaStream_t s) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  if (ns > NSC || nv > NVC || R > RC || bytes != Lay::bytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      factor_solve_classed<NSC, NVC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  factor_solve_classed<NSC, NVC, RC>
      <<<(unsigned)((L + Lay::lanes - 1) / Lay::lanes), kGroupBlock, bytes, s>>>(
          L, N, ns, nv, R, s0mask, in, out);
  return (int)cudaGetLastError();
}

// Launch K2's class, ⌈R / RC⌉ tiles on grid rows.
template <int NSC, int NVC, int RC>
int launch_resolve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask, int bytes,
                           const ResolveIn& in, const ForwardIO& io, cudaStream_t s) {
  using Lay = ClassLayout<NSC, NVC, RC>;
  if (ns > NSC || nv > NVC || bytes != Lay::bytes) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      resolve_classed<NSC, NVC, RC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((L + Lay::lanes - 1) / Lay::lanes), (unsigned)((R + RC - 1) / RC));
  resolve_classed<NSC, NVC, RC><<<grid, kGroupBlock, bytes, s>>>(L, N, ns, nv, R, s0mask, in, io);
  return (int)cudaGetLastError();
}

}  // namespace
