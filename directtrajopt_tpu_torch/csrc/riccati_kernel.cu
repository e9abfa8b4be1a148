// Fused Riccati KKT factor + multi-RHS solve, and resolve with stored
// factors, for Hopper (sm_90a), float32.
//
// Replaces the two Pallas kernels of directtrajopt_tpu/ops/riccati_kernel.py:
//   * _fused_kernel (:342; wrapper _factor_solve_pallas)
//       -> factor_solve_grouped, factor_solve_classed
//   * _resolve_kernel (:488; wrapper _resolve_pallas)
//       -> resolve_grouped, resolve_columns, resolve_classed
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
// The design is chosen by shape in the wrapper (ops/riccati_kernel.py
// design(): GROUPED_SHAPES for K1, RESOLVE_GROUPED_SHAPES and
// RESOLVE_COLUMN_SHAPES for K2, the size classes everywhere else):
//
// * factor_solve_grouped<NS, NV, R> — a group of G threads per lane (G =
//   NS up to n_s = 8; beyond, the least power of two ≥ NS, so 16 at n_s =
//   10 and 32 at 18, the threads past NS owning no row: GroupLayout),
//   32/G lanes to a warp, 64-thread blocks. Thread i owns
//   row i of P and entry i of each p_r and s_r; the products P·A, P·B,
//   AᵀPA + MvsᵀKg and the right-hand-side updates are row- or
//   column-parallel over the group, which trades PA, PB, w, Kg, P and s
//   through shared memory under __syncwarp. Hvv (NV×NV), its Cholesky and
//   the kff solves are computed by every thread of the group from the same
//   shared data, so `ok` and the factors agree across the group; so is the
//   masked Cholesky of P0 up to n_s = 8, in registers. Beyond, where P0 and
//   L0 would be 2·n_s² registers a thread, the group factors P0 in the
//   lane's shared memory, column by column (chol_shared: every thread sums
//   each pivot, each owner its row), and the forward sweeps read L0 there.
//   Each knot's blocks (Qss, Qsv, Qvv, A, B, qs, qv, b; in the forward
//   sweep P, Kg, A, B, b and the stashed p, kff) are double-buffered in
//   shared memory with cp.async: knot k±1's copies are in flight while
//   knot k computes. Input
//   and output are lane-major, as the port holds them ((L, N, r, c) stage
//   stacks, (L, R, N, d) right-hand sides), so a group reads each block at
//   contiguous addresses and the wrapper copies nothing. Every loop bound
//   is a compile-time constant: no register array is indexed at run time.
//   Instantiated at (8,3,3) (path 1), (2,1,3) (path 2), (2,1,7) (path 3,
//   the global-phase family: 4 border columns, 2 arrowhead columns and the
//   main system; its lane's shared memory is 196 floats, 25 KB a block),
//   (10,3,3) and (18,3,3) (path 7, the scaling family at state_dim 8 and
//   16: 1,040 and 2,688 floats a lane, 16.6 and 21.5 KB a block), and
//   (4,1,1) (path 5, the cartpole family: G = 4, 16 lanes a block).
//   Bound on the card (H100 SXM, 3.35 TB/s; the FLOP bound is 5-10× lower):
//   each input byte read once and each output byte written once is 85.8 KB
//   per lane at (8,3,3), N=51 — 22.0 MB, 6.6 µs at 256 lanes and 703 MB,
//   210 µs at 8192 — 26 µs (86.9 MB) at (2,1,3), N=51, 8192 lanes, and
//   46 µs (153.5 MB) at (2,1,7). The
//   sweep is sequential in N, so the design spends the lane's parallelism
//   on the group (a knot's critical path is ~NS times shorter than one
//   thread's) and hides each knot's load latency behind the previous
//   knot's arithmetic; at 256 lanes it still fills only 32 blocks.
// * resolve_grouped<NS, NV, R> (K2) — the same design for new right-hand
//   sides against stored factors: w row-parallel, mv summed by every thread
//   in order from shared memory and solved against Lv_k, p column-parallel;
//   each knot's P_{k+1}, Lv, Mvs, A, B, qs, qv, b double-buffered with
//   cp.async; the initial-state solve and the forward sweep are K1's own
//   (initial_and_forward, one device function for both). Lane-major in and
//   out: K1's outputs are read as K1 wrote them. Instantiated at (8,3,2)
//   (path 1's fused SOC + restoration), (2,1,2) (path 2's), (10,3,2)
//   and (18,3,2) (path 7's; L0 copied into the lane's shared memory), and
//   (4,1,2) (path 5's).
//   Bound (each input byte read once, each output byte written once):
//   58.3 KB per lane
//   at (8,3,2), N=51 — 14.9 MB, 4.5 µs at 256 lanes — and 58.5 MB, 17.5 µs
//   at (2,1,2), 8192 lanes; like K1 it waits on each knot's dependent
//   chain, not on its loads.
// * resolve_columns<NS, NV> (K2 for many right-hand sides) — one thread per
//   (lane, column), R (1 … 40) at run time: once the factors are stored
//   the R columns of a resolve are independent, so the card runs them side
//   by side (327,680 threads at 8192 lanes and R = 40, the L-BFGS SMW
//   correction's 2m columns) where resolve_grouped would run R columns in
//   turn on a lane's group (and its ring of R columns would not fit a
//   block's static shared memory). The (lane, column) pairs are flattened
//   across 128-thread blocks, so warps stay full at any R, and a block
//   sweeps the knots in chunks of 8: each chunk's right-hand-side rows of
//   the block's columns (contiguous in the (L, R, N, d) stacks) and its
//   lanes' stored blocks (≤ 127/R + 2 lanes; P, Lv, Mvs, A, B backward, P,
//   Kg, A, B forward, and L0) arrive by cp.async into dynamic shared
//   memory, double-buffered, while the previous chunk computes; each thread
//   keeps one column's p or s in registers and writes its results over the
//   rows it read, and the block stores the chunk's results together: read
//   straight from global memory, each thread's rows lie 640 bytes from its
//   neighbour's, a half-used sector a row, which held (4,1,40) × 8192 to
//   the one-thread-a-lane kernel's time. The order of summation is the
//   grouped kernels', so a column's result does not depend on R or on the
//   other columns of the launch.
//   Lane-major in and out, as resolve_grouped. Instantiated at (4,1) (path
//   5b). Bound: 998 MB, 0.298 ms at (4,1,40) × 8192, N=40 (the right-hand
//   sides and solutions are 95 % of it); the stashed p_k, kff_k make the
//   round trip through dzs, dzv, and b is read in both sweeps (1.73 GB).
// * factor_solve_classed<NSC, NVC, RC> / resolve_classed<NSC, NVC, RC>
//   (riccati_classed.cuh, instantiated in riccati_classed_factor.cu and
//   riccati_classed_resolve.cu, which nvcc builds beside this file) — the
//   grouped design at run-time sizes, one instantiation a size class, for
//   every shape within the Pallas kernels' caps that has no exact instance.
//
// Division and sqrt are IEEE (no fast math): correctly rounded.

#include "riccati_common.cuh"

namespace {

// ---- factor_solve_grouped: a thread group per lane, lane-major I/O ---------

// Shared memory of one lane, in floats: a ring of kStages knot buffers,
// then the group's scratch. Every block starts on 16 bytes. The lane stride
// is ≡ max(G, 4) (mod 32 banks), so the groups of a warp broadcast from
// distinct banks. A group of G threads serves a lane, G the least power of
// two ≥ NS (NS itself up to n_s = 8); thread gi owns row gi of P where gi <
// NS. One row a thread ran K1 (18,3,3) × 128 lanes in 0.39 ms of device
// time on the H100, against 0.61 ms for two rows a thread in 16-thread
// groups: each lane's chain of dependent knots, not the card's occupancy,
// sets the time.
template <int NS, int NV, int R>
struct GroupLayout {
  static constexpr int G = pow2_at_least(NS), lanes = kGroupBlock / G,
                       min_blocks = NS > 8 ? kGroupMinBlocksWide : kGroupMinBlocks;
  // backward buffer: knot k's input blocks
  static constexpr int Qss = 0, Qsv = align4(Qss + NS * NS), Qvv = align4(Qsv + NS * NV),
                       A = align4(Qvv + NV * NV), B = align4(A + NS * NS),
                       qs = align4(B + NS * NV), qv = align4(qs + R * NS),
                       b = align4(qv + R * NV), bwd = align4(b + R * NS);
  // K2's backward buffer: P_{k+1}, Mvs_k and Lv_k in the places (and sizes)
  // of Qss, Qsv and Qvv; A, B, qs, qv, b as K1's
  static constexpr int rP = Qss, rMvs = Qsv, rLv = Qvv;
  // forward buffer: knot k's P and Kg, its A, B, b, and the stashed p, kff
  static constexpr int fP = 0, fKg = align4(fP + NS * NS), fA = align4(fKg + NV * NS),
                       fB = align4(fA + NS * NS), fb = align4(fB + NS * NV),
                       fp = align4(fb + R * NS), fkff = align4(fp + R * NS),
                       fwd = align4(fkff + R * NV);
  static constexpr int buf = bwd > fwd ? bwd : fwd;
  // scratch (beyond n_s = 8 Pn holds the masked P0 and then its factor L0)
  static constexpr int PA = kStages * buf, PB = align4(PA + NS * NS), W = align4(PB + NS * NV),
                       Kg = align4(W + R * NS), Pn = align4(Kg + NV * NS),
                       S = align4(Pn + NS * NS), end = align4(S + R * NS);
  static constexpr int pad = G < 4 ? 4 : G;
  static constexpr int stride = end + (pad - end % 32 + 32) % 32;
  static_assert(32 % G == 0, "a group must not straddle two warps");
  static_assert(lanes * stride * 4 <= 48 * 1024, "a block's static shared memory");
  // whether thread gi owns a row of P
  static __device__ __forceinline__ bool owns(int gi) { return G == NS || gi < NS; }
};

// The group's share of the cp.async copies of NSEG segments of S floats,
// `gstride` floats apart in global memory, into contiguous shared memory.
template <int S, int NSEG, int G>
__device__ __forceinline__ void copy_async(float* dst, const float* src, long gstride, int gi) {
  constexpr int C = chunk_floats(S), per = S / C;
#pragma unroll
  for (int c0 = 0; c0 < NSEG * per; c0 += G) {
    const int c = c0 + gi;
    if (c < NSEG * per) {
      const int r = c / per, q = c - r * per;
      __pipeline_memcpy_async(dst + r * S + q * C, src + r * gstride + q * C,
                              C * sizeof(float));
    }
  }
}

// Backward sweep: knot k's input blocks of lane l into `buf`.
template <int NS, int NV, int R>
__device__ __forceinline__ void load_backward(float* buf, const FactorIn& in, int l, int N,
                                              int k, int gi) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;      // (l, k) of an (L, N, r, c) stack
  const long rh = (long)l * R * N + k;  // (l, 0, k) of an (L, R, N, d) stack
  const long rs = N;                    // between r and r + 1, in rows of d
  copy_async<NS * NS, 1, G>(buf + Lay::Qss, in.Qss + st * NS * NS, 0, gi);
  copy_async<NS * NV, 1, G>(buf + Lay::Qsv, in.Qsv + st * NS * NV, 0, gi);
  copy_async<NV * NV, 1, G>(buf + Lay::Qvv, in.Qvv + st * NV * NV, 0, gi);
  copy_async<NS * NS, 1, G>(buf + Lay::A, in.A + st * NS * NS, 0, gi);
  copy_async<NS * NV, 1, G>(buf + Lay::B, in.B + st * NS * NV, 0, gi);
  copy_async<NS, R, G>(buf + Lay::qs, in.qs + rh * NS, rs * NS, gi);
  copy_async<NV, R, G>(buf + Lay::qv, in.qv + rh * NV, rs * NV, gi);
  copy_async<NS, R, G>(buf + Lay::b, in.b + rh * NS, rs * NS, gi);
}

// Forward sweep: knot k's P, Kg, A, B, b and the stashed p_k, kff_k of lane
// l into `buf`.
template <int NS, int NV, int R>
__device__ __forceinline__ void load_forward(float* buf, const ForwardIO& io, int l, int N, int k,
                                             int gi) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;
  const long rh = (long)l * R * N + k;
  const long rs = N;
  copy_async<NS * NS, 1, G>(buf + Lay::fP, io.P + st * NS * NS, 0, gi);
  copy_async<NV * NS, 1, G>(buf + Lay::fKg, io.Kg + st * NV * NS, 0, gi);
  copy_async<NS * NS, 1, G>(buf + Lay::fA, io.A + st * NS * NS, 0, gi);
  copy_async<NS * NV, 1, G>(buf + Lay::fB, io.B + st * NS * NV, 0, gi);
  copy_async<NS, R, G>(buf + Lay::fb, io.b + rh * NS, rs * NS, gi);
  copy_async<NS, R, G>(buf + Lay::fp, io.dzs + rh * NS, rs * NS, gi);
  copy_async<NV, R, G>(buf + Lay::fkff, io.dzv + rh * NV, rs * NV, gi);
}

// x ← (L0 L0ᵀ)⁻¹ x with L0 in registers (n_s ≤ 8: cho_solve) or, beyond,
// row-major in the lane's shared memory (the same order of summation).
template <int NS>
__device__ __forceinline__ void solve_l0(const float (&L0)[NS][NS], float (&x)[NS]) {
  cho_solve<NS>(L0, x, NS);
}

template <int NS>
__device__ __forceinline__ void solve_l0(const float* L0, float (&x)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    float s = x[i];
#pragma unroll
    for (int t = 0; t < i; ++t) s -= L0[i * NS + t] * x[t];
    x[i] = s / L0[i * NS + i];
  }
#pragma unroll
  for (int i = NS - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int t = i + 1; t < NS; ++t) s -= L0[t * NS + i] * x[t];
    x[i] = s / L0[i * NS + i];
  }
}

// The masked P0 (row-major in the lane's shared memory M) factored in place
// by the group, column by column: every thread sums column c's pivot from
// the same shared data (so `ok` agrees across the group), each owner of a
// row below it that row's entry; __syncwarp between the reads of column c
// and its writes, and after them. The lower triangle then holds L0, as
// chol_or_identity leaves it (the identity where a pivot is ≤ 0 or an
// entry not finite); the upper triangle is left as it was. For n_s > 8,
// whose register copy of P0 and L0 would be 2·n_s² floats a thread.
template <int NS, int NV, int R>
__device__ __forceinline__ bool chol_shared(float* M, int gi) {
  using Lay = GroupLayout<NS, NV, R>;
  bool ok = true;
#pragma unroll
  for (int c = 0; c < NS; ++c) {
    float d = M[c * NS + c];
#pragma unroll
    for (int t = 0; t < c; ++t) d -= M[c * NS + t] * M[c * NS + t];
    if (!(d > 0.0f)) ok = false;
    const float s = sqrtf(d);
    float v = s;
    if (Lay::owns(gi) && gi > c) {
      float acc = M[gi * NS + c];
#pragma unroll
      for (int t = 0; t < c; ++t) acc -= M[gi * NS + t] * M[c * NS + t];
      v = acc / s;
    }
    __syncwarp();
    if (Lay::owns(gi) && gi >= c) M[gi * NS + c] = v;
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j)
      if (!isfinite(M[i * NS + j])) ok = false;
  __syncwarp();
  if (!ok && Lay::owns(gi)) {
#pragma unroll
    for (int j = 0; j < NS; ++j) M[gi * NS + j] = (gi == j) ? 1.0f : 0.0f;
  }
  __syncwarp();
  return ok;
}

// The initial-state solve and the forward sweep of lane l, shared by K1 and
// K2 (every dot product sums its terms in ascending index order, the
// order of the plain version's recursion and of every K1/K2 kernel here).
// On entry every thread of the group can read the masked
// initial factor L0 (a register array up to n_s = 8, the lane's shared Pn
// beyond) and holds entry gi of each p_0, and the group has stashed p_k,
// kff_k in dzs, dzv. Threads of a ragged lane (store false) read lane ls and
// store nothing.
template <int NS, int NV, int R, class L0T>
__device__ __forceinline__ void initial_and_forward(float* sh, const L0T& L0, const float (&p)[R],
                                                    const ForwardIO& io, int l, int ls, bool store,
                                                    int N, unsigned s0mask, int gi) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G, D = kStages;
  float* const sS = sh + Lay::S;
  if (Lay::owns(gi)) {
#pragma unroll
    for (int r = 0; r < R; ++r) sS[r * NS + gi] = p[r];
  }
  __syncwarp();
  float s[R];  // entry gi of s_0, per right-hand side
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float x[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) x[i] = ((s0mask >> i) & 1u) ? sS[r * NS + i] : 0.0f;
    solve_l0<NS>(L0, x);
    s[r] = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (i == gi) s[r] = ((s0mask >> i) & 1u) ? -x[i] : 0.0f;
  }
  // the group's stores of the stashes (and of K1's P and Kg), before it
  // reads them back
  __threadfence_block();
  __syncwarp();
  if (Lay::owns(gi)) {
#pragma unroll
    for (int r = 0; r < R; ++r) sS[r * NS + gi] = s[r];
  }

#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (q < N) load_forward<NS, NV, R>(sh + q * Lay::buf, io, ls, N, q, gi);
    __pipeline_commit();
  }
  for (int k = 0; k < N; ++k) {
    const float* cur = sh + (k % D) * Lay::buf;
    if (k + D - 1 < N)
      load_forward<NS, NV, R>(sh + ((k + D - 1) % D) * Lay::buf, io, ls, N, k + D - 1, gi);
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
    float sn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float* sr = sS + r * NS;
      const long rk = ((long)l * R + r) * N + k;
      float v[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j) acc += sr[j] * fKg[a * NS + j];
        v[a] = acc + fkff[r * NV + a];
      }
      if (Lay::owns(gi)) {
        if (k >= 1) {
          float acc = 0.0f;
#pragma unroll
          for (int j = 0; j < NS; ++j) acc += fP[gi * NS + j] * sr[j];
          if (store)
            io.lam[(((long)l * R + r) * (N - 1) + k - 1) * NS + gi] = -(acc + fp[r * NS + gi]);
        }
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j) acc += sr[j] * fA[gi * NS + j];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += v[a] * fB[gi * NV + a];
        sn[r] = acc + acc2 + fb[r * NS + gi];
        if (store) io.dzs[rk * NS + gi] = sr[gi];
      }
      if (store) {
#pragma unroll
        for (int a = 0; a < NV; ++a)
          if ((r * NV + a) % G == gi) io.dzv[rk * NV + a] = v[a];
      }
    }
    __syncwarp();
    if (Lay::owns(gi)) {
#pragma unroll
      for (int r = 0; r < R; ++r) sS[r * NS + gi] = sn[r];
    }
  }
}

// Every dot product sums its terms in ascending index order, the order
// that factor_solve_classed keeps at run-time sizes. Threads of a last, ragged lane (l ≥ L) load from lane L − 1, take part in
// every __syncwarp, and store nothing; so do a group's threads past NS,
// which own no row.
template <int NS, int NV, int R>
__global__ void __launch_bounds__(kGroupBlock, GroupLayout<NS, NV, R>::min_blocks)
    factor_solve_grouped(int L, int N, unsigned s0mask, FactorIn in, FactorOut out) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G;
  __shared__ __align__(16) float smem[Lay::lanes * Lay::stride];
  const int grp = threadIdx.x / G, gi = threadIdx.x % G;
  const int l = blockIdx.x * Lay::lanes + grp;
  const bool store = l < L;
  const int ls = store ? l : L - 1;
  float* const sh = smem + grp * Lay::stride;
  float* const sPA = sh + Lay::PA;
  float* const sPB = sh + Lay::PB;
  float* const sW = sh + Lay::W;
  float* const sKg = sh + Lay::Kg;
  float* const sPn = sh + Lay::Pn;

  float Prow[NS];  // row gi of P_{k+1}
  float p[R];      // entry gi of p_{k+1}, per right-hand side
#pragma unroll
  for (int j = 0; j < NS; ++j) Prow[j] = 0.0f;
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = 0.0f;
  bool ok = true;

  // ---- backward sweep ----
  // knot k's copies are committed as group N − 1 − k: the ring holds knots
  // k .. k − D + 1, and each iteration refills the buffer its predecessor
  // read (behind that iteration's last __syncwarp)
  constexpr int D = kStages;
#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (N - 1 - q >= 0) load_backward<NS, NV, R>(sh + q * Lay::buf, in, ls, N, N - 1 - q, gi);
    __pipeline_commit();
  }
  for (int k = N - 1, it = 0; k >= 0; --k, ++it) {
    const float* cur = sh + (it % D) * Lay::buf;
    if (k - (D - 1) >= 0)
      load_backward<NS, NV, R>(sh + ((it + D - 1) % D) * Lay::buf, in, ls, N, k - (D - 1), gi);
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

    // row gi of PA = P·A and PB = P·B; entry gi of w_r = P·b_r + p_r
    if (Lay::owns(gi)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += Prow[t] * A[t * NS + j];
        sPA[gi * NS + j] = acc;
      }
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += Prow[t] * B[t * NV + a];
        sPB[gi * NV + a] = acc;
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NS; ++j) acc += rb[r * NS + j] * Prow[j];
        sW[r * NS + gi] = acc + p[r];
      }
    }
    __syncwarp();

    // Hvv = Qvv + BᵀPB and its Cholesky (every thread)
    float H[NV][NV];
#pragma unroll
    for (int a = 0; a < NV; ++a)
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += B[t * NV + a] * sPB[t * NV + c];
        H[a][c] = Qvv[a * NV + c] + acc;
      }
    float Lv[NV][NV];
    ok = chol_or_identity<NV>(H, Lv, NV) && ok;
    // each output is stored as soon as it is known, which keeps it out of
    // the registers for the rest of the knot
    const long st = (long)l * N + k;
    if (store) {
#pragma unroll
      for (int e = 0; e < NV * NV; ++e)
        if (e % G == gi) out.Lv[st * NV * NV + e] = Lv[e / NV][e % NV];
    }
    // column gi of Mvs = Qsvᵀ + BᵀPA and of Kg = −Hvv⁻¹Mvs
    float mcol[NV];
    if (Lay::owns(gi)) {
      float kcol[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += B[t * NV + a] * sPA[t * NS + gi];
        mcol[a] = Qsv[gi * NV + a] + acc;
        kcol[a] = mcol[a];
      }
      cho_solve<NV>(Lv, kcol, NV);
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        sKg[a * NS + gi] = -kcol[a];
        if (store) {
          out.Kg[(st * NV + a) * NS + gi] = -kcol[a];
          out.Mvs[(st * NV + a) * NS + gi] = mcol[a];
        }
      }
    }
    // right-hand sides: kff_r (every thread) and entry gi of p_r
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float kff[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) acc += sW[r * NS + i] * B[i * NV + a];
        kff[a] = qv[r * NV + a] + acc;
      }
      cho_solve<NV>(Lv, kff, NV);
#pragma unroll
      for (int a = 0; a < NV; ++a) kff[a] = -kff[a];
      const long rk = ((long)l * R + r) * N + k;
      if (Lay::owns(gi)) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += sW[r * NS + t] * A[t * NS + gi];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += kff[a] * mcol[a];
        p[r] = (qs[r * NS + gi] + acc) + acc2;
        if (store) out.dzs[rk * NS + gi] = p[r];  // stash p_k
      }
      if (store) {
#pragma unroll
        for (int a = 0; a < NV; ++a)
          if ((r * NV + a) % G == gi) out.dzv[rk * NV + a] = kff[a];  // stash kff_k
      }
    }
    __syncwarp();

    // row gi of P_k = sym(Qss + AᵀPA + MvsᵀKg)
    if (Lay::owns(gi)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += A[t * NS + gi] * sPA[t * NS + j];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += mcol[a] * sKg[a * NS + j];
        sPn[gi * NS + j] = (Qss[gi * NS + j] + acc) + acc2;
      }
    }
    __syncwarp();
    if (Lay::owns(gi)) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        Prow[j] = 0.5f * (sPn[gi * NS + j] + sPn[j * NS + gi]);
        if (store) out.P[(st * NS + gi) * NS + j] = Prow[j];
      }
    }
  }

  // ---- masked Cholesky of P0, then the forward sweep ----
  // P0m = P0∘(s0 s0ᵀ) + diag(1 − s0), as initial_factor
  const ForwardIO io{out.P, out.Kg, in.A, in.B, in.b, out.dzs, out.dzv, out.lam};
  __syncwarp();
  if constexpr (NS <= 8) {  // every thread, in registers
#pragma unroll
    for (int j = 0; j < NS; ++j) sPn[gi * NS + j] = Prow[j];
    __syncwarp();
    float P0m[NS][NS], L0[NS][NS];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        P0m[i][j] = (((s0mask >> i) & (s0mask >> j) & 1u) != 0) ? sPn[i * NS + j]
                                                               : ((i == j) ? 1.0f : 0.0f);
    ok = chol_or_identity<NS>(P0m, L0, NS) && ok;
    if (store) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (i == gi) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
            out.L0[((long)l * NS + i) * NS + j] = (j <= i) ? L0[i][j] : 0.0f;
        }
      if (gi == 0) out.ok[l] = ok ? 1.0f : 0.0f;
    }
    initial_and_forward<NS, NV, R>(sh, L0, p, io, l, ls, store, N, s0mask, gi);
  } else {  // by the group, in the lane's shared memory (Pn)
    if (Lay::owns(gi)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        sPn[gi * NS + j] = (((s0mask >> gi) & (s0mask >> j) & 1u) != 0)
                               ? Prow[j] : ((gi == j) ? 1.0f : 0.0f);
    }
    __syncwarp();
    ok = chol_shared<NS, NV, R>(sPn, gi) && ok;
    if (store) {
      if (Lay::owns(gi)) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
          out.L0[((long)l * NS + gi) * NS + j] = (j <= gi) ? sPn[gi * NS + j] : 0.0f;
      }
      if (gi == 0) out.ok[l] = ok ? 1.0f : 0.0f;
    }
    const float* sL0 = sPn;
    initial_and_forward<NS, NV, R>(sh, sL0, p, io, l, ls, store, N, s0mask, gi);
  }
}

// ---- resolve_grouped: K2 on K1's thread-group design ---------------------

// Backward sweep of the resolve: knot k's P_{k+1} (for k < N − 1), Lv_k,
// Mvs_k, A_k, B_k and right-hand sides of lane l into `buf`.
template <int NS, int NV, int R>
__device__ __forceinline__ void load_resolve(float* buf, const ResolveIn& in, int l, int N, int k,
                                             int gi) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G;
  const long st = (long)l * N + k;
  const long rh = (long)l * R * N + k;
  const long rs = N;
  if (k + 1 < N) copy_async<NS * NS, 1, G>(buf + Lay::rP, in.P + (st + 1) * NS * NS, 0, gi);
  copy_async<NV * NS, 1, G>(buf + Lay::rMvs, in.Mvs + st * NV * NS, 0, gi);
  copy_async<NV * NV, 1, G>(buf + Lay::rLv, in.Lv + st * NV * NV, 0, gi);
  copy_async<NS * NS, 1, G>(buf + Lay::A, in.A + st * NS * NS, 0, gi);
  copy_async<NS * NV, 1, G>(buf + Lay::B, in.B + st * NS * NV, 0, gi);
  copy_async<NS, R, G>(buf + Lay::qs, in.qs + rh * NS, rs * NS, gi);
  copy_async<NV, R, G>(buf + Lay::qv, in.qv + rh * NV, rs * NV, gi);
  copy_async<NS, R, G>(buf + Lay::b, in.b + rh * NS, rs * NS, gi);
}

// K2 on K1's design, summing in the same order as resolve_classed: thread gi owns entry gi of w_r and p_r (w
// row-parallel, p column-parallel), and every thread of the group sums
// mv_r = qv_r + Bᵀw_r in order from shared memory and solves it against
// Lv_k. Each knot's blocks are double-buffered in shared memory with
// cp.async; the initial-state solve and the forward sweep are K1's.
template <int NS, int NV, int R>
__global__ void __launch_bounds__(kGroupBlock, GroupLayout<NS, NV, R>::min_blocks)
    resolve_grouped(int L, int N, unsigned s0mask, ResolveIn in, ForwardIO io) {
  using Lay = GroupLayout<NS, NV, R>;
  constexpr int G = Lay::G, D = kStages;
  __shared__ __align__(16) float smem[Lay::lanes * Lay::stride];
  const int grp = threadIdx.x / G, gi = threadIdx.x % G;
  const int l = blockIdx.x * Lay::lanes + grp;
  const bool store = l < L;
  const int ls = store ? l : L - 1;
  float* const sh = smem + grp * Lay::stride;
  float* const sW = sh + Lay::W;

  float p[R];  // entry gi of p_{k+1}, per right-hand side
#pragma unroll
  for (int r = 0; r < R; ++r) p[r] = 0.0f;

  // knot k's copies are committed as group N − 1 − k. Each iteration waits
  // for its knot, then (behind the __syncwarp that ends every thread's
  // reads of the previous knot) refills the buffer that knot used.
#pragma unroll
  for (int q = 0; q < D - 1; ++q) {
    if (N - 1 - q >= 0) load_resolve<NS, NV, R>(sh + q * Lay::buf, in, ls, N, N - 1 - q, gi);
    __pipeline_commit();
  }
  for (int k = N - 1, it = 0; k >= 0; --k, ++it) {
    const float* cur = sh + (it % D) * Lay::buf;
    __pipeline_wait_prior(D - 2);
    __syncwarp();
    if (k - (D - 1) >= 0)
      load_resolve<NS, NV, R>(sh + ((it + D - 1) % D) * Lay::buf, in, ls, N, k - (D - 1), gi);
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
    if (Lay::owns(gi)) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float acc = 0.0f;
        if (k < N - 1) {
#pragma unroll
          for (int j = 0; j < NS; ++j) acc += rb[r * NS + j] * Pn[gi * NS + j];
        }
        sW[r * NS + gi] = acc + p[r];
      }
    }
    __syncwarp();
    float Lv[NV][NV];
#pragma unroll
    for (int a = 0; a < NV; ++a)
#pragma unroll
      for (int c = 0; c < NV; ++c) Lv[a][c] = Lvk[a * NV + c];
    // kff_r (every thread) and entry gi of p_r
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float kff[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) acc += sW[r * NS + i] * B[i * NV + a];
        kff[a] = qv[r * NV + a] + acc;
      }
      cho_solve<NV>(Lv, kff, NV);
#pragma unroll
      for (int a = 0; a < NV; ++a) kff[a] = -kff[a];
      const long rk = ((long)l * R + r) * N + k;
      if (Lay::owns(gi)) {
        float acc = 0.0f;
#pragma unroll
        for (int t = 0; t < NS; ++t) acc += sW[r * NS + t] * A[t * NS + gi];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += kff[a] * Mvs[a * NS + gi];
        p[r] = (qs[r * NS + gi] + acc) + acc2;
        if (store) io.dzs[rk * NS + gi] = p[r];  // stash p_k
      }
      if (store) {
#pragma unroll
        for (int a = 0; a < NV; ++a)
          if ((r * NV + a) % G == gi) io.dzv[rk * NV + a] = kff[a];  // stash kff_k
      }
    }
  }

  // the stored masked initial factor (lower triangle)
  if constexpr (NS <= 8) {  // in registers
    float L0[NS][NS];
#pragma unroll
    for (int i = 0; i < NS; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        L0[i][j] = (j <= i) ? in.L0[((long)ls * NS + i) * NS + j] : 0.0f;
    initial_and_forward<NS, NV, R>(sh, L0, p, io, l, ls, store, N, s0mask, gi);
  } else {  // in the lane's shared memory (Pn), each thread its row
    float* const sL0 = sh + Lay::Pn;
    if (Lay::owns(gi)) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
        sL0[gi * NS + j] = (j <= gi) ? in.L0[((long)ls * NS + gi) * NS + j] : 0.0f;
    }
    __syncwarp();
    const float* cL0 = sL0;
    initial_and_forward<NS, NV, R>(sh, cL0, p, io, l, ls, store, N, s0mask, gi);
  }
}

// ---- resolve_columns: K2 with a thread per (lane, right-hand side) -------

// Threads (columns) a block, where shared memory allows, and knots a chunk;
// tools/torch_resolve_columns.py builds other values with
// -DDTO_COLUMN_BLOCK / -DDTO_COLUMN_KNOTS to time them.
#ifndef DTO_COLUMN_BLOCK
#define DTO_COLUMN_BLOCK 128
#endif
#ifndef DTO_COLUMN_KNOTS
#define DTO_COLUMN_KNOTS 8
#endif
constexpr int kColumnBlock = DTO_COLUMN_BLOCK, kColumnKnots = DTO_COLUMN_KNOTS;

// Shared memory of resolve_columns, in floats, for T columns (threads) and
// `lanes` lanes a block: a ring of kStages chunk stages, then each lane's
// L0. A stage holds, for the kColumnKnots knots k0 … k0 + KC − 1 of one
// chunk, three row tiles of the block's columns — column j's row at knot
// k0 + kk at j·S + kk·d, S = KC·d + pad (pad: the floats of one copy, so
// rows stay aligned for it and a warp's row reads fall on distinct banks)
// — and each lane's stored blocks of those knots (P for KC + 1).
template <int NS, int NV>
struct ColumnLayout {
  static constexpr int KC = kColumnKnots;
  static constexpr int SS = KC * NS + chunk_floats(NS), SV = KC * NV + chunk_floats(NV);
  // a lane's blocks, knot-major as in global memory
  static constexpr int P = 0, Lv = align4(P + (KC + 1) * NS * NS),
                       MK = align4(Lv + KC * NV * NV), A = align4(MK + KC * NV * NS),
                       B = align4(A + KC * NS * NS), lane = align4(B + KC * NS * NV);
  // offsets, for T columns and `lanes` lanes
  static __host__ __device__ constexpr int T2(int T) { return T * SS; }
  static __host__ __device__ constexpr int TV(int T) { return 2 * T * SS; }
  static __host__ __device__ constexpr int lanes_at(int T) { return align4(2 * T * SS + T * SV); }
  static __host__ __device__ constexpr int stage(int T, int lanes) {
    return lanes_at(T) + lanes * lane;
  }
  static __host__ __device__ constexpr int L0(int T, int lanes) {
    return kStages * stage(T, lanes);
  }
  // the most lanes T consecutive (lane, column) pairs touch
  static int lanes(int T, int R) {
    const int n = (T - 1) / R + 2;
    return n < T ? n : T;
  }
  static size_t bytes(int T, int R) {
    return (size_t)(L0(T, lanes(T, R)) + lanes(T, R) * align4(NS * NS)) * sizeof(float);
  }
};

// cp.async copies of the rows k0 … k0 + nk − 1 (d floats each) of the
// block's nc columns c0 … c0 + nc − 1 of an (·, N, d) stack into a row
// tile: consecutive threads take consecutive rows of a column, so a warp
// reads whole sectors.
template <int d>
__device__ __forceinline__ void load_rows(float* tile, const float* src, long c0, int nc, int N,
                                          int k0, int nk) {
  constexpr int C = chunk_floats(d), per = d / C, S = kColumnKnots * d + C;
  for (int e = threadIdx.x; e < nc * kColumnKnots * per; e += blockDim.x) {
    const int j = e / (kColumnKnots * per), rem = e - j * (kColumnKnots * per);
    const int kk = rem / per, q = rem - kk * per;
    if (kk < nk)
      __pipeline_memcpy_async(tile + j * S + kk * d + q * C,
                              src + ((c0 + j) * N + k0 + kk) * d + q * C, C * sizeof(float));
  }
}

// The same rows from a tile back to an (·, Nd, d) stack, knot k0 + kk at
// row k0 + kk − off; rows before 0 (λ's row −1) are skipped.
template <int d>
__device__ __forceinline__ void store_rows(float* dst, const float* tile, long c0, int nc, int Nd,
                                           int k0, int nk, int off) {
  constexpr int C = chunk_floats(d), per = d / C, S = kColumnKnots * d + C;
  for (int e = threadIdx.x; e < nc * kColumnKnots * per; e += blockDim.x) {
    const int j = e / (kColumnKnots * per), rem = e - j * (kColumnKnots * per);
    const int kk = rem / per, q = rem - kk * per;
    const int k = k0 + kk - off;
    if (kk >= nk || k < 0) continue;
    const float* x = tile + j * S + kk * d + q * C;
    float* y = dst + ((c0 + j) * Nd + k) * d + q * C;
    if constexpr (C == 4) {
      *reinterpret_cast<float4*>(y) = *reinterpret_cast<const float4*>(x);
    } else if constexpr (C == 2) {
      *reinterpret_cast<float2*>(y) = *reinterpret_cast<const float2*>(x);
    } else {
      *y = *x;
    }
  }
}

// cp.async copies of nb consecutive S-float blocks of each of nl lanes
// (lane l0 + j's first at src + j·gstride) to dst + j·sstride.
template <int S>
__device__ __forceinline__ void load_blocks(float* dst, int sstride, const float* src,
                                            long gstride, int nl, int nb) {
  constexpr int C = chunk_floats(S), per = S / C, most = (kColumnKnots + 1) * per;
  for (int e = threadIdx.x; e < nl * most; e += blockDim.x) {
    const int j = e / most, q = e - j * most;
    if (q < nb * per)
      __pipeline_memcpy_async(dst + j * sstride + q * C, src + j * gstride + q * C,
                              C * sizeof(float));
  }
}

// One stage's copies: knots k0 … k0 + nk − 1 of the block's columns (the
// backward sweep's qs, b, qv; the forward's b, stashed p, stashed kff) and
// of its lanes (P for knots k0 … k0 + nk, clipped to N − 1; Lv and Mvs
// backward, Kg forward; A, B).
template <int NS, int NV, bool FORWARD>
__device__ __forceinline__ void load_chunk(float* stage, int T, int nl, const ResolveIn& in,
                                           const ForwardIO& io, long c0, int nc, int l0, int N,
                                           int k0, int nk) {
  using Lay = ColumnLayout<NS, NV>;
  if (FORWARD) {
    load_rows<NS>(stage, in.b, c0, nc, N, k0, nk);
    load_rows<NS>(stage + Lay::T2(T), io.dzs, c0, nc, N, k0, nk);
    load_rows<NV>(stage + Lay::TV(T), io.dzv, c0, nc, N, k0, nk);
  } else {
    load_rows<NS>(stage, in.qs, c0, nc, N, k0, nk);
    load_rows<NS>(stage + Lay::T2(T), in.b, c0, nc, N, k0, nk);
    load_rows<NV>(stage + Lay::TV(T), in.qv, c0, nc, N, k0, nk);
  }
  float* ln = stage + Lay::lanes_at(T);
  const long st = (long)l0 * N + k0, ls = N;
  const int nP = (k0 + nk + 1 <= N ? nk + 1 : nk);
  load_blocks<NS * NS>(ln + Lay::P, Lay::lane, in.P + st * NS * NS, ls * NS * NS, nl, nP);
  if (FORWARD) {
    load_blocks<NV * NS>(ln + Lay::MK, Lay::lane, in.Kg + st * NV * NS, ls * NV * NS, nl, nk);
  } else {
    load_blocks<NV * NV>(ln + Lay::Lv, Lay::lane, in.Lv + st * NV * NV, ls * NV * NV, nl, nk);
    load_blocks<NV * NS>(ln + Lay::MK, Lay::lane, in.Mvs + st * NV * NS, ls * NV * NS, nl, nk);
  }
  load_blocks<NS * NS>(ln + Lay::A, Lay::lane, in.A + st * NS * NS, ls * NS * NS, nl, nk);
  load_blocks<NS * NV>(ln + Lay::B, Lay::lane, in.B + st * NS * NV, ls * NS * NV, nl, nk);
}

// One row of M floats from shared memory (16 bytes at a time where M is a
// multiple of 4: the row tiles keep such rows on 16 bytes).
template <int M>
__device__ __forceinline__ void load_row(float (&x)[M], const float* src) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + q);
      x[q] = v.x, x[q + 1] = v.y, x[q + 2] = v.z, x[q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) x[i] = src[i];
  }
}

template <int M>
__device__ __forceinline__ void store_row(float* dst, const float (&x)[M]) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M; q += 4)
      *reinterpret_cast<float4*>(dst + q) = make_float4(x[q], x[q + 1], x[q + 2], x[q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < M; ++i) dst[i] = x[i];
  }
}

// The arithmetic, in the order of summation, of resolve_grouped for one
// column. Thread g of the launch serves column c = g of the (L·R) columns,
// r = c mod R of lane l = c / R. The block runs its columns through the
// knots in chunks of kColumnKnots: each chunk's rows and stored blocks
// arrive by cp.async while the previous chunk computes; each thread reads
// its rows from the stage and writes its results into the slots it read
// (p over qs and kff over qv backward; λ over b, s over p, v over kff
// forward), and the block stores the chunk's results to global memory
// together, a warp on whole sectors. Threads past L·R (the last block's)
// take part in every __syncthreads and copy, and compute on what they find.
template <int NS, int NV>
__global__ void __launch_bounds__(kColumnBlock)
    resolve_columns(int L, int N, int R, int lanes, unsigned s0mask, ResolveIn in, ForwardIO io) {
  using Lay = ColumnLayout<NS, NV>;
  constexpr int D = kStages, KC = kColumnKnots;
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x;
  const long LR = (long)L * R, c0 = (long)blockIdx.x * T, c = c0 + threadIdx.x;
  const int nc = (int)(c0 + T < LR ? T : LR - c0);  // columns of this block
  const long cc = c < LR ? c : LR - 1;
  const int l0 = (int)(c0 / R), j = (int)(cc / R) - l0;
  const int nl = (int)((c0 + nc - 1) / R) - l0 + 1;  // lanes of this block
  const int stage = Lay::stage(T, lanes);
  const int nq = (N + KC - 1) / KC;  // chunks
  const int t = threadIdx.x;
  float* const sL0 = smem + Lay::L0(T, lanes);

  // ---- backward sweep: w, kff, p; p_k and kff_k stashed in dzs, dzv ----
  float p[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) p[i] = 0.0f;
  load_chunk<NS, NV, false>(smem, T, nl, in, io, c0, nc, l0, N, (nq - 1) * KC,
                            N - (nq - 1) * KC);
  __pipeline_commit();
  for (int it = 0; it < nq; ++it) {
    const int q = nq - 1 - it, k0 = q * KC, nk = N - k0 < KC ? N - k0 : KC;
    float* const cur = smem + (it % D) * stage;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (q >= 1)
      load_chunk<NS, NV, false>(smem + ((it + 1) % D) * stage, T, nl, in, io, c0, nc, l0, N,
                                k0 - KC, KC);
    __pipeline_commit();
    float* const tq = cur + t * Lay::SS;               // qs, then p
    const float* const tb = cur + Lay::T2(T) + t * Lay::SS;  // b
    float* const tv = cur + Lay::TV(T) + t * Lay::SV;  // qv, then kff
    const float* const ln = cur + Lay::lanes_at(T) + j * Lay::lane;
    for (int kk = nk - 1; kk >= 0; --kk) {
      const int k = k0 + kk;
      const float* Pn = ln + Lay::P + (kk + 1) * NS * NS;
      const float* Lvk = ln + Lay::Lv + kk * NV * NV;
      const float* Mvs = ln + Lay::MK + kk * NV * NS;
      const float* A = ln + Lay::A + kk * NS * NS;
      const float* B = ln + Lay::B + kk * NS * NV;
      float qs[NS], qv[NV], b[NS];
      load_row(qs, tq + kk * NS);
      load_row(qv, tv + kk * NV);
      load_row(b, tb + kk * NS);
      // w = P_{k+1}·b + p (P_N = 0)
      float w[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float acc = 0.0f;
        if (k < N - 1) {
#pragma unroll
          for (int e = 0; e < NS; ++e) acc += b[e] * Pn[i * NS + e];
        }
        w[i] = acc + p[i];
      }
      float Lv[NV][NV];
#pragma unroll
      for (int a = 0; a < NV; ++a)
#pragma unroll
        for (int e = 0; e < NV; ++e) Lv[a][e] = Lvk[a * NV + e];
      float kff[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) acc += w[i] * B[i * NV + a];
        kff[a] = qv[a] + acc;
      }
      cho_solve<NV>(Lv, kff, NV);
#pragma unroll
      for (int a = 0; a < NV; ++a) kff[a] = -kff[a];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < NS; ++e) acc += w[e] * A[e * NS + i];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += kff[a] * Mvs[a * NS + i];
        p[i] = (qs[i] + acc) + acc2;
      }
      store_row(tq + kk * NS, p);    // stash p_k
      store_row(tv + kk * NV, kff);  // stash kff_k
    }
    __syncthreads();
    store_rows<NS>(io.dzs, cur, c0, nc, N, k0, nk, 0);
    store_rows<NV>(io.dzv, cur + Lay::TV(T), c0, nc, N, k0, nk, 0);
  }
  // the stashes stored, and every thread's reads of the ring done, before
  // the forward sweep reads them back and refills the ring
  __syncthreads();

  // ---- the initial-state solve and the forward sweep ----
  load_blocks<NS * NS>(sL0, align4(NS * NS), in.L0 + (long)l0 * NS * NS, NS * NS, nl, 1);
  load_chunk<NS, NV, true>(smem, T, nl, in, io, c0, nc, l0, N, 0, N < KC ? N : KC);
  __pipeline_commit();
  float s[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.0f;
  for (int q = 0; q < nq; ++q) {
    const int k0 = q * KC, nk = N - k0 < KC ? N - k0 : KC;
    float* const cur = smem + (q % D) * stage;
    __pipeline_wait_prior(0);
    __syncthreads();
    if (q + 1 < nq)
      load_chunk<NS, NV, true>(smem + ((q + 1) % D) * stage, T, nl, in, io, c0, nc, l0, N,
                               k0 + KC, N - k0 - KC < KC ? N - k0 - KC : KC);
    __pipeline_commit();
    if (q == 0) {  // s_0 from the masked initial factor and p_0
      float x[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) x[i] = ((s0mask >> i) & 1u) ? p[i] : 0.0f;
      solve_l0<NS>(sL0 + j * align4(NS * NS), x);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = ((s0mask >> i) & 1u) ? -x[i] : 0.0f;
    }
    float* const tb = cur + t * Lay::SS;               // b, then λ
    float* const tp = cur + Lay::T2(T) + t * Lay::SS;  // stashed p, then s
    float* const tv = cur + Lay::TV(T) + t * Lay::SV;  // stashed kff, then v
    const float* const ln = cur + Lay::lanes_at(T) + j * Lay::lane;
    for (int kk = 0; kk < nk; ++kk) {
      const int k = k0 + kk;
      const float* fP = ln + Lay::P + kk * NS * NS;
      const float* fKg = ln + Lay::MK + kk * NV * NS;
      const float* fA = ln + Lay::A + kk * NS * NS;
      const float* fB = ln + Lay::B + kk * NS * NV;
      float b[NS], ps[NS], kf[NV];
      load_row(b, tb + kk * NS);
      load_row(ps, tp + kk * NS);
      load_row(kf, tv + kk * NV);
      if (k >= 1) {
        float lam[NS];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          float acc = 0.0f;
#pragma unroll
          for (int e = 0; e < NS; ++e) acc += fP[i * NS + e] * s[e];
          lam[i] = -(acc + ps[i]);
        }
        store_row(tb + kk * NS, lam);
      }
      float v[NV];
#pragma unroll
      for (int a = 0; a < NV; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < NS; ++e) acc += s[e] * fKg[a * NS + e];
        v[a] = acc + kf[a];
      }
      float sn[NS];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float acc = 0.0f;
#pragma unroll
        for (int e = 0; e < NS; ++e) acc += s[e] * fA[i * NS + e];
        float acc2 = 0.0f;
#pragma unroll
        for (int a = 0; a < NV; ++a) acc2 += v[a] * fB[i * NV + a];
        sn[i] = acc + acc2 + b[i];
      }
      store_row(tp + kk * NS, s);
      store_row(tv + kk * NV, v);
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = sn[i];
    }
    __syncthreads();
    store_rows<NS>(io.lam, cur, c0, nc, N - 1, k0, nk, 1);
    store_rows<NS>(io.dzs, cur + Lay::T2(T), c0, nc, N, k0, nk, 0);
    store_rows<NV>(io.dzv, cur + Lay::TV(T), c0, nc, N, k0, nk, 0);
  }
}

template <int NS, int NV>
int launch_resolve_columns(int L, int N, int R, unsigned s0mask, const ResolveIn& in,
                           const ForwardIO& io, cudaStream_t s) {
  using Lay = ColumnLayout<NS, NV>;
  int T = kColumnBlock;  // fewer columns a block where a lane's stages would not fit (R = 1)
  while (T > 32 && Lay::bytes(T, R) > (size_t)kBlockSmem) T /= 2;
  const size_t bytes = Lay::bytes(T, R);
  if (bytes > (size_t)kBlockSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      resolve_columns<NS, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long threads = (long)L * R;
  resolve_columns<NS, NV><<<(unsigned)((threads + T - 1) / T), T, bytes, s>>>(
      L, N, R, Lay::lanes(T, R), s0mask, in, io);
  return (int)cudaGetLastError();
}

template <int NS, int NV, int R>
unsigned grouped_grid(int L) {
  constexpr int lanes = GroupLayout<NS, NV, R>::lanes;
  return (unsigned)((L + lanes - 1) / lanes);
}


}  // namespace

// Lane-major K1: stage stacks (L, N, r, c) and right-hand sides (L, R, N, d)
// in, contiguous and 16-byte aligned; P, Lv, Kg, Mvs (L, N, r, c), L0
// (L, ns, ns), ok (L,), dzs, dzv (L, R, N, d) and λ (L, R, N − 1, ns) out.
extern "C" int dto_factor_solve_grouped(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                        const void* Qss, const void* Qsv, const void* Qvv,
                                        const void* A, const void* B, const void* qs,
                                        const void* qv, const void* rb, void* P, void* Lv,
                                        void* Kg, void* Mvs, void* L0, void* ok, void* dzs,
                                        void* dzv, void* lam, void* stream) {
  if (L < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FactorIn in{(const float*)Qss, (const float*)Qsv, (const float*)Qvv, (const float*)A,
                    (const float*)B,   (const float*)qs,  (const float*)qv,  (const float*)rb};
  const FactorOut out{(float*)P,  (float*)Lv,  (float*)Kg,  (float*)Mvs, (float*)L0,
                      (float*)ok, (float*)dzs, (float*)dzv, (float*)lam};
  if (ns == 8 && nv == 3 && R == 3)
    factor_solve_grouped<8, 3, 3>
        <<<grouped_grid<8, 3, 3>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else if (ns == 2 && nv == 1 && R == 3)
    factor_solve_grouped<2, 1, 3>
        <<<grouped_grid<2, 1, 3>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else if (ns == 2 && nv == 1 && R == 7)
    factor_solve_grouped<2, 1, 7>
        <<<grouped_grid<2, 1, 7>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else if (ns == 10 && nv == 3 && R == 3)
    factor_solve_grouped<10, 3, 3>
        <<<grouped_grid<10, 3, 3>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else if (ns == 18 && nv == 3 && R == 3)
    factor_solve_grouped<18, 3, 3>
        <<<grouped_grid<18, 3, 3>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else if (ns == 4 && nv == 1 && R == 1)
    factor_solve_grouped<4, 1, 1>
        <<<grouped_grid<4, 1, 1>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, out);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}


// Lane-major K2: stored factors P, Lv, Kg, Mvs (L, N, r, c), L0 (L, ns, ns),
// A, B (L, N, r, c) and right-hand sides (L, R, N, d) in, contiguous and
// 16-byte aligned; dzs, dzv (L, R, N, d) and λ (L, R, N − 1, ns) out.
extern "C" int dto_resolve_grouped(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                   const void* P, const void* Lv, const void* Kg,
                                   const void* Mvs, const void* L0, const void* A,
                                   const void* B, const void* qs, const void* qv,
                                   const void* rb, void* dzs, void* dzv, void* lam,
                                   void* stream) {
  if (L < 1 || N < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ResolveIn in{(const float*)P,  (const float*)Lv, (const float*)Kg, (const float*)Mvs,
                     (const float*)L0, (const float*)A,  (const float*)B,  (const float*)qs,
                     (const float*)qv, (const float*)rb};
  const ForwardIO io{(const float*)P, (const float*)Kg, (const float*)A, (const float*)B,
                     (const float*)rb, (float*)dzs, (float*)dzv, (float*)lam};
  if (ns == 8 && nv == 3 && R == 2)
    resolve_grouped<8, 3, 2>
        <<<grouped_grid<8, 3, 2>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, io);
  else if (ns == 2 && nv == 1 && R == 2)
    resolve_grouped<2, 1, 2>
        <<<grouped_grid<2, 1, 2>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, io);
  else if (ns == 10 && nv == 3 && R == 2)
    resolve_grouped<10, 3, 2>
        <<<grouped_grid<10, 3, 2>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, io);
  else if (ns == 18 && nv == 3 && R == 2)
    resolve_grouped<18, 3, 2>
        <<<grouped_grid<18, 3, 2>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, io);
  else if (ns == 4 && nv == 1 && R == 2)
    resolve_grouped<4, 1, 2>
        <<<grouped_grid<4, 1, 2>(L), kGroupBlock, 0, s>>>(L, N, s0mask, in, io);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K2 with a thread per (lane, column), 1 ≤ R ≤ 40, on resolve_grouped's
// lane-major tensors (contiguous, 16-byte aligned).
extern "C" int dto_resolve_columns(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                   const void* P, const void* Lv, const void* Kg,
                                   const void* Mvs, const void* L0, const void* A,
                                   const void* B, const void* qs, const void* qv,
                                   const void* rb, void* dzs, void* dzv, void* lam,
                                   void* stream) {
  if (L < 1 || N < 1 || R < 1 || R > kRResolveMax) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ResolveIn in{(const float*)P,  (const float*)Lv, (const float*)Kg, (const float*)Mvs,
                     (const float*)L0, (const float*)A,  (const float*)B,  (const float*)qs,
                     (const float*)qv, (const float*)rb};
  const ForwardIO io{(const float*)P, (const float*)Kg, (const float*)A, (const float*)B,
                     (const float*)rb, (float*)dzs, (float*)dzv, (float*)lam};
  if (ns == 4 && nv == 1) return launch_resolve_columns<4, 1>(L, N, R, s0mask, in, io, s);
  return (int)cudaErrorInvalidValue;
}
