// Declarations shared by the window Jacobian and residual kernels' sources
// (expv_kernel.cu: the exact instantiations and the C entries;
// expv_classed.cu: the size-class kernels): the views a launch reads, the
// generators, the launch-fixed divisor, the Jacobian's column map, the
// launch limits, and the size-class launchers the C entries call.

#pragma once

#include <cuda_runtime.h>

namespace expv {

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

// The Pallas kernels' caps on x_dim and n_drives.
constexpr int kDimMax = 8;

// x_dim and n_drives of a call, which the size-class kernels take at run
// time.
struct Dims {
  int xd, nd;
};

// Where K3 puts −J's columns in a row of its d-wide output: the state's
// x_dim columns from x, the drives' from u, ∂/∂Δt at t (−1: a fixed Δt, no
// such column). Every other column holds +0.
struct JacCols {
  int d, x, u, t;
};

constexpr int kResBlock = 256;          // K4 threads per block
constexpr size_t kResSmem = 48 * 1024;  // the L1 form's partials (no opt-in)
constexpr size_t kJacSmem = 48 * 1024;  // K3's output tile (no opt-in)

// The size-class K3 and K4 (expv_classed.cu) at any 1 ≤ xd ≤ 8, 0 ≤ nd ≤ 8,
// the class chosen from (dims.xd, dims.nd); the arguments are the exact
// launchers'. cudaErrorInvalidValue, launching nothing, where a warp's
// windows' output tile exceeds kJacSmem (K3) or the L1 form's partials
// exceed kResSmem (K4).
int launch_jac_classed(int P, int T, int K, int order, const Gens& g, const View& u,
                       const View& dt, const View& x, const JacCols& c, const Dims& dims,
                       float* out, cudaStream_t s);
int launch_res_classed(bool l1, int P, int T, int K, int order, const Gens& g, const View& u,
                       const View& dt, const View& x, const View& xn, const Dims& dims,
                       float* out, cudaStream_t s);

}  // namespace expv
