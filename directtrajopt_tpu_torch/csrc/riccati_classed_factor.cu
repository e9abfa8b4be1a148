// K1's size-class kernels (riccati_classed.cuh), one instantiation a class
// of ops/riccati_kernel.py SIZE_CLASSES, and their C entries. A source of
// its own, so that nvcc builds it beside the other kernels' sources.

#include "riccati_classed.cuh"

// Size-class K1 at any (n_s, n_v, R) within the class (nsc, nvc, rc), on
// factor_solve_grouped's lane-major tensors (contiguous, 16-byte aligned).
// smem_bytes: the class's shared memory a block as the wrapper computed it
// (classed_smem_bytes); a call whose bytes are not the class's own, or
// exceed a block's 227 KB, is refused.
extern "C" int dto_factor_solve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                        int nsc, int nvc, int rc, int smem_bytes,
                                        const void* Qss, const void* Qsv, const void* Qvv,
                                        const void* A, const void* B, const void* qs,
                                        const void* qv, const void* rb, void* P, void* Lv,
                                        void* Kg, void* Mvs, void* L0, void* ok, void* dzs,
                                        void* dzv, void* lam, void* stream) {
  if (L < 1 || N < 1 || ns < 1 || nv < 1 || R < 1 || smem_bytes > kBlockSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const FactorIn in{(const float*)Qss, (const float*)Qsv, (const float*)Qvv, (const float*)A,
                    (const float*)B,   (const float*)qs,  (const float*)qv,  (const float*)rb};
  const FactorOut out{(float*)P,  (float*)Lv,  (float*)Kg,  (float*)Mvs, (float*)L0,
                      (float*)ok, (float*)dzs, (float*)dzv, (float*)lam};
  if (nsc == 4 && nvc == 4 && rc == 8)
    return launch_factor_solve_classed<4, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out, s);
  if (nsc == 8 && nvc == 4 && rc == 8)
    return launch_factor_solve_classed<8, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out, s);
  if (nsc == 16 && nvc == 4 && rc == 8)
    return launch_factor_solve_classed<16, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out, s);
  if (nsc == 8 && nvc == 8 && rc == 8)
    return launch_factor_solve_classed<8, 8, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out, s);
  if (nsc == 16 && nvc == 8 && rc == 8)
    return launch_factor_solve_classed<16, 8, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out, s);
  if (nsc == 24 && nvc == 24 && rc == 8)
    return launch_factor_solve_classed<24, 24, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, out,
                                                  s);
  return (int)cudaErrorInvalidValue;
}

// The shared memory a block of the size class (nsc, nvc, rc) takes, in
// bytes (both kinds), or −1 for a class with no instantiation.
extern "C" int dto_classed_smem_bytes(int nsc, int nvc, int rc) {
  if (nsc == 4 && nvc == 4 && rc == 8) return ClassLayout<4, 4, 8>::bytes;
  if (nsc == 8 && nvc == 4 && rc == 8) return ClassLayout<8, 4, 8>::bytes;
  if (nsc == 16 && nvc == 4 && rc == 8) return ClassLayout<16, 4, 8>::bytes;
  if (nsc == 8 && nvc == 8 && rc == 8) return ClassLayout<8, 8, 8>::bytes;
  if (nsc == 16 && nvc == 8 && rc == 8) return ClassLayout<16, 8, 8>::bytes;
  if (nsc == 24 && nvc == 24 && rc == 8) return ClassLayout<24, 24, 8>::bytes;
  return -1;
}
