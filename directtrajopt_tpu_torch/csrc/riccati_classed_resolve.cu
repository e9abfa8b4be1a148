// K2's size-class kernels (riccati_classed.cuh), one instantiation a class
// of ops/riccati_kernel.py SIZE_CLASSES, and their C entry. A source of its
// own, so that nvcc builds it beside the other kernels' sources.

#include "riccati_classed.cuh"

// Size-class K2, 1 ≤ R ≤ 40 in tiles of rc, on resolve_grouped's
// lane-major tensors; smem_bytes as for dto_factor_solve_classed.
extern "C" int dto_resolve_classed(int L, int N, int ns, int nv, int R, unsigned s0mask,
                                   int nsc, int nvc, int rc, int smem_bytes, const void* P,
                                   const void* Lv, const void* Kg, const void* Mvs,
                                   const void* L0, const void* A, const void* B, const void* qs,
                                   const void* qv, const void* rb, void* dzs, void* dzv,
                                   void* lam, void* stream) {
  if (L < 1 || N < 1 || ns < 1 || nv < 1 || R < 1 || R > kRResolveMax ||
      smem_bytes > kBlockSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const ResolveIn in{(const float*)P,  (const float*)Lv, (const float*)Kg, (const float*)Mvs,
                     (const float*)L0, (const float*)A,  (const float*)B,  (const float*)qs,
                     (const float*)qv, (const float*)rb};
  const ForwardIO io{(const float*)P, (const float*)Kg, (const float*)A, (const float*)B,
                     (const float*)rb, (float*)dzs, (float*)dzv, (float*)lam};
  if (nsc == 4 && nvc == 4 && rc == 8)
    return launch_resolve_classed<4, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  if (nsc == 8 && nvc == 4 && rc == 8)
    return launch_resolve_classed<8, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  if (nsc == 16 && nvc == 4 && rc == 8)
    return launch_resolve_classed<16, 4, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  if (nsc == 8 && nvc == 8 && rc == 8)
    return launch_resolve_classed<8, 8, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  if (nsc == 16 && nvc == 8 && rc == 8)
    return launch_resolve_classed<16, 8, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  if (nsc == 24 && nvc == 24 && rc == 8)
    return launch_resolve_classed<24, 24, 8>(L, N, ns, nv, R, s0mask, smem_bytes, in, io, s);
  return (int)cudaErrorInvalidValue;
}
