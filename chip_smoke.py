"""Drive the PyTorch port of directtrajopt_tpu on one NVIDIA GPU.

    python3 chip_smoke.py            # full size: B=8192 lanes, N=51 knots

Phases, each printing its own lines:

1. Environment: the card's name and power limit, torch / CUDA versions, and
   the seconds the kernel build took (the CUDA sources under
   ``directtrajopt_tpu_torch/csrc`` are compiled at first use).
2. Every kernel of the main path against its plain PyTorch version on the
   card, in float32, at the shapes the pipeline gives it (and the
   size-class Riccati kernels at other shapes and, beside each exact
   instance, on the same call): deviation, bound, median CUDA-event
   times of kernel and plain version, and the kernel's time bound (bytes
   over the card's memory rate, or float32 operations over its peak). The
   K2 and K4 rows add the kernel's device time per launch from
   ``torch.profiler``. K4 reads the line search's trial grid in place, as
   strided views of the knot matrix (problems × slots × knots × width).
   Then the same at the state-constrained family's shapes: K3/K4 for a
   2-D state with 1 drive at a fixed Δt, K1/K2 at (n_s, n_v) = (2, 1) on
   inputs captured from that family's own solve, one lane made indefinite.
3. Path 1, the certified two-stage pipeline (Gauss-Newton seek,
   exact-Hessian polish) at B=8192 through ``solve_batch_compact``, with
   each kernel's launch count, the converged share, the KKT error and
   RMS(u) against the golden optimum over the converged lanes.
4. Path 2, the state-constrained family (‖x_k‖² ≤ cap at every knot: one
   fast inequality row per knot, slacks and duals) at B=8192, N=51, float32,
   exact Hessian, compensated residuals, with each kernel's launch count,
   the converged share, the KKT error, max |u − u*| against the float64
   golden ``tests/golden/torch/state_constrained_n51.npz`` and the
   constraint's violation over the converged lanes.
5. Path 3, the global-phase family (a global θ ∈ ℝ², the Riccati
   backend's arrowhead border) at B=8192, N=51, float32: R3 and R′ as the
   structure analysis gives them, each kernel's launch count, the
   converged share, the KKT error, |u − u*| and |θ − θ*| against
   ``tests/golden/torch/global_phase_n51.npz``, the two equalities'
   residuals, and the device copies per iteration beside path 2's. Phase 2
   holds K1 (2,1,R3) and K2 (2,1,R′) on path 3's captured calls, and K3/K4
   on its knot matrix, whose lane stride is N·d + n_g, with no copy.
6. Path 4, the solver's scheduled and polished entry points on path 1's
   family (float32, N=51). First K1-K4 against their plain versions at the
   shapes path 4 adds: K4 on 8192 lanes × 9 slots (4a's first phase runs
   the whole batch in one lockstep), and K1-K4 on 1024 lanes (4b's float32
   phase). 4a: ``solve_batch_scheduled`` at B=8192 (``scheduled_config()``:
   the seek's options, 24 + 112 iterations, chunks of 256, a 32-row
   telemetry ring on the card) with each phase's seconds, iterations and
   launches, the straggler count, the converged share, the KKT error,
   max |u, du, ddu − ref| on lanes 0-63 against
   ``tests/golden/torch/scheduled_n51.npz`` and the ring's soundness. 4b:
   ``solve_batch_polished`` on lanes 0-1023 (``polished_config()``): each
   phase's seconds, iterations and launches (the float64 polish runs the
   kernels' plain versions: 0 launches), the converged share, the KKT
   error, RMS(u) against the golden optimum, and the float64 polish's
   seconds per lockstep iteration beside path 1's float32 polish's. The
   launch check covers 4a and 4b's float32 phase together.
7. Path 5, the cartpole family (general RK4 dynamics through
   ``GeneralIntegrator``, N=40, x 4, u 1, fixed Δt, lane i from seed i) at
   B=8192 in float32 in one lockstep chunk. 5a: the exact Hessian
   (``cartpole_config()``: ``torch.func`` Jacobians and Hessians of the RK4
   step at full width, K1 grouped (4,1,1), K2 grouped (4,1,2)); 5b: L-BFGS
   with m = 20 (``cartpole_lbfgs_config()``: no AD Hessian, σI in the stage
   blocks and the SMW correction through K2 at (4,1,40), the column kernel
   ``resolve_columns<4,1>``, once an iteration). Each with its seconds,
   lockstep passes and launches (K1/K2 by kernel: no size-class K1/K2), the
   converged share and, over the converged lanes, the KKT error,
   |obj/obj* − 1| and RMS(u − u*) against ``tests/golden/cartpole_n40_
   seed0.npz``. 5c: lanes 0-255 of path 1's batch with the seek's options,
   five times, each with one option changed (Mehrotra μ, adaptive μ,
   ``ls_memory=4``, least-squares initial duals, float64 residual
   refinement), each with its seconds, converged count, iterations and K1 /
   K2 launches; every lane must end finite. Phase 2 holds K1 (4,1,1) and K2
   (4,1,2) on 5a's captured calls and K2 (4,1,40) on 5b's (the SMW columns
   of a later iteration), and beside them, on the same calls, the
   size-class kernels; and on stage data at 256 lanes the K1 split at
   R = 9 (K1 on 8 columns, K2 on the ninth), the column K2 at (4,1,40)
   (bitwise the same as five launches of 8 columns; R = 41 takes the plain
   version) and the size-class K2 at (5,2,40) (bitwise its five tiles).

8. Path 6, the dense KKT backend (``chip_smoke.path6``). 6a: the order-1
   time-dependent family (``make_batched_td_problems``: the 4-D Pauli state
   under G(u, t), u linear between knots, Δt free and equal at every knot;
   not Riccati-eligible) at B=2048, N=51, float64, backend "auto", which
   must warn and fall back to dense: the converged share, the KKT error,
   ``td_error`` and, on lanes 0-15, |obj/obj* − 1| and |u − u*| against
   ``tests/golden/torch/td_order1_n51.npz`` with the iterations beside the
   golden's. 6b: lanes 0-255 of path 1's batch on the dense backend with
   the seek's options, twice: the converged share against its bar from the
   JAX package (``tools/torch_dense_bars.py``), iterations beside path 1's
   seek on the same lanes, the two runs' Z bitwise equal. 6c: lanes 0-1023
   of path 5's batch with 5b's L-BFGS options on the dense backend: 5b's
   certificate, and |obj_dense/obj_riccati − 1| against 5b per lane. Each
   with seconds, lockstep passes, factorizations a KKT step, peak memory,
   one ``prepare`` and one batched Cholesky timed at its shape, and its
   launches: K1-K3 (and on 6a and 6c K4) must stay at 0, K4 must run on
   6b's line search.

9. Path 7, the scaling family (``make_batched_scaled_problems``: random
   generators, lane i from seed 42 + i; the JAX package's
   ``bench_sweep.py``) at N=51 in float32 through ``solve_batch_compact``
   with ``scaled_config()``. 7a: state_dim 8, Padé (the grouped K1
   (10,3,3) and K2 (10,3,2)); 7b: state_dim 16, Padé (the grouped K1/K2 at
   (18,3,·)); 7c: state_dim 8 with the Taylor action of order 12 (K1/K2 as
   7a, the size-class K3/K4 ``window_jac_classed<8,2>`` and
   ``residual_classed<8,2,·>`` at (8,2)); 7e: state_dim 4, Padé (K1 (6,3,3) and
   K2 (6,3,2): the size-class kernels ``factor_solve_classed<8,4,8>`` and
   ``resolve_classed<8,4,8>``). Each with its seconds, lockstep passes,
   iterations, launches (by kernel, and K1/K2 by instantiation: the exact
   ones on 7a-7c, the size-class ones on 7e) and plain calls (0), the
   converged share against its bar (the JAX package's share on lanes 0-63
   less 0.1, ``tools/torch_scaled_bars.py``), the KKT error, and
   |obj/obj* − 1| on lanes 0-3 against the float64 golden
   ``tests/golden/torch/scaled.npz`` (7e's ``scaled_dim4.npz``). 7d: state_dim 23 (n_s 25,
   x_dim 23), beyond every kernel's caps, 64 lanes at N=11: the plain
   versions on the card (``PLAIN_CALLS`` > 0, no launch), the first 5
   iterations' steps and Z as on the CPU, the whole solve certified, and
   no more lanes parting from the CPU's solve than part between two
   float32 solves. Phase 2 holds the grouped K1/K2 on 7a's and 7b's
   captured calls and the size-class ones on 7e's, and beside the grouped
   ones on the same calls the size-class kernels (each device time beside
   the grouped one's), the size-class ones at the range's corner
   (24,24,8), the size-class K3/K4 on 7c's knot matrix and at
   (3,1), (6,2) and (8,8), and K3/K4 at 9 drives, beyond the caps, on the plain
   version.

10. Path 8, path 1's pipeline sharded over two processes that share the
   card (``chip_smoke.path8``): ``torch.multiprocessing.spawn`` starts two
   ranks, which join a gloo group (``file://`` rendezvous in a temporary
   directory); each builds path 1's batch, takes its 4096 lanes and runs
   the seek and the polish with path 1's options through
   ``parallel.solve_batch_compact_sharded``, whose one gather gives both
   ranks the whole result. Held to path 1's result of this run: per-lane
   iterations of both stages and converged flags equal, Z bitwise; path 1's
   certificate; on each rank K1-K4 launched and no plain call. Its seconds
   and certified solves/s beside path 1's, then ``parallel.weak_scaling``
   at 1 and 2 ranks on the seek's lockstep solve (its options, its first
   phase's 20 iterations), 1024 lanes a rank.
11. The z_k gates of ``integrators/base.py``: ``stack_hessians_zk`` on the
   calls captured from path 1's polish (256 lanes: the bilinear integrator
   and two derivative integrators) and from path 2 (8192 lanes), under
   the default, ``DTX_ZK_CUSTOM_HESS``, ``DTX_ZK_READCOLS`` and both: wall
   ms (CUDA events, median of 20) and device ms (profiler, 3 calls) a
   prepare, each
   setting within 1e-5 of the call's largest entry of the default; then
   path 2 with both gates on, beside its default run, certified on every
   converged lane.

Exits non-zero if there is no CUDA device, if any kernel fails to build,
launch or agree, if a kernel of a path was never launched during it (or a
Riccati kernel was on path 6), if a float32 call on paths 1-8 took a
plain version, if path 6b's two runs differ or 6a's fallback warning is
missing, if path 8's result is not path 1's, if a rank of path 8 fails, if
a z_k gate disagrees with the default, or if a path's result does not meet
its certificate. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

GOLDEN_RMS = 1e-4  # max RMS(u) against the golden optimum, per converged lane
GOLDEN_U = 1e-4  # path 2: max |u − u*| against its golden optimum, per converged lane
KKT_CERT = 1e-6  # max KKT error per converged lane
VIOL_CERT = 1e-6  # path 2: max (‖x_k‖² − cap) per converged lane
# path 3, per converged lane: |θ − θ*| against the tol-1e-10 optimum and the
# two equalities' residuals; on lanes 0-63, |Z − Z_ref| against the JAX
# package's f64 solve of those lanes at the cell's own options (tol 1e-6).
# |u − u*| against the optimum gets a loose bar: u is weakly determined, and
# every solve at tol 1e-6 (either package, f32 or f64) stops up to 5.8e-3
# from the optimum's u, at the point Z_ref holds
GOLDEN_THETA = 1e-4
EQ_CERT = 1e-6
GOLDEN_REF3 = 1e-4
GOLDEN_U3 = 1e-2
# path 4a, on lanes 0-63: |u, du, ddu − ref| against the JAX package's f64
# scheduled solve at the cell's options; path 4b: the KKT error after the
# float64 polish (the bars of tests/test_golden.py)
GOLDEN_REF4 = 1e-4
KKT_POLISH = 1e-7
# path 5, per converged lane, against the float64 optimum of the cartpole
# family: 5a (exact Hessian, tol 1e-5) and 5b (L-BFGS, tol 1e-4; the JAX
# package's float32 L-BFGS of the same 8192 lanes reaches 3.253e-2 on the
# objective and stops along the flat u-valley, so u is not certified;
# tools/torch_cartpole_ref.py --lbfgs). 5a's RMS(u) bar is
# 2e-3: the JAX package's own float32 solve of the same 8192 lanes at the
# same options stops up to 1.464e-3 from u* (174 lanes above 1e-3; median
# 2.5e-4; tools/torch_cartpole_ref.py, PERF.md §6)
KKT_5A, OBJ_5A, RMS_5A = 1e-5, 1e-4, 2e-3
KKT_5B, OBJ_5B = 1e-4, 5e-2
# path 6a, per converged lane: the KKT error and the step-doubling
# estimate of the time-dependent integrator at the solution (the port's
# TD_ACCURACY_ATOL); on lanes 0-15, against the JAX package's float64 solve
# (tests/golden/torch/td_order1_n51.npz), |obj/obj* − 1| and max |u − u*|.
# Path 6b's bar: the JAX package's float32 dense solve of lanes 0-63 at the
# same options converges CONV_6B_JAX of them (tools/torch_dense_bars.py,
# PERF.md §6); the bar is that share less 0.1. Path 6c keeps 5b's bars.
KKT_6A, TD_ATOL, OBJ_6A, U_6A = 1e-8, 1e-3, 1e-6, 1e-4
CONV_6B_JAX = 30 / 64
BAR_6B = CONV_6B_JAX - 0.1
# path 7 (the scaling family, float32): each sub-path runs
# scaled_config()'s batch, one chunk of 128 lanes (cut from 1024: a chunk
# whose slowest lane takes 378 iterations costs 39-186 s, PERF.md §4); its
# bars: the JAX package's
# float32 converged share on lanes 0-63 at the same options (56, 39 and 56
# of 64; tools/torch_scaled_bars.py, PERF.md §6) less 0.1; the KKT error of
# a converged lane at most the options' acceptable_tol; and |obj/obj* − 1|
# ≤ OBJ_7 against the float64 golden (tests/golden/torch/scaled.npz, made at
# the same options) on the golden's lanes where the JAX package's own
# float32 solve comes within OBJ_7 of it (HELD_7: 4.0e-6 on 7a's lane 0,
# 2.6e-6 on 7c's; on the others both packages' float32 solves stop 2e-3 to
# 30 away: these random problems are not convex, and long solves part).
# 7e (state_dim 4, Padé: K1/K2 at (6,3,·), the size-class kernels) has its
# golden in tests/golden/torch/scaled_dim4.npz; the JAX package's float32
# solve converges 62 of its lanes 0-63 and comes within 1.5e-2 to 0.79 of
# the golden's objectives on lanes 0-3, so none of them is held
SUB7 = {"7a": (8, None), "7b": (16, None), "7c": (8, 12), "7e": (4, None)}  # state_dim, order
CONV_7_JAX = {"7a": 56 / 64, "7b": 39 / 64, "7c": 56 / 64, "7e": 62 / 64}
HELD_7 = {"7a": (0,), "7b": (), "7c": (0,), "7e": ()}
# (x_dim, n_drives) of the seeded size-class K3/K4 rows (2048 lanes x 50
# windows, Taylor order 12), shapes no path runs: a real 3-vector with one
# drive (3,1), a qutrit's state as a real vector with two drives (6,2), and
# the caps (8,8)
SEEDED_EXPV = ((3, 1), (6, 2), (8, 8))
OBJ_7, KKT_7 = 1e-3, 5e-4
# 7d: 64 lanes at N=11, state_dim 23 (n_s 25, x_dim 23: beyond every
# kernel's caps), Taylor order 12, on the card and on the CPU. The first
# ITER_7D iterations take the same steps on every lane, each lane's Z
# within Z_7D (relative to max(max |Z|, 1)) of the CPU's; the whole solve
# is certified (KKT, converged count within 10 % of the CPU's), and at
# most PART_7D lanes part: take other iterations than the CPU's, or end
# beyond Z_7D from its Z. Two sound float32 CPU solves, the JAX package's
# and the port's, part so on 24 of the family's first 512 lanes (4.7 %:
# 15 on other iterations, up to 1.0 apart; 9 on equal iterations, 1.2e-3
# to 2.3e-2 apart; the first 5 iterations within 2.1e-4 on every lane;
# tools/torch_scaled_bars.py --witness-7d --lanes 512, PERF.md §6):
# PART_7D is 10 % of the lanes.
STATE_7D, LANES_7D, N_7D, ITER_7D, Z_7D, PART_7D = 23, 64, 11, 5, 1e-3, 6
MIN_CONVERGED = 0.99  # share of lanes that must converge
DEVICE = "cuda:0"

KERNELS = {
    # launch-count key (the size-class K1/K2: their launches in
    # ``_build.INSTANCES``): (route, source, TPU kernel it replaces)
    "factor_solve": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_kernel.cu",
                     "directtrajopt_tpu/ops/riccati_kernel.py:342"),
    "resolve": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_kernel.cu",
                "directtrajopt_tpu/ops/riccati_kernel.py:488"),
    "window_jac": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                   "directtrajopt_tpu/ops/expv_kernel.py:111"),
    "residual": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                 "directtrajopt_tpu/ops/expv_kernel.py:293"),
    "residual_l1": ("cuda", "directtrajopt_tpu_torch/csrc/expv_kernel.cu",
                    "directtrajopt_tpu/ops/expv_kernel.py:293"),
    "factor_solve_classed": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_classed.cuh",
                             "directtrajopt_tpu/ops/riccati_kernel.py:342"),
    "resolve_classed": ("cuda", "directtrajopt_tpu_torch/csrc/riccati_classed.cuh",
                        "directtrajopt_tpu/ops/riccati_kernel.py:488"),
    "window_jac_generic": ("cuda", "directtrajopt_tpu_torch/csrc/expv_classed.cu",
                           "directtrajopt_tpu/ops/expv_kernel.py:111"),
    "residual_generic": ("cuda", "directtrajopt_tpu_torch/csrc/expv_classed.cu",
                         "directtrajopt_tpu/ops/expv_kernel.py:293"),
    "residual_l1_generic": ("cuda", "directtrajopt_tpu_torch/csrc/expv_classed.cu",
                            "directtrajopt_tpu/ops/expv_kernel.py:293"),
}
# the launch counts of the kernels that paths 1-6 run (the exact K1/K2,
# K3/K4 at their exact shapes)
BASE_KERNELS = ("factor_solve", "resolve", "window_jac", "residual", "residual_l1")
# path 2 rows of the kernels table: (row name, launch-count key)
PATH2 = [("factor_solve_sc", "factor_solve"), ("resolve_sc", "resolve"),
         ("window_jac_sc", "window_jac"), ("residual_sc", "residual"),
         ("residual_l1_sc", "residual_l1")]
# path 3 rows: K1 at (2,1,R3), K2 at (2,1,R'), K3/K4 on the knot matrix with
# its global tail
PATH3 = [("factor_solve_gp", "factor_solve"), ("resolve_gp", "resolve"),
         ("window_jac_gp", "window_jac"), ("residual_gp", "residual"),
         ("residual_l1_gp", "residual_l1")]
# path 5c: lanes 0-255 of path 1's batch with the seek's options and one
# option changed: (name, the option, the least share of lanes that must
# converge). Each bar is the JAX package's converged share on lanes 0-63 at
# the same options (float32, CPU: 41, 59, 64, 64 and 64 of 64;
# tools/torch_option_bars.py, PERF.md §6) less 0.1, for the other
# lanes of the 256. The seek's budget of 136 iterations is short for the
# Mehrotra and adaptive rules on this family.
PATH5C = [
    ("mehrotra", dict(mu_strategy="mehrotra"), 0.54),
    ("adaptive", dict(mu_strategy="adaptive"), 0.82),
    ("ls_memory=4", dict(ls_memory=4), 0.9),
    ("least_squares", dict(dual_init="least_squares"), 0.9),
    ("refine_residuals", dict(refine_residuals=True, compensated_residuals=False), 0.9),
]
LANES_5C = 256
# H100 SXM peaks (NVIDIA's data sheet, at 700 W): device memory, and float32
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# thread instructions a second: 132 SMs × 128 lanes at the 1.98 GHz boost
# clock that the float32 peak assumes; and the instructions of one IEEE
# float32 division (a reciprocal, its refinement and the rounding fix-up).
# Both are estimates, beside the bound, for K3's divisions.
INSTR_PER_S = 132 * 128 * 1.98e9
DIV_INSTRUCTIONS = 12


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, reps: int = 20) -> float:
    """Median milliseconds of ``fn`` over ``reps`` CUDA-event timed runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def cuda_ms_back_to_back(fn, calls: int = 20) -> float:
    """Milliseconds per call of ``calls`` calls of ``fn`` between two CUDA
    events: the device's time per call where it, not the host's launch
    work, is the slower of the two (``cuda_ms`` adds the host's time)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def device_ms(fn, name: str, calls: int = 20):
    """Mean device milliseconds per launch of the kernels whose name
    contains ``name``, from ``torch.profiler`` over ``calls`` calls of
    ``fn``; None where the profiler records no such launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, n = 0.0, 0
    for e in prof.key_averages():
        if name in e.key:
            t = getattr(e, "device_time_total", None)
            total_us += e.cuda_time_total if t is None else t
            n += e.count
    return total_us / n / 1e3 if n else None


def op_count(fn, name: str) -> int:
    """Calls of the operator ``name`` (e.g. ``aten::copy_``) that one call of
    ``fn`` makes, from ``torch.profiler``'s host-side record."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.key == name)


def max_dev(ref, out, rel):
    """Deviation of ``out`` from ``ref`` over a tuple of outputs, on their
    finite entries: max |ref − out| (``rel`` False), over max(max |ref|, 1)
    per output (True), or over max(max |ref[..., c]|, 1) per column c of
    the last axis ("col"); and the max absolute deviation. Both are inf
    where the two are not finite at the same entries."""
    worst, worst_abs = 0.0, 0.0
    for x, y in zip(ref, out):
        if x.dtype == torch.bool or not x.numel():
            continue
        fin = torch.isfinite(x)
        if not torch.equal(fin, torch.isfinite(y)):
            return math.inf, math.inf
        x0 = torch.where(fin, x.float(), 0.0)
        d = (x0 - torch.where(fin, y.float(), 0.0)).abs()
        if rel == "col":
            scale = x0.abs().reshape(-1, x.shape[-1]).amax(0).clamp(min=1.0)
        elif rel:
            scale = x0.abs().max().clamp(min=1.0)
        else:
            scale = 1.0
        worst = max(worst, (d / scale).max().item())
        worst_abs = max(worst_abs, d.max().item())
    return worst, worst_abs


def non_finite(outs) -> int:
    """Entries of the outputs that are not finite."""
    return sum(int((~torch.isfinite(t)).sum()) for t in outs if t.dtype != torch.bool)


def nbytes(tensors) -> int:
    """Bytes of storage the tensors touch, each element once: a view that
    overlaps another of the same storage (x and x_next of one knot matrix)
    or repeats its elements (a scalar expanded with stride 0) adds only
    the elements no other view touched."""
    groups: dict = {}
    for t in tensors:
        if torch.is_tensor(t) and t.numel():
            groups.setdefault(t.untyped_storage().data_ptr(), []).append(t)
    total = 0
    for ts in groups.values():
        t0 = ts[0]
        if len(ts) == 1 and t0.is_contiguous():
            total += t0.numel() * t0.element_size()
            continue
        size = t0.element_size()
        if any(t.element_size() != size for t in ts):
            raise ValueError("views of one storage with different element sizes")
        n = t0.untyped_storage().nbytes() // size
        seen = torch.zeros(n, dtype=torch.bool, device=t0.device)
        idx = torch.arange(n, device=t0.device)
        for t in ts:
            seen[idx.as_strided(t.shape, t.stride(), t.storage_offset())] = True
        total += int(seen.sum()) * size
    return total


def time_bound(n_bytes: int, n_ops: int):
    """Least milliseconds the card could take to move ``n_bytes`` (each input
    read once, each output written once) and do ``n_ops`` float32 operations,
    and which of the two bounds it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def riccati_ops(L, N, ns, nv, R, factor: bool) -> int:
    """Float32 operations (a multiply-add counts 2) of K1 (``factor``) or K2:
    per knot and right-hand side the backward w, kff (with its solve) and p,
    and the forward λ, v and next s; K1 adds the factor of every knot."""
    per_rhs = (2 * ns * ns + 2 * ns * nv + 2 * nv * nv + 2 * ns * ns + 2 * nv * ns
               + 2 * ns * ns + 2 * ns * nv + 2 * ns * ns + 2 * nv * ns)
    per_knot = R * per_rhs
    if factor:  # PA, PB, Hvv, Mvs, Cholesky, Kg, AᵀPA + MvsᵀKg
        per_knot += (2 * ns ** 3 + 2 * ns * ns * nv + 2 * nv * nv * ns + 2 * nv * ns * ns
                     + nv ** 3 // 3 + 2 * nv * nv * ns + 2 * ns ** 3 + 2 * ns * ns * nv)
    return L * N * per_knot


def horner_ops(L, K, xd, nd, order, jac: bool, free_time: bool = False) -> int:
    """Float32 operations of K3 (``jac``) or K4 on L lanes × K windows: G and
    A = Δt·G, then per Taylor step y ← x + A·y/k and, for K3, the tangents
    and the matrix E."""
    step = 2 * xd * xd
    if jac:
        step += 4 * nd * xd * xd + 2 * xd ** 3 + (4 * xd * xd if free_time else 0)
    return L * K * (2 * nd * xd * xd + xd * xd + order * step + xd)


def jac_divisions(xd, nd, order, free_time: bool) -> int:
    """Correctly rounded divisions per window of K3: per Taylor step, one
    for each entry of E, of each tangent and of y."""
    return order * xd * (xd + nd + (1 if free_time else 0) + 1)


def stage_data(seed, B, N, dev, ns=8, nv=3, R=3):
    """Well-conditioned random Riccati stage stacks (float32 on ``dev``): the
    generator of the JAX package's Pallas-kernel test, at the slice's sizes."""
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * 2.0
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * 2.0
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [torch.as_tensor(a, dtype=torch.float32, device=dev)
            for a in (Qss, Qsv, Qvv, A, Bm, qs, qv, b)]


def lane_rel(x, ref, mask) -> float:
    """Max over the lanes in ``mask`` of max|x − ref| / max(max|ref|, 1), per lane."""
    d = (x.double() - ref).abs().reshape(x.shape[0], -1).amax(1)
    s = ref.abs().reshape(x.shape[0], -1).amax(1).clamp(min=1.0)
    r = (d / s)[mask]
    if not bool(torch.isfinite(r).all()):
        return math.inf
    return float(r.max()) if r.numel() else 0.0


def well_conditioned(plain, args, tol: float = 1e-3) -> torch.Tensor:
    """Lanes on which the plain float32 version reproduces a float64
    evaluation to ``tol`` relative (per lane, every output; certified lanes
    only where there is a certificate). On the others float32 itself is off
    by more than ``tol``, so two float32 evaluations legitimately disagree
    by more than that (at O(1) on the worst-conditioned lanes)."""
    p32 = plain(*args)
    p64 = plain(args[0], *(t.double() for t in args[1:]))
    mask = torch.ones(args[1].shape[0], dtype=torch.bool, device=args[1].device)
    for x, y in zip(p32, p64):
        if x.dtype == torch.bool:
            mask &= x & y
            continue
        d = (x.double() - y).abs().reshape(x.shape[0], -1).amax(1)
        s = y.abs().reshape(x.shape[0], -1).amax(1).clamp(min=1.0)
        mask &= d / s <= tol
    return mask


class Capture:
    """Record the arguments of the first ``n`` calls of a kernel wrapper."""

    def __init__(self, module, name: str, n: int = 1):
        self.module, self.name, self.n = module, name, n
        self.calls: list = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def wrapped(*args):
            if len(self.calls) < self.n:
                self.calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return self.orig(*args)

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class Timed:
    """Record each call of a solve phase, ``module.name`` (``_solve_impl``):
    its wall seconds (ending in a device sync), lanes, dtype, lockstep
    passes, unconverged lanes and kernel launches."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls: list = []

    def __enter__(self):
        from directtrajopt_tpu_torch.ops import _build

        self.orig = getattr(self.module, self.name)

        def wrapped(problem, options, *args):
            before = dict(_build.LAUNCHES)
            t0 = time.perf_counter()
            r = self.orig(problem, options, *args)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            st = r.ipm.state
            # a lane that stopped on convergence ran one pass more than its count
            stop = st.converged | (st.acc_count >= options.acceptable_iter)
            self.calls.append(dict(
                seconds=sec, lanes=int(r.converged.shape[0]), dtype=str(r.ipm.Z.dtype),
                passes=int((r.ipm.iterations + stop.int()).max()),
                unconverged=int((~r.converged).sum()),
                gauss_newton=options.hessian_approximation == "gauss_newton",
                launches={k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}))
            return r

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def ptxas_summary(log: str) -> list[tuple[str, str, str, str]]:
    """(kernel, registers, stack frame and spills, shared memory) per kernel
    from ``nvcc -Xptxas -v`` output."""
    kernels = ("factor_solve_grouped", "factor_solve_classed", "resolve_grouped",
               "resolve_columns", "resolve_classed", "window_jac_kernel", "residual_grid_kernel",
               "window_jac_classed", "residual_classed")
    out, name, frame = [], None, ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            m = re.search("(" + "|".join(kernels) + r")(I(?:L[ib]\d+E)+E)?", ln)
            name = None if m is None else m.group(1) + (
                "<" + ",".join(re.findall(r"L[ib](\d+)E", m.group(2))) + ">" if m.group(2) else "")
        elif name and "stack frame" in ln:
            frame = ln.split(":", 1)[-1].strip()
        elif name and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln)
            smem = re.search(r"(\d+) bytes smem", ln)
            out.append((name, regs.group(1) if regs else "?", frame,
                        smem.group(1) if smem else "0"))
            name = None
    return out


def base_counts(counts: dict) -> dict:
    """The launch counts of the kernels that paths 1-6 run."""
    return {k: counts.get(k, 0) for k in BASE_KERNELS}


def no_plain_calls(tag: str) -> None:
    """Fail if a float32 call on the card took a plain version since the
    counts were last set to 0."""
    from directtrajopt_tpu_torch.ops import _build

    if any(_build.PLAIN_CALLS.values()):
        fail(f"{tag}: float32 calls took a plain version: {dict(_build.PLAIN_CALLS)}")


def phase_line(tag, what, c):
    print(f"[{tag}] {what}: {c['seconds']:.2f} s, {c['lanes']} lanes ({c['dtype']}), "
          f"{c['passes']} lockstep passes, {c['unconverged']} unconverged after it; "
          f"kernel launches {json.dumps(c['launches'])}", flush=True)


def path6(dev, prob_big, prob_cp, it1, obj5b) -> dict:
    """Path 6, the dense backend: 6a (the order-1 time-dependent family,
    auto → dense, float64), 6b (lanes 0-255 of path 1's batch ``prob_big``,
    float32, twice; ``it1``: path 1's seek iterations) and 6c (lanes 0-1023
    of path 5's cartpole batch ``prob_cp`` with L-BFGS; ``obj5b``: 5b's
    objectives). Prints and certifies each; returns 6b's launches."""
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.module import tree_take
    from directtrajopt_tpu_torch.ops import _build
    from directtrajopt_tpu_torch.solvers import ops_dense
    from directtrajopt_tpu_torch.solvers.canonical import make_nlp
    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    solve_mod = importlib.import_module("directtrajopt_tpu_torch.solvers.solve")
    N = benchmarks.headline_config()["N"]
    N5 = benchmarks.cartpole_config()["N"]

    k1_3 = ("factor_solve", "resolve", "window_jac")
    orig_retry = ops_dense._reg_retry
    retry_stats = {"steps": 0, "factors": 0}

    def counting_retry(factor, *a, **kw):
        retry_stats["steps"] += 1

        def counted(delta):
            retry_stats["factors"] += 1
            return factor(delta)

        return orig_retry(counted, *a, **kw)

    def run6(tag, what, run):
        """One dense solve: its result, its phase record, its launches and
        the factorizations per KKT step."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        retry_stats.update(steps=0, factors=0)
        ops_dense._reg_retry = counting_retry
        try:
            with Timed(solve_mod, "_solve_impl") as tm:
                res = run()
        finally:
            ops_dense._reg_retry = orig_retry
        counts = dict(_build.LAUNCHES)
        c = dict(tm.calls[0], seconds=sum(x["seconds"] for x in tm.calls),
                 passes=sum(x["passes"] for x in tm.calls), launches=counts,
                 unconverged=int((~res.converged).sum()))
        phase_line(tag, what, c)
        per = retry_stats["factors"] / max(retry_stats["steps"], 1)
        print(f"[{tag}] {len(tm.calls)} solve call(s); {retry_stats['steps']} KKT steps, "
              f"{retry_stats['factors']} factorizations ({per:.3f} a step); peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
        return res, c

    def dense_layer(tag, prob, res, gn: bool):
        """The dense context's layer times at the solution of ``res``: one
        ``prepare`` (assembly: residuals, Jacobians, Hessian) and one
        batched Cholesky factorization of a matrix of its shape, CUDA
        events, median of three."""
        nlp = make_nlp(prob)
        ops = ops_dense.DenseOps(nlp)
        Z, st = res.ipm.Z, res.ipm.state
        t_prep = cuda_ms(lambda: ops.prepare(Z, st.lam, st.nu, gauss_newton=gn), reps=3)
        A = torch.randn((Z.shape[0], nlp.z_dim, nlp.z_dim), dtype=Z.dtype, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
        M = A @ A.transpose(-1, -2) / nlp.z_dim + torch.eye(nlp.z_dim, dtype=Z.dtype, device=dev)
        del A
        t_chol = cuda_ms(lambda: torch.linalg.cholesky_ex(M), reps=3)
        del M
        print(f"[{tag}] dense layer at B={Z.shape[0]} z_dim={nlp.z_dim} n_eq={nlp.n_eq} "
              f"{str(Z.dtype).replace('torch.', '')}: prepare (assembly) {t_prep:.2f} ms, "
              f"batched Cholesky (torch.linalg.cholesky_ex) {t_chol:.2f} ms", flush=True)

    def no_riccati_kernels(tag, counts, k4: bool):
        zero = [k for k in (k1_3 if k4 else tuple(KERNELS)) if counts.get(k, 0)]
        k4n = counts.get("residual", 0) + counts.get("residual_l1", 0)
        print(f"[{tag}] launches K1 {counts.get('factor_solve', 0)}, K2 {counts.get('resolve', 0)}, "
              f"K3 {counts.get('window_jac', 0)}, K4 {counts.get('residual', 0)} + "
              f"{counts.get('residual_l1', 0)} (L1)", flush=True)
        if zero:
            fail(f"{tag}: the dense backend launched {zero}: {counts}")
        if k4 and not k4n:
            fail(f"{tag}: K4 was never launched on the dense backend's line search")

    # ---- 6a: the order-1 time-dependent family, auto -> dense, float64 ---- #
    td_cfg = benchmarks.td_config()
    B6a, N6a = td_cfg["batch"], td_cfg["N"]
    prob6a = benchmarks.make_batched_td_problems(B6a, N=N6a, device=dev)
    with warnings.catch_warnings(record=True) as w6a:
        warnings.simplefilter("always")
        res6a, _ = run6("path6a", f"time-dependent order-1 B={B6a} N={N6a} float64, "
                                  "backend auto", lambda: solve_batch_compact(
                                      prob6a, **td_cfg["solve_kw"]))
    msgs = [str(x.message) for x in w6a]
    fallback = any("not Riccati-eligible" in m for m in msgs)
    td_warn = [m for m in msgs if "integrator error" in m]
    no_riccati_kernels("path6a", _build.LAUNCHES, k4=False)
    conv6a = res6a.converged.cpu().numpy()
    kkt6a = res6a.kkt_error.cpu().numpy()
    it6a = res6a.iterations.cpu().numpy()
    ln6a = np.nonzero(conv6a)[0]
    tde = res6a.td_error.cpu().numpy()
    obj_err6a, u_err6a, it_gold = benchmarks.td_certificate(res6a)
    L6 = len(it_gold)
    kkt6a_max = float(kkt6a[ln6a].max()) if len(ln6a) else float("nan")
    print(f"[path6a] fallback warning seen: {fallback}; converged {len(ln6a)}/{B6a}; iterations "
          f"median {np.median(it6a):g} max {it6a.max()}; max kkt over converged {kkt6a_max:.3e} "
          f"(bound {KKT_6A:g}); td_error max {tde.max():.3e} (bound {TD_ATOL:g}); accuracy "
          f"warnings {len(td_warn)}", flush=True)
    print(f"[path6a] lanes 0-{L6 - 1} vs the JAX package's float64 solve: max |obj/obj* - 1| "
          f"{obj_err6a.max():.3e} (bound {OBJ_6A:g}), max |u - u*| {u_err6a.max():.3e} (bound "
          f"{U_6A:g}); iterations {it6a[:L6].tolist()} beside the golden's {it_gold.tolist()}",
          flush=True)
    st6a = res6a.status.cpu().numpy()
    for i in np.nonzero(~conv6a)[0][:16]:
        print(f"[path6a] unconverged lane {i}: {it6a[i]} iterations, kkt {kkt6a[i]:.3e}, "
              f"status {st6a[i]}")
    dense_layer("path6a", prob6a, res6a, gn=False)
    del prob6a, res6a
    if not fallback:
        fail("path 6a: the auto backend's dense-fallback warning did not fire")
    if len(ln6a) < MIN_CONVERGED * B6a:
        fail(f"path 6a: only {len(ln6a)}/{B6a} lanes converged")
    if not (kkt6a_max <= KKT_6A and tde.max() <= TD_ATOL and not td_warn):
        fail("path 6a: a converged lane is not certified, or td_error is above its bound")
    if not (obj_err6a.max() <= OBJ_6A and u_err6a.max() <= U_6A):
        fail("path 6a: lanes 0-15 miss the golden's bounds")

    # ---- 6b: path 1's family on the dense backend, float32 ---------------- #
    d_cfg = benchmarks.dense_config()
    L6b = d_cfg["lanes"]
    prob6b = tree_take(prob_big, torch.arange(L6b, device=dev))
    Z6b = []
    for rep in range(2):
        res6b, c6b = run6("path6b", f"path 1's lanes 0-{L6b - 1} N={N} float32, backend dense, "
                                    f"the seek's options (run {rep + 1} of 2)",
                          lambda: solve_batch_compact(prob6b, **d_cfg["solve_kw"]))
        no_riccati_kernels("path6b", c6b["launches"], k4=True)
        Z6b.append(res6b.problem.trajectory.to_zvec())
    launches6b = c6b["launches"]
    same6b = torch.equal(Z6b[0], Z6b[1])
    conv6b = res6b.converged.cpu().numpy()
    it6b = res6b.iterations.cpu().numpy()
    kkt6b = res6b.kkt_error.cpu().numpy()
    finite6b = bool(torch.isfinite(Z6b[1]).all())
    it_seek = it1[:L6b]
    print(f"[path6b] converged {int(conv6b.sum())}/{L6b} (bar {BAR_6B:.0%}); iterations median "
          f"{np.median(it6b):g} max {it6b.max()} beside path 1's seek on the same lanes: median "
          f"{np.median(it_seek):g} max {it_seek.max()}; max kkt over converged "
          f"{kkt6b[conv6b].max() if conv6b.any() else float('nan'):.3e}; finite {finite6b}; "
          f"two runs bitwise equal: {same6b}", flush=True)
    st6b = res6b.status.cpu().numpy()
    for i in np.nonzero(~conv6b)[0][:16]:
        print(f"[path6b] unconverged lane {i}: {it6b[i]} iterations, kkt {kkt6b[i]:.3e}, "
              f"status {st6b[i]}")
    dense_layer("path6b", prob6b, res6b, gn=True)
    del prob6b, res6b, Z6b
    if not same6b:
        fail("path 6b: two runs of the dense backend differ")
    if not finite6b or conv6b.sum() < BAR_6B * L6b:
        fail(f"path 6b: {int(conv6b.sum())}/{L6b} converged is below its bar, or an iterate "
             "is not finite")

    # ---- 6c: dense L-BFGS on the cartpole family, float32 ----------------- #
    c_cfg = benchmarks.cartpole_dense_lbfgs_config()
    L6c = c_cfg["lanes"]
    prob6c = tree_take(prob_cp, torch.arange(L6c, device=dev))
    res6c, c6c = run6("path6c", f"cartpole lanes 0-{L6c - 1} N={N5} float32, backend dense, "
                                f"L-BFGS m={c_cfg['solve_kw']['limited_memory_max_history']}",
                      lambda: solve_batch_compact(prob6c, **c_cfg["solve_kw"]))
    no_riccati_kernels("path6c", c6c["launches"], k4=False)
    conv6c = res6c.converged.cpu().numpy()
    it6c = res6c.iterations.cpu().numpy()
    kkt6c = res6c.kkt_error.cpu().numpy()
    ln6c = np.nonzero(conv6c)[0]
    obj_err6c, _ = benchmarks.cartpole_certificate(res6c)
    obj6c = res6c.objective.detach().to("cpu", torch.float64).numpy()
    vs5b = np.abs(obj6c / obj5b[:L6c] - 1.0)

    def worst6c(x):
        return float(x[ln6c].max()) if len(ln6c) else float("nan")

    print(f"[path6c] converged {len(ln6c)}/{L6c}; iterations median {np.median(it6c):g} max "
          f"{it6c.max()}; over converged lanes: max kkt {worst6c(kkt6c):.3e} (bound {KKT_5B:g}), "
          f"max |obj/obj* - 1| {worst6c(obj_err6c):.3e} (bound {OBJ_5B:g}); per lane "
          f"|obj_dense/obj_riccati - 1| against 5b: median {np.median(vs5b):.3e} max "
          f"{vs5b.max():.3e}", flush=True)
    dense_layer("path6c", prob6c, res6c, gn=False)
    del prob6c, res6c
    if len(ln6c) < MIN_CONVERGED * L6c:
        fail(f"path 6c: only {len(ln6c)}/{L6c} lanes converged")
    if not (worst6c(kkt6c) <= KKT_5B and worst6c(obj_err6c) <= OBJ_5B):
        fail("path 6c: a converged lane is not certified")
    return launches6b


def seeded_expv(xd, nd, dev, lanes=2048, K=50):
    """The seeded K3/K4 inputs at (x_dim, n_drives) on ``dev``, float32:
    Gd (lanes, xd, xd), Gv (lanes, nd, xd, xd) of unit scale, u (lanes, K,
    nd), Δt (lanes, K) near 0.1, x and x_next (lanes, K, xd)."""
    rng = np.random.default_rng(10 * xd + nd)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        0.5 * rng.normal(size=(lanes, xd, xd)), 0.5 * rng.normal(size=(lanes, nd, xd, xd)),
        0.3 * rng.normal(size=(lanes, K, nd)), 0.1 + 0.05 * rng.random((lanes, K)),
        rng.normal(size=(lanes, K, xd)), rng.normal(size=(lanes, K, xd))))


def trial_grid_7c(prob, dev):
    """Path 7c's line-search trial grid on ``prob``'s knots: (lanes,
    max_ls + 2 slots, N, d), slot i at Z + 0.5^i·dZ, dZ seeded noise of
    1e-3."""
    from directtrajopt_tpu_torch.solvers.options import IPMOptions

    lay = prob.trajectory.layout
    n_slots = IPMOptions().max_ls + 2
    Z = prob.trajectory.to_zvec()
    dZ = torch.as_tensor(1e-3 * np.random.default_rng(70).standard_normal(Z.shape),
                         dtype=torch.float32, device=dev)
    al = torch.as_tensor(0.5 ** np.arange(n_slots), dtype=torch.float32, device=dev)
    return (Z[:, None] + al[None, :, None] * dZ[:, None]).reshape(
        Z.shape[0], n_slots, lay.N, lay.dim)


def scaled_batch(lanes, N, state_dim, n_controls=2, taylor_order=None, dev=DEVICE,
                 dtype=torch.float32):
    """The scaling family's lanes 0-(lanes − 1) (seeds 42 + i) in ``dtype``:
    as its builder makes them (Padé) or, with ``taylor_order``, the same
    problems with the Taylor action of that order, built from the port's
    public constructors."""
    from directtrajopt_tpu_torch import (BilinearIntegrator, DerivativeIntegrator,
                                         DirectTrajOptProblem, QuadraticRegularizer, benchmarks)
    from directtrajopt_tpu_torch.solvers.solve import cast_problem

    if taylor_order is None:
        prob = benchmarks.make_batched_scaled_problems(lanes, N, state_dim, n_controls,
                                                       device=dev)
    else:
        Gd, Gv, data = benchmarks.scaled_data(lanes, N, state_dim, n_controls)
        traj = benchmarks.scaled_trajectory(data, device=dev, dtype=torch.float64)
        integ = BilinearIntegrator.create((Gd, Gv), "x", "u", batch=lanes, device=dev,
                                          method="taylor", taylor_order=taylor_order)
        prob = DirectTrajOptProblem.create(traj, QuadraticRegularizer.create("u", traj, 1.0),
                                           [integ, DerivativeIntegrator.create("u", "du")])
    return cast_problem(prob, dtype)


def path7(dev) -> tuple:
    """Path 7, the scaling family at N=51 through ``solve_batch_compact``
    with ``scaled_config()``: 7a-7c (``SUB7``, its batch) against their
    bars, then 7d (``STATE_7D``) beyond the kernels' caps against the
    same solve on the CPU. Prints and certifies each; returns the launches of
    7a-7c and 7e by sub-path and their K1/K2 launches by CUDA kernel."""
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import _build, expv_kernel, riccati_kernel
    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    solve_mod = importlib.import_module("directtrajopt_tpu_torch.solvers.solve")
    cfg = benchmarks.scaled_config()
    N7 = cfg["N"]
    gold_7, gold_7e = np.load(benchmarks.GOLDEN_SCALED), np.load(benchmarks.GOLDEN_SCALED_DIM4)
    # the kernels each sub-path must launch, and the K1/K2 instantiations
    # (``_build.INSTANCES``): the grouped ones at 7a-7c's n_s and no
    # size-class one; the size-class ones on 7e and no exact one
    needs = {"7a": ("factor_solve", "resolve"), "7b": ("factor_solve", "resolve"),
             "7c": ("factor_solve", "resolve", "window_jac_generic", "residual_generic",
                    "residual_l1_generic"), "7e": ("factor_solve", "resolve")}
    needs_k12 = {tag: (f"factor_solve_grouped<{ns},3,3>", f"resolve_grouped<{ns},3,2>")
                 for tag, ns in (("7a", 10), ("7b", 18), ("7c", 10))}
    needs_k12["7e"] = tuple(
        "{}_classed<{},{},{}>".format(k, *riccati_kernel.size_class(k, 6, 3, R))
        for k, R in (("factor_solve", 3), ("resolve", 2)))
    # the size-class K3/K4 by CUDA kernel: 7c's (8,2) class, both K4 forms
    c7c = "{},{}".format(*expv_kernel.size_class(8, 2))
    needs_k34 = {"7c": (f"window_jac_classed<{c7c}>", f"residual_classed<{c7c},0>",
                        f"residual_classed<{c7c},1>")}
    expv = ("window_jac", "residual", "residual_l1", "window_jac_generic", "residual_generic",
            "residual_l1_generic")
    launches, instances, t_all = {}, {}, time.perf_counter()
    for tag, (dim, order) in SUB7.items():
        lanes = cfg["batch"]
        prob = scaled_batch(lanes, N7, dim, taylor_order=order, dev=dev)
        torch.cuda.synchronize()
        _build.reset_launches()
        with Timed(solve_mod, "_solve_impl") as tm:
            res = solve_batch_compact(prob, **cfg["solve_kw"])
        counts = {k: v for k, v in _build.LAUNCHES.items() if v}
        k12 = {k: v for k, v in _build.INSTANCES.items()
               if k.startswith(("factor_solve", "resolve"))}
        k34 = {k: v for k, v in _build.INSTANCES.items() if k not in k12}
        plain = dict(_build.PLAIN_CALLS)
        c = dict(tm.calls[0], seconds=sum(x["seconds"] for x in tm.calls),
                 passes=sum(x["passes"] for x in tm.calls), launches=counts,
                 unconverged=int((~res.converged).sum()))
        phase_line(f"path{tag}", f"scaling family B={lanes} N={N7} state_dim {dim} float32, "
                                 f"{'Padé' if order is None else f'Taylor order {order}'}, "
                                 f"{len(tm.calls)} phase chunks", c)
        conv = res.converged.cpu().numpy()
        kkt = res.kkt_error.cpu().numpy()
        it = res.iterations.cpu().numpy()
        obj = res.objective.detach().to("cpu", torch.float64).numpy()
        gold = gold_7e if tag == "7e" else gold_7
        g_obj = gold[f"p{tag}_objective"]
        n = len(g_obj)
        err = np.abs(obj[:n] / g_obj - 1.0)
        held = [i for i in HELD_7[tag] if conv[i]]
        err_max = float(err[held].max()) if held else 0.0
        kkt_max = float(kkt[conv].max()) if conv.any() else 0.0
        bar = CONV_7_JAX[tag] - 0.1
        print(f"[path{tag}] converged {int(conv.sum())}/{lanes} (bar {bar:.4f}); iterations "
              f"median {np.median(it):g} max {it.max()}; max kkt over converged {kkt_max:.3e} "
              f"(bound {KKT_7:g}); lanes 0-{n - 1}: |obj/obj* - 1| "
              f"{np.array2string(err, precision=3)} (bound {OBJ_7:g} on the held lanes "
              f"{list(HELD_7[tag])}, {len(held)} of them converged here), converged "
              f"{conv[:n].tolist()} beside the golden's {gold[f'p{tag}_converged'].tolist()}, "
              f"iterations {it[:n].tolist()} beside the golden's "
              f"{gold[f'p{tag}_iterations'].tolist()}; plain calls {json.dumps(plain)}; "
              f"K1/K2 launches by kernel {json.dumps(k12)}, size-class K3/K4 launches by "
              f"kernel {json.dumps(k34)}", flush=True)
        del prob, res
        launches[tag], instances[tag] = counts, k12
        missing = [k for k in needs[tag] if not counts.get(k)]
        missing += [k for k in needs_k12[tag] if not k12.get(k)]
        missing += [k for k in needs_k34.get(tag, ()) if not k34.get(k)]
        if missing:
            fail(f"path {tag}: {missing} never launched: {counts}, {k12}, {k34}")
        if any(k not in needs_k12[tag] for k in k12):
            fail(f"path {tag}: a K1/K2 other than {needs_k12[tag]} ran: {k12}")
        if any(k not in needs_k34.get(tag, ()) for k in k34):
            fail(f"path {tag}: a size-class K3/K4 other than {needs_k34.get(tag)} ran: {k34}")
        if order is None and any(counts.get(k) for k in expv):
            fail(f"path {tag}: the Padé method launched K3/K4: {counts}")
        no_plain_calls(f"path {tag}")
        if conv.mean() < bar:
            fail(f"path {tag}: {int(conv.sum())}/{lanes} converged is below its bar")
        if not (kkt_max <= KKT_7 and err_max <= OBJ_7):
            fail(f"path {tag}: a converged lane is not certified")
    t7 = time.perf_counter() - t_all
    path7d(dev)
    print(f"[path7] 7a-7c, 7e {t7:.2f} s; path 7 {time.perf_counter() - t_all:.2f} s", flush=True)
    return launches, instances


def path7d(dev) -> None:
    """Path 7d: the scaling family beyond every kernel's caps (``STATE_7D``)
    on the card, which must take the plain versions, against the same solve
    on the CPU. Prints and certifies it."""
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import _build
    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    cfg = benchmarks.scaled_config()
    kw = dict(cfg["solve_kw"], chunk=LANES_7D)
    runs = {}
    for where in (dev, "cpu"):
        prob = scaled_batch(LANES_7D, N_7D, STATE_7D, taylor_order=12, dev=where)
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solve_batch_compact(prob, **kw)
        short = solve_batch_compact(prob, **dict(kw, phases=((ITER_7D, None),)))
        if where != "cpu":
            torch.cuda.synchronize()
        runs[str(where)] = (res, short, time.perf_counter() - t0, dict(_build.PLAIN_CALLS),
                            {k: v for k, v in _build.LAUNCHES.items() if v})
    (r_d, s_d, t_d, plain_d, counts_d), (r_c, s_c, t_c, _, _) = runs[str(dev)], runs["cpu"]

    def z_dev(a, b):
        """Per lane max |Z_a − Z_b| / max(max |Z_b|, 1)."""
        Za = a.problem.trajectory.to_zvec().double().cpu()
        Zb = b.problem.trajectory.to_zvec().double().cpu()
        return ((Za - Zb).abs().amax(1) / Zb.abs().amax(1).clamp(min=1.0)).numpy()

    it_d, it_c = r_d.iterations.cpu().numpy(), r_c.iterations.cpu().numpy()
    same = it_d == it_c
    dz, dz_short = z_dev(r_d, r_c), z_dev(s_d, s_c)
    parted = ~same | (dz > Z_7D)
    same_short = bool((s_d.iterations.cpu() == s_c.iterations.cpu()).all())
    conv_d, conv_c = r_d.converged.cpu().numpy(), r_c.converged.cpu().numpy()
    kkt_d = r_d.kkt_error.cpu().numpy()
    kkt_max = float(kkt_d[conv_d].max()) if conv_d.any() else 0.0
    print(f"[path7d] beyond the caps: B={LANES_7D} N={N_7D} state_dim {STATE_7D}, 2 drives, "
          f"Taylor order 12, float32: card {t_d:.2f} s, CPU {t_c:.2f} s (the solve and its first "
          f"{ITER_7D} iterations); plain calls on the card {json.dumps(plain_d)}; launches "
          f"{json.dumps(counts_d)}; first {ITER_7D} iterations: the same on every lane {same_short}, "
          f"max per-lane |Z - Z_cpu| {dz_short.max():.3e} (bound {Z_7D:g}); the solve: converged "
          f"{int(conv_d.sum())} / {int(conv_c.sum())}, max kkt over converged {kkt_max:.3e} (bound "
          f"{KKT_7:g}), iterations equal on {int(same.sum())}/{LANES_7D} lanes (card median "
          f"{np.median(it_d):g} max {it_d.max()}), per-lane |Z - Z_cpu| on those median "
          f"{np.median(dz[same]):.3e} max {dz[same].max(initial=0):.3e}, on the others max "
          f"{dz[~same].max(initial=0):.3e}; lanes parted (other iterations or Z beyond "
          f"{Z_7D:g}) {np.flatnonzero(parted).tolist()} (at most {PART_7D})", flush=True)
    if not (plain_d["factor_solve"] and plain_d["window_jac"] and plain_d["residual"]):
        fail("path 7d: K1, K3 or K4 did not take the plain version beyond the caps")
    if counts_d:
        fail(f"path 7d: a kernel launched beyond the caps: {counts_d}")
    if not (same_short and dz_short.max() <= Z_7D):
        fail("path 7d: the card's first iterations differ from the CPU's")
    if conv_d.sum() < conv_c.sum() - 0.1 * LANES_7D or kkt_max > KKT_7:
        fail("path 7d: the card's solve is not certified")
    if parted.sum() > PART_7D:
        fail("path 7d: more lanes part from the CPU's solve than part between two float32 "
             "solves")
    del runs, r_d, r_c, s_d, s_c

# path 8: path 1's pipeline sharded over PATH8_RANKS processes that share
# the card (gloo: NCCL refuses two ranks on one GPU), then weak_scaling on
# the seek's lockstep solve at 1 and 2 ranks, WEAK_LANES lanes a rank
PATH8_RANKS, WEAK_LANES = 2, 1024


def path8_rank(rank: int, world: int, tmp: str) -> None:
    """One rank of path 8 (started by ``torch.multiprocessing.spawn``): the
    seek and the polish of path 1's batch through
    ``solve_batch_compact_sharded``, each rank on its half, after a short
    warm-up on one chunk; then ``weak_scaling``. Writes its launches, times
    and (rank 0) the gathered result to ``tmp/rank<r>.pt``."""
    import torch.distributed as dist

    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.module import tree_take
    from directtrajopt_tpu_torch.ops import _build
    from directtrajopt_tpu_torch.parallel import (init_distributed, make_mesh,
                                                  solve_batch_compact_sharded, weak_scaling)
    from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve_batch_compact

    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    init_distributed(num_processes=world, process_id=rank, backend="gloo",
                     init_method=f"file://{os.path.join(tmp, 'init')}")
    mesh = make_mesh(dev)
    cfg = benchmarks.headline_config()

    def batch(lanes):
        return cast_problem(benchmarks.make_batched_bilinear_problems(
            lanes, N=cfg["N"], feasible_start=True, taylor_order=cfg["taylor_order"],
            device=dev, dtype=torch.float64), torch.float32)

    prob = batch(cfg["batch"])
    w = solve_batch_compact(tree_take(prob, torch.arange(cfg["phase1_kw"]["chunk"], device=dev)),
                            **dict(cfg["phase1_kw"], phases=((2, None),)))
    solve_batch_compact(w.problem, warm=w.ipm.state.best_kkt_warm,
                        **dict(cfg["polish_kw"], phases=((1, None),)))
    torch.cuda.synchronize()
    dist.barrier()
    _build.reset_launches()
    t0 = time.perf_counter()
    seek = solve_batch_compact_sharded(prob, mesh=mesh, **cfg["phase1_kw"])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    pol = solve_batch_compact_sharded(seek.problem, mesh=mesh,
                                      warm=seek.ipm.state.best_kkt_warm, **cfg["polish_kw"])
    torch.cuda.synchronize()
    dist.barrier()
    t2 = time.perf_counter()
    out = dict(seek_s=t1 - t0, polish_s=t2 - t1, launches=dict(_build.LAUNCHES),
               plain=dict(_build.PLAIN_CALLS), instances=dict(_build.INSTANCES))
    if rank == 0:
        lanes = np.nonzero(pol.converged.cpu().numpy())[0]
        out.update(it1=seek.iterations.cpu(), it2=pol.iterations.cpu(),
                   conv=pol.converged.cpu(), Z1=seek.problem.trajectory.to_zvec().cpu(),
                   Z=pol.problem.trajectory.to_zvec().cpu(), kkt=pol.kkt_error.cpu(),
                   rms=benchmarks.rms_u_vs_golden(pol, lanes))
    del prob, seek, pol, w
    torch.cuda.empty_cache()
    # the seek's options on its lockstep solve, its first phase's budget
    seek_kw = {k: v for k, v in cfg["phase1_kw"].items() if k not in ("phases", "chunk")}
    batch.per_device = WEAK_LANES
    out["weak"] = weak_scaling(batch, [1, 2], repeats=3, devices=dev,
                               **dict(seek_kw, max_iter=cfg["phase1_kw"]["phases"][0][0]))
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def path8(path1: dict) -> list:
    """Path 8: path 1's pipeline on two processes that share the card
    (``path8_rank``), held to path 1's own result of this run (``path1``:
    its per-lane seek and polish iterations, converged flags and Z, on the
    host): iterations and converged equal and Z bitwise, path 1's
    certificate on every converged lane, K1-K4 launched on both ranks and
    no plain call. Prints its seconds and certified solves/s beside path
    1's, and the weak-scaling records. Returns each rank's launches."""
    import shutil
    import tempfile

    import torch.multiprocessing as mp

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="dto_path8_")
    try:
        t0 = time.perf_counter()
        mp.spawn(path8_rank, args=(PATH8_RANKS, tmp), nprocs=PATH8_RANKS)
        t_all = time.perf_counter() - t0
        outs = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                for r in range(PATH8_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    o = outs[0]
    conv = o["conv"].numpy()
    lanes = np.nonzero(conv)[0]
    kkt_max = float(o["kkt"].numpy()[lanes].max()) if len(lanes) else float("nan")
    rms_max = float(o["rms"].max()) if len(lanes) else float("nan")
    t8 = o["seek_s"] + o["polish_s"]
    t1 = path1["seconds"]
    same = {k: torch.equal(o[k], path1[k]) for k in ("it1", "it2", "conv", "Z1", "Z")}
    diff = (o["Z"] != path1["Z"]).any(1)
    print(f"[path8] path 1's pipeline sharded over {PATH8_RANKS} processes sharing the card "
          f"(gloo, file:// rendezvous), {len(conv) // PATH8_RANKS} lanes a rank, chunk "
          f"{path1['chunk']}: seek {o['seek_s']:.2f} s, polish {o['polish_s']:.2f} s, total "
          f"{t8:.2f} s in rank 0 after a warm-up (path 1: {t1:.2f} s); spawn to join "
          f"{t_all:.2f} s", flush=True)
    print(f"[path8] certified {len(lanes)}/{len(conv)} lanes: {len(lanes) / t8:.1f} certified "
          f"solves/s (path 1: {path1['certified']}/{len(conv)}, {path1['certified'] / t1:.1f}); "
          f"max kkt {kkt_max:.3e} (bound {KKT_CERT:g}), max RMS(u) vs golden {rms_max:.3e} "
          f"(bound {GOLDEN_RMS:g})", flush=True)
    print(f"[path8] against path 1 of this run: seek iterations equal {same['it1']}, polish "
          f"iterations equal {same['it2']}, converged equal {same['conv']}, seek Z bitwise "
          f"{same['Z1']}, polish Z bitwise {same['Z']} ({int(diff.sum())} lanes differ"
          f"{', max |dZ| %.3e' % float((o['Z'] - path1['Z']).abs().max()) if diff.any() else ''})",
          flush=True)
    for r, x in enumerate(outs):
        print(f"[path8] rank {r}: seek {x['seek_s']:.2f} s, polish {x['polish_s']:.2f} s; kernel "
              f"launches {json.dumps(x['launches'])}; by kernel {json.dumps(x['instances'])}; "
              f"plain calls {json.dumps(x['plain'])}", flush=True)
    for rec in o["weak"]:
        print(f"[path8] weak_scaling (the seek's options, its first phase's "
              f"{path1['weak_iter']} iterations in one lockstep): {json.dumps(rec)}", flush=True)
    for r, x in enumerate(outs):
        if any(v == 0 for v in base_counts(x["launches"]).values()):
            fail(f"path 8: a kernel was never launched on rank {r}: {x['launches']}")
        if any(x["plain"].values()):
            fail(f"path 8: rank {r} took a plain version: {x['plain']}")
    if not all(same.values()):
        fail(f"path 8's gathered result differs from path 1's: {same}")
    if len(lanes) < MIN_CONVERGED * len(conv) or not (kkt_max <= KKT_CERT
                                                     and rms_max < GOLDEN_RMS):
        fail("path 8: a converged lane is not certified, or too few converged")
    if outs[1]["weak"] != o["weak"]:
        fail("path 8: the ranks' weak-scaling records differ")
    return [x["launches"] for x in outs]


# the z_k gates of integrators/base.py timed on stack_hessians_zk, and the
# largest deviation each may have from the default on the same call,
# relative to the call's largest entry (float32: the same sums reordered
# through the Taylor chain)
GATE_SETTINGS = {"default": {}, "DTX_ZK_CUSTOM_HESS": {"DTX_ZK_CUSTOM_HESS": "1"},
                 "DTX_ZK_READCOLS": {"DTX_ZK_READCOLS": "1"},
                 "both": {"DTX_ZK_CUSTOM_HESS": "1", "DTX_ZK_READCOLS": "1"}}
GATE_TOL = 1e-5


class gates:
    """Set one of ``GATE_SETTINGS`` in ``os.environ`` for a block."""

    def __init__(self, setting: str):
        self.setting = setting

    def __enter__(self):
        self.saved = {k: os.environ.pop(k) for k in ("DTX_ZK_CUSTOM_HESS", "DTX_ZK_READCOLS")
                      if k in os.environ}
        os.environ.update(GATE_SETTINGS[self.setting])

    def __exit__(self, *exc):
        for k in GATE_SETTINGS["both"]:
            os.environ.pop(k, None)
        os.environ.update(self.saved)


def device_busy_ms(fn, calls: int = 20):
    """Device milliseconds per call of ``fn``: the time of every device
    event ``torch.profiler`` records over ``calls`` calls, summed; None
    where it records none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / calls / 1e3 if us else None


def gate_phase(captured: dict, prob_sc, sc_cfg, path2: dict) -> None:
    """The z_k gates: ``stack_hessians_zk`` under each of ``GATE_SETTINGS``
    on the calls captured from path 1's polish and path 2 (``captured``:
    name → the calls of one prepare), timed (CUDA events, median of 20;
    profiler device time over 3 calls) and held to the default on the same
    call; then
    path 2 once more with both gates on, beside its default run
    (``path2``), and its certificate on every converged lane."""
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.integrators.base import stack_hessians_zk
    from directtrajopt_tpu_torch.ops import _build
    from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

    for what, calls in captured.items():

        def prepare(calls=calls):
            return [stack_hessians_zk(*a) for a in calls]

        names = [type(a[0]).__name__ for a in calls]
        ref = None
        with gates("default"):
            peak = max(float(h.abs().max()) for h in prepare())
        if not peak > 0:
            fail(f"the z_k gates: the Hessians of {what}'s captured prepare are zero")
        for setting in GATE_SETTINGS:
            with gates(setting):
                out = prepare()
                # the profiler's record of these many small operations is slow to
                # read back: 3 calls
                ms, dms = cuda_ms(prepare), device_busy_ms(prepare, calls=3)
            if ref is None:
                ref = out
            rel = max(float((o - r).abs().max() / r.abs().max().clamp(min=1e-30))
                      for o, r in zip(out, ref))
            print(f"[gates] {what} ({', '.join(names)}; lanes {calls[0][2].shape[0]}): "
                  f"largest entry {peak:.3e}; {setting}: stack_hessians_zk {ms:.4f} ms a prepare (device "
                  f"{'not measured' if dms is None else f'{dms:.4f} ms'}); max deviation from "
                  f"the default {rel:.3e} of the call's largest entry (bound {GATE_TOL:g})",
                  flush=True)
            if rel > GATE_TOL:
                fail(f"the z_k gates ({setting}) disagree with the default on {what}")
    with gates("both"):
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res = solve_batch_compact(prob_sc, **sc_cfg["solve_kw"])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = dict(_build.LAUNCHES)
        no_plain_calls("path 2 with both z_k gates")
    conv = res.converged.cpu().numpy()
    it = res.iterations.cpu().numpy()
    kkt = res.kkt_error.cpu().numpy()
    lanes = np.nonzero(conv)[0]
    err_u, viol = benchmarks.state_constrained_certificate(res)

    def worst(x):
        return float(x[lanes].max()) if len(lanes) else float("nan")

    print(f"[gates] path 2 with DTX_ZK_CUSTOM_HESS and DTX_ZK_READCOLS: {sec:.2f} s, converged "
          f"{len(lanes)}/{len(conv)}, iterations median {np.median(it):g} max {it.max()}; "
          f"default run: {path2['seconds']:.2f} s, converged {path2['converged']}/{len(conv)}, "
          f"iterations median {path2['median']:g} max {path2['max']}; over converged lanes max "
          f"kkt {worst(kkt):.3e}, max |u - u*| {worst(err_u):.3e}, max (|x_k|^2 - cap) "
          f"{worst(viol):.3e}; kernel launches {json.dumps(launches)}", flush=True)
    if any(v == 0 for v in base_counts(launches).values()):
        fail(f"path 2 with both z_k gates: a kernel was never launched: {launches}")
    if not (worst(kkt) <= KKT_CERT and worst(err_u) <= GOLDEN_U and worst(viol) <= VIOL_CERT):
        fail("path 2 with both z_k gates: a converged lane is not certified")


def main() -> None:
    # ---------------- 1. environment ---------------------------------------- #
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script measures the GPU port only")
    from directtrajopt_tpu_torch import benchmarks
    from directtrajopt_tpu_torch.ops import _build, expv_kernel, riccati_kernel
    from directtrajopt_tpu_torch.solvers import ops_riccati
    from directtrajopt_tpu_torch.solvers.canonical import make_nlp
    from directtrajopt_tpu_torch.solvers.ops_riccati import analyze
    from directtrajopt_tpu_torch.solvers.options import IPMOptions
    from directtrajopt_tpu_torch.module import tree_take
    from directtrajopt_tpu_torch.solvers.solve import (
        cast_problem,
        solve,
        solve_batch_compact,
        solve_batch_polished,
        solve_batch_scheduled,
    )

    # the module (the package re-exports its function ``solve`` under that name)
    solve_mod = importlib.import_module("directtrajopt_tpu_torch.solvers.solve")
    dev = torch.device(DEVICE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: unavailable"
    print(f"[env] device: {smi_line}")
    print(f"[env] torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info()
    print(f"[env] kernel build: {time.perf_counter() - t0:.1f} s -> "
          f"{os.path.basename(info['path'])}")
    ptxas = ptxas_summary(info.get("log", ""))
    for name, regs, frame, smem in ptxas:
        print(f"[ptxas] {name}: {regs} registers; {frame}; {smem} bytes smem")
    # the grouped and column K1 and K2, the size-class K1 and K2 up to the
    # class (16,8,8), and every K3 and K4 kernel, exact and size-class, keep
    # every array in registers or shared memory (the size-class K1/K2 at
    # (24,24,8) may use local memory: printed)
    n_classes = len(riccati_kernel.SIZE_CLASSES)
    n_expv = len(expv_kernel.SIZE_CLASSES)
    for kname, count, wide in (
            ("factor_solve_grouped", len(riccati_kernel.GROUPED_SHAPES), None),
            ("resolve_grouped", len(riccati_kernel.RESOLVE_GROUPED_SHAPES), None),
            ("resolve_columns", len(riccati_kernel.RESOLVE_COLUMN_SHAPES), None),
            ("factor_solve_classed", n_classes - 1, "<24,24,8>"),
            ("resolve_classed", n_classes - 1, "<24,24,8>"),
            ("residual_grid_kernel", 2 * len(expv_kernel.SUPPORTED_SHAPES), None),
            ("window_jac_kernel", 2 * len(expv_kernel.SUPPORTED_SHAPES), None),
            ("residual_classed", 2 * n_expv, None), ("window_jac_classed", n_expv, None)):
        found = [(name, frame) for name, _, frame, _ in ptxas
                 if name.startswith(kname + "<") and not name.startswith(kname + (wide or "."))]
        if info.get("log") and (len(found) != count or any(
                re.search(r"[1-9]\d* bytes", frame) for _, frame in found)):
            fail(f"{kname}: want {count} instantiations with no stack frame and no spills, "
                 f"ptxas says {found}")

    # the wrapper's shared memory for each size class is the kernel's own
    smem = {c: (riccati_kernel.classed_smem_bytes("factor_solve", c[0], c[1], 1),
                _build.library().dto_classed_smem_bytes(*c)) for c in riccati_kernel.SIZE_CLASSES}
    print(f"[env] size classes (NSC, NVC, RC): shared memory a block, wrapper / kernel: "
          f"{json.dumps({str(c): v for c, v in smem.items()})}", flush=True)
    if any(a != b for a, b in smem.values()):
        fail("classed_smem_bytes disagrees with the size-class kernels' layout")

    # ---------------- 2. kernels against their plain versions -------------- #
    cfg = benchmarks.headline_config()
    B, N, order = cfg["batch"], cfg["N"], cfg["taylor_order"]
    prob256 = cast_problem(benchmarks.make_batched_bilinear_problems(
        256, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)
    # capture the Riccati kernels' real inputs from a short exact-Hessian solve
    with Capture(riccati_kernel, "factor_solve", 64) as cap_f, \
            Capture(riccati_kernel, "resolve", 64) as cap_r:
        solve(prob256, max_iter=3, compensated_residuals=True)
    results = {}

    def check(name, label, kern, plain, tol, rel, ins, n_ops, extra_ok=None, lanes=None,
              prof=None, reps=20):
        """``ins``: the kernel's input tensors and ``n_ops`` its float32
        operations, for its time bound (the storage the views touch, each
        element once: K4's x and x_next one slab of N knots, u and Δt once
        per window, a fixed Δt one scalar, the generators once per problem);
        ``lanes``: compare the outputs on these lanes only (a bool mask);
        ``prof``: the CUDA kernel's name, to read its device time from the
        profiler; ``reps``: the timed calls of each timer (fewer for the
        slow wide K1)."""
        out_k = kern()
        out_p = plain()
        torch.cuda.synchronize()
        outs_k = out_k if isinstance(out_k, tuple) else (out_k,)
        outs_p = out_p if isinstance(out_p, tuple) else (out_p,)
        if lanes is not None and not bool(lanes.any()):
            fail(f"{label}: no lane to compare")
        cmp_p, cmp_k = ((outs_p, outs_k) if lanes is None else
                        ([t[lanes] for t in outs_p], [t[lanes] for t in outs_k]))
        dev_rel, dev_abs = max_dev(cmp_p, cmp_k, rel)
        n_inf = non_finite(cmp_p)
        ms_k, ms_p = cuda_ms(kern, reps), cuda_ms(plain, reps)
        ms_seq = cuda_ms_back_to_back(kern, reps)
        ms_dev = device_ms(kern, prof, reps) if prof else None
        dev_txt = "" if prof is None else (
            f", device {ms_dev:.4f} ms per launch (profiler)" if ms_dev is not None
            else ", device time not measured (the profiler recorded no launch)")
        b_ms, b_by = time_bound(nbytes(ins) + nbytes(outs_k), n_ops)
        ok = dev_rel <= tol and (extra_ok is None or extra_ok(outs_p, outs_k))
        kind = {"col": "per-column relative", True: "relative", False: "absolute"}[rel]
        print(f"[kernel] {label}: max {kind} deviation {dev_rel:.3e} (bound {tol:g}), "
              f"max abs {dev_abs:.3e} ({n_inf} non-finite entries, in both, left out); kernel "
              f"{ms_k:.4f} ms ({ms_seq:.4f} ms per call back to back{dev_txt}), plain "
              f"{ms_p:.4f} ms; "
              f"time bound {b_ms:.4f} ms ({b_by}), {b_ms / ms_k:.1%} of it reached "
              f"-> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            fail(f"{label} disagrees with its plain version")
        results.setdefault(name, dict(max_abs_err=dev_abs, ms=ms_k, plain_ms=ms_p, tol=tol,
                                      bound_ms=b_ms, bound_by=b_by, device_ms=ms_dev))

    def ok_equal(p, k):
        return bool((p[5] == k[5]).all())

    # K1 / K2 on well-conditioned stage data: the 5e-6 relative bound of the
    # JAX package's own Pallas-kernel test, with the certificate equal. The
    # paths' shapes run K1's grouped and K2's exact-size instantiations (and
    # beside them, on the same inputs, the size-class kernels); the others,
    # with one indefinite lane each for K1, run the size-class kernels.
    s0_slice = cap_f.calls[0][0]

    def riccati_inputs(seed, lanes, ns, nv, R, bad_lane=None):
        """Initial-state mask and stage data; ``bad_lane`` gets an indefinite stage."""
        s0 = s0_slice if ns == len(s0_slice) else np.arange(ns) >= 2
        st = stage_data(seed, lanes, N, dev, ns, nv, R)
        if bad_lane is not None:
            st[2][bad_lane, 20] = -1e6 * torch.eye(nv, device=dev)
            bad = torch.nonzero(~riccati_kernel.factor_solve_plain(s0, *st)[5])[:, 0].tolist()
            if bad != [bad_lane]:
                fail(f"the indefinite fixture must fail the certificate on lane {bad_lane} alone")
        return s0, st

    def but_lane(lanes, bad):
        """Every lane but ``bad`` (None: every lane): the factors of an
        indefinite lane grow without bound after its failed pivot (to inf and
        NaN at (8,3,2) and (24,24,8)), so its rows compare them on the other
        lanes and its certificate on all."""
        keep = torch.ones(lanes, dtype=torch.bool, device=dev)
        if bad is not None:
            keep[bad] = False
        return keep

    def beside_exact(key, what):
        """Print the size-class row ``key + "_classed"`` beside the exact
        instance's row ``key``: device times and their ratio."""
        new, old = results[f"{key}_classed"], results[key]
        ratio = (new["device_ms"] / old["device_ms"]
                 if new["device_ms"] and old["device_ms"] else math.nan)
        print(f"[classed] {what}: exact {old['ms']:.4f} ms a call (device {old['device_ms']}), "
              f"size-class {new['ms']:.4f} ms (device {new['device_ms']}): classed / exact "
              f"{ratio:.2f} in device time", flush=True)

    for key, lanes, shape, bad in (
        ("factor_solve", 256, (8, 3, 3), None),
        ("factor_solve_big", 8192, (8, 3, 3), 77),
        ("factor_solve_classed_82", 256, (8, 3, 2), 5),
        ("factor_solve_classed_small", 256, (5, 2, 2), 5),
    ):
        s0, st = riccati_inputs(0, lanes, *shape, bad)
        inst = riccati_kernel.design("factor_solve", *shape)
        check(key, f"K1 factor_solve ({inst}) B={lanes} "
                   f"(n_s,n_v,R)={shape}" + (f", lane {bad} indefinite" if bad is not None else ""),
              lambda: riccati_kernel.factor_solve(s0, *st),
              lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, st,
              riccati_ops(lanes, N, *shape, factor=True), ok_equal, lanes=but_lane(lanes, bad),
              prof=f"factor_solve_{inst}")
        if key == "factor_solve":  # the size-class kernel on the same inputs
            check("factor_solve_classed", f"K1 factor_solve_classed B={lanes} (n_s,n_v,R)={shape}",
                  lambda: riccati_kernel.factor_solve_classed(s0, *st),
                  lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, st,
                  riccati_ops(lanes, N, *shape, factor=True), ok_equal, prof="factor_solve_classed",
                  reps=5)
            beside_exact("factor_solve", f"K1 {shape} B={lanes}")
    for key, shape in (
        ("resolve", (8, 3, 2)),
        ("resolve_classed_81", (8, 3, 1)),
        ("resolve_classed_small", (5, 2, 2)),
    ):
        s0, st = riccati_inputs(1, 256, *shape)
        fac = riccati_kernel.factor_solve_plain(s0, *st)
        inst = riccati_kernel.design("resolve", *shape)
        check(key, f"K2 resolve ({inst}) B=256 (n_s,n_v,R')={shape}",
              lambda: riccati_kernel.resolve(s0, *fac[:5], *st[3:]),
              lambda: riccati_kernel.resolve_plain(s0, *fac[:5], *st[3:]), 5e-6, True,
              list(fac[:5]) + st[3:], riccati_ops(256, N, *shape, factor=False),
              prof=f"resolve_{inst}")
        if key == "resolve":
            check("resolve_classed", f"K2 resolve_classed B=256 (n_s,n_v,R')={shape}",
                  lambda: riccati_kernel.resolve_classed(s0, *fac[:5], *st[3:]),
                  lambda: riccati_kernel.resolve_plain(s0, *fac[:5], *st[3:]), 5e-6, True,
                  list(fac[:5]) + st[3:], riccati_ops(256, N, *shape, factor=False),
                  prof="resolve_classed", reps=5)
            beside_exact("resolve", f"K2 {shape} B=256")
    # ... and on the inputs the pipeline gives them (every captured call):
    # the certificate must agree exactly, and on certified lanes each output
    # of the kernel may be no further from a float64 evaluation than 3x the
    # plain float32 version is (worst case over the calls; floor: the 5e-6
    # bound above). Two float32 sweeps of 51 stages legitimately differ by
    # more than 5e-6 on the IPM's conditioning.
    def pipeline_calls(what, cap_f, cap_r, well_only=False):
        """``well_only`` (path 2, whose lanes with an infeasible guess start
        at D ≈ 1e15): hold the kernel's certificate to the plain float32 one,
        and compare outputs, on the well-conditioned lanes only (elsewhere a
        pivot can sit at the rounding level, so two float32 sweeps may
        decide it differently)."""
        worst = {}
        n_cert_f64 = n_cert_k = 0
        for label, calls, kern, plain, has_ok in (
            ("K1", cap_f.calls, riccati_kernel.factor_solve, riccati_kernel.factor_solve_plain,
             True),
            ("K2", cap_r.calls, riccati_kernel.resolve, riccati_kernel.resolve_plain, False),
        ):
            for a in calls:
                k, p32 = kern(*a), plain(*a)
                p64 = plain(a[0], *(t.double() for t in a[1:]))
                if has_ok:
                    n_cert_f64 += int((p32[5] != p64[5]).sum())
                    n_cert_k += int((k[5] != p32[5]).sum())
                    if well_only:
                        mask = well_conditioned(plain, a)
                        if not bool(k[5][mask].all()):
                            fail(f"K1 certificate disagrees with its plain version on {what} inputs")
                    elif not (bool((k[5] == p64[5]).all()) and bool((p32[5] == p64[5]).all())):
                        fail(f"K1 certificate disagrees on {what} inputs")
                    else:
                        mask = p64[5]
                    k, p32, p64 = (tuple(t for i, t in enumerate(o) if i != 5)
                                   for o in (k, p32, p64))
                elif well_only:
                    mask = well_conditioned(plain, a)
                else:
                    mask = torch.ones(a[1].shape[0], dtype=torch.bool, device=dev)
                for i, (x, y, z) in enumerate(zip(k, p32, p64)):
                    ek, ep = worst.get((label, i), (0.0, 0.0))
                    worst[(label, i)] = (max(ek, lane_rel(x, z, mask)),
                                         max(ep, lane_rel(y, z, mask)))
        ratio = max(ek / max(ep, 5e-6) for ek, ep in worst.values())
        cert = (f"on well-conditioned lanes the kernel's certificate equals the plain float32 "
                f"one and"
                f" (elsewhere the kernel's and plain float32's differ on {n_cert_k} lane-calls, "
                f"plain float32's and float64's on {n_cert_f64})"
                if well_only else "certificates equal;")
        print(f"[kernel] K1/K2 on {len(cap_f.calls)}+{len(cap_r.calls)} captured {what} calls: "
              f"{cert} worst output's (kernel vs f64) / max(plain f32 vs f64, 5e-6) "
              f"= {ratio:.2f} (bound 3)", flush=True)
        if ratio > 3.0:
            fail(f"K1/K2 are less accurate than their plain versions on {what} inputs")

    pipeline_calls("pipeline", cap_f, cap_r)

    prob_big = cast_problem(benchmarks.make_batched_bilinear_problems(
        B, N=N, feasible_start=True, taylor_order=order, device=dev,
        dtype=torch.float64), torch.float32)

    def check_k3(key, what, prob, zmat=None, prof="window_jac_kernel"):
        """K3 on the integrator's own arguments: views of the knot matrix
        (``zmat``, default the trajectory's), −J written into the knot's
        width d. Every K3 row holds each column c of J (a state, a drive,
        Δt) to 2e-6 · max(max |J[..., c]|, 1): the JAX test's absolute bound
        on the columns of unit scale or less, relative on a column that
        reaches the tens (∂(E·x)/∂Δt = G·E·x), where 2e-6 is two float32
        roundings."""
        integ, lay = prob.integrators[0], prob.trajectory.layout
        zmat = prob.trajectory.knot_matrix() if zmat is None else zmat
        ja = integ._window_jac_args(lay, zmat)
        P3, T3, K3, xd3 = ja[4].shape
        nd3, o3 = ja[1].shape[1], integ.taylor_order
        free = ja[5][2] is not None
        n_div = jac_divisions(xd3, nd3, o3, free)
        est = P3 * T3 * K3 * n_div * DIV_INSTRUCTIONS / INSTR_PER_S * 1e3
        check(key, f"K3 window_jac_zk {what} B={P3} x {K3} windows, d={ja[6]}; {n_div} "
                   f"divisions a window, ≈ {n_div * DIV_INSTRUCTIONS} instructions (estimate: "
                   f"{est:.4f} ms at the card's instruction rate)",
              lambda: expv_kernel.window_jac_zk(o3, *ja),
              lambda: expv_kernel.window_jac_zk_plain(o3, *ja), 2e-6, "col", ja[:5],
              horner_ops(P3 * T3, K3, xd3, nd3, o3, True, free), prof=prof)

    # K3 at path 1's shape (a compact chunk of 256 lanes) and at B lanes
    check_k3("window_jac", "<4,2> free dt", prob256)
    check_k3("window_jac_big", "<4,2> free dt", prob_big)
    layout = prob_big.trajectory.layout

    # K4 on the seek's trial grid: lanes = 256 problems x (max_ls + 2) slots
    n_slots = cfg["phase1_kw"]["max_ls"] + 2
    Z = prob256.trajectory.to_zvec()
    rng = np.random.default_rng(0)
    dZ = torch.as_tensor(1e-3 * rng.standard_normal(Z.shape), dtype=torch.float32, device=dev)
    alphas = torch.as_tensor(0.5 ** np.arange(n_slots), dtype=torch.float32, device=dev)
    Zt = (Z[:, None] + alphas[None, :, None] * dZ[:, None]).reshape(
        Z.shape[0], n_slots, layout.N, layout.dim)
    # 256 problems x grid slots, views of Zt as the line search passes them
    targs = prob256.integrators[0]._trial_views(layout, Zt)
    P4, T4, K4, xd4 = targs[4].shape
    ops4 = horner_ops(P4 * T4, K4, xd4, targs[1].shape[1], order, False)
    check("residual_l1", f"K4 residual (L1 form) on Zt {tuple(Zt.shape)}",
          lambda: expv_kernel.residual_l1(order, *targs),
          lambda: expv_kernel.residual_l1_plain(order, *targs), 2e-6, False, targs, ops4,
          prof="residual_grid_kernel")
    check("residual", f"K4 residual (vector form) on Zt {tuple(Zt.shape)}",
          lambda: expv_kernel.residual_action(order, *targs),
          lambda: expv_kernel.residual_action_plain(order, *targs), 2e-6, False, targs, ops4,
          prof="residual_grid_kernel")

    # ---- at the state-constrained family's shapes (path 2) ---------------- #
    sc_cfg = benchmarks.state_constrained_config()
    B2, N2 = sc_cfg["batch"], sc_cfg["N"]
    prob_sc = cast_problem(benchmarks.make_batched_state_constrained_problems(
        B2, N=N2, device=dev), torch.float32)
    integ_sc = prob_sc.integrators[0]
    lay_sc = prob_sc.trajectory.layout
    order_sc = integ_sc.taylor_order
    check_k3("window_jac_sc", "<2,1> fixed dt", prob_sc)
    # K4 on path 2's own trial grid: one chunk of B2 problems x (max_ls + 2) slots
    n_slots2 = IPMOptions().max_ls + 2
    Z2 = prob_sc.trajectory.to_zvec()
    dZ2 = torch.as_tensor(1e-3 * rng.standard_normal(Z2.shape), dtype=torch.float32, device=dev)
    al2 = torch.as_tensor(0.5 ** np.arange(n_slots2), dtype=torch.float32, device=dev)
    Zt2 = (Z2[:, None] + al2[None, :, None] * dZ2[:, None]).reshape(
        B2, n_slots2, lay_sc.N, lay_sc.dim)
    t_sc = integ_sc._trial_views(lay_sc, Zt2)
    P2, T2, K2, xd2 = t_sc[4].shape
    ops4_sc = horner_ops(P2 * T2, K2, xd2, t_sc[1].shape[1], order_sc, False)
    # the L1 form sums 100 rounded terms of this family's O(0.1) residuals
    # per lane (Σ|r| of a few units), so its 2e-6 bound is relative to
    # max(Σ|r|, 1), as the CPU tests hold it (rtol 2e-6)
    check("residual_l1_sc", f"K4 residual <2,1> (L1 form) on Zt {tuple(Zt2.shape)}",
          lambda: expv_kernel.residual_l1(order_sc, *t_sc),
          lambda: expv_kernel.residual_l1_plain(order_sc, *t_sc), 2e-6, True, t_sc, ops4_sc,
          prof="residual_grid_kernel")
    check("residual_sc", f"K4 residual <2,1> (vector form) on Zt {tuple(Zt2.shape)}",
          lambda: expv_kernel.residual_action(order_sc, *t_sc),
          lambda: expv_kernel.residual_action_plain(order_sc, *t_sc), 2e-6, False, t_sc,
          ops4_sc, prof="residual_grid_kernel")
    def plain_f32_error(plain, args, mask):
        """Worst per-lane relative deviation (to max(max |ref|, 1)) of the plain
        float32 version from a float64 evaluation over the lanes in ``mask``."""
        p32 = plain(*args)
        p64 = plain(args[0], *(t.double() for t in args[1:]))
        return max(lane_rel(x, y, mask) for x, y in zip(p32, p64) if x.dtype != torch.bool)

    def compare_lanes(plain, args, f32_floor):
        """Lanes and bound for a captured call's kernel-vs-plain row. Where
        plain float32 reproduces float64 to 1e-6 (the paths' usual case), the
        5e-6 bound on those lanes. With ``f32_floor`` (path 5, whose RK4
        Jacobians and terminal cost leave every lane's plain float32 K1 2e-6
        to 5e-5 from float64): the lanes within 1e-3 of float64, and the
        bound max(5e-6, 4δ), δ the plain float32 version's own worst
        deviation from float64 there (two float32 evaluations each within δ
        differ by up to 2δ, and pipeline_calls allows the kernel 3δ)."""
        if not f32_floor:
            return well_conditioned(plain, args, tol=1e-6), 5e-6, ""
        mask = well_conditioned(plain, args)
        delta = plain_f32_error(plain, args, mask)
        return mask, max(5e-6, 4 * delta), f"; plain float32 within {delta:.2e} of float64"

    def captured_rows(tag, what, cap_f, cap_r, lanes, n_knots, f32_floor=False, reps=20):
        """K1 and K2 on the first calls captured from a path's own solve
        (rows ``factor_solve_<tag>``, ``resolve_<tag>``), one certified lane
        made indefinite at stage 20; then every captured call. Where the
        call takes an exact instance, the size-class kernel too, on the same
        call, lanes and bounds (rows ``factor_solve_<tag>_classed``,
        ``resolve_<tag>_classed``, 5 timed calls each), its device time
        beside the exact one's."""
        f_args = list(cap_f.calls[0])
        shape_f = (f_args[1].shape[-1], f_args[3].shape[-1], f_args[6].shape[1])
        ok0 = riccati_kernel.factor_solve_plain(*f_args)[5]
        bad_lane = int(torch.nonzero(ok0)[0, 0])  # a certified lane, made indefinite
        f_args[3] = f_args[3].clone()
        f_args[3][bad_lane, 20] = -1e6
        ok1 = riccati_kernel.factor_solve_plain(*f_args)[5]
        if bool(ok1[bad_lane]) or not bool(
                (ok1 | (torch.arange(len(ok1), device=dev) == bad_lane) == ok0).all()):
            fail(f"the indefinite {what} fixture must fail the certificate on its lane alone")
        # The certificate must equal the plain float32 one on the indefinite
        # lane and on the well-conditioned lanes (plain float32 certified and
        # within 1e-3 of float64); elsewhere a pivot can sit at the rounding
        # level. The factors are compared where the plain float32 version
        # reproduces float64 to 1e-6, a fifth of the bound: only there can two
        # float32 sweeps be held to 5e-6. Left out on path 2 are the lanes
        # whose guess violates the cap (s = slack_min, D = ν/s ≈ 1e15: float32
        # is off at O(1)) and a few dozen whose stage blocks reach 1e4-1e13.
        well_c = well_conditioned(riccati_kernel.factor_solve_plain, f_args)
        well_c[bad_lane] = True
        n_diff = int((riccati_kernel.factor_solve(*f_args)[5] != ok1).sum())

        def ok_equal_lanes(p, k):
            return bool((p[5] == k[5])[well_c].all())

        well_f, tol_f, note_f = compare_lanes(riccati_kernel.factor_solve_plain, f_args,
                                              f32_floor)
        inst_f = riccati_kernel.design("factor_solve", *shape_f)
        check(f"factor_solve_{tag}",
              f"K1 factor_solve ({inst_f}) on {what} inputs "
              f"B={lanes} (n_s,n_v,R)={shape_f}, lane {bad_lane} indefinite; certificate "
              f"equal on it and the {int(well_c.sum()) - 1} lanes where plain float32 is within "
              f"1e-3 of float64 (differs on {n_diff} others); factors compared on "
              f"{int(well_f.sum())} lanes{note_f}",
              lambda: riccati_kernel.factor_solve(*f_args),
              lambda: riccati_kernel.factor_solve_plain(*f_args), tol_f, True, f_args[1:],
              riccati_ops(lanes, n_knots, *shape_f, factor=True), ok_equal_lanes, lanes=well_f,
              prof=f"factor_solve_{inst_f}", reps=reps)
        r_args = cap_r.calls[0]
        shape_r = (r_args[1].shape[-1], r_args[2].shape[-1], r_args[8].shape[1])
        well_r, tol_r, note_r = compare_lanes(riccati_kernel.resolve_plain, r_args, f32_floor)
        inst_r = riccati_kernel.design("resolve", *shape_r)
        check(f"resolve_{tag}", f"K2 resolve ({inst_r}) on {what} "
                                f"inputs B={lanes} (n_s,n_v,R')={shape_r} "
                                f"(compared on {int(well_r.sum())} lanes{note_r})",
              lambda: riccati_kernel.resolve(*r_args),
              lambda: riccati_kernel.resolve_plain(*r_args), tol_r, True, r_args[1:],
              riccati_ops(lanes, n_knots, *shape_r, factor=False), lanes=well_r,
              prof=f"resolve_{inst_r}", reps=reps)
        for k, inst, shape, args, tol, well, n_ops, extra in (
                ("factor_solve", inst_f, shape_f, f_args, tol_f, well_f,
                 riccati_ops(lanes, n_knots, *shape_f, factor=True), ok_equal_lanes),
                ("resolve", inst_r, shape_r, r_args, tol_r, well_r,
                 riccati_ops(lanes, n_knots, *shape_r, factor=False), None)):
            if inst in ("classed", "split"):
                continue
            kern = getattr(riccati_kernel, f"{k}_classed")
            plain = getattr(riccati_kernel, f"{k}_plain")
            check(f"{k}_{tag}_classed", f"{'K1' if k == 'factor_solve' else 'K2'} {k}_classed "
                                        f"on the same {what} call {shape}",
                  lambda: kern(*args), lambda: plain(*args), tol, True, args[1:], n_ops, extra,
                  lanes=well, prof=f"{k}_classed", reps=5)
            beside_exact(f"{k}_{tag}", f"{k} {shape} on the {what} call, B={lanes}")
        pipeline_calls(what, cap_f, cap_r, well_only=True)
        return shape_f, shape_r

    # K1 at (2,1,3) and K2 at (2,1,2) on inputs captured from path 2's own
    # solve: its problem, all B2 lanes in one chunk, its options, 3 iterations
    kw2 = {k: v for k, v in sc_cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    with Capture(riccati_kernel, "factor_solve", 64) as cap_f2, \
            Capture(riccati_kernel, "resolve", 64) as cap_r2:
        solve(prob_sc, max_iter=3, **kw2)
    captured_rows("sc", "path-2", cap_f2, cap_r2, B2, N2)
    del cap_f2, cap_r2

    # ---- at the global-phase family's shapes (path 3) --------------------- #
    # The knot matrix is a view of Z = [z_1; …; z_N; θ]: its lane stride is
    # N·d + n_g (155 floats), and K3 and K4 read it in place.
    g_cfg = benchmarks.global_config()
    B3, N3 = g_cfg["batch"], g_cfg["N"]
    prob_g = cast_problem(benchmarks.make_batched_global_problems(B3, N=N3, device=dev),
                          torch.float32)
    integ_g, lay_g = prob_g.integrators[0], prob_g.trajectory.layout
    nlp_g = make_nlp(prob_g)
    S3 = analyze(nlp_g)
    m_c3 = len(S3.bp_steps) + len(S3.lin_border_rows) + nlp_g.n_nl_eq + len(S3.ib_flat)
    R3 = m_c3 + S3.n_g + 1
    shape3 = (len(S3.s_idx), len(S3.v_idx), R3)
    print(f"[path3] analyze: (n_s, n_v) = {shape3[:2]}, n_g = {S3.n_g}, border rows m_c = "
          f"{m_c3} ({len(S3.bp_steps)} pinned-target dynamics, {len(S3.lin_border_rows)} "
          f"linear, {nlp_g.n_nl_eq} nonlinear, {len(S3.ib_flat)} inequality): K1 at "
          f"(n_s, n_v, R3) = {shape3}, d = {lay_g.dim}, lane stride z_dim = {nlp_g.z_dim}",
          flush=True)
    if shape3 not in riccati_kernel.GROUPED_SHAPES:
        fail(f"path 3's K1 shape {shape3} has no grouped instantiation")
    Zg = prob_g.trajectory.to_zvec()
    nd3 = N3 * lay_g.dim
    zmat_g = Zg[:, :nd3].reshape(B3, N3, lay_g.dim)
    check_k3("window_jac_gp", "<2,1> fixed dt, knot matrix with its global tail", prob_g, zmat_g)
    dZ3 = torch.as_tensor(1e-3 * rng.standard_normal(Zg.shape), dtype=torch.float32, device=dev)
    Zt3 = Zg[:, None] + al2[None, :, None] * dZ3[:, None]  # path 2's trial slots
    zt3 = Zt3[..., :nd3].reshape(B3, n_slots2, N3, lay_g.dim)
    t_g = integ_g._trial_views(lay_g, zt3)
    # u, x and x_next of the trial grid (a fixed Δt is a scalar of its own)
    for v, base in ((zmat_g, Zg), (zt3, Zt3), (t_g[2], Zt3), (t_g[4], Zt3), (t_g[5], Zt3)):
        if v.untyped_storage().data_ptr() != base.untyped_storage().data_ptr():
            fail("a view of path 3's knot matrix is a copy")
    P3, T3, K3n, xd3 = t_g[4].shape
    ops4_g = horner_ops(P3 * T3, K3n, xd3, t_g[1].shape[1], integ_g.taylor_order, False)
    check("residual_l1_gp", f"K4 residual <2,1> (L1 form) on Zt {tuple(Zt3.shape)} with its "
                            f"global tail",
          lambda: expv_kernel.residual_l1(integ_g.taylor_order, *t_g),
          lambda: expv_kernel.residual_l1_plain(integ_g.taylor_order, *t_g), 2e-6, True, t_g,
          ops4_g, prof="residual_grid_kernel")
    check("residual_gp", f"K4 residual <2,1> (vector form) on Zt {tuple(Zt3.shape)} with its "
                         f"global tail",
          lambda: expv_kernel.residual_action(integ_g.taylor_order, *t_g),
          lambda: expv_kernel.residual_action_plain(integ_g.taylor_order, *t_g), 2e-6, False,
          t_g, ops4_g, prof="residual_grid_kernel")
    n_copy = op_count(lambda: (integ_g.jacobians_zk_stacked(lay_g, zmat_g),
                               integ_g.residuals_stacked(lay_g, zt3),
                               integ_g.residuals_l1_stacked(lay_g, zt3)), "aten::copy_")
    print(f"[path3] K3 and K4 on the tailed knot matrix: {n_copy} device copies around them "
          f"(one call of each entry)", flush=True)
    if n_copy:
        fail("the knot matrix with a global tail was copied around K3 or K4")
    kw3 = {k: v for k, v in g_cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    with Capture(riccati_kernel, "factor_solve", 16) as cap_f3, \
            Capture(riccati_kernel, "resolve", 16) as cap_r3:
        solve(prob_g, max_iter=3, **kw3)
    shape_f3, shape_r3 = captured_rows("gp", "path-3", cap_f3, cap_r3, B3, N3)
    if shape_f3 != shape3:
        fail(f"path 3's K1 calls have shape {shape_f3}, analyze gives {shape3}")
    R3p = shape_r3[2]
    del cap_f3, cap_r3

    # ---- at the cartpole family's shapes (path 5) ------------------------ #
    # K1 beyond 8 right-hand sides: K1 on the first 8 columns, K2 on the
    # others (two launches), at the symmetry problem's width R = 9
    s0, st = riccati_inputs(4, 256, 1, 1, 9, bad_lane=5)
    check("factor_solve_split", "K1 factor_solve (split: size-class K1 on 8 columns, then K2 "
                                "on 1) B=256 (n_s,n_v,R)=(1, 1, 9), lane 5 indefinite; device "
                                "time of the K1 launch only",
          lambda: riccati_kernel.factor_solve(s0, *st),
          lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, st,
          riccati_ops(256, N, 1, 1, 9, factor=True), ok_equal, lanes=but_lane(256, 5),
          prof="factor_solve_classed")
    # K2 at the Pallas resolve's bound, R = 40, in one launch: the column
    # kernel at (4,1), a thread per lane and column, whose columns do not
    # depend on the others of the launch; and the size-class kernel at
    # (5,2), a shape with no column instance, its 8-column tiles on grid rows
    r40 = {}
    for key, shape in (("resolve_r40", (4, 1, 40)), ("resolve_r40_classed", (5, 2, 40))):
        s0, st = riccati_inputs(5, 256, *shape)
        fac = riccati_kernel.factor_solve_plain(s0, *st)
        r_in = (s0, *fac[:5], st[3], st[4])
        inst = riccati_kernel.design("resolve", *shape)
        check(key, f"K2 resolve ({inst}, R' in one launch) B=256 (n_s,n_v,R')={shape}",
              lambda: riccati_kernel.resolve(*r_in, *st[5:]),
              lambda: riccati_kernel.resolve_plain(*r_in, *st[5:]), 5e-6, True,
              list(fac[:5]) + st[3:], riccati_ops(256, N, *shape, factor=False),
              prof=f"resolve_{inst}")
        _build.reset_launches()
        whole = riccati_kernel.resolve(*r_in, *st[5:])
        tiles = [riccati_kernel.resolve(*r_in, *(x[:, i:i + 8] for x in st[5:]))
                 for i in range(0, 40, 8)]
        r40[inst] = (all(torch.equal(w, torch.cat([t[j] for t in tiles], 1))
                         for j, w in enumerate(whole)), dict(_build.INSTANCES))
    # beyond the caps (R' = 41) the plain version runs on the card, counted
    r41 = (*r_in, *(torch.cat([x, x[:, :1]], 1) for x in st[5:]))
    _build.reset_launches()
    out41 = riccati_kernel.resolve(*r41)
    plain41 = (dict(_build.PLAIN_CALLS), dict(_build.LAUNCHES))
    same41 = all(torch.equal(a, b) for a, b in zip(out41, riccati_kernel.resolve_plain(*r41)))
    print(f"[kernel] K2 at R'=40 bitwise equal to five launches of 8 columns: column kernel "
          f"(4,1) {r40['columns'][0]} (launches {json.dumps(r40['columns'][1])}), size-class "
          f"(5,2) {r40['classed'][0]} (launches {json.dumps(r40['classed'][1])}); R'=41 "
          f"(5,2) takes the plain version: plain calls {json.dumps(plain41[0])}, launches "
          f"{sum(plain41[1].values())}, bitwise the plain version's: {same41}", flush=True)
    if not (r40["columns"] == (True, {"resolve_columns<4,1>": 6})
            and r40["classed"] == (True, {"resolve_classed<8,4,8>": 6})):
        fail("K2 at 40 right-hand sides differs from its 8-column pieces, or another kernel ran")
    if not (same41 and plain41[0]["resolve"] == 1 and not any(plain41[1].values())):
        fail("K2 at R'=41 did not take the plain version")
    del s0, st, fac, r_in, whole, tiles, r41, out41
    # K1 (4,1,1) and K2 (4,1,2) on calls captured from 5a's own solve (its
    # problem, all B5 lanes in one chunk, its options, 3 iterations), and K2
    # (4,1,40) on 5b's SMW columns of a later iteration (nonzero pairs)
    cp_cfg, lb_cfg = benchmarks.cartpole_config(), benchmarks.cartpole_lbfgs_config()
    B5, N5 = cp_cfg["batch"], cp_cfg["N"]
    if lb_cfg["batch"] != B5:
        fail("5a and 5b run one batch")
    prob_cp = cast_problem(benchmarks.make_batched_cartpole_problems(B5, N=N5, device=dev),
                           torch.float32)
    kw5a = {k: v for k, v in cp_cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    kw5b = {k: v for k, v in lb_cfg["solve_kw"].items() if k not in ("phases", "chunk")}
    with Capture(riccati_kernel, "factor_solve", 16) as cap_f5, \
            Capture(riccati_kernel, "resolve", 16) as cap_r5:
        solve(prob_cp, max_iter=3, **kw5a)
    shape_f5, shape_r5 = captured_rows("cp", "path-5a", cap_f5, cap_r5, B5, N5, f32_floor=True)
    del cap_f5, cap_r5
    with Capture(riccati_kernel, "resolve", 8) as cap_r5b:
        solve(prob_cp, max_iter=4, **kw5b)
    smw_calls = [a for a in cap_r5b.calls if a[8].shape[1] == 40]
    if len(smw_calls) < 2:
        fail(f"5b's first iterations made {len(smw_calls)} K2 calls at R'=40")
    r5b = smw_calls[-1]
    if not bool(r5b[8].abs().amax() > 0):
        fail("5b's captured SMW columns are zero")
    shape_r5b = (r5b[1].shape[-1], r5b[2].shape[-1], r5b[8].shape[1])
    well5b, tol5b, note5b = compare_lanes(riccati_kernel.resolve_plain, r5b, True)
    des5b = riccati_kernel.design("resolve", *shape_r5b)
    check("resolve_lbfgs", f"K2 resolve ({des5b}) on path-5b "
                           f"inputs B={B5} (n_s,n_v,R')={shape_r5b}: the SMW columns of "
                           f"iteration {len(smw_calls) - 1} (compared on {int(well5b.sum())} "
                           f"lanes{note5b})",
          lambda: riccati_kernel.resolve(*r5b), lambda: riccati_kernel.resolve_plain(*r5b),
          tol5b, True, r5b[1:], riccati_ops(B5, N5, *shape_r5b, factor=False), lanes=well5b,
          prof=f"resolve_{des5b}")
    # the size-class kernel on the same call (five tiles of 8 columns on
    # grid rows)
    check("resolve_lbfgs_classed", f"K2 resolve_classed on the same path-5b call "
                                   f"(n_s,n_v,R')={shape_r5b}",
          lambda: riccati_kernel.resolve_classed(*r5b),
          lambda: riccati_kernel.resolve_plain(*r5b), tol5b, True, r5b[1:],
          riccati_ops(B5, N5, *shape_r5b, factor=False), lanes=well5b, prof="resolve_classed",
          reps=5)
    beside_exact("resolve_lbfgs", f"K2 {shape_r5b} on the path-5b call, B={B5} (columns)")
    del cap_r5b, smw_calls, r5b

    # ---- at the scaling family's shapes (path 7) -------------------------- #
    # The grouped K1 (10,3,3) and K2 (10,3,2) on 7a's captured calls and
    # K1 (18,3,3), K2 (18,3,2) on 7b's, each with one lane made indefinite,
    # and beside them, on the same calls, the size-class kernels; the
    # size-class K1 (6,3,3) and K2 (6,3,2) on 7e's. Plain float32 is nowhere
    # within 1e-6 of float64 on these random systems: path 5's rule (lanes
    # within 1e-3, the bound max(5e-6, 4δ))
    s7 = benchmarks.scaled_config()
    N7, B7 = s7["N"], s7["batch"]
    kw7 = {k: v for k, v in s7["solve_kw"].items() if k not in ("phases", "chunk")}
    shapes7 = {}
    for tag7 in ("7a", "7b", "7e"):
        dim7, order7 = SUB7[tag7]
        prob7 = scaled_batch(B7, N7, dim7, taylor_order=order7, dev=dev)
        with Capture(riccati_kernel, "factor_solve", 3) as cap_f7, \
                Capture(riccati_kernel, "resolve", 3) as cap_r7:
            solve(prob7, max_iter=3, **kw7)
        shapes7[tag7] = captured_rows(tag7, f"path-{tag7}", cap_f7, cap_r7, B7, N7,
                                      f32_floor=True)
        del prob7, cap_f7, cap_r7
    print(f"[path7] captured shapes (K1, K2): {shapes7}", flush=True)
    want7 = {"7a": ((10, 3, 3), (10, 3, 2)), "7b": ((18, 3, 3), (18, 3, 2)),
             "7e": ((6, 3, 3), (6, 3, 2))}
    if shapes7 != want7:
        fail(f"path 7's K1/K2 shapes {shapes7} are not {want7}")
    # the size-class kernels at the range's corner, seeded: K1 with one lane
    # indefinite, K2 on the factors of well-conditioned data
    s0, st = riccati_inputs(6, 256, 24, 24, 8, bad_lane=5)
    check("factor_solve_classed_corner", "K1 factor_solve (classed) B=256 (n_s,n_v,R)=(24, 24, "
                                         "8), lane 5 indefinite",
          lambda: riccati_kernel.factor_solve(s0, *st),
          lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, st,
          riccati_ops(256, N, 24, 24, 8, factor=True), ok_equal, lanes=but_lane(256, 5),
          prof="factor_solve_classed", reps=5)
    s0, st = riccati_inputs(7, 256, 24, 24, 8)
    fac = riccati_kernel.factor_solve_plain(s0, *st)
    check("resolve_classed_corner", "K2 resolve (classed) B=256 (n_s,n_v,R')=(24, 24, 8)",
          lambda: riccati_kernel.resolve(s0, *fac[:5], *st[3:]),
          lambda: riccati_kernel.resolve_plain(s0, *fac[:5], *st[3:]), 5e-6, True,
          list(fac[:5]) + st[3:], riccati_ops(256, N, 24, 24, 8, factor=False),
          prof="resolve_classed", reps=5)
    del s0, st, fac
    # the size-class K3/K4 at (8,2) on 7c's knot matrix and trial grid
    c7c = "<{},{}>".format(*expv_kernel.size_class(8, 2))
    prob7c = scaled_batch(B7, N7, SUB7["7c"][0], taylor_order=SUB7["7c"][1], dev=dev)
    check_k3("window_jac_7c", f"size-class {c7c} at (8,2), free dt", prob7c,
             prof="window_jac_classed")
    lay7 = prob7c.trajectory.layout
    Zt7 = trial_grid_7c(prob7c, dev)
    t7 = prob7c.integrators[0]._trial_views(lay7, Zt7)
    ops7 = horner_ops(Zt7.shape[0] * Zt7.shape[1], lay7.N - 1, 8, 2, SUB7["7c"][1], False)
    check("residual_l1_7c", f"K4 residual size-class {c7c} at (8,2) (L1 form) on Zt "
                            f"{tuple(Zt7.shape)}",
          lambda: expv_kernel.residual_l1(SUB7["7c"][1], *t7),
          lambda: expv_kernel.residual_l1_plain(SUB7["7c"][1], *t7), 2e-6, True, t7, ops7,
          prof="residual_classed")
    check("residual_7c", f"K4 residual size-class {c7c} at (8,2) (vector form) on Zt "
                         f"{tuple(Zt7.shape)}",
          lambda: expv_kernel.residual_action(SUB7["7c"][1], *t7),
          lambda: expv_kernel.residual_action_plain(SUB7["7c"][1], *t7), 2e-6, False, t7, ops7,
          prof="residual_classed")
    del prob7c, Zt7, t7
    # ... and at (3,1), (6,2) and (8,8) on seeded data: 2048 lanes x 50
    # windows, generators of unit scale (the bound is absolute), Taylor
    # order 12
    for xd7, nd7 in SEEDED_EXPV:
        cls7 = "<{},{}>".format(*expv_kernel.size_class(xd7, nd7))
        Gd7, Gv7, u7, dt7, x7, xn7 = seeded_expv(xd7, nd7, dev)
        ins3 = (Gd7, Gv7, u7, dt7, x7)
        # per column, as check_k3 holds every K3 row
        check(f"window_jac_{xd7}_{nd7}", f"K3 window_jac size-class {cls7} at ({xd7},{nd7}) "
                                     f"B=2048 x 50 windows, free dt",
              lambda: expv_kernel.window_jac(12, True, *ins3),
              lambda: expv_kernel.window_jac_plain(12, True, *ins3), 2e-6, "col", ins3,
              horner_ops(2048, 50, xd7, nd7, 12, True, True), prof="window_jac_classed")
        ins4 = (Gd7, Gv7, u7[:, None], dt7[:, None], x7[:, None], xn7[:, None])
        ops4g = horner_ops(2048, 50, xd7, nd7, 12, False)
        check(f"residual_{xd7}_{nd7}", f"K4 residual size-class {cls7} at ({xd7},{nd7}) "
                                   f"(vector form) B=2048 x 50",
              lambda: expv_kernel.residual_action(12, *ins4),
              lambda: expv_kernel.residual_action_plain(12, *ins4), 2e-6, False, ins4, ops4g,
              prof="residual_classed")
        check(f"residual_l1_{xd7}_{nd7}", f"K4 residual size-class {cls7} at ({xd7},{nd7}) "
                                      f"(L1 form) B=2048 x 50",
              lambda: expv_kernel.residual_l1(12, *ins4),
              lambda: expv_kernel.residual_l1_plain(12, *ins4), 2e-6, True, ins4, ops4g,
              prof="residual_classed")
        del Gd7, Gv7, u7, dt7, x7, xn7, ins3, ins4
    # beyond the caps (9 drives) K3 and K4 take the plain version on the
    # card, counted, and compute it bitwise
    rng7 = np.random.default_rng(49)
    Gd7, Gv7, u7, dt7, x7, xn7 = (torch.as_tensor(a, dtype=torch.float32, device=dev) for a in (
        0.5 * rng7.normal(size=(256, 4, 4)), 0.5 * rng7.normal(size=(256, 9, 4, 4)),
        0.3 * rng7.normal(size=(256, 50, 9)), 0.1 + 0.05 * rng7.random((256, 50)),
        rng7.normal(size=(256, 50, 4)), rng7.normal(size=(256, 50, 4))))
    ins4 = (Gd7, Gv7, u7[:, None], dt7[:, None], x7[:, None], xn7[:, None])
    _build.reset_launches()
    outs9 = (expv_kernel.window_jac(12, True, Gd7, Gv7, u7, dt7, x7),
             expv_kernel.residual_action(12, *ins4), expv_kernel.residual_l1(12, *ins4))
    plain9, launched9 = dict(_build.PLAIN_CALLS), sum(_build.LAUNCHES.values())
    same9 = all(torch.equal(a, b) for a, b in zip(outs9, (
        expv_kernel.window_jac_plain(12, True, Gd7, Gv7, u7, dt7, x7),
        expv_kernel.residual_action_plain(12, *ins4), expv_kernel.residual_l1_plain(12, *ins4))))
    print(f"[kernel] K3/K4 at (4,9), beyond the caps: plain calls {json.dumps(plain9)}, launches "
          f"{launched9}, bitwise the plain versions': {same9}", flush=True)
    if not (same9 and launched9 == 0 and plain9["window_jac"] == plain9["residual"]
            == plain9["residual_l1"] == 1):
        fail("K3/K4 at 9 drives did not take the plain version")
    del Gd7, Gv7, u7, dt7, x7, xn7, ins4, outs9

    # the captured calls (≈ 1.5 GiB at B=8192) go before the paths' peak
    # device memory is measured
    del cap_f, cap_r

    # ---------------- 3. path 1: the certified pipeline -------------------- #
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    times = {}
    # Timed: for path 4's polish comparison; the Hessian calls of the
    # polish's first prepare (its three integrators) for the z_k gates
    with Timed(solve_mod, "_solve_impl") as tm1, \
            Capture(ops_riccati, "stack_hessians_zk", 3) as cap_h1:
        res2, res1 = benchmarks.run_headline(prob_big, cfg, times)
    launches = dict(_build.LAUNCHES)
    no_plain_calls("path 1")
    t_seek, t_polish = times["seek"], times["polish"]

    conv = res2.converged.cpu().numpy()
    kkt = res2.kkt_error.cpu().numpy()
    lanes = np.nonzero(conv)[0]
    rms = benchmarks.rms_u_vs_golden(res2, lanes)
    it1, it2 = res1.iterations.cpu().numpy(), res2.iterations.cpu().numpy()
    print(f"[pipeline] B={B} N={N} float32: seek {t_seek:.2f} s, "
          f"polish {t_polish:.2f} s, total {t_seek + t_polish:.2f} s")
    print(f"[pipeline] seek converged {int(res1.converged.sum())}/{B}; "
          f"iterations median {np.median(it1):g} max {it1.max()}")
    print(f"[pipeline] polish converged {len(lanes)}/{B}; "
          f"iterations median {np.median(it2):g} max {it2.max()}")
    kkt_max = float(kkt[lanes].max()) if len(lanes) else float("nan")
    rms_max = float(rms.max()) if len(lanes) else float("nan")
    print(f"[pipeline] over converged lanes: max kkt {kkt_max:.3e} (bound {KKT_CERT:g}), "
          f"max RMS(u) vs golden {rms_max:.3e} (bound {GOLDEN_RMS:g})")
    print(f"[pipeline] kernel launches: {json.dumps(launches)}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    kkt1, st2 = res1.kkt_error.cpu().numpy(), res2.status.cpu().numpy()
    for i in np.nonzero(~conv)[0][:16]:
        print(f"[pipeline] unconverged lane {i}: seek {it1[i]} iterations, kkt {kkt1[i]:.3e}; "
              f"polish {it2[i]} iterations, kkt {kkt[i]:.3e}, status {st2[i]}")

    if any(v == 0 for v in base_counts(launches).values()):
        fail(f"a kernel of the main path was never launched: {launches}")
    if len(lanes) < MIN_CONVERGED * B:
        fail(f"only {len(lanes)}/{B} lanes converged")
    if not (kkt_max <= KKT_CERT and rms_max < GOLDEN_RMS):
        fail("a converged lane is not certified")
    # what path 8 is held to, on the host
    path1 = dict(it1=res1.iterations.cpu(), it2=res2.iterations.cpu(), conv=res2.converged.cpu(),
                 Z1=res1.problem.trajectory.to_zvec().cpu(),
                 Z=res2.problem.trajectory.to_zvec().cpu(), seconds=t_seek + t_polish,
                 certified=len(lanes), chunk=cfg["phase1_kw"]["chunk"],
                 weak_iter=cfg["phase1_kw"]["phases"][0][0])

    # ---------------- 4. path 2: the state-constrained family --------------- #
    del res1, res2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    # for the z_k gates: the Hessians of the fourth prepare (the duals of
    # the first are zero)
    with Capture(ops_riccati, "stack_hessians_zk", 4) as cap_h2:
        res_sc = solve_batch_compact(prob_sc, **sc_cfg["solve_kw"])
    torch.cuda.synchronize()
    t_path2 = time.perf_counter() - t0
    launches2 = dict(_build.LAUNCHES)
    no_plain_calls("path 2")
    conv2 = res_sc.converged.cpu().numpy()
    kkt2 = res_sc.kkt_error.cpu().numpy()
    it_sc = res_sc.iterations.cpu().numpy()
    lanes2 = np.nonzero(conv2)[0]
    err_u, viol = benchmarks.state_constrained_certificate(res_sc)
    print(f"[path2] state-constrained B={B2} N={N2} float32: solve {t_path2:.2f} s; "
          f"converged {len(lanes2)}/{B2}; iterations median {np.median(it_sc):g} "
          f"max {it_sc.max()}")
    kkt2_max = float(kkt2[lanes2].max()) if len(lanes2) else float("nan")
    err_max = float(err_u[lanes2].max()) if len(lanes2) else float("nan")
    viol_max = float(viol[lanes2].max()) if len(lanes2) else float("nan")
    print(f"[path2] over converged lanes: max kkt {kkt2_max:.3e} (bound {KKT_CERT:g}), "
          f"max |u - u*| {err_max:.3e} (bound {GOLDEN_U:g}), "
          f"max (|x_k|^2 - cap) {viol_max:.3e} (bound {VIOL_CERT:g})")
    print(f"[path2] kernel launches: {json.dumps(launches2)}; "
          f"peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    st_sc = res_sc.status.cpu().numpy()
    for i in np.nonzero(~conv2)[0][:16]:
        print(f"[path2] unconverged lane {i}: {it_sc[i]} iterations, kkt {kkt2[i]:.3e}, "
              f"status {st_sc[i]}")
    if any(v == 0 for v in base_counts(launches2).values()):
        fail(f"a kernel of path 2 was never launched: {launches2}")
    if len(lanes2) < MIN_CONVERGED * B2:
        fail(f"path 2: only {len(lanes2)}/{B2} lanes converged")
    if not (kkt2_max <= KKT_CERT and err_max <= GOLDEN_U and viol_max <= VIOL_CERT):
        fail("path 2: a converged lane is not certified")
    path2 = dict(seconds=t_path2, converged=len(lanes2), median=float(np.median(it_sc)),
                 max=int(it_sc.max()))

    # ---------------- 5. path 3: the global-phase family -------------------- #
    del res_sc
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    res_g = solve_batch_compact(prob_g, **g_cfg["solve_kw"])
    torch.cuda.synchronize()
    t_path3 = time.perf_counter() - t0
    launches3 = dict(_build.LAUNCHES)
    no_plain_calls("path 3")
    conv3 = res_g.converged.cpu().numpy()
    kkt3 = res_g.kkt_error.cpu().numpy()
    it_g = res_g.iterations.cpu().numpy()
    lanes3 = np.nonzero(conv3)[0]
    err_u3, err_th3, lin3, eq3, err_ref3 = benchmarks.global_certificate(res_g)
    ref_lanes = lanes3[lanes3 < len(err_ref3)]
    ref_max = float(err_ref3[ref_lanes].max()) if len(ref_lanes) else float("nan")

    def worst(x):
        return float(x[lanes3].max()) if len(lanes3) else float("nan")

    print(f"[path3] global-phase B={B3} N={N3} float32: solve {t_path3:.2f} s; "
          f"converged {len(lanes3)}/{B3}; iterations median {np.median(it_g):g} "
          f"max {it_g.max()}")
    print(f"[path3] over converged lanes: max kkt {worst(kkt3):.3e} (bound {KKT_CERT:g}), "
          f"max |u - u*| {worst(err_u3):.3e} (bound {GOLDEN_U3:g}), "
          f"max |theta - theta*| {worst(err_th3):.3e} (bound {GOLDEN_THETA:g}), "
          f"max |theta_0 + theta_1 - 0.2| {worst(lin3):.3e}, "
          f"max |u_3 - 0.5 theta_0 - 0.1| {worst(eq3):.3e} (bound {EQ_CERT:g} each)")
    print(f"[path3] lanes 0-{len(err_ref3) - 1} ({len(ref_lanes)} converged): max |Z - Z_ref| "
          f"{ref_max:.3e} (bound {GOLDEN_REF3:g}; Z_ref: the JAX package's f64 solve at "
          f"tol 1e-6)")
    print(f"[path3] K1 at (n_s, n_v, R3) = {shape3}, K2 at R' = {R3p}; kernel launches: "
          f"{json.dumps(launches3)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    st_g = res_g.status.cpu().numpy()
    for i in np.nonzero(~conv3)[0][:16]:
        print(f"[path3] unconverged lane {i}: {it_g[i]} iterations, kkt {kkt3[i]:.3e}, "
              f"status {st_g[i]}")
    if any(v == 0 for v in base_counts(launches3).values()):
        fail(f"a kernel of path 3 was never launched: {launches3}")
    if len(lanes3) < MIN_CONVERGED * B3:
        fail(f"path 3: only {len(lanes3)}/{B3} lanes converged")
    if len(ref_lanes) < MIN_CONVERGED * len(err_ref3):
        fail(f"path 3: only {len(ref_lanes)}/{len(err_ref3)} reference lanes converged")
    if not (worst(kkt3) <= KKT_CERT and worst(err_u3) <= GOLDEN_U3
            and worst(err_th3) <= GOLDEN_THETA and worst(lin3) <= EQ_CERT
            and worst(eq3) <= EQ_CERT and ref_max <= GOLDEN_REF3):
        fail("path 3: a converged lane is not certified")
    # device copies per iteration, path 3 beside path 2: the copies of a
    # 3-iteration solve less those of a 2-iteration one, of one chunk
    per_it = {}
    for label, prob_x, kw_x in (("path 2", prob_sc, kw2), ("path 3", prob_g, kw3)):
        n2 = op_count(lambda: solve(prob_x, max_iter=2, **kw_x), "aten::copy_")
        n3 = op_count(lambda: solve(prob_x, max_iter=3, **kw_x), "aten::copy_")
        per_it[label] = n3 - n2
    print(f"[path3] device copies (aten::copy_, host-to-device included) per iteration: "
          f"path 3 {per_it['path 3']}, path 2 {per_it['path 2']}", flush=True)

    # ---------------- 6. path 4: scheduled and polished entry points -------- #
    del res_g
    sch_cfg, pol_cfg = benchmarks.scheduled_config(), benchmarks.polished_config()
    B4a, B4b = sch_cfg["batch"], pol_cfg["batch"]
    if B4a != B:
        fail(f"path 4a runs path 1's batch ({B}), got {B4a}")
    # K4 on 4a's first phase: all lanes in one lockstep, the seek's 9 slots
    Zb = prob_big.trajectory.to_zvec()
    dZb = torch.as_tensor(1e-3 * rng.standard_normal(Zb.shape), dtype=torch.float32, device=dev)
    Ztb = (Zb[:, None] + alphas[None, :, None] * dZb[:, None]).reshape(
        B, n_slots, layout.N, layout.dim)
    tb_args = prob_big.integrators[0]._trial_views(layout, Ztb)
    ops4b = horner_ops(B * n_slots, layout.N - 1, xd4, tb_args[1].shape[1], order, False)
    check("residual_l1_big", f"K4 residual (L1 form) on Zt {tuple(Ztb.shape)}",
          lambda: expv_kernel.residual_l1(order, *tb_args),
          lambda: expv_kernel.residual_l1_plain(order, *tb_args), 2e-6, False, tb_args, ops4b,
          prof="residual_grid_kernel")
    check("residual_big", f"K4 residual (vector form) on Zt {tuple(Ztb.shape)}",
          lambda: expv_kernel.residual_action(order, *tb_args),
          lambda: expv_kernel.residual_action_plain(order, *tb_args), 2e-6, False, tb_args, ops4b,
          prof="residual_grid_kernel")
    del Ztb, tb_args
    # K1-K4 on 4b's float32 phase: B4b lanes in one lockstep, exact Hessian
    # with SOC and restoration (K2 at R' = 2), the default 12 trial slots
    s0, st = riccati_inputs(2, B4b, 8, 3, 3)
    check(f"factor_solve_{B4b}", f"K1 factor_solve (grouped) B={B4b} (n_s,n_v,R)=(8, 3, 3)",
          lambda: riccati_kernel.factor_solve(s0, *st),
          lambda: riccati_kernel.factor_solve_plain(s0, *st), 5e-6, True, st,
          riccati_ops(B4b, N, 8, 3, 3, factor=True), ok_equal, prof="factor_solve_grouped")
    s0r, str_ = riccati_inputs(3, B4b, 8, 3, 2)
    fac = riccati_kernel.factor_solve_plain(s0r, *str_)
    check(f"resolve_{B4b}", f"K2 resolve (grouped) B={B4b} (n_s,n_v,R')=(8, 3, 2)",
          lambda: riccati_kernel.resolve(s0r, *fac[:5], *str_[3:]),
          lambda: riccati_kernel.resolve_plain(s0r, *fac[:5], *str_[3:]), 5e-6, True,
          list(fac[:5]) + str_[3:], riccati_ops(B4b, N, 8, 3, 2, factor=False),
          prof="resolve_grouped")
    del s0, st, s0r, str_, fac
    prob4b = tree_take(prob_big, torch.arange(B4b, device=dev))
    check_k3(f"window_jac_{B4b}", "<4,2> free dt", prob4b)
    n_slots4 = IPMOptions().max_ls + 2
    Z4 = prob4b.trajectory.to_zvec()
    al4 = torch.as_tensor(0.5 ** np.arange(n_slots4), dtype=torch.float32, device=dev)
    Zt4 = (Z4[:, None] + al4[None, :, None] * dZb[:B4b, None]).reshape(
        B4b, n_slots4, layout.N, layout.dim)
    t4 = prob4b.integrators[0]._trial_views(layout, Zt4)
    ops44 = horner_ops(B4b * n_slots4, layout.N - 1, xd4, t4[1].shape[1], order, False)
    check(f"residual_l1_{B4b}", f"K4 residual (L1 form) on Zt {tuple(Zt4.shape)}",
          lambda: expv_kernel.residual_l1(order, *t4),
          lambda: expv_kernel.residual_l1_plain(order, *t4), 2e-6, False, t4, ops44,
          prof="residual_grid_kernel")
    check(f"residual_{B4b}", f"K4 residual (vector form) on Zt {tuple(Zt4.shape)}",
          lambda: expv_kernel.residual_action(order, *t4),
          lambda: expv_kernel.residual_action_plain(order, *t4), 2e-6, False, t4, ops44,
          prof="residual_grid_kernel")
    del Zt4, t4, dZb

    # ---- 4a: solve_batch_scheduled at B=8192 ------------------------------ #
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with Timed(solve_mod, "_solve_impl") as tm4a:
        res4a = solve_batch_scheduled(prob_big, **sch_cfg["solve_kw"])
    torch.cuda.synchronize()
    t_4a = time.perf_counter() - t0
    launches4a = dict(_build.LAUNCHES)
    no_plain_calls("path 4a")
    conv4a = res4a.converged.cpu().numpy()
    kkt4a = res4a.kkt_error.cpu().numpy()
    it_all = res4a.iterations.cpu().numpy()
    it_last = res4a.ipm.iterations.cpu().numpy()  # of the phase that produced the lane
    strag = it_all > it_last
    lanes4a = np.nonzero(conv4a)[0]
    err_det, err_full = benchmarks.scheduled_certificate(res4a)
    n_ref4 = min(B4a, len(np.load(benchmarks.GOLDEN_SCHEDULED)["Z_ref"]))
    sound = benchmarks.telemetry_sound(res4a)
    rms4a = benchmarks.rms_u_vs_golden(res4a, lanes4a)
    kkt4a_max = float(kkt4a[lanes4a].max()) if len(lanes4a) else float("nan")
    p1_its = np.where(strag, it_all - it_last, it_all)
    print(f"[path4a] solve_batch_scheduled B={B4a} N={N} float32: {t_4a:.2f} s; converged "
          f"{len(lanes4a)}/{B4a}; phase 1 iterations median {np.median(p1_its):g} max "
          f"{p1_its.max()}; {tm4a.calls[0]['unconverged']} stragglers into phase 2 "
          f"({len(tm4a.calls) - 1} chunks of {sch_cfg['solve_kw']['chunk']}), their phase-2 "
          f"iterations median {np.median(it_last[strag]) if strag.any() else 0:g} max "
          f"{it_last[strag].max() if strag.any() else 0}", flush=True)
    phase_line("path4a", "phase 1", tm4a.calls[0])
    if len(tm4a.calls) > 1:
        p2 = dict(seconds=sum(c["seconds"] for c in tm4a.calls[1:]),
                  lanes=sum(c["lanes"] for c in tm4a.calls[1:]), dtype=tm4a.calls[1]["dtype"],
                  passes=sum(c["passes"] for c in tm4a.calls[1:]),
                  unconverged=sum(c["unconverged"] for c in tm4a.calls[1:]),
                  launches={k: sum(c["launches"].get(k, 0) for c in tm4a.calls[1:])
                            for k in launches4a})
        phase_line("path4a", "phase 2 (all chunks, padding included)", p2)
    print(f"[path4a] over converged lanes: max kkt {kkt4a_max:.3e} (bound {KKT_CERT:g}); "
          f"lanes 0-{n_ref4 - 1}: max |u, du, ddu - ref| {err_det:.3e} (bound {GOLDEN_REF4:g}), "
          f"max |Z - Z_ref| {err_full:.3e} (not certified: the optimum u = 0 leaves dt and x "
          f"free); RMS(u) vs golden max {float(rms4a.max()) if len(lanes4a) else float('nan'):.3e} "
          f"(printed, not certified)")
    print(f"[path4a] telemetry ring {tuple(res4a.ipm.history_stats.shape)}: sound on "
          f"{int(sound.sum())}/{B4a} lanes; kernel launches {json.dumps(launches4a)}; peak "
          f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    st4a = res4a.status.cpu().numpy()
    for i in np.nonzero(~conv4a)[0][:16]:
        print(f"[path4a] unconverged lane {i}: {it_all[i]} iterations, kkt {kkt4a[i]:.3e}, "
              f"status {st4a[i]}")
    del res4a

    # ---- 4b: solve_batch_polished on lanes 0-(B4b - 1) -------------------- #
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with Timed(solve_mod, "_solve_impl") as tm4b:
        res4b = solve_batch_polished(prob4b, **pol_cfg["solve_kw"])
    torch.cuda.synchronize()
    t_4b = time.perf_counter() - t0
    launches4b = dict(_build.LAUNCHES)
    no_plain_calls("path 4b (its float32 phase; the float64 polish is not counted)")
    c32, c64 = tm4b.calls
    conv4b = res4b.converged.cpu().numpy()
    kkt4b = res4b.kkt_error.cpu().numpy()
    lanes4b = np.nonzero(conv4b)[0]
    rms4b = benchmarks.rms_u_vs_golden(res4b, lanes4b)
    it4b = res4b.iterations.cpu().numpy()
    kkt4b_max = float(kkt4b[lanes4b].max()) if len(lanes4b) else float("nan")
    rms4b_max = float(rms4b.max()) if len(lanes4b) else float("nan")
    z64 = res4b.problem.trajectory.to_zvec().dtype == torch.float64
    print(f"[path4b] solve_batch_polished B={B4b} N={N}: {t_4b:.2f} s; converged "
          f"{len(lanes4b)}/{B4b}; polish iterations median {np.median(it4b):g} max {it4b.max()}",
          flush=True)
    phase_line("path4b", "float32 phase", c32)
    phase_line("path4b", "float64 polish (the kernels serve float32 only: the plain "
                         "versions run, 0 launches expected)", c64)
    pol1 = [c for c in tm1.calls if not c["gauss_newton"]]
    s_p1 = sum(c["seconds"] for c in pol1) / max(1, sum(c["passes"] for c in pol1))
    print(f"[path4b] float64 polish: {c64['seconds'] / max(1, c64['passes']):.4f} s per lockstep "
          f"iteration at {c64['lanes']} lanes; path 1's compensated-float32 polish in this run: "
          f"{s_p1:.4f} s per lockstep iteration at {pol1[0]['lanes'] if pol1 else 0} lanes "
          f"({sum(c['passes'] for c in pol1)} passes in {sum(c['seconds'] for c in pol1):.2f} s)")
    print(f"[path4b] over converged lanes: Z float64 {z64}; max kkt {kkt4b_max:.3e} (bound "
          f"{KKT_POLISH:g}), max RMS(u) vs golden {rms4b_max:.3e} (bound {GOLDEN_RMS:g}); "
          f"kernel launches {json.dumps(launches4b)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    st4b = res4b.status.cpu().numpy()
    for i in np.nonzero(~conv4b)[0][:16]:
        print(f"[path4b] unconverged lane {i}: {it4b[i]} polish iterations, kkt {kkt4b[i]:.3e}, "
              f"status {st4b[i]}")
    launches4 = {k: launches4a[k] + c32["launches"].get(k, 0) for k in BASE_KERNELS}
    if any(v == 0 for v in launches4.values()):
        fail(f"a kernel of path 4 (4a and 4b's float32 phase) was never launched: {launches4}")
    if len(lanes4a) < MIN_CONVERGED * B4a:
        fail(f"path 4a: only {len(lanes4a)}/{B4a} lanes converged")
    if not (kkt4a_max <= KKT_CERT and err_det <= GOLDEN_REF4):
        fail("path 4a: a converged lane is not certified")
    if not sound.all():
        fail(f"path 4a: the telemetry ring is unsound on lanes {np.nonzero(~sound)[0][:16]}")
    if len(lanes4b) < MIN_CONVERGED * B4b:
        fail(f"path 4b: only {len(lanes4b)}/{B4b} lanes converged")
    if not (z64 and kkt4b_max <= KKT_POLISH and rms4b_max < GOLDEN_RMS):
        fail("path 4b: a converged lane is not certified in float64")
    del res4b

    # ---------------- 7. path 5: the cartpole family ------------------------ #
    def riccati_launches(counts):
        return {k: counts.get(k, 0) for k in ("factor_solve", "resolve")}

    def run5(tag, what, cfg5, kkt_bar, obj_bar, rms_bar, needs_k12):
        """Solve path 5's batch with ``cfg5`` in one chunk; print and
        certify, and fail unless each K1/K2 kernel of ``needs_k12`` ran and
        no size-class K1/K2 did. Returns the launches, the objectives and the
        K1/K2 launches by kernel (``_build.INSTANCES``)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        _build.reset_launches()
        with Timed(solve_mod, "_solve_impl") as tm:
            res = solve_batch_compact(prob_cp, **cfg5["solve_kw"])
        counts = dict(_build.LAUNCHES)
        k12 = dict(_build.INSTANCES)
        no_plain_calls(tag)
        conv5 = res.converged.cpu().numpy()
        kkt5 = res.kkt_error.cpu().numpy()
        it5 = res.iterations.cpu().numpy()
        ln5 = np.nonzero(conv5)[0]
        obj_err, rms5 = benchmarks.cartpole_certificate(res)

        def worst(x):
            return float(x[ln5].max()) if len(ln5) else float("nan")

        phase_line(tag, what, tm.calls[0])
        print(f"[{tag}] converged {len(ln5)}/{B5}; iterations median {np.median(it5):g} max "
              f"{it5.max()}; over converged lanes: max kkt {worst(kkt5):.3e} (bound {kkt_bar:g}), "
              f"max |obj/obj* - 1| {worst(obj_err):.3e} (bound {obj_bar:g}), RMS(u - u*) median "
              f"{np.median(rms5[ln5]) if len(ln5) else float('nan'):.3e} max {worst(rms5):.3e} "
              f"(bound {rms_bar:g}; {int((rms5[ln5] > 1e-3).sum())} lanes above 1e-3); peak "
              f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; K1/K2 "
              f"launches by kernel {json.dumps(k12)}", flush=True)
        st5 = res.status.cpu().numpy()
        for i in np.nonzero(~conv5)[0][:16]:
            print(f"[{tag}] unconverged lane {i}: {it5[i]} iterations, kkt {kkt5[i]:.3e}, "
                  f"status {st5[i]}")
        if any(v == 0 for v in riccati_launches(counts).values()):
            fail(f"{tag}: a kernel of the path was never launched: {counts}")
        missing = [k for k in needs_k12 if not k12.get(k)]
        if missing:
            fail(f"{tag}: {missing} never launched: {k12}")
        if any("_classed<" in k for k in k12):
            fail(f"{tag}: a size-class K1/K2 ran where the grouped or column one should: {k12}")
        if len(ln5) < MIN_CONVERGED * B5:
            fail(f"{tag}: only {len(ln5)}/{B5} lanes converged")
        if not (worst(kkt5) <= kkt_bar and worst(obj_err) <= obj_bar and worst(rms5) <= rms_bar):
            fail(f"{tag}: a converged lane is not certified")
        return counts, res.objective.detach().to("cpu", torch.float64).numpy(), k12

    k1_5, k2_5, k2_5b = (f"factor_solve_grouped<{shape_f5[0]},{shape_f5[1]},{shape_f5[2]}>",
                         f"resolve_grouped<{shape_r5[0]},{shape_r5[1]},{shape_r5[2]}>",
                         f"resolve_columns<{shape_r5b[0]},{shape_r5b[1]}>")
    _, _, inst5a = run5("path5a", f"cartpole B={B5} N={N5} float32, exact Hessian", cp_cfg,
                        KKT_5A, OBJ_5A, RMS_5A, (k1_5, k2_5))
    _, obj5b, inst5b = run5("path5b", f"cartpole B={B5} N={N5} float32, L-BFGS m="
                                      f"{lb_cfg['solve_kw']['limited_memory_max_history']}",
                            lb_cfg, KKT_5B, OBJ_5B, float("inf"), (k1_5, k2_5b))

    # ---- 5c: the other IPM options on lanes 0-255 of path 1's batch -------- #
    prob5c = tree_take(prob_big, torch.arange(LANES_5C, device=dev))
    launches5c = {}
    for name, extra, bar in PATH5C:
        _build.reset_launches()
        with Timed(solve_mod, "_solve_impl") as tm5c:
            res5c = solve_batch_compact(prob5c, **dict(cfg["phase1_kw"], **extra))
        no_plain_calls(f"path 5c ({name})")
        for k, v in _build.LAUNCHES.items():
            launches5c[k] = launches5c.get(k, 0) + v
        n_conv = int(res5c.converged.sum())
        it5c = res5c.iterations.cpu().numpy()
        finite = torch.isfinite(res5c.problem.trajectory.to_zvec()).all(-1)
        passes = sum(c["passes"] for c in tm5c.calls)
        secs = sum(c["seconds"] for c in tm5c.calls)
        k12 = riccati_launches(_build.LAUNCHES)
        print(f"[path5c] {name}: {secs:.2f} s, {passes} lockstep passes over "
              f"{len(tm5c.calls)} phases; converged {n_conv}/{LANES_5C} (bar {bar:.0%}); "
              f"iterations median {np.median(it5c):g} max {it5c.max()}; finite on "
              f"{int(finite.sum())}/{LANES_5C} lanes; K1 / K2 launches {k12['factor_solve']} / "
              f"{k12['resolve']}; all launches {json.dumps(dict(_build.LAUNCHES))}", flush=True)
        if not bool(finite.all()):
            fail(f"path 5c ({name}): an iterate is not finite")
        if k12["factor_solve"] == 0 or n_conv < bar * LANES_5C:
            fail(f"path 5c ({name}): no K1 launch, or {n_conv}/{LANES_5C} converged is below "
                 f"its bar")
        del res5c

    # ---------------- 8. path 6: the dense backend --------------------------- #
    launches6b = path6(dev, prob_big, prob_cp, it1, obj5b)
    no_plain_calls("path 6")
    del prob_cp, prob_big

    # ---------------- 9. path 7: the scaling family -------------------------- #
    torch.cuda.empty_cache()
    launches7, instances7 = path7(dev)

    # ---------------- 10. path 8: path 1 on two processes -------------------- #
    launches8 = path8(path1)

    # ---------------- 11. the z_k gates ------------------------------------- #
    gate_phase({"path 1's polish": cap_h1.calls, "path 2": cap_h2.calls[-1:]}, prob_sc, sc_cfg,
               path2)

    table = []
    for name in BASE_KERNELS:
        route, src, replaces = KERNELS[name]
        r = results[name]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=launches[name], max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    for name, key in PATH2:
        route, src, replaces = KERNELS[key]
        r = results[name]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=launches2[key], max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    for name, key in PATH3:
        route, src, replaces = KERNELS[key]
        r = results[name]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=launches3[key], max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    # path 4's rows: K1/K3/K4 at 8192 lanes (4a's first phase), path 1's
    # shapes at 256 lanes (4a's straggler chunks; no K2: SOC and restoration
    # are off), and K1-K4 at B4b lanes (4b's float32 phase)
    p2_launch = {k: sum(c["launches"].get(k, 0) for c in tm4a.calls[1:]) for k in KERNELS}
    path4 = ([(f"{k}_big", k, tm4a.calls[0]["launches"]) for k in
              ("factor_solve", "window_jac", "residual", "residual_l1")]
             + [(f"{k}_sched", k, p2_launch) for k in
                ("factor_solve", "window_jac", "residual", "residual_l1")]
             + [(f"{k}_{B4b}", k, c32["launches"]) for k in BASE_KERNELS])
    for name, key, counts in path4:
        route, src, replaces = KERNELS[key]
        r = results[name if name in results else key]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=counts.get(key, 0), max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    # path 5's rows, launches by kernel (``_build.INSTANCES``): K1 (4,1,1)
    # and K2 (4,1,2) in 5a and 5b (5b's K2 (4,1,2): SOC + restoration), K2
    # (4,1,40) in 5b (the SMW columns once an iteration); the size-class
    # kernels, timed on the same captured calls, and the seeded R' = 40 rows
    # (no path runs them); 5c's runs at path 1's shapes (K2 at (8,3,1):
    # Mehrotra's main step by resolve, the size-class kernel)
    path5 = [("factor_solve_cp", "factor_solve", inst5a.get(k1_5, 0), "factor_solve_cp"),
             ("resolve_cp", "resolve", inst5a.get(k2_5, 0), "resolve_cp"),
             ("factor_solve_lbfgs", "factor_solve", inst5b.get(k1_5, 0), "factor_solve_cp"),
             ("resolve_lbfgs", "resolve", inst5b.get(k2_5b, 0), "resolve_lbfgs"),
             ("resolve_lbfgs_soc", "resolve", inst5b.get(k2_5, 0), "resolve_cp")]
    path5 += [(name, key, 0, name) for name, key in (
        ("factor_solve_cp_classed", "factor_solve_classed"),
        ("resolve_cp_classed", "resolve_classed"), ("resolve_lbfgs_classed", "resolve_classed"),
        ("resolve_r40", "resolve"), ("resolve_r40_classed", "resolve_classed"))]
    path5 += [(f"{k}_options", k, launches5c.get(k, 0),
               "resolve_classed_81" if k == "resolve" else k) for k in BASE_KERNELS]
    for name, key, n_launch, res_key in path5:
        route, src, replaces = KERNELS[key]
        r = results[res_key]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=n_launch, max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    # path 6b's rows: K4 on the dense backend's line search at path 1's
    # shapes (256 lanes, the seek's slots), the shapes of the K4 rows above
    for k in ("residual", "residual_l1"):
        route, src, replaces = KERNELS[k]
        r = results[k]
        table.append(dict(name=f"{k}_dense", route=route, source=src, replaces=replaces,
                          launches=launches6b.get(k, 0), max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    # path 7's rows: the grouped K1/K2 at (10,3,·) on 7a and 7c (the same
    # shape) and at (18,3,·) on 7b, the size-class K3/K4 on 7c, the size-class
    # K1/K2 at (6,3,·) on 7e (launches by CUDA kernel); the size-class
    # kernels on 7a's and 7b's captured calls (no path runs them there);
    # the seeded rows (the size-class corner, the size-class K3/K4 at
    # (3,1), (6,2) and (8,8)) at shapes no path runs
    def classed_launches(k):
        return {k: sum(v for name, v in instances7["7e"].items()
                       if name.startswith(k + "<"))}

    rows7 = [("factor_solve_7a", "factor_solve", launches7["7a"], "factor_solve_7a"),
             ("resolve_7a", "resolve", launches7["7a"], "resolve_7a"),
             ("factor_solve_7b", "factor_solve", launches7["7b"], "factor_solve_7b"),
             ("resolve_7b", "resolve", launches7["7b"], "resolve_7b"),
             ("factor_solve_7c", "factor_solve", launches7["7c"], "factor_solve_7a"),
             ("resolve_7c", "resolve", launches7["7c"], "resolve_7a"),
             ("factor_solve_7e", "factor_solve_classed",
              classed_launches("factor_solve_classed"), "factor_solve_7e"),
             ("resolve_7e", "resolve_classed", classed_launches("resolve_classed"),
              "resolve_7e"),
             ("factor_solve_7a_classed", "factor_solve_classed", {}, "factor_solve_7a_classed"),
             ("resolve_7a_classed", "resolve_classed", {}, "resolve_7a_classed"),
             ("factor_solve_7b_classed", "factor_solve_classed", {}, "factor_solve_7b_classed"),
             ("resolve_7b_classed", "resolve_classed", {}, "resolve_7b_classed"),
             ("window_jac_7c", "window_jac_generic", launches7["7c"], "window_jac_7c"),
             ("residual_7c", "residual_generic", launches7["7c"], "residual_7c"),
             ("residual_l1_7c", "residual_l1_generic", launches7["7c"], "residual_l1_7c"),
             ("factor_solve_classed_corner", "factor_solve_classed", {},
              "factor_solve_classed_corner"),
             ("resolve_classed_corner", "resolve_classed", {}, "resolve_classed_corner")]
    # the size-class kernels beside the exact instances at paths 1-3's
    # shapes, and at the seeded shapes no path runs
    rows7 += [(name, f"{'factor_solve' if name.startswith('factor') else 'resolve'}_classed", {},
               name) for name in (
        "factor_solve_classed", "resolve_classed", "factor_solve_sc_classed",
        "resolve_sc_classed", "factor_solve_gp_classed", "resolve_gp_classed",
        "factor_solve_classed_82", "factor_solve_classed_small", "resolve_classed_81",
        "resolve_classed_small") if name in results]
    rows7 += [(f"{k}_{xd}_{nd}", f"{k}_generic", {}, f"{k}_{xd}_{nd}")
              for xd, nd in SEEDED_EXPV for k in ("window_jac", "residual", "residual_l1")]
    for name, key, counts, res_key in rows7:
        route, src, replaces = KERNELS[key]
        r = results[res_key]
        table.append(dict(name=name, route=route, source=src, replaces=replaces,
                          launches=counts.get(key, 0), max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    # path 8's rows: path 1's shapes, launches summed over the two ranks
    for k in BASE_KERNELS:
        route, src, replaces = KERNELS[k]
        r = results[k]
        table.append(dict(name=f"{k}_sharded", route=route, source=src, replaces=replaces,
                          launches=sum(x[k] for x in launches8), max_abs_err=r["max_abs_err"],
                          ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                          bound_by=r["bound_by"], library_ms=None, device_ms=r["device_ms"]))
    print(json.dumps({"kernels": table}))
    print(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
