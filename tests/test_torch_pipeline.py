"""The certified two-stage pipeline of the port, as a whole.

* Against JAX: the same N=11 batch (carried across by ``bridge``) through
  the seek and the polish of ``benchmarks.headline_config`` in both
  packages at f64. Per-lane iteration counts and converged flags must be
  equal and the solutions agree to 1e-7 (the end-to-end bound of
  ``tests/test_expv_kernel.py::test_e2e_solve_matches_generic_path``).
* Against the golden optimum: the port alone at N=51 in f64 and in f32 (the
  f32 polish runs ``compensated_residuals``) must converge every lane to
  kkt ≤ 1e-6 with RMS(u) < 1e-4, the bars of ``tests/test_bench_quality.py``.
* Chunking: per-lane results do not depend on the compaction chunk.
"""

import jax
import numpy as np
import pytest
import torch

from directtrajopt_tpu import benchmarks as jbench
from directtrajopt_tpu.solvers.solve import solve_batch_compact as j_compact
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.solvers.solve import cast_problem, solve_batch_compact

torch.set_num_threads(1)


def _kw(stage, chunk):
    cfg = tbench.headline_config(batch=2)
    return dict(cfg[stage], chunk=chunk)


@pytest.fixture(scope="module")
def runs():
    """Seek then polish of one N=11, B=2 batch in both packages (f64)."""
    jp = jbench.make_batched_bilinear_problems(2, N=11, feasible_start=True, taylor_order=6)
    j1 = j_compact(jp, **_kw("phase1_kw", 2))
    j2 = j_compact(j1.problem, warm=j1.ipm.state.best_kkt_warm, **_kw("polish_kw", 2))
    t1 = solve_batch_compact(from_numpy_problem(jp, "cpu"), **_kw("phase1_kw", 2))
    t2 = solve_batch_compact(t1.problem, warm=t1.ipm.state.best_kkt_warm, **_kw("polish_kw", 2))
    return (j1, j2), (t1, t2)


@pytest.mark.parametrize("stage", [0, 1], ids=["seek", "polish"])
def test_pipeline_matches_jax(runs, stage):
    jr, tr = runs[0][stage], runs[1][stage]
    assert np.array_equal(np.asarray(jr.iterations), tr.iterations.numpy())
    assert np.array_equal(np.asarray(jr.converged), tr.converged.numpy())
    assert tr.converged.all()
    Zj = np.asarray(jax.device_get(jr.problem.trajectory.to_zvec()))
    Zt = tr.problem.trajectory.to_zvec().numpy()
    assert np.max(np.abs(Zj - Zt)) < 1e-7
    np.testing.assert_allclose(tr.kkt_error.numpy(), np.asarray(jr.kkt_error), rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_headline_pipeline_matches_golden(dtype):
    cfg = tbench.headline_config(batch=2)
    batch = cast_problem(tbench.make_batched_bilinear_problems(
        2, N=cfg["N"], feasible_start=True, taylor_order=cfg["taylor_order"], device="cpu"),
        dtype)
    times = {}
    res, res_seek = tbench.run_headline(batch, cfg, times)
    assert set(times) == {"seek", "polish"} and min(times.values()) > 0
    assert res.problem.trajectory.data["u"].dtype == dtype
    assert res_seek.converged.all() and res.converged.all()
    assert float(res.kkt_error.max()) <= 1e-6
    rms = tbench.rms_u_vs_golden(res)
    assert rms.shape == (2,) and rms.max() < 1e-4, rms


def test_results_do_not_depend_on_chunk():
    batch = tbench.make_batched_bilinear_problems(3, N=11, seed=7, feasible_start=True,
                                                  taylor_order=6, device="cpu")
    kw = dict(_kw("phase1_kw", 1), phases=((4, None), (40, 1e-2)))
    r1 = solve_batch_compact(batch, **kw)
    r3 = solve_batch_compact(batch, **dict(kw, chunk=3))
    assert torch.equal(r1.iterations, r3.iterations)
    assert torch.equal(r1.converged, r3.converged)
    torch.testing.assert_close(r1.problem.trajectory.to_zvec(), r3.problem.trajectory.to_zvec(),
                               rtol=0, atol=1e-12)
