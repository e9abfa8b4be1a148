"""The plain reference against the program on a few lanes (CPU, float64):
the same residuals, objective, pins and bounds; its Jacobian against
autograd; its certificate small at a solved answer and large where the
answer is wrong."""

import numpy as np
import pytest
import torch

from directtrajopt_tpu_torch.solvers.canonical import make_nlp
from harness import spec
from portbench_helpers import small_cell

WORKLOADS = ["bilinear_n51.rollout8192", "scaled_n51.d4x8192", "scaled_n51.d8x2048"]


def _setup(workload, N=6, lanes=3, seed=7):
    cell = small_cell(workload, N=N, lanes=lanes)
    cfg = dict(cell.config, dtype="float64")
    drv = spec.system(cfg)
    drawn = drv.draw(cfg, cell.traffic, seed, 0, torch.device("cpu"))
    prob = drv.build(cfg, drawn, torch.device("cpu"))
    ref = spec.reference(cfg)
    lay = ref.layout(cfg, cell.traffic)
    return cfg, drawn, prob, ref, lay


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_poses_the_programs_problem(workload):
    cfg, drawn, prob, ref, lay = _setup(workload)
    nlp = make_nlp(prob)
    g = torch.Generator().manual_seed(3)
    Z = 0.3 * torch.randn((3, lay.D), generator=g, dtype=torch.float64)
    Z[:, lay.offsets["dt"]::lay.d] = 0.05 + 0.2 * torch.rand((3, lay.N), generator=g,
                                                              dtype=torch.float64)
    c_prog = nlp.c_eq(Z)
    c_ref = ref.residuals(cfg, lay, Z, drawn["problem"]["Gd"], drawn["problem"]["Gv"])
    assert c_prog.shape == c_ref.shape
    torch.testing.assert_close(c_ref, c_prog, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(ref.objective(cfg, lay, Z), nlp.objective(Z), rtol=1e-12,
                               atol=1e-14)
    pin_idx, pin_val = ref.pins(cfg, lay)
    np.testing.assert_array_equal(np.sort(pin_idx), nlp.fix_idx)
    np.testing.assert_allclose(nlp.fix_val[0].numpy(), pin_val[np.argsort(pin_idx)])
    lb, ub = ref.bounds(cfg, lay)
    free = nlp.free_mask.numpy() > 0
    np.testing.assert_array_equal(lb[free], nlp.lb[0].numpy()[free])
    np.testing.assert_array_equal(ub[free], nlp.ub[0].numpy()[free])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_jacobian_and_gradient(workload):
    cfg, drawn, prob, ref, lay = _setup(workload, N=4, lanes=2)
    g = torch.Generator().manual_seed(5)
    Z = 0.3 * torch.randn((2, lay.D), generator=g, dtype=torch.float64)
    Z[:, lay.offsets["dt"]::lay.d] = 0.1 + 0.1 * torch.rand((2, lay.N), generator=g,
                                                             dtype=torch.float64)
    Gd, Gv = drawn["problem"]["Gd"], drawn["problem"]["Gv"]
    J = ref.jacobian(cfg, lay, Z, Gd, Gv)
    for b in range(2):
        Ja = torch.autograd.functional.jacobian(
            lambda z: ref.residuals(cfg, lay, z[None], Gd[b:b + 1], Gv[b:b + 1])[0], Z[b])
        torch.testing.assert_close(J[b], Ja, rtol=1e-10, atol=1e-12)
        ga = torch.autograd.functional.jacobian(
            lambda z: ref.objective(cfg, lay, z[None])[0], Z[b])
        torch.testing.assert_close(ref.gradient(cfg, lay, Z)[b], ga, rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("workload", WORKLOADS[:2])
def test_certificate_of_a_solve(workload):
    """At the program's answer every number is small; an answer moved off
    the dynamics, or a reported objective changed, reads large."""
    import run as bench

    cell = small_cell(workload, N=11, lanes=4)
    prog = bench.Program(cell, 5, torch.device("cpu"))
    call = prog.call(0)
    a, p = call["answer"], call["problem"]
    assert bool(a["converged"].all())
    ref = spec.reference(cell.config)
    lay = ref.layout(cell.config, cell.traffic)
    c = ref.certificate(cell.config, lay, a, p)
    assert float(c["feas"].max()) < 1e-3 and float(c["stat"].max()) < 1e-3
    assert float(c["comp"].max()) < 1e-3 and float(c["obj_gap"].max()) < 1e-6
    Z = a["Z"].clone()
    Z[1, lay.col("x", 5)] += 0.05
    obj = a["objective"].clone()
    obj[2] += 0.05
    bad = ref.certificate(cell.config, lay, dict(a, Z=Z, objective=obj), p)
    assert float(bad["feas"][1]) > 0.04 and float(bad["obj_gap"][2]) > 0.04
    assert float(bad["feas"][0]) == float(c["feas"][0])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_feasible_point_and_the_optimum(workload):
    """The reference's feasible point meets every constraint; with the
    chain at 0 it is the optimum, where every number reads 0."""
    cfg, drawn, prob, ref, lay = _setup(workload, N=6, lanes=3)
    Z0 = spec.system(cfg).guess(cfg, drawn)
    Z = ref.feasible(cfg, lay, Z0, drawn["problem"])
    zero = torch.zeros_like(Z)
    c = ref.certificate(cfg, lay, dict(Z=Z, zL=zero, zU=zero, objective=ref.objective(cfg, lay, Z)),
                        drawn["problem"])
    assert float(c["feas"].max()) < 1e-12 and float(c["opt_gap"].min()) > 1e-4
    Zm = Z0.clone().view(3, lay.N, lay.d)
    for name in cfg["chain"]:
        Zm[..., lay.cols(name, 0)] = 0.0
    Z = ref.feasible(cfg, lay, Zm.view(3, -1), drawn["problem"])
    c = ref.certificate(cfg, lay, dict(Z=Z, zL=zero, zU=zero, objective=ref.objective(cfg, lay, Z)),
                        drawn["problem"])
    assert ref.optimum(cfg) == 0.0
    for k in ("feas", "stat", "opt_gap"):
        assert float(c[k].max()) < 1e-12, k
