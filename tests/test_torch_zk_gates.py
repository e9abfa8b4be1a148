"""The environment gates of ``integrators/base.py`` in the port, against the
JAX package under the same setting.

Both packages read the gates when the derivative functions run, the JAX
package when it traces them: its functions are traced here under each
setting. For each setting and
each integrator family (the bilinear integrator, Taylor and Padé, the
derivative integrator with a free and a fixed Δt, the time-dependent
integrator, which has read columns but no ``hessian_zk``, and cartpole's
RK4 integrator, which reads every column), the z_k-width Jacobians and
Hessians agree to 1e-12 of their largest entry in float64, and so do the
window Jacobians and Hessians under ``DTX_NO_READCOLS`` and
``DTX_NO_CUSTOM_HESS`` and the stacked residuals under
``DTX_RES_KERNEL=0`` (their default forms are held in
``tests/test_torch_time_dependent.py``). One N=11 exact-Hessian
solve of path 1's family with both z_k gates on takes the same iterations
on every lane as the JAX package's under the same gates and ends within
1e-7 of it (the bar of ``tests/test_torch_pipeline.py``; the JAX solve is
``golden/torch/zk_gates_n11.npz``).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import directtrajopt_tpu as dtx
import directtrajopt_tpu_torch as tdx
from directtrajopt_tpu import benchmarks as jbench
from directtrajopt_tpu.integrators import base as jbase
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.bridge import from_numpy_problem
from directtrajopt_tpu_torch.integrators import base as tbase
from directtrajopt_tpu_torch.ops import expv_kernel
from directtrajopt_tpu_torch.solvers.solve import solve_batch_compact

torch.set_num_threads(1)

GATES = ("DTX_ZK_CUSTOM_HESS", "DTX_ZK_READCOLS", "DTX_NO_READCOLS", "DTX_NO_CUSTOM_HESS",
         "DTX_ZK_KERNEL", "DTX_RES_KERNEL")
SETTINGS = {
    "default": {},
    "custom": {"DTX_ZK_CUSTOM_HESS": "1"},
    "readcols": {"DTX_ZK_READCOLS": "1"},
    "both": {"DTX_ZK_CUSTOM_HESS": "1", "DTX_ZK_READCOLS": "1"},
    "no_readcols": {"DTX_NO_READCOLS": "1"},
    "no_custom_hess": {"DTX_NO_CUSTOM_HESS": "1"},
    "no_kernels": {"DTX_ZK_KERNEL": "0", "DTX_RES_KERNEL": "0"},
}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "torch", "zk_gates_n11.npz")
G_DRIFT = np.array([[0.0, 1.0], [-1.0, 0.0]])
G_DRIVE = np.array([[0.0, 1.0], [1.0, 0.0]])


def _set(monkeypatch, setting):
    for g in GATES:
        monkeypatch.delenv(g, raising=False)
    for g, v in SETTINGS[setting].items():
        monkeypatch.setenv(g, v)


def _t(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _traj(free_time, N=6, seed=0):
    """x 2, u 1, du 1, t 1 and (free) Δt, perturbed so that every read
    column carries curvature."""
    rng = np.random.default_rng(seed)
    dts = np.full((N, 1), 0.1) + 0.01 * rng.normal(size=(N, 1))
    data = {"x": rng.normal(size=(N, 2)) * 0.5, "u": rng.normal(size=(N, 1)) * 0.3,
            "du": rng.normal(size=(N, 1)) * 0.1, "t": np.cumsum(dts, axis=0) - dts[0]}
    if free_time:
        data["dt"] = dts
    return dtx.Trajectory.create(data, timestep="dt" if free_time else 0.1, controls="du")


def _knot_pair(name):
    """The JAX integrator and layout, the port's, and a seeded knot matrix,
    for one family."""
    if name == "cartpole_rk4":
        jl = jbench.make_cartpole_problem(N=9, seed=2).trajectory.layout
        tp = tbench.make_cartpole_problem(N=9, seed=2, device="cpu")
        zm = tp.trajectory.to_zvec()[0].numpy().reshape(9, -1)
        return (dtx.GeneralIntegrator.create(jbench.cartpole_dynamics(), "x", "u"), jl,
                tdx.GeneralIntegrator.create(tbench.cartpole_dynamics(), "x", "u"),
                tp.trajectory.layout, zm + 0.3 * np.random.default_rng(5).normal(size=zm.shape))
    traj = _traj(name != "derivative_fixed_dt")
    fn = None
    if name.startswith("bilinear"):
        ji = dtx.BilinearIntegrator.create((G_DRIFT, [G_DRIVE]), "x", "u", None,
                                           method=name.split("_")[1])
    elif name.startswith("derivative"):
        ji = dtx.DerivativeIntegrator.create("u", "du", traj)
    else:
        ji = dtx.TimeDependentBilinearIntegrator.create(
            lambda u, t: (1.0 + 0.3 * jnp.sin(t)) * jnp.asarray(G_DRIFT) + u[0] * jnp.asarray(G_DRIVE),
            "x", "u", "t", traj, spline_order=0, n_steps=1)

        def fn(u, t):
            return (1.0 + 0.3 * torch.sin(t)) * _t(G_DRIFT, u) + u[0] * _t(G_DRIVE, u)
    jp = dtx.DirectTrajOptProblem.create(traj, dtx.QuadraticRegularizer.create("u", traj, 1.0), ji)
    tp = from_numpy_problem(jp, "cpu", functions={("integrator", 0): fn} if fn else {})
    return ji, traj.layout, tp.integrators[0], tp.trajectory.layout, np.array(traj.knot_matrix())


FAMILIES = ["bilinear_taylor", "bilinear_pade", "derivative_free_dt", "derivative_fixed_dt",
            "time_dependent", "cartpole_rk4"]


class _Recorded(dict):
    """The environment a setting gives the gates, recording which gates a
    traced function reads and the values it finds."""

    def __init__(self, setting):
        super().__init__((k, v) for k, v in os.environ.items() if k not in GATES)
        self.update(SETTINGS[setting])
        self.reads = {}

    def get(self, key, default=None):
        value = super().get(key, default)
        if key in GATES:
            self.reads[key] = super().get(key)
        return value


# the functions each setting is held on: the z_k-width Jacobians and
# Hessians under every setting, and the window Jacobians and Hessians and
# the stacked residuals where a gate reaches them
FUNCTIONS = {"jacobians_zk": SETTINGS, "hessians_zk": SETTINGS,
             "jacobians": ("no_readcols", "no_custom_hess"),
             "hessians": ("no_readcols", "no_custom_hess"), "residuals": ("no_kernels",)}


def _call(base, fn, integ, layout, z, m):
    if fn.startswith("hessians"):
        return getattr(base, "stack_" + fn)(integ, layout, z, m)
    return getattr(base, "stack_" + fn)(integ, layout, z)


@functools.lru_cache(maxsize=None)
def _jax_reference(family):
    """The JAX package's outputs, each function under each of its settings,
    from one program. A function is traced under a setting unless a trace
    under another setting read the same values of every gate it read (its
    program is then the same)."""
    ji, jl, _, _, zm = _knot_pair(family)
    mu = np.random.default_rng(7).normal(size=(jl.N - 1, ji.residual_dim(jl)))
    environ = os.environ

    def every_setting(z, m):
        out = {}
        for fn, settings in FUNCTIONS.items():
            traced = []  # (gate values read, output)
            for setting in settings:
                env = _Recorded(setting)
                hit = [o for reads, o in traced if all(env.get(k) == v for k, v in reads.items())]
                if hit:
                    out[fn, setting] = hit[0]
                    continue
                os.environ = env
                try:
                    out[fn, setting] = _call(jbase, fn, ji, jl, z, m)
                finally:
                    os.environ = environ
                traced.append((env.reads, out[fn, setting]))
        return out

    out = jax.jit(every_setting)(jnp.asarray(zm), jnp.asarray(mu))
    return {k: np.asarray(v) for k, v in out.items()}, mu


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("family", FAMILIES)
def test_gates_match_jax(monkeypatch, family, setting):
    ref, mu = _jax_reference(family)
    _set(monkeypatch, setting)
    ji, jl, ti, tl, zm = _knot_pair(family)
    zt, mt = torch.as_tensor(zm)[None], torch.as_tensor(mu)[None]
    for fn, settings in FUNCTIONS.items():
        if setting not in settings:
            continue
        j, t = ref[fn, setting], _call(tbase, fn, ti, tl, zt, mt)
        assert t.shape[1:] == j.shape
        np.testing.assert_allclose(t[0].numpy(), j, rtol=0, atol=1e-12 * max(np.abs(j).max(), 1.0))
    assert np.abs(ref["hessians_zk", setting]).max() > 0 or family == "derivative_fixed_dt"
    cj, ct = jbase._read_cols(ji, jl), tbase._read_cols(ti, tl)
    assert (cj is None and ct is None) or np.array_equal(cj, ct)


def test_readcols_and_closed_form_are_taken(monkeypatch):
    """Under the gates the restricted AD and the closed form run: one
    tangent for each read column, and ``hessian_zk`` is called."""
    _, _, ti, tl, zm = _knot_pair("derivative_free_dt")
    zt, mu = torch.as_tensor(zm)[None], torch.ones((1, tl.N - 1, 1), dtype=torch.float64)
    calls = []

    class Spy:
        def __getattr__(self, a):
            f = getattr(ti, a)
            if a != "hessian_zk":
                return f
            return lambda *args: calls.append(a) or f(*args)

    for setting, tangents, called in (("default", tl.dim, []), ("readcols", 3, []),
                                      ("custom", tl.dim, ["hessian_zk"])):
        _set(monkeypatch, setting)
        calls.clear()
        tbase.stack_hessians_zk(Spy(), tl, zt, mu)
        assert calls == called
        assert tbase._zk_tangents(ti, tl, zt).shape == (tangents, tl.dim)
    _set(monkeypatch, "default")
    assert torch.equal(tbase._zk_tangents(ti, tl, zt), torch.eye(tl.dim, dtype=torch.float64))


def test_kernel_gates_route_around_the_kernels(monkeypatch):
    """``DTX_RES_KERNEL=0`` / ``DTX_ZK_KERNEL=0`` keep float32 calls of the
    bilinear integrator off the residual and window-Jacobian kernels'
    wrappers; unset, the wrappers run."""
    p = tbench.make_batched_bilinear_problems(2, N=6, feasible_start=True, taylor_order=6,
                                              device="cpu", dtype=torch.float32)
    integ, lay, zmat = p.integrators[0], p.trajectory.layout, p.trajectory.knot_matrix()
    seen = []
    for name in ("residual_action", "residual_l1", "window_jac_zk"):
        orig = getattr(expv_kernel, name)
        monkeypatch.setattr(expv_kernel, name,
                            lambda *a, _n=name, _o=orig: seen.append(_n) or _o(*a))
    outs = {}
    for setting in ("default", "no_kernels"):
        _set(monkeypatch, setting)
        seen.clear()
        outs[setting] = (tbase.stack_residuals(integ, lay, zmat),
                         tbase.stack_residuals_l1(integ, lay, zmat),
                         tbase.stack_jacobians_zk(integ, lay, zmat))
        assert seen == ([] if setting == "no_kernels"
                        else ["residual_action", "residual_l1", "window_jac_zk"])
    for a, b in zip(outs["default"], outs["no_kernels"]):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6 * max(float(a.abs().max()), 1.0))


def test_exact_hessian_solve_with_both_gates_matches_jax(monkeypatch):
    """Path 1's family at N=11 (two lanes), exact Hessian, both z_k gates
    on: the closed-form Hessians of the bilinear and derivative integrators
    and the read-column Jacobians of the derivative chain, against the JAX
    package's solve under the same gates (``golden/torch/zk_gates_n11.npz``,
    made by ``golden/torch/make_zk_gates.py``)."""
    _set(monkeypatch, "both")
    kw = {k: v for k, v in tbench.headline_config(batch=2)["phase1_kw"].items()
          if k != "hessian_approximation"}
    kw.update(phases=((60, None),), chunk=2, hessian_regularization="inertia")
    ref = np.load(GOLDEN)
    assert str(ref["options"]) == repr(kw)
    batch = tbench.make_batched_bilinear_problems(2, N=11, feasible_start=True, taylor_order=6,
                                                  device="cpu")
    res = solve_batch_compact(batch, **kw)
    assert np.array_equal(res.iterations.numpy(), ref["iterations"])
    assert np.array_equal(res.converged.numpy(), ref["converged"])
    assert bool(res.converged.all())
    assert np.max(np.abs(res.problem.trajectory.to_zvec().numpy() - ref["Z"])) < 1e-7
