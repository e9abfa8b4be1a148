"""L-BFGS, ``GeneralIntegrator`` and the cartpole family in the port, against
the JAX package.

Called live in both packages on the same seeded inputs:

* ``_lbfgs_compact`` on random S, Y with every pair count 0..m (float64,
  1e-12);
* one L-BFGS ``kkt_step`` with the SMW correction, and its ``resolve`` and
  ``resolve.many``, on the N=12 cartpole of
  ``tests/test_lbfgs.py::test_lbfgs_riccati_step_agreement`` (float64, dZ
  and λ to 1e-10);
* ``GeneralIntegrator``'s residuals, z_k Jacobians and z_k Hessians with
  Euler and RK4 (float64, 1e-12);
* the cartpole guesses of seeds 0-2 (float64, bitwise).

The Riccati kernels' plain versions: K1 on 12 right-hand sides as K1 on 8
then K2 on 4 (``split_factor_solve``, the card's route) equals one K1 call
bitwise; K2 on 40 right-hand sides equals five calls of 8 to 1e-14
relative in float64 and within the card rows' 5e-6 in float32 (not
bitwise: the CPU's batched matmul rounds a 40-row product
differently from an 8-row one; the card's K2 runs the same code for each
column (the column kernel) or tile of 8 (the generic one), so there it is
bitwise, which ``chip_smoke.py`` checks).

Whole solves against the JAX package's, stored by
``tests/golden/torch/make_lbfgs_cartpole.py``: L-BFGS at the options of
``test_lbfgs_riccati_matches_dense`` (N=30, m=10, tol 1e-5, float64) on
lanes from seeds 0-1, with zero and with least-squares initial duals
(B₀ = I): per-lane iterations equal and Z within 1e-8. And the port's
float64 exact-Hessian solve of the N=40 family against the
``cartpole_n40_seed*.npz`` goldens: RMS(u) < 1e-4 and the objective to
1e-6, the bars of ``tests/test_golden.py``.
"""

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
from directtrajopt_tpu.solvers import ipm as jipm
from directtrajopt_tpu.solvers.canonical import make_nlp as jmake_nlp
from directtrajopt_tpu.solvers.ops_riccati import RiccatiOps as JRiccatiOps
from directtrajopt_tpu.solvers.options import IPMOptions as JOptions
from directtrajopt_tpu_torch import benchmarks as tbench
from directtrajopt_tpu_torch.integrators import base as tbase
from directtrajopt_tpu_torch.ops import riccati_kernel as rk
from directtrajopt_tpu_torch.solvers import ipm as tipm
from directtrajopt_tpu_torch.solvers.canonical import make_nlp as tmake_nlp
from directtrajopt_tpu_torch.solvers.ops_riccati import RiccatiOps as TRiccatiOps

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
GOLDEN_LBFGS = os.path.join(GOLDEN, "torch", "lbfgs_cartpole_n30.npz")


def test_lbfgs_compact_matches_jax_every_count():
    m, z = 5, 11
    rng = np.random.default_rng(3)
    S = rng.normal(size=(m, z))
    Y = 1.5 * S + 0.1 * rng.normal(size=(m, z))
    counts = np.arange(m + 1)
    js, jU, jM = jax.vmap(lambda c: jipm._lbfgs_compact(jnp.asarray(S), jnp.asarray(Y), c))(
        jnp.asarray(counts, jnp.int32))
    B = len(counts)
    ts, tU, tM = tipm._lbfgs_compact(torch.as_tensor(S).expand(B, m, z),
                                     torch.as_tensor(Y).expand(B, m, z),
                                     torch.as_tensor(counts, dtype=torch.int32))
    for t, j in ((ts, js), (tU, jU), (tM, jM)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12, atol=1e-12)
    assert float(ts[0]) == 1.0 and not tU[0].any()  # no pair: σ = 1, U = 0


def _step_inputs(z_dim, n_eq, n_in, free, m=4):
    """The seeded inputs of ``test_lbfgs_riccati_step_agreement``."""
    rng = np.random.default_rng(0)
    lam = rng.normal(size=n_eq) * 0.1
    S = rng.normal(size=(m, z_dim)) * 0.01
    Y = S * 2.0 + rng.normal(size=(m, z_dim)) * 0.001
    Sig = np.full(z_dim, 0.1) * free
    D = np.full(n_in, 0.5)
    g = rng.normal(size=z_dim) * free
    rhs_c = rng.normal(size=n_eq) * 0.1
    extra_z = rng.normal(size=(3, z_dim)) * free
    extra_c = rng.normal(size=(3, n_eq)) * 0.1
    return dict(lam=lam, S=S, Y=Y, Sig=Sig, D=D, g=g, rhs_c=rhs_c, extra_z=extra_z,
                extra_c=extra_c, count=m)


def test_lbfgs_kkt_step_and_resolve_match_jax():
    jp = jbench.make_cartpole_problem(N=12, seed=1)
    jnlp = jmake_nlp(jp)
    free = np.asarray(jnlp.free_mask)
    a = _step_inputs(jnlp.z_dim, jnlp.n_eq, jnlp.n_in, free)
    Zj = jnlp.apply_pins(jnp.asarray(jp.trajectory.to_zvec()))
    jopt = JOptions()

    @jax.jit
    def jstep():
        ctx = JRiccatiOps(jnlp).prepare(Zj, jnp.asarray(a["lam"]), jnp.zeros((jnlp.n_in,)),
                                        skip_hessian=True)
        ctx.set_lbfgs(*jipm._lbfgs_compact(jnp.asarray(a["S"]), jnp.asarray(a["Y"]),
                                           jnp.asarray(a["count"], jnp.int32)))
        dZ, lp, ok, _, resolve = ctx.kkt_step(jnp.asarray(a["Sig"]), jnp.asarray(a["D"]),
                                              jnp.asarray(a["g"]), jnp.asarray(a["rhs_c"]),
                                              jnp.zeros(()), jopt)
        r1 = resolve(jnp.asarray(a["extra_z"][0]), jnp.asarray(a["extra_c"][0]))
        r3 = resolve.many(jnp.asarray(a["extra_z"]), jnp.asarray(a["extra_c"]))
        return dZ, lp, ok, r1, r3

    dZ_j, lam_j, ok_j, r1_j, r3_j = jstep()

    tp = tbench.make_cartpole_problem(N=12, seed=1, device="cpu")
    tnlp = tmake_nlp(tp)
    assert tnlp.z_dim == jnlp.z_dim and tnlp.n_eq == jnlp.n_eq

    def t(x):
        return torch.as_tensor(np.asarray(x))[None]

    Zt = tnlp.apply_pins(tp.trajectory.to_zvec())
    np.testing.assert_array_equal(Zt[0].numpy(), np.asarray(Zj))
    ctx = TRiccatiOps(tnlp).prepare(Zt, t(a["lam"]), torch.zeros((1, tnlp.n_in),
                                                                 dtype=torch.float64),
                                    skip_hessian=True)
    assert not ctx.QW.any()  # no AD Hessian in L-BFGS mode
    ctx.set_lbfgs(*tipm._lbfgs_compact(t(a["S"]), t(a["Y"]),
                                       torch.tensor([a["count"]], dtype=torch.int32)))
    dZ_t, lam_t, ok_t, _, resolve = ctx.kkt_step(t(a["Sig"]), t(a["D"]), t(a["g"]),
                                                 t(a["rhs_c"]), torch.zeros(1, dtype=torch.float64),
                                                 tdx.IPMOptions())
    assert bool(ok_j) and bool(ok_t[0])
    np.testing.assert_allclose(dZ_t[0].numpy(), np.asarray(dZ_j), rtol=0, atol=1e-10)
    np.testing.assert_allclose(lam_t[0].numpy(), np.asarray(lam_j), rtol=0, atol=1e-10)
    dz1, l1 = resolve(t(a["extra_z"][0]), t(a["extra_c"][0]))
    np.testing.assert_allclose(dz1[0].numpy(), np.asarray(r1_j[0]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l1[0].numpy(), np.asarray(r1_j[1]), rtol=0, atol=1e-10)
    dz3, l3 = resolve.many(t(a["extra_z"]), t(a["extra_c"]))
    np.testing.assert_allclose(dz3[0].numpy(), np.asarray(r3_j[0]), rtol=0, atol=1e-10)
    np.testing.assert_allclose(l3[0].numpy(), np.asarray(r3_j[1]), rtol=0, atol=1e-10)


@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_general_integrator_matches_jax(scheme):
    jf = jbench.cartpole_dynamics()
    ji = dtx.GeneralIntegrator.create(jf, "x", "u", scheme=scheme)
    ti = tdx.GeneralIntegrator.create(tbench.cartpole_dynamics(), "x", "u", scheme=scheme)
    jp = jbench.make_cartpole_problem(N=9, seed=2)
    layout_j = jp.trajectory.layout
    tp = tbench.make_cartpole_problem(N=9, seed=2, device="cpu")
    layout_t = tp.trajectory.layout
    assert ji.read_cols(layout_j) == ti.read_cols(layout_t) == [0, 1, 2, 3, 4]
    rng = np.random.default_rng(5)
    zmat = np.asarray(jp.trajectory.to_zvec()).reshape(9, -1) + 0.3 * rng.normal(size=(9, 5))
    mu = rng.normal(size=(8, 4))
    zj, zt = jnp.asarray(zmat), torch.as_tensor(zmat)[None]
    pairs = (
        (jbase.stack_residuals(ji, layout_j, zj),
         tbase.stack_residuals(ti, layout_t, zt)),
        (jbase.stack_jacobians_zk(ji, layout_j, zj),
         tbase.stack_jacobians_zk(ti, layout_t, zt)),
        (jbase.stack_hessians_zk(ji, layout_j, zj, jnp.asarray(mu)),
         tbase.stack_hessians_zk(ti, layout_t, zt, torch.as_tensor(mu)[None])),
    )
    for j, t in pairs:
        assert t.shape[1:] == j.shape
        np.testing.assert_allclose(t[0].numpy(), np.asarray(j), rtol=0, atol=1e-12)


def test_cartpole_guesses_bitwise():
    tp = tbench.make_batched_cartpole_problems(3, N=40, seed0=0, device="cpu")
    for s in range(3):
        jz = np.asarray(jbench.make_cartpole_problem(N=40, seed=s).trajectory.to_zvec())
        np.testing.assert_array_equal(tp.trajectory.to_zvec()[s].numpy(), jz)
        np.testing.assert_array_equal(
            np.load(os.path.join(GOLDEN, f"cartpole_n40_seed{s}.npz"))["Z0"], jz)
    one = tbench.make_cartpole_problem(N=40, seed=1, device="cpu").trajectory.to_zvec()
    assert torch.equal(one[0], tp.trajectory.to_zvec()[1])


def _stage_inputs(R, dtype, seed=0, L=5, N=9, ns=4, nv=1):
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    A = rng.standard_normal((L, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((L, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    b = rng.standard_normal((L, R, N, ns))
    b[:, :, -1] = 0.0
    arrs = (sym(rng.standard_normal((L, N, ns, ns))) * 0.1 + np.eye(ns) * 2.0,
            rng.standard_normal((L, N, ns, nv)) * 0.1,
            sym(rng.standard_normal((L, N, nv, nv))) * 0.1 + np.eye(nv) * 2.0,
            A, Bm, rng.standard_normal((L, R, N, ns)), rng.standard_normal((L, R, N, nv)), b)
    return np.arange(ns) >= 2, [torch.as_tensor(x, dtype=dtype) for x in arrs]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_k1_split_and_k2_tiles_plain(dtype):
    s0, st = _stage_inputs(12, dtype)
    one = rk.factor_solve_plain(s0, *st)
    split = rk.split_factor_solve(rk.factor_solve_plain, rk.resolve_plain, s0, *st)
    assert len(split) == len(one)
    for x, y in zip(one, split):
        assert torch.equal(x, y)
    _, st40 = _stage_inputs(40, dtype, seed=1)
    args = (s0, *one[:5], st[3], st[4])
    whole = rk.resolve_plain(*args, *st40[5:])
    tiles = [rk.resolve_plain(*args, *(x[:, i:i + 8] for x in st40[5:])) for i in range(0, 40, 8)]
    # float64: 1e-14; float32: the 5e-6 bound of the card's K1/K2 rows,
    # relative to max(max |ref|, 1) per output
    bound = 1e-14 if dtype == torch.float64 else 5e-6
    for j, w in enumerate(whole):
        cat = torch.cat([t[j] for t in tiles], 1)
        assert (w - cat).abs().max() <= bound * max(float(w.abs().max()), 1.0)
    # K2's bound is the Pallas resolve's 40, K1's 8 (beyond it, the split)
    assert rk.RESOLVE_MAX_SIZES["R"] == 40 and rk.MAX_SIZES["R"] == 8


@pytest.fixture(scope="module")
def lbfgs_golden():
    return np.load(GOLDEN_LBFGS)


@pytest.mark.parametrize("dual_init", ["zero", "least_squares"])
def test_lbfgs_solve_matches_jax(lbfgs_golden, dual_init):
    g = lbfgs_golden
    sfx = "" if dual_init == "zero" else "_ls"
    seeds = [int(s) for s in g["seeds"]][:2]  # the golden's first two lanes
    tp = tbench.make_batched_cartpole_problems(len(seeds), N=int(g["N"]), seed0=seeds[0],
                                               device="cpu")
    assert seeds == [0, 1]
    kw = dict(tol=1e-5, max_iter=300, hessian_approximation="lbfgs",
              limited_memory_max_history=10, dual_init=dual_init)
    assert repr({k: v for k, v in kw.items() if k != "dual_init"}) == str(g["options"])
    r = tdx.solve_batch(tp, **kw)
    assert r.converged.all() and g["converged" + sfx][:2].all()
    np.testing.assert_array_equal(r.iterations.numpy(), g["iterations" + sfx][:2])
    np.testing.assert_allclose(r.problem.trajectory.to_zvec().numpy(), g["Z" + sfx][:2],
                               rtol=0, atol=1e-8)
    assert r.ipm.state.lbfgs_S.shape == (len(seeds), 10, tp.trajectory.layout.z_dim)


def test_cartpole_f64_exact_matches_goldens():
    tp = tbench.make_batched_cartpole_problems(3, N=40, device="cpu")
    r = tdx.solve(tp, tol=1e-9, max_iter=300)
    assert r.converged.all()
    layout = tp.trajectory.layout
    for s in range(3):
        data = np.load(os.path.join(GOLDEN, f"cartpole_n40_seed{s}.npz"))
        Zg = data["Z_star"][: 40 * layout.dim].reshape(40, layout.dim)
        Z = r.problem.trajectory.to_zvec()[s, : 40 * layout.dim].reshape(40, layout.dim).numpy()
        for comp in ("u", "x"):
            sl = layout.comp_slice(comp)
            assert np.sqrt(np.mean((Z[:, sl] - Zg[:, sl]) ** 2)) < 1e-4
    obj_err, rms = tbench.cartpole_certificate(r)
    assert (obj_err < 1e-6).all() and (rms < 1e-4).all()
