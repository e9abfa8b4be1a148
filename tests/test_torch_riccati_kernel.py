"""The port's Riccati factor+solve and resolve (plain PyTorch versions of the
CUDA kernels) against the JAX package.

f64: against the XLA scans ``_factor_solve_xla`` / ``_resolve_xla`` to 1e-12
relative (both are exact algorithms in f64; only rounding differs). f32:
against the Pallas kernels in interpret mode to 5e-6 relative, the bound
``tests/test_pallas_kkt.py`` puts on the Pallas kernel itself; the ``ok``
certificate must agree exactly, including on indefinite stages.
"""

import itertools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from directtrajopt_tpu.ops import riccati_kernel as rk
from directtrajopt_tpu_torch.ops import _build
from directtrajopt_tpu_torch.ops import riccati_kernel as trk

torch.set_num_threads(1)

NAMES = ["P", "Lv", "Kg", "Mvs", "L0", "ok", "dzs", "dzv", "lam"]


def _stage_data(seed, B=4, N=7, ns=5, nv=3, R=3, convex=True):
    """Random stage stacks, the generator of tests/test_pallas_kkt.py."""
    rng = np.random.default_rng(seed)

    def sym(x):
        return 0.5 * (x + np.swapaxes(x, -1, -2))

    shift = 2.0 if convex else 0.3
    Qss = sym(rng.standard_normal((B, N, ns, ns))) * 0.1 + np.eye(ns) * shift
    Qsv = rng.standard_normal((B, N, ns, nv)) * 0.1
    Qvv = sym(rng.standard_normal((B, N, nv, nv))) * 0.1 + np.eye(nv) * shift
    A = rng.standard_normal((B, N, ns, ns)) * 0.3
    A[:, -1] = 0.0
    Bm = rng.standard_normal((B, N, ns, nv)) * 0.3
    Bm[:, -1] = 0.0
    qs = rng.standard_normal((B, R, N, ns))
    qv = rng.standard_normal((B, R, N, nv))
    b = rng.standard_normal((B, R, N, ns))
    b[:, :, -1] = 0.0
    return [Qss, Qsv, Qvv, A, Bm, qs, qv, b]


def _s0m(ns):
    s0m = np.ones(ns)
    s0m[: min(2, ns - 1)] = 0.0
    return s0m


def _rel(x, y):
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    return np.max(np.abs(x - y)) / max(np.max(np.abs(x)), 1.0)


def _jax_xla(s0m, args):
    return jax.vmap(lambda *a: rk._factor_solve_xla(s0m, *a))(*map(jnp.asarray, args))


@pytest.mark.parametrize("ns,nv,R,N", [(8, 3, 3, 51), (5, 2, 2, 9)])
def test_factor_solve_f64_matches_xla(ns, nv, R, N):
    s0m = _s0m(ns)
    args = _stage_data(0, N=N, ns=ns, nv=nv, R=R)
    ref = _jax_xla(s0m, args)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    for name, x, y in zip(NAMES, ref, out):
        if name == "ok":
            assert (np.asarray(x) == y.numpy()).all()
            continue
        assert y.shape == x.shape, name
        assert _rel(x, y.numpy()) < 1e-12, name


@pytest.mark.parametrize("ns,nv,R", [(8, 3, 3), (4, 2, 6)])
def test_factor_solve_f32_matches_pallas_interpret(ns, nv, R):
    s0m = _s0m(ns)
    args = [a.astype(np.float32) for a in _stage_data(1, B=5, ns=ns, nv=nv, R=R)]
    ref = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    for name, x, y in zip(NAMES, ref, out):
        if name == "ok":
            assert (np.asarray(x) == y.numpy()).all()
            continue
        assert y.dtype == torch.float32
        assert _rel(x, y.numpy()) < 5e-6, name


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_nonconvex_certificate_agrees(dtype):
    """Indefinite stages: ``ok`` equals the JAX verdict lane for lane."""
    s0m = np.ones(5)
    args = [a.astype(dtype) for a in _stage_data(2, B=8, convex=False)]
    ref = _jax_xla(s0m, args)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    ok_ref = np.asarray(ref[5])
    assert (ok_ref == out[5].numpy()).all()
    assert not ok_ref.all()  # the fixture really is indefinite somewhere
    if dtype == np.float32:
        pal = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
        assert (np.asarray(pal[5]) == out[5].numpy()).all()
    else:
        # identity substitution: the failing lanes' factors match too
        for name, x, y in zip(NAMES, ref, out):
            if name != "ok":
                assert _rel(x, y.numpy()) < 1e-12, name


@pytest.mark.parametrize("R", [1, 2])
def test_resolve_matches_jax(R):
    ns, nv = 8, 3
    s0m = _s0m(ns)
    args = _stage_data(3, B=3, N=11, ns=ns, nv=nv, R=R)
    fac = _jax_xla(s0m, args)
    ref = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(*fac[:5], *map(jnp.asarray, args[3:]))
    tfac = [torch.as_tensor(np.asarray(t)) for t in fac[:5]]
    out = trk.resolve(s0m, *tfac, *(torch.as_tensor(a) for a in args[3:]))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref, out):
        assert _rel(x, y.numpy()) < 1e-12, name
    # f32 against the Pallas resolve kernel in interpret mode
    fac32 = [np.asarray(t, np.float32) for t in fac[:5]]
    a32 = [a.astype(np.float32) for a in args[3:]]
    ref32 = rk._resolve_pallas(s0m, *map(jnp.asarray, fac32 + a32), interpret=True)
    out32 = trk.resolve(s0m, *(torch.as_tensor(a) for a in fac32 + a32))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref32, out32):
        assert _rel(x, y.numpy()) < 5e-6, name


def test_state_constrained_shapes_f32_match_pallas_interpret():
    """(n_s, n_v) = (2, 1): K1 with R=3 (two border columns + the main
    system) on 6 lanes, lane 4 indefinite, then K2 with R'=2 (SOC and
    restoration) against its factors; 5e-6 relative, ``ok`` equal."""
    ns, nv = 2, 1
    s0m = np.zeros(ns)  # the initial state is pinned
    args = [a.astype(np.float32) for a in _stage_data(6, B=6, N=11, ns=ns, nv=nv, R=3)]
    args[2][4, 5] = -1e6
    ref = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    ok = np.asarray(ref[5])
    assert (ok == out[5].numpy()).all() and ok.tolist() == [True] * 4 + [False, True]
    for name, x, y in zip(NAMES, ref, out):
        if name != "ok":  # the indefinite lane's substituted factors are not compared
            assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name
    fac = [np.asarray(t) for t in ref[:5]]
    rhs = [a.astype(np.float32) for a in _stage_data(7, B=6, N=11, ns=ns, nv=nv, R=2)[5:]]
    ref_r = rk._resolve_pallas(s0m, *map(jnp.asarray, fac + args[3:5] + rhs), interpret=True)
    out_r = trk.resolve(s0m, *(torch.as_tensor(a) for a in fac + args[3:5] + rhs))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref_r, out_r):
        assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name


def test_path2_shape_n51_f32_matches_pallas_interpret():
    """Path 2's K1 shape at its full depth: (n_s, n_v, R) = (2, 1, 3), N=51,
    the initial state pinned, lane 1 indefinite; 5e-6 relative on the
    certified lanes, ``ok`` equal."""
    ns, nv, R, N = 2, 1, 3, 51
    s0m = np.zeros(ns)
    args = [a.astype(np.float32) for a in _stage_data(8, B=4, N=N, ns=ns, nv=nv, R=R)]
    args[2][1, 30] = -1e6
    ref = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
    ok = np.asarray(ref[5])
    assert (ok == out[5].numpy()).all() and ok.tolist() == [True, False, True, True]
    for name, x, y in zip(NAMES, ref, out):
        if name != "ok":
            assert y.shape == np.asarray(x).shape, name
            assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name


@pytest.mark.parametrize("ns,which", [(10, "factor"), (10, "resolve"), (18, "factor"),
                                       (18, "resolve"), (6, "factor"), (6, "resolve")])
def test_scaling_family_shapes_n51_f32_match_jax(ns, which):
    """The scaling family's shapes (path 7: state_dim 8 and 16, grouped, and
    4, path 7e's (6,3,·), the size-class kernels' on the card), N=51,
    float32, the first two initial states pinned, lane 1 indefinite at
    stage 30: the plain K1 at (n_s, 3, 3) against the JAX package's factor
    and the plain K2 at (n_s, 3, 2) against its resolve on those factors;
    5e-6 relative on the certified lanes, ``ok`` equal. At n_s = 6 and 10 the
    reference is the Pallas kernel in interpret mode; at 18, whose
    interpreted trace takes 9 s (factor) and 5 s (resolve) on the CPU, the
    f32 XLA scans ``_factor_solve_xla`` / ``_resolve_xla``. There the JAX
    package's own f32 factor is up to 3.6e-6 from its f64 one, and two f32
    evaluations each within δ of f64 differ by up to 2δ: the bound is
    max(5e-6, 4δ), δ the JAX f32 version's worst deviation from f64 on the
    certified lanes (the rule of the card's rows at these shapes)."""
    nv, N = 3, 51
    s0m = _s0m(ns)
    a64 = _stage_data(11, B=4, N=N, ns=ns, nv=nv, R=3)
    a64[2][1, 30] = -1e6 * np.eye(nv)
    args = [a.astype(np.float32) for a in a64]
    interpret = ns <= 10
    if interpret and which == "factor":
        fac = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    else:
        fac = _jax_xla(s0m, args)
    tol = 5e-6
    if not interpret:
        fac64 = _jax_xla(s0m, a64)
        ok64 = np.asarray(fac64[5])
        if which == "factor":
            ref64, ref32 = fac64, fac
        else:
            rhs64 = _stage_data(12, B=4, N=N, ns=ns, nv=nv, R=2)[5:]
            ref64 = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(
                *map(jnp.asarray, [np.asarray(t) for t in fac64[:5]] + a64[3:5] + rhs64))
            ref32 = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(*map(jnp.asarray, (
                [np.asarray(t) for t in fac[:5]] + args[3:5]
                + [a.astype(np.float32) for a in rhs64])))
        delta = max(_rel(np.asarray(x)[ok64], np.asarray(y)[ok64])
                    for x, y in zip(ref64, ref32) if np.asarray(x).dtype != bool)
        tol = max(tol, 4 * delta)
    ok = np.asarray(fac[5])
    assert ok.tolist() == [True, False, True, True]
    want = "classed" if ns == 6 else "grouped"
    assert trk.design("factor_solve", ns, nv, 3) == trk.design("resolve", ns, nv, 2) == want
    if which == "factor":
        out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
        assert (ok == out[5].numpy()).all()
        for name, x, y in zip(NAMES, fac, out):
            if name != "ok":
                assert y.shape == np.asarray(x).shape, name
                assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < tol, name
        return
    fac = [np.asarray(t) for t in fac[:5]]
    rhs = [a.astype(np.float32) for a in _stage_data(12, B=4, N=N, ns=ns, nv=nv, R=2)[5:]]
    ins = fac + args[3:5] + rhs
    if interpret:
        ref = rk._resolve_pallas(s0m, *map(jnp.asarray, ins), interpret=True)
    else:
        ref = jax.vmap(lambda *a: rk._resolve_xla(s0m, *a))(*map(jnp.asarray, ins))
    out = trk.resolve(s0m, *(torch.as_tensor(a) for a in ins))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref, out):
        assert y.shape == np.asarray(x).shape, name
        assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < tol, name


def test_launches_are_counted_by_kernel_and_instantiation():
    """``count_launch`` adds one to the wrapper's key and one to the CUDA
    kernel's name; ``reset_launches`` sets both to nothing."""
    _build.reset_launches()
    _build.count_launch("factor_solve", "factor_solve_grouped<18,3,3>")
    _build.count_launch("factor_solve", "factor_solve_grouped<18,3,3>")
    _build.count_launch("resolve", "resolve_classed<8,4,8>")
    assert _build.LAUNCHES["factor_solve"] == 2 and _build.LAUNCHES["resolve"] == 1
    assert _build.INSTANCES == {"factor_solve_grouped<18,3,3>": 2, "resolve_classed<8,4,8>": 1}
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values()) and _build.INSTANCES == {}


def test_instantiated_shapes_match_the_kernel_source():
    """``GROUPED_SHAPES`` are exactly the shapes ``dto_factor_solve_grouped``
    dispatches to ``factor_solve_grouped``, ``RESOLVE_GROUPED_SHAPES``
    those ``dto_resolve_grouped`` dispatches to ``resolve_grouped`` (each
    condition naming the template arguments it launches), and
    ``RESOLVE_COLUMN_SHAPES`` the (n_s, n_v) ``dto_resolve_columns``
    dispatches to ``resolve_columns``; the one-thread-a-lane kernels the
    size-class ones replaced are gone."""
    src = (Path(trk.__file__).parent.parent / "csrc" / "riccati_kernel.cu").read_text()

    def entry(entry_name):
        body = src[src.index(f'extern "C" int {entry_name}('):]
        return body[: body.index("\n}\n")]

    for entry_name, kernel, shapes in (
        ("dto_factor_solve_grouped", "factor_solve_grouped", trk.GROUPED_SHAPES),
        ("dto_resolve_grouped", "resolve_grouped", trk.RESOLVE_GROUPED_SHAPES),
    ):
        body = entry(entry_name)
        pairs = re.findall(r"if \(ns == (\d+) && nv == (\d+) && R == (\d+)\)\s*"
                           + kernel + r"<(\d+), (\d+), (\d+)>", body)
        assert all(p[:3] == p[3:] for p in pairs)
        assert {tuple(map(int, p[:3])) for p in pairs} == set(shapes)
        assert len(re.findall(kernel + "<", body)) == len(shapes)
    body = entry("dto_resolve_columns")
    pairs = re.findall(r"if \(ns == (\d+) && nv == (\d+)\)\s*return "
                       r"launch_resolve_columns<(\d+), (\d+)>", body)
    assert all(p[:2] == p[2:] for p in pairs)
    assert {tuple(map(int, p[:2])) for p in pairs} == set(trk.RESOLVE_COLUMN_SHAPES)
    assert len(re.findall("launch_resolve_columns<", body)) == len(trk.RESOLVE_COLUMN_SHAPES)
    assert "resolve_fixed" not in src
    csrc = Path(trk.__file__).parent.parent / "csrc"
    every = "".join(f.read_text() for f in csrc.glob("*.cu*"))
    for gone in ("factor_solve_generic", "factor_solve_wide", "resolve_generic", "resolve_wide",
                 "kWideThreads", "dto_factor_solve(", "dto_resolve("):
        assert gone not in every, gone


@pytest.mark.parametrize("kind,shape,want", [
    ("factor_solve", (8, 3, 3), "grouped"),
    ("factor_solve", (4, 1, 1), "grouped"),
    ("factor_solve", (4, 1, 2), "classed"),
    ("factor_solve", (4, 1, 9), "split"),
    ("factor_solve", (18, 3, 2), "classed"),
    ("resolve", (4, 1, 2), "grouped"),
    ("resolve", (4, 1, 40), "columns"),
    ("resolve", (4, 1, 1), "columns"),
    ("resolve", (5, 2, 40), "classed"),
    ("resolve", (8, 3, 1), "classed"),
    ("resolve", (24, 24, 8), "classed"),
])
def test_design_is_chosen_by_shape(kind, shape, want):
    """The wrapper's kernel design for a float32 call on the card, a pure
    function of the kind and (n_s, n_v, R): grouped at the grouped shapes,
    the column K2 at its (n_s, n_v) for every other R, the size-class
    kernels elsewhere, K1 split beyond 8 columns."""
    assert trk.design(kind, *shape) == want
    with pytest.raises(ValueError, match="unknown"):
        trk.design("residual", *shape)


def _classed_dispatch(kind):
    """The (NSC, NVC, RC) classes that ``dto_<kind>_classed`` dispatches to
    ``launch_<kind>_classed`` in csrc/riccati_classed_<factor|resolve>.cu,
    each condition naming the template arguments it launches."""
    name = "riccati_classed_factor.cu" if kind == "factor_solve" else "riccati_classed_resolve.cu"
    src = (Path(trk.__file__).parent.parent / "csrc" / name).read_text()
    body = src[src.index(f'extern "C" int dto_{kind}_classed('):]
    body = body[: body.index("\n}\n")]
    triples = re.findall(r"if \(nsc == (\d+) && nvc == (\d+) && rc == (\d+)\)\s*return "
                         rf"launch_{kind}_classed<(\d+), (\d+), (\d+)>", body)
    assert all(t[:3] == t[3:] for t in triples)
    assert len(re.findall(f"launch_{kind}_classed<", body)) == len(triples)
    return {tuple(map(int, t[:3])) for t in triples}


@pytest.mark.parametrize("kind", ["factor_solve", "resolve"])
def test_size_class_is_the_least_instantiated_class_that_holds_the_shape(kind):
    """``size_class`` gives every (n_s, n_v, R) within the caps (R ≤ 8 for
    K1, ≤ 40 for K2 in tiles of RC) the class of least shared memory among
    the kernel source's instantiations that hold it, and refuses the
    shapes beyond; the classes are exactly the source's."""
    classes = _classed_dispatch(kind)
    assert classes == set(trk.SIZE_CLASSES)
    cost = {c: trk.classed_smem_bytes(kind, c[0], c[1], 1) for c in classes}
    r_max = 8 if kind == "factor_solve" else 40
    for ns, nv in itertools.product(range(1, 25), range(1, 25)):
        holders = [c for c in classes if ns <= c[0] and nv <= c[1]]
        least = min(holders, key=cost.get)
        assert [c for c in holders if cost[c] == cost[least]] == [least]
        for R in range(1, r_max + 1):
            assert trk.size_class(kind, ns, nv, R) == least
    for shape in ((25, 3, 3), (3, 25, 3), (0, 1, 1), (4, 1, r_max + 1)):
        with pytest.raises(ValueError):
            trk.size_class(kind, *shape)


@pytest.mark.parametrize("kind", ["factor_solve", "resolve"])
def test_classed_shared_memory_fits_a_block(kind):
    """At every shape within the caps the size-class kernel's block takes at
    most the H100's 227 KB (232,448 bytes) of shared memory."""
    r_max = 8 if kind == "factor_solve" else 40
    worst = max(trk.classed_smem_bytes(kind, ns, nv, R)
                for ns, nv, R in itertools.product(range(1, 25), range(1, 25), range(1, r_max + 1)))
    assert worst <= 232_448
    assert worst == trk.classed_smem_bytes(kind, 24, 24, 1)


def test_classed_launch_failure_raises():
    """A refused classed launch (a class's bytes that do not fit, say)
    raises; the wrapper never falls back to the plain version."""

    class Refusing:
        def __getattr__(self, name):
            return lambda *args: 1

    s0m = _s0m(6)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _stage_data(3, ns=6, nv=3)]
    lib, ptr = _build.library, _build.stream_ptr
    _build.library, _build.stream_ptr = Refusing, lambda dev: 0
    try:
        with pytest.raises(RuntimeError, match="factor_solve: CUDA launch failed"):
            trk._factor_solve_lane_major("classed", s0m, args, 4, 7, 6, 3, 3)
        with pytest.raises(RuntimeError, match="resolve: CUDA launch failed"):
            trk._resolve_lane_major("classed", s0m, args[:2] + args, 4, 7, 6, 3, 3)
    finally:
        _build.library, _build.stream_ptr = lib, ptr


@pytest.mark.parametrize("ns,nv,s0", [(8, 3, "free"), (2, 1, "pinned")])
def test_resolve_path_shapes_n51_f32_matches_pallas_interpret(ns, nv, s0):
    """K2 at both paths' shapes, (n_s, n_v, R') = (8, 3, 2) and (2, 1, 2),
    N=51: factors from the Pallas factor kernel with lane 2 indefinite, then
    two new right-hand sides (the fused SOC + restoration resolve) against
    ``_resolve_pallas`` in interpret mode; 5e-6 relative on the certified
    lanes."""
    N = 51
    s0m = _s0m(ns) if s0 == "free" else np.zeros(ns)
    args = [a.astype(np.float32) for a in _stage_data(9, B=5, N=N, ns=ns, nv=nv, R=3)]
    args[2][2, 17] = -1e6 * np.eye(nv)
    fac = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    ok = np.asarray(fac[5])
    assert ok.tolist() == [True, True, False, True, True]
    fac = [np.asarray(t) for t in fac[:5]]
    rhs = [a.astype(np.float32) for a in _stage_data(10, B=5, N=N, ns=ns, nv=nv, R=2)[5:]]
    ref = rk._resolve_pallas(s0m, *map(jnp.asarray, fac + args[3:5] + rhs), interpret=True)
    out = trk.resolve(s0m, *(torch.as_tensor(a) for a in fac + args[3:5] + rhs))
    assert (ns, nv, 2) in trk.RESOLVE_GROUPED_SHAPES
    for name, x, y in zip(["dzs", "dzv", "lam"], ref, out):
        assert y.shape == np.asarray(x).shape, name
        assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name


@pytest.mark.parametrize("which,R", [("factor", 1), ("resolve", 2), ("resolve", 40)])
def test_cartpole_shapes_n40_f32_match_pallas_interpret(which, R):
    """Path 5's shapes (the cartpole family: n_s 4, n_v 1, N = 40, the
    initial state pinned), float32, 3 lanes, lane 1 indefinite: the plain
    K1 at (4,1,1) against ``_factor_solve_pallas`` and the plain K2 at
    (4,1,2) (SOC + restoration) and (4,1,40) (the L-BFGS SMW columns)
    against ``_resolve_pallas`` on the Pallas factors, both in interpret
    mode; 5e-6 relative on the certified lanes, ``ok`` equal."""
    ns, nv, N = 4, 1, 40
    s0m = np.zeros(ns)
    args = [a.astype(np.float32) for a in _stage_data(13, B=3, N=N, ns=ns, nv=nv, R=1)]
    args[2][1, 25] = -1e6
    fac = rk._factor_solve_pallas(s0m, *map(jnp.asarray, args), interpret=True)
    ok = np.asarray(fac[5])
    assert ok.tolist() == [True, False, True]
    if which == "factor":
        assert trk.design("factor_solve", ns, nv, R) == "grouped"
        out = trk.factor_solve(s0m, *(torch.as_tensor(a) for a in args))
        assert (ok == out[5].numpy()).all()
        for name, x, y in zip(NAMES, fac, out):
            if name != "ok":
                assert y.shape == np.asarray(x).shape, name
                assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name
        return
    assert trk.design("resolve", ns, nv, R) == ("grouped" if R == 2 else "columns")
    rhs = [a.astype(np.float32) for a in _stage_data(14, B=3, N=N, ns=ns, nv=nv, R=R)[5:]]
    ins = [np.asarray(t) for t in fac[:5]] + args[3:5] + rhs
    ref = rk._resolve_pallas(s0m, *map(jnp.asarray, ins), interpret=True)
    out = trk.resolve(s0m, *(torch.as_tensor(a) for a in ins))
    for name, x, y in zip(["dzs", "dzv", "lam"], ref, out):
        assert y.shape == np.asarray(x).shape, name
        assert _rel(np.asarray(x)[ok], y.numpy()[ok]) < 5e-6, name


def test_grouped_inputs_are_passed_without_a_copy():
    """The grouped kernel reads the caller's lane-major tensors as they are:
    a fresh contiguous tensor is not copied; a strided or misaligned one
    (its copies move 16 bytes at a time) is."""
    x = torch.zeros(10, 4)
    assert trk._aligned(x) is x
    y = torch.arange(41, dtype=torch.float32)[1:]  # 4 bytes past an aligned start
    z = trk._aligned(y)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, y)
    t = torch.arange(12, dtype=torch.float32).reshape(4, 3).t()
    assert trk._aligned(t).is_contiguous() and torch.equal(trk._aligned(t), t)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrappers run the plain version and count no launch."""
    s0m = _s0m(5)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in _stage_data(4)]
    before = dict(_build.LAUNCHES)
    out = trk.factor_solve(s0m, *args)
    ref = trk.factor_solve_plain(s0m, *args)
    for x, y in zip(out, ref):
        assert torch.equal(x, y)
    assert _build.LAUNCHES == before


def test_wrapper_checks_shapes():
    s0m = _s0m(5)
    args = [torch.as_tensor(a) for a in _stage_data(5)]
    args[2] = args[2][:, :-1]  # Qvv with the wrong number of stages
    with pytest.raises(ValueError, match="Qvv"):
        trk.factor_solve(s0m, *args)
