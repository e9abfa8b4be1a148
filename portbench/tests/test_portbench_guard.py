"""Nothing a run loads belongs to the JAX stack, compared by whole
top-level module name."""

import json
import subprocess
import sys
import textwrap

from harness import guard

import run as bench


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_modules(["directtrajopt_tpu_torch", "directtrajopt_tpu_torch.ops",
                                    "jaxtyping", "flaxen", "numpy"]) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "directtrajopt_tpu",
           "directtrajopt_tpu.solvers.ipm"]
    assert guard.forbidden_modules(bad + ["torch"]) == sorted(bad)


def test_a_cpu_run_loads_no_module_of_the_jax_stack():
    """Drive a run of each family in a fresh interpreter; its modules
    afterwards hold the port and nothing of the JAX stack."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{str(bench.HERE)!r}, {str(bench.HERE / "tests")!r}]
        import torch
        import run as bench
        from harness import guard
        from portbench_helpers import args, small_cell
        for w in ("bilinear_n51.rollout8192", "scaled_n51.d8x2048"):
            out = bench.run(small_cell(w, N=6, lanes=2), args(w), torch.device("cpu"))
        print(json.dumps(dict(bad=guard.forbidden_modules(),
                              port="directtrajopt_tpu_torch" in sys.modules)))
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    assert seen == {"bad": [], "port": True}
