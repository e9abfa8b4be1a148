"""The port imports no JAX: no module of ``directtrajopt_tpu_torch`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``directtrajopt_tpu``
(the port's own name excepted), at any level of the file. Read from each
file's syntax tree: this environment imports JAX at interpreter start-up,
so ``sys.modules`` cannot tell."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "directtrajopt_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]


def _jax_imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return [n for n in names if n.split(".")[0] in ("jax", "jaxlib", "directtrajopt_tpu")]


@pytest.mark.parametrize("name", FILES)
def test_port_file_imports_no_jax(name):
    assert _jax_imports(ROOT / name) == []


def test_the_check_sees_jax_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nimport jax.numpy as jnp\ndef g():\n"
                 "    from directtrajopt_tpu.ops import expm\n"
                 "    from directtrajopt_tpu_torch import module\n    from . import x\n")
    assert _jax_imports(f) == ["jax.numpy", "directtrajopt_tpu.ops"]
    assert len(FILES) > 40 and "directtrajopt_tpu_torch/parallel/mesh.py" in FILES
