"""The check that a run loaded nothing of the JAX stack.

The port's package name begins with the JAX package's
(``directtrajopt_tpu_torch`` against ``directtrajopt_tpu``), so modules are
compared by their whole top-level name, the part before the first dot.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "directtrajopt_tpu"})


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, sorted."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".", 1)[0] in FORBIDDEN)
