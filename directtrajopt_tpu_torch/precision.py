"""Device and precision policy of the port.

Every float32 matrix product of the solver must run at full float32. The
JAX package forces this with ``jax.default_matmul_precision("highest")``
(``directtrajopt_tpu/solvers/ipm.py``), because reduced-precision passes
spoiled the KKT factorization. On Hopper the same trap is TF32, which
cuBLAS and cuDNN may use for float32 unless told not to. ``apply()`` turns
it off; the solver calls it once, when it is imported. ``check_device``
resolves the ``device`` argument of the entry points (None: the card).
"""

from __future__ import annotations

import torch

__all__ = ["apply", "check_device"]


def apply() -> None:
    """Full-float32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def check_device(device) -> torch.device:
    """Normalise a device argument. ``None`` means the card: the port's entry
    points run on the GPU unless the caller asks for the CPU (``"cpu"``), and
    they never fall back to it — without a CUDA device, ``None`` raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    return torch.device(device)
