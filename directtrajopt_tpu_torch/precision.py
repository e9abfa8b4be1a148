"""Device and precision policy of the port.

Every float32 matrix product of the solver must run at full float32. The
JAX package forces this with ``jax.default_matmul_precision("highest")``
(``directtrajopt_tpu/solvers/ipm.py``), because reduced-precision passes
spoiled the KKT factorization. On Hopper the same trap is TF32, which
cuBLAS and cuDNN may use for float32 unless told not to. ``apply()`` turns
it off; the solver calls it once, when it is imported. ``check_device``
resolves the ``device`` argument of the entry points (None: the card).
``lane_sum`` sums each lane's row so that the result does not depend on the
lane's place in the batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["apply", "check_device", "lane_sum"]


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


def lane_sum(x: torch.Tensor, dims: int = 1, nan: bool = False) -> torch.Tensor:
    """Sum over the last ``dims`` axes of every lane (``nan``: NaNs left
    out), the same for a lane wherever it lies in the batch. On the card a
    sum over a row of 128 or more contiguous elements splits the row at its
    alignment to the reduction's vector width (4 elements), so the same row
    rounds differently at another place in the batch when the row length is
    not a multiple of 4 (the lanes of a compacted chunk, a shard). There the
    rows are padded with zeros to a multiple of 4 first, so that every row
    starts on the same alignment. The CPU's order of summation does not
    depend on the place, and its sums are left as they were."""
    axes = tuple(range(-dims, 0))
    if x.is_cuda:
        x = x.flatten(-dims) if dims > 1 else x
        if x.shape[-1] % 4:
            x = F.pad(x, (0, -x.shape[-1] % 4))
        axes = -1
    return torch.nansum(x, axes) if nan else x.sum(axes)
