"""The shared pieces of the benchmark's problem draws.

A cell's problems come from three places: the configuration file (the
family's fixed data), the traffic file (lanes a call, and how the initial
guesses are drawn) and ``--seed`` with the call's index. Each family draws
its own problems (``systems/<family>.py``, ``draw``) on the device, in a few
large calls, from the generator that :func:`call_generator` gives for
(seed, call), with :func:`_draw` for each block that a traffic file states:
the same seed gives the same problems, and every seed the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def call_generator(seed: int, call: int, device) -> torch.Generator:
    """A generator on ``device`` for call ``call`` of a run with ``seed``
    (any whole number; two calls or two seeds never share a stream)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), int(call) % (1 << 64)])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) >> 1)
    return g


def _draw(spec, shape, g, device):
    """One block of draws: ``{"uniform": s}`` on [−s, s], ``{"normal": s}``
    s·N(0, 1), or a constant."""
    if isinstance(spec, (int, float)):
        return torch.full(shape, float(spec), dtype=F64, device=device)
    (kind, s), = spec.items()
    if kind == "uniform":
        return s * (2 * torch.rand(shape, generator=g, dtype=F64, device=device) - 1)
    if kind == "normal":
        return s * torch.randn(shape, generator=g, dtype=F64, device=device)
    raise ValueError(f"unknown draw {kind!r}")
