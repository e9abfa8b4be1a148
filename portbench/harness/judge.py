"""The comparison that decides ``correct``.

A run's answers are read lane by lane by the configuration's plain
reference (``certificate``, whose per-lane numbers its ``NUMBERS`` names;
each is taken as the worst over the lanes the program flagged converged),
beside the share of its lanes that the program did not certify. Where no
lane was flagged, every certificate number reads infinite. The numbers that
``limits/<workload>.json`` lists are compared, each with its limit; the run
is correct when each of them is finite and within its limit.
"""

from __future__ import annotations

import math

import torch


def numbers(lanes: int, flagged: int, certs: list, names) -> dict:
    """The run's numbers from its lane counts and the per-lane certificates
    (dicts of (n,) tensors, keyed by ``names``) of its flagged lanes."""
    out = {"uncertified_share": (lanes - flagged) / lanes if lanes else math.inf}
    for key in names:
        vals = [c[key] for c in certs if c[key].numel()]
        out[key] = float(torch.cat(vals).max()) if vals else math.inf
    return out


def compare(values: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) for every number with a limit."""
    compared, ok = {}, True
    for name, entry in limits["numbers"].items():
        v = values.get(name, math.inf)
        compared[name] = {"value": v, "limit": entry["limit"]}
        ok &= math.isfinite(v) and v <= entry["limit"]
    return ok, compared
