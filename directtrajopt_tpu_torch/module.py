"""Frozen dataclasses for problem components, and tree helpers over them.

Every component of a problem (trajectory, integrators, objectives,
constraints) is a frozen dataclass. Tensor fields carry a leading batch
dimension — one lane per scenario — and every other field (names, knot
indices, orders) is static structure shared by the whole batch.

``tree_map`` walks dataclasses, dicts, tuples, lists and NamedTuples and
applies a function to the tensor leaves, passing static leaves through. The
batch solver uses it to gather, scatter and select whole lanes of a problem
or a solver state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import torch

T = TypeVar("T")

__all__ = ["module", "tree_map", "tree_where", "tree_take"]


def module(cls: type[T]) -> type[T]:
    """Class decorator: a frozen dataclass with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def _replace(self: T, **changes: Any) -> T:
        return dataclasses.replace(self, **changes)

    cls.replace = _replace  # type: ignore[attr-defined]
    return cls


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to matching tensor leaves of ``tree`` and ``rest``.

    Non-tensor leaves (strings, ints, numpy index arrays, None) are taken
    from ``tree`` unchanged."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        changes = {
            f.name: tree_map(
                fn, getattr(tree, f.name), *(getattr(r, f.name) for r in rest)
            )
            for f in dataclasses.fields(tree)
        }
        return dataclasses.replace(tree, **changes)
    if _is_namedtuple(tree):
        return type(tree)(
            *(tree_map(fn, a, *(r[i] for r in rest)) for i, a in enumerate(tree))
        )
    if isinstance(tree, (tuple, list)):
        return type(tree)(
            tree_map(fn, a, *(r[i] for r in rest)) for i, a in enumerate(tree)
        )
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return tree


def tree_where(mask: torch.Tensor, new, old):
    """Per-lane select: ``new`` where ``mask`` (shape (B,)) holds, else ``old``.
    A leaf that ``new`` shares with ``old`` is returned as it is, with no
    device operation."""

    def sel(a, b):
        if a is b:
            return a
        m = mask.reshape(mask.shape + (1,) * (a.ndim - 1))
        return torch.where(m, a, b)

    return tree_map(sel, new, old)


def tree_take(tree, idx: torch.Tensor):
    """Gather lanes ``idx`` along the leading batch axis of every leaf."""
    return tree_map(lambda x: x.index_select(0, idx), tree)
