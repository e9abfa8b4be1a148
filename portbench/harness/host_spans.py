"""The program's own spans (``utils.profiling.record``) over a traced
call: self times, counts under a span, and the device's idle time put down
to the host span that was open during it (``spans.py`` prints them).

A recording is the list ``spans`` of ``(name, start_ns, end_ns, parent)``
in the order the spans opened, ``parent`` -1 for a root, on the clock of
``time.time_ns``, the clock of the profiler's device events. Device work
runs after the host enqueues it, so no number here gives device time to a
host span. Device idle time at t is the device waiting for whatever the
host does at t, and that is what :func:`idle_by_span` reads.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

NO_SPAN = "(no span)"


class Tree(NamedTuple):
    names: list
    start: np.ndarray  # ns
    end: np.ndarray  # ns
    parent: np.ndarray  # index, -1 for a root
    self_ns: np.ndarray  # duration less the children's
    paths: list  # "root/.../name"


def tree(rec) -> Tree | None:
    """The recording's spans as arrays; None without a recording or spans."""
    if rec is None or not rec.spans:
        return None
    names = [s[0] for s in rec.spans]
    start = np.array([s[1] for s in rec.spans], dtype=np.int64)
    end = np.array([s[2] for s in rec.spans], dtype=np.int64)
    end = np.where(end < 0, max(rec.end_ns, int(start.max())), end)  # open at the end
    parent = np.array([s[3] for s in rec.spans], dtype=np.int64)
    dur = (end - start).astype(np.float64)
    has = parent >= 0
    child = np.bincount(parent[has], weights=dur[has], minlength=len(names))
    paths: list = []
    for i, p in enumerate(parent):  # a parent opens before its children
        paths.append(names[i] if p < 0 else f"{paths[p]}/{names[i]}")
    return Tree(names, start, end, parent, dur - child, paths)


def under(t: Tree, name: str, ancestor: str) -> np.ndarray:
    """The indices of the spans ``name`` with a span ``ancestor`` open
    around them."""
    key = f"{ancestor}/"
    return np.array([i for i, (n, p) in enumerate(zip(t.names, t.paths))
                     if n == name and (p.startswith(key) or f"/{key}" in p)], dtype=np.int64)


def named(t: Tree, name: str) -> np.ndarray:
    return np.array([i for i, n in enumerate(t.names) if n == name], dtype=np.int64)


def idle_intervals(events, lo: int, hi: int):
    """The device's idle intervals inside [lo, hi) as two sorted arrays
    (starts, ends): the time between the union of the events' intervals,
    as ``trace.timeline`` sums it."""
    n = len(events)
    s = np.clip(np.fromiter((e.start_ns for e in events), np.int64, n), lo, hi)
    e = np.clip(np.fromiter((e.end_ns for e in events), np.int64, n), lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return np.array([lo], dtype=np.int64), np.array([hi], dtype=np.int64)
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    reach = np.maximum.accumulate(e)
    prev = np.concatenate([[lo], reach[:-1]])
    gap = s > prev
    a, b = list(prev[gap]), list(s[gap])
    if reach[-1] < hi:
        a.append(reach[-1])
        b.append(hi)
    return np.array(a, dtype=np.int64), np.array(b, dtype=np.int64)


def _cumulative(a: np.ndarray, b: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Idle ns in [a[0], t) for each t, of the disjoint sorted intervals."""
    cum = np.concatenate([[0], np.cumsum(b - a)])
    j = np.searchsorted(a, t, side="right") - 1
    jc = np.clip(j, 0, len(a) - 1)
    part = np.clip(t - a[jc], 0, (b - a)[jc])
    return np.where(j >= 0, cum[jc] + part, 0)


def innermost(t: Tree, lo: int, hi: int):
    """The innermost span open over time, as change points: from
    ``times[k]`` on, span ``owners[k]`` (-1: none), clipped to [lo, hi]."""
    times, owners = [lo], [-1]
    stack: list = []
    for i in range(len(t.names)):
        p = t.parent[i]
        while stack and stack[-1] != p:
            j = stack.pop()
            times.append(t.end[j])
            owners.append(stack[-1] if stack else -1)
        times.append(t.start[i])
        owners.append(i)
        stack.append(i)
    while stack:
        j = stack.pop()
        times.append(t.end[j])
        owners.append(stack[-1] if stack else -1)
    return np.clip(np.array(times, dtype=np.int64), lo, hi), np.array(owners, dtype=np.int64)


def idle_by_span(events, lo: int, hi: int, rec):
    """The device's idle seconds in [lo, hi) by the path of the innermost
    host span open during them (``NO_SPAN`` where none was), largest
    first, and the share (%) that falls under no span or directly under a
    root's self time; None without a recording."""
    t = tree(rec)
    if t is None or hi <= lo:
        return None
    a, b = idle_intervals(events, lo, hi)
    times, owners = innermost(t, lo, hi)
    edges = np.append(times, hi)
    idle = np.diff(_cumulative(a, b, edges))
    per_owner = np.bincount(owners + 1, weights=idle, minlength=len(t.names) + 1)
    by_path: dict = {}
    blind = per_owner[0]
    for i in np.nonzero(per_owner[1:])[0]:
        by_path[t.paths[i]] = by_path.get(t.paths[i], 0.0) + per_owner[i + 1]
        if t.parent[i] < 0:
            blind += per_owner[i + 1]
    if per_owner[0]:
        by_path[NO_SPAN] = per_owner[0]
    total = float(np.sum(b - a))
    ranked = sorted(((k, v * 1e-9) for k, v in by_path.items()), key=lambda kv: -kv[1])
    return ranked, (100.0 * blind / total if total > 0 else 0.0)


def self_by_path(rec):
    """Host seconds of the recording by span path (each span's self time),
    with the time under no span as ``NO_SPAN``, largest first; None
    without a recording."""
    t = tree(rec)
    if t is None:
        return None
    out: dict = {}
    for p, s in zip(t.paths, t.self_ns):
        out[p] = out.get(p, 0.0) + s
    roots = t.parent < 0
    rest = (rec.end_ns - rec.start_ns) - float(np.sum(t.end[roots] - t.start[roots]))
    if rest > 0:
        out[NO_SPAN] = rest
    return sorted(((k, v * 1e-9) for k, v in out.items()), key=lambda kv: -kv[1])


def busy_outside_roots(events, lo: int, hi: int, rec):
    """Share (%) of the device's busy time in [lo, hi) that lies outside
    every root span of the recording. Each pass ends in a blocking read, so
    a solve's device work falls inside its root span where the host and
    the device share a clock; None without a recording or device time."""
    t = tree(rec)
    if t is None or hi <= lo:
        return None
    a, b = idle_intervals(events, lo, hi)
    busy_a = np.concatenate([[lo], b])
    busy_b = np.concatenate([a, [hi]])
    keep = busy_b > busy_a
    busy_a, busy_b = busy_a[keep], busy_b[keep]
    busy = float(np.sum(busy_b - busy_a))
    if busy <= 0:
        return None
    roots = np.nonzero(t.parent < 0)[0]
    ra, rb = np.clip(t.start[roots], lo, hi), np.clip(t.end[roots], lo, hi)
    order = np.argsort(ra, kind="stable")
    ra, rb = ra[order], rb[order]
    inside = float(np.sum(_cumulative(ra, rb, busy_b) - _cumulative(ra, rb, busy_a)))
    return 100.0 * (busy - inside) / busy


COVER = ("ipm.pass", "ipm.init", "solve.structure", "solve.result")


def cover_share(rec, seconds: float):
    """Share (%) of ``seconds`` (the benchmark's stage seconds) that the
    spans ``COVER`` take; None without a recording."""
    t = tree(rec)
    if t is None or seconds <= 0:
        return None
    i = np.array([k for k, n in enumerate(t.names) if n in COVER], dtype=np.int64)
    return 100.0 * float(np.sum(t.end[i] - t.start[i])) * 1e-9 / seconds if len(i) else 0.0


def _seconds(t: Tree, idx) -> float:
    return float(np.sum(t.end[idx] - t.start[idx])) * 1e-9


def readout(call: dict, prof, setup, rec, bounds) -> dict:
    """The numbers of one traced call's spans: ``call`` as ``run.Program``
    returns it, ``prof`` its :class:`trace.Profile`, ``setup`` and ``rec``
    the recordings of set-up with the warm-up and of the call, ``bounds``
    the stages' window (ns). The per-pass numbers divide by the passes of
    ``ipm.ms_per_pass``."""
    t, passes = tree(rec), call["passes"]
    if t is None or not passes:
        return {}
    stages = sum(s["seconds"] for s in call["spans"].values())
    lo, hi = bounds

    def self_ms(name):
        return float(t.self_ns[under(t, name, "ipm.pass")].sum()) * 1e-6 / passes

    syncs = under(t, "host.sync", "ipm.pass")
    lib = tree(setup)
    out = {"ipm.ms_per_pass": 1e3 * stages / passes,
           "ipm.prepare_ms_per_pass": self_ms("ipm.prepare"),
           "ipm.kkt_ms_per_pass": self_ms("ipm.kkt"),
           "ipm.line_search_ms_per_pass": self_ms("ipm.line_search"),
           "ipm.sync_ms_per_pass": 1e3 * _seconds(t, syncs) / passes,
           "ipm.syncs_per_pass": len(syncs) / passes,
           "solve.structure_s": _seconds(t, named(t, "solve.structure")),
           "setup.library_s": None if lib is None else _seconds(lib, named(lib, "build.library")),
           "passes": passes, "ipm_pass_spans": len(named(t, "ipm.pass")),
           "cover_pct": cover_share(rec, stages)}
    if setup is not None:
        out["setup_by_span"] = self_by_path(setup)[:10]
    if prof.events:
        ranked, blind = idle_by_span(prof.events, lo, hi, rec)
        out.update({"device.idle_unspanned_share": blind, "idle_by_span": ranked[:10],
                    "busy_outside_roots_pct": busy_outside_roots(prof.events, lo, hi, rec),
                    "window_s": prof.window_s, "busy_s": prof.busy_s})
    return out
