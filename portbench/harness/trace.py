"""What a traced run reads: the profiler's events of one call, reduced in
memory to device intervals, and the shapes of the calls into the kernel
layer.

Only a summary leaves the process: no trace file is written. The traced
window is the call's solve: from the start of its first stage to the end of
its last (the spans that ``systems/`` opens around each
``solve_batch_compact``, as the device's annotations where the profiler
keeps them, else by the wall clock where the device's clock is the wall
clock), so that drawing and building the problems and copying the answers
back lie outside it. The
device's busy time is the union of the intervals in which a kernel, a copy
or a set ran inside it; an idle gap is time between two of them, named by
the device operation that ends it (the one the host was preparing).
"""

from __future__ import annotations

import importlib
import re
import time
from contextlib import contextmanager
from functools import lru_cache
from typing import NamedTuple

from .roofline import tensor_meta


ANNOTATION = re.compile(r"^(portbench|stage):")  # the benchmark's own spans


class DeviceEvent(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    kernel: bool


class Profile(NamedTuple):
    window_s: float  # the traced window: the call's stages on the device
    busy_s: float  # union of device intervals inside it
    events: list  # DeviceEvent inside it
    idle_gaps: list  # [(what ends the gap, seconds)], by total time
    device_ops: list  # [(kernel, seconds)], every kernel by total time
    bounded_by: str = "stages"  # "stages", "stages (wall clock)" or "call"

    @property
    def n_kernels(self) -> int:
        return sum(e.kernel for e in self.events)

    def device_time(self, patterns) -> float:
        """Seconds of the kernels whose name contains one of ``patterns``."""
        return sum(sec for name, sec in self.device_ops if any(p in name for p in patterns))


@lru_cache(maxsize=None)
def short_name(name: str) -> str:
    """A kernel's name without its return type, anonymous namespaces and
    argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += (ch == "<") - (ch == ">")
        out.append(ch)
    return "".join(out)[:160]


def timeline(events, lo: int, hi: int):
    """One pass over the device's events (ns) inside the window [lo, hi):
    the seconds in which one of them ran (their union), and the idle gaps'
    seconds by the operation that ends each gap (the one the host was
    preparing while the device waited), largest first."""
    busy, t, idle = 0, lo, {}
    for ev in sorted(events, key=lambda e: e.start_ns):
        s, e = max(ev.start_ns, lo), min(ev.end_ns, hi)
        if e <= s:
            continue
        if s > t:
            idle[f"before {ev.name}"] = idle.get(f"before {ev.name}", 0) + (s - t)
        busy += max(0, e - max(s, t))
        t = max(t, e)
    if t < hi:
        idle["after the last operation"] = hi - t
    return busy * 1e-9, sorted(((k, v * 1e-9) for k, v in idle.items()), key=lambda kv: -kv[1])


@lru_cache(maxsize=None)
def _device_kind(name: str) -> str:
    """What a device event of this name is: the benchmark's own annotation,
    a copy, a set or a kernel."""
    if ANNOTATION.match(name):
        return "annotation"
    low = name.lower()
    return "copy" if low.startswith("memcpy") else "set" if low.startswith("memset") else "kernel"


def reduce_profile(events, t0_ns: int, t1_ns: int, stages_ns=None) -> Profile:
    """Reduce the profiler's events of one call, which ran from ``t0_ns``
    to ``t1_ns`` on the wall clock, to its stages' window (module
    docstring): the device's stage annotations, else ``stages_ns`` (the
    stages' first start and last end on the wall clock) where the device's
    events lie inside the call's wall-clock span, else the call's host
    annotation or the call itself."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    out, stages, mark = [], [], None
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            kind = _device_kind(name)
            if kind != "annotation":
                out.append(DeviceEvent(short_name(name), e.start_ns(), e.end_ns(),
                                       kind == "kernel"))
            elif name.startswith("stage:"):
                stages.append((e.start_ns(), e.end_ns()))
        elif name == "portbench:call":
            mark = (e.start_ns(), e.end_ns())
    bounded_by = "stages"
    if stages:
        lo, hi = min(a for a, _ in stages), max(b for _, b in stages)
    elif stages_ns and out and _window(out, t0_ns, t1_ns) == (t0_ns, t1_ns):
        (lo, hi), bounded_by = stages_ns, "stages (wall clock)"
    else:
        (lo, hi), bounded_by = mark or _window(out, t0_ns, t1_ns), "call"
    out = [ev for ev in out if ev.end_ns > lo and ev.start_ns < hi]
    busy, idle = timeline(out, lo, hi)
    by_name: dict = {}
    for ev in out:
        if ev.kernel:
            by_name[ev.name] = by_name.get(ev.name, 0) + (ev.end_ns - ev.start_ns)
    ops = sorted(((k, v * 1e-9) for k, v in by_name.items()), key=lambda kv: -kv[1])
    return Profile((hi - lo) * 1e-9, busy, out, idle, ops, bounded_by)


def _window(events, t0: int, t1: int):
    """The call's span where the profiler kept no annotation of it: the
    wall clock where the device's events lie inside it, else their span."""
    if not events:
        return t0, t1
    first, last = min(ev.start_ns for ev in events), max(ev.end_ns for ev in events)
    return (t0, t1) if first >= t0 and last <= t1 else (first, last)


def profile_call(fn, stages_ns=None):
    """Run ``fn()`` under ``torch.profiler``, recording the device's
    activity (the host's operations only where there is no device:
    recording them costs a long call minutes); returns (fn's result,
    :class:`Profile`). ``stages_ns(result)`` gives the stages' wall-clock
    bounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        sync()
        t0 = time.time_ns()
        with torch.profiler.record_function("portbench:call"):
            out = fn()
        sync()
        t1 = time.time_ns()
    return out, reduce_profile(prof.profiler.kineto_results.events(), t0, t1,
                               stages_ns(out) if stages_ns else None)


class KernelCall(NamedTuple):
    fn: str  # "module:function"
    args: tuple  # TensorMeta for a tensor, the value otherwise
    outs: tuple  # TensorMeta of the tensors returned


def _meta(x):
    import torch

    if torch.is_tensor(x):
        return tensor_meta(x)
    if isinstance(x, (tuple, list)):
        return tuple(_meta(v) for v in x)
    return x


def _flat_tensors(x):
    import torch

    if torch.is_tensor(x):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat_tensors(v)]
    return []


@contextmanager
def record_calls(targets):
    """Record every outermost call of the functions ``targets``
    ("package.module:function") with the shapes of its arguments and
    results, reading no device value; the functions are restored after."""
    calls, depth, saved = [], [0], []
    for target in sorted(set(targets)):
        mod_name, fn_name = target.split(":")
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def wrapper(*args, _orig=orig, _target=target, **kwargs):
            depth[0] += 1
            try:
                out = _orig(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                calls.append(KernelCall(_target, _meta(args),
                                        tuple(tensor_meta(t) for t in _flat_tensors(out))))
            return out

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, wrapper)
    try:
        yield calls
    finally:
        for mod, fn_name, orig in saved:
            setattr(mod, fn_name, orig)
