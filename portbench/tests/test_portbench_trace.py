"""The arithmetic of the per-layer metrics on synthetic inputs: bytes,
least times and roofline shares; device intervals, idle share and idle
gaps; the profiler's event kinds."""

from types import SimpleNamespace

import pytest
import torch

from harness import roofline, spec, trace
from harness.roofline import TensorMeta, nbytes, tensor_meta, time_bound


def test_nbytes_counts_each_element_once():
    z = torch.zeros(2, 5, 3)
    x, xn = z[:, :-1], z[:, 1:]  # knot k and knot k+1 of one matrix: one slab
    assert nbytes([tensor_meta(z)]) == z.numel() * 4
    assert nbytes([tensor_meta(x), tensor_meta(xn)]) == z.numel() * 4
    assert nbytes([tensor_meta(x)]) == 2 * 4 * 3 * 4
    s = torch.zeros(()).expand(7, 9)  # a scalar expanded with stride 0
    assert nbytes([tensor_meta(s)]) == 4
    a, b = torch.zeros(3), torch.zeros(4, dtype=torch.float64)
    assert nbytes([tensor_meta(a), tensor_meta(b)]) == 12 + 32


def test_time_bound_takes_the_larger_bound():
    peaks = roofline.PEAKS
    t, by = time_bound(int(peaks["hbm_bytes_per_s"]), 0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = time_bound(0, int(2 * peaks["f32_ops_per_s"]))
    assert t == pytest.approx(2.0) and by == "operations"


def test_riccati_and_horner_ops_scale_with_lanes():
    assert roofline.riccati_ops(2, 5, 8, 3, 3, True) == 2 * roofline.riccati_ops(1, 5, 8, 3, 3,
                                                                                 True)
    assert roofline.riccati_ops(1, 1, 1, 1, 1, False) == 18
    assert roofline.horner_ops(1, 1, 1, 1, 1, False) == 2 + 1 + 2 + 1


def _meta(shape, storage=1):
    n = 1
    for s in shape:
        n *= s
    stride, acc = [], 1
    for s in reversed(shape):
        stride.insert(0, acc)
        acc *= s
    return TensorMeta(storage, n, 4, tuple(shape), tuple(stride), 0, True)


def _view(calls, device_s, plain=0, kernel="factor_solve_grouped<8,3,3>"):
    mod, data = spec.metric_reader("roofline.riccati")
    ev = [trace.DeviceEvent(kernel, 0, int(device_s * 1e9), True),
          trace.DeviceEvent("aten::add", 0, 10**9, True)]
    prof = trace.Profile(1.0, 1.0, ev, [], [(kernel, device_s), ("aten::add", 1.0)])
    t = SimpleNamespace(kernel_calls=calls, profile=prof, data=data,
                        counters={"PLAIN_CALLS": {"factor_solve": plain, "resolve": 0}})
    return mod, t


def test_roofline_share_of_synthetic_calls():
    L, N, ns, nv, R = 4, 5, 8, 3, 3
    args = (None, _meta((L, N, ns, ns), 1), _meta((L, N, ns, nv), 2), _meta((L, N, nv, nv), 3),
            _meta((L, N, ns, ns), 4), _meta((L, N, ns, nv), 5), _meta((L, R, N, ns), 6),
            _meta((L, R, N, nv), 7), _meta((L, R, N, ns), 8))
    outs = (_meta((L, N, ns, ns), 9),)
    call = trace.KernelCall("directtrajopt_tpu_torch.ops.riccati_kernel:factor_solve", args,
                            outs)
    least = time_bound(roofline.call_bytes(call), roofline.riccati_ops(L, N, ns, nv, R, True))[0]
    mod, t = _view([call, call], device_s=4 * least)
    assert mod.read(t) == pytest.approx(50.0)
    assert _view([call], 4 * least, plain=1)[0].read(_view([call], 4 * least, plain=1)[1]) is None
    assert mod.read(_view([], 1.0)[1]) is None
    assert mod.read(_view([call], 1.0, kernel="other")[1]) is None


def test_timeline_busy_and_idle_gaps():
    ev = [trace.DeviceEvent(n, s, e, True) for n, s, e in
          [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("a", 38, 45), ("d", 60, 70)]]
    busy, idle = trace.timeline(ev, 0, 100)
    assert busy == pytest.approx(45e-9)
    assert dict(idle) == {"before c": pytest.approx(10e-9), "before d": pytest.approx(15e-9),
                          "after the last operation": pytest.approx(30e-9)}
    busy, idle = trace.timeline(ev, 8, 35)
    assert busy == pytest.approx(17e-9) and dict(idle) == {"before c": pytest.approx(10e-9)}
    mod, _ = spec.metric_reader("device.idle_share")
    prof = trace.Profile(1e-7, 45e-9, ev, idle, [])
    assert mod.read(SimpleNamespace(profile=prof)) == pytest.approx(55.0)


def test_device_kinds_and_window():
    assert trace._device_kind("factor_solve_grouped<8, 3, 3>") == "kernel"
    assert trace._device_kind("Memcpy HtoD (Pageable -> Device)") == "copy"
    assert trace._device_kind("Memset (Device)") == "set"
    assert trace._device_kind("portbench:call") == "annotation"
    ev = [trace.DeviceEvent("a", 100, 200, True)]
    assert trace._window(ev, 50, 300) == (50, 300)
    assert trace._window(ev, 150, 300) == (100, 200)
    assert trace._window([], 1, 2) == (1, 2)


class _Event:
    """A profiler event as the reduction reads one."""

    def __init__(self, name, start, end, device=True):
        self._n, self._s, self._e, self._d = name, start, end, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._d else torch.autograd.DeviceType.CPU


def test_stage_spans_bound_the_traced_window():
    """Drawing, building and copying back before and after the stages lie
    outside the window, by the device's stage annotations or by the stages'
    wall-clock bounds where the device's clock is the wall clock; else the
    call's annotation bounds it."""
    ev = [_Event("draw_kernel", 0, 50), _Event("stage:seek", 100, 300),
          _Event("factor_solve_grouped<8, 3, 3>", 100, 200), _Event("gemm", 250, 300),
          _Event("stage:polish", 320, 400), _Event("gemm", 340, 400),
          _Event("Memcpy DtoH (Device -> Pageable)", 450, 500),
          _Event("portbench:call", 0, 500, device=False)]
    prof = trace.reduce_profile(ev, 0, 500)
    assert prof.bounded_by == "stages" and prof.window_s == pytest.approx(300e-9)
    assert prof.busy_s == pytest.approx(210e-9) and prof.n_kernels == 3
    assert dict(prof.idle_gaps) == {"before gemm": pytest.approx(90e-9)}
    bare = [e for e in ev if not e.name().startswith("stage:")]
    prof = trace.reduce_profile(bare, 0, 500, stages_ns=(100, 400))
    assert prof.bounded_by == "stages (wall clock)" and prof.busy_s == pytest.approx(210e-9)
    prof = trace.reduce_profile(bare, 10, 500, stages_ns=(100, 400))  # another clock
    assert prof.bounded_by == "call" and prof.window_s == pytest.approx(500e-9)
    prof = trace.reduce_profile(bare, 0, 500)
    assert prof.bounded_by == "call" and prof.n_kernels == 4


def test_short_names():
    assert trace.short_name("void factor_solve_grouped<8, 3, 3>(int, float*)") == \
        "factor_solve_grouped<8, 3, 3>"
    assert trace.short_name("at::native::f<(anon)>(x)") == "at::native::f<(anon)>"


def test_record_calls_restores_the_functions():
    from directtrajopt_tpu_torch.ops import riccati_kernel

    orig = riccati_kernel.resolve
    with trace.record_calls(["directtrajopt_tpu_torch.ops.riccati_kernel:resolve"]) as calls:
        assert riccati_kernel.resolve is not orig
    assert riccati_kernel.resolve is orig and calls == []
