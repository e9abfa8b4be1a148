"""The program's spans over a traced call (``spans.py``): self times, the
per-pass numbers, the device's idle time put down to the host span open
during it (on a synthetic recording and device trace), a traced call on the
CPU, and on the card the host's and the device's clocks agreeing."""

from types import SimpleNamespace

import pytest
import torch

import spans
from harness import host_spans
from harness.trace import DeviceEvent
from portbench_helpers import args, small_cell

MS = 1_000_000  # ns

# solve.compact [0, 100)
#   ipm.pass [10, 60): ipm.prepare [12, 20), host.sync [20, 40)
#   ipm.pass [70, 90): host.sync [80, 90)
SPANS = [("solve.compact", 0, 100, -1), ("ipm.pass", 10, 60, 0), ("ipm.prepare", 12, 20, 1),
         ("host.sync", 20, 40, 1), ("ipm.pass", 70, 90, 0), ("host.sync", 80, 90, 4)]
BUSY = [(0, 15), (45, 72), (95, 100)]  # idle 15-45, 72-95, 100-120 of [0, 120)
NEW = ("ipm.prepare_ms_per_pass", "ipm.kkt_ms_per_pass", "ipm.line_search_ms_per_pass",
       "ipm.sync_ms_per_pass", "ipm.syncs_per_pass", "solve.structure_s")


def recording(spans=SPANS, start=0, end=120):
    return SimpleNamespace(spans=[(n, a * MS, b * MS, p) for n, a, b, p in spans],
                           start_ns=start * MS, end_ns=end * MS)


def events(busy=BUSY):
    return [DeviceEvent("k", a * MS, b * MS, True) for a, b in busy]


def test_self_times_and_paths():
    t = host_spans.tree(recording())
    assert t.paths[3] == "solve.compact/ipm.pass/host.sync"
    assert list(t.self_ns / MS) == [30, 22, 8, 20, 10, 10]
    got = dict(host_spans.self_by_path(recording()))
    assert got["(no span)"] == pytest.approx(0.020)
    assert got["solve.compact/ipm.pass"] == pytest.approx(0.032)
    assert sum(got.values()) == pytest.approx(0.120)


def test_idle_is_split_by_the_innermost_span():
    ranked, blind = host_spans.idle_by_span(events(), 0, 120 * MS, recording())
    got = {k: v / 1e-3 for k, v in ranked}
    # 15-45: prepare 15-20, the read 20-40, the pass 40-45; 72-95: the pass
    # 72-80, the read 80-90, the root 90-95; 100-120 under no span
    assert got == pytest.approx({"solve.compact/ipm.pass/host.sync": 30,
                                 "(no span)": 20, "solve.compact/ipm.pass": 13,
                                 "solve.compact/ipm.pass/ipm.prepare": 5, "solve.compact": 5})
    assert [k for k, _ in ranked][:2] == ["solve.compact/ipm.pass/host.sync", "(no span)"]
    assert blind == pytest.approx(100 * 25 / 73)
    # the idle seconds are those that trace.timeline sums
    a, b = host_spans.idle_intervals(events(), 0, 120 * MS)
    assert list(zip(a // MS, b // MS)) == [(15, 45), (72, 95), (100, 120)]


def test_busy_outside_the_roots():
    assert host_spans.busy_outside_roots(events(), 0, 120 * MS, recording()) == 0.0
    late = events(BUSY + [(105, 110)])
    assert host_spans.busy_outside_roots(late, 0, 120 * MS, recording()) == pytest.approx(
        100 * 5 / 52)
    assert host_spans.cover_share(recording(), 0.1) == pytest.approx(70.0)


def test_readout_of_a_synthetic_call():
    call = {"passes": 2, "spans": {"seek": {"seconds": 0.1, "t_ns": (0, 120 * MS)}}}
    prof = SimpleNamespace(events=events(), window_s=0.12, busy_s=0.047)
    got = host_spans.readout(call, prof, None, recording(), (0, 120 * MS))
    assert got["ipm.ms_per_pass"] == pytest.approx(50.0)
    assert got["ipm.prepare_ms_per_pass"] == pytest.approx(4.0)
    assert got["ipm.kkt_ms_per_pass"] == 0.0 and got["solve.structure_s"] == 0.0
    assert got["ipm.sync_ms_per_pass"] == pytest.approx(15.0)
    assert got["ipm.syncs_per_pass"] == 1.0 and got["ipm_pass_spans"] == 2
    assert got["device.idle_unspanned_share"] == pytest.approx(100 * 25 / 73)
    assert got["idle_by_span"][0][0] == "solve.compact/ipm.pass/host.sync"
    assert got["busy_outside_roots_pct"] == 0.0 and got["setup.library_s"] is None
    assert host_spans.readout(call, prof, None, None, (0, 120 * MS)) == {}


def test_cpu_traced_call_reads_the_spans():
    w = "bilinear_n51.rollout8192"
    got = spans.traced_spans(small_cell(w), 2**31 + 11, torch.device("cpu"))
    assert set(NEW) <= set(got) and got["device"] == "cpu"
    assert got["ipm.syncs_per_pass"] >= 1 and got["solve.structure_s"] > 0
    assert got["ipm_pass_spans"] >= got["passes"] and got["cover_pct"] > 50
    # no device on the CPU: no idle time to put down to a span
    assert "idle_by_span" not in got and "device.idle_unspanned_share" not in got
    paths = [p for p, _ in got["setup_by_span"]]
    assert "solve.compact/ipm.pass/ipm.prepare" in paths


@pytest.mark.chip
def test_the_clocks_agree_on_the_card(cuda_device):
    """On the card, the device's busy time in the traced stages' window
    lies inside the solve's root spans: every pass ends in a blocking read,
    so its device work ends inside it."""
    cell = small_cell("bilinear_n51.rollout8192", N=11, lanes=256)
    got = spans.traced_spans(cell, 2**31 + 3, cuda_device)
    assert got["busy_outside_roots_pct"] < 1.0
    assert got["device.idle_unspanned_share"] <= 10.0 and got["cover_pct"] >= 95.0
