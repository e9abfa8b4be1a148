"""The benchmark's files are found by the names BENCHMARK.json gives, and a
cell or a metric is added by adding files."""

import json
import re
import shutil

import pytest

import run as bench
from harness import spec

BENCH = spec.benchmark(bench.ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.cell(BENCH, workload)
    assert cell.config["family"] and cell.traffic["lanes"] >= cell.traffic["chunk"] >= 1
    drv, ref = spec.system(cell.config), spec.reference(cell.config)
    for fn in ("setup", "draw", "build", "solve", "counters", "guess"):
        assert callable(getattr(drv, fn))
    for fn in ("layout", "certificate", "feasible", "objective", "controls"):
        assert callable(getattr(ref, fn))
    assert ref.NUMBERS and int(getattr(ref, "BLOCK", bench.REFERENCE_BLOCK)) >= 1
    assert cell.limits["numbers"], "a cell is judged by at least one number"
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_every_metric_has_a_reader(metric):
    mod, data = spec.metric_reader(metric)
    assert callable(mod.read)
    if "wrap" in data:
        assert data["patterns"] and data["plain_keys"]


def test_benchmark_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert configs == used
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/") and (bench.ROOT / c["file"]).exists()
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200


def test_a_cell_is_added_by_adding_files(tmp_path):
    """A copy of the harness finds a new cell from new files alone."""
    here = tmp_path / "portbench"
    shutil.copytree(bench.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    traffic = json.loads((here / "traffic" / "d8x2048.json").read_text())
    (here / "traffic" / "d6x1024.json").write_text(
        json.dumps(dict(traffic, lanes=1024, chunk=1024, state_dim=6)))
    limits = (here / "limits" / "scaled_n51.d8x2048.json").read_text()
    (here / "limits" / "scaled_n51.d6x1024.json").write_text(limits)
    new = dict(BENCH, workloads=BENCH["workloads"] + [
        {"name": "scaled_n51.d6x1024", "config": "scaled_n51", "traffic": "d6x1024",
         "chips": 1, "why": "a new cell"}])
    cell = spec.cell(new, "scaled_n51.d6x1024", here=here)
    assert cell.traffic["state_dim"] == 6 and cell.config["family"] == "bilinear_chain"
    assert {m["name"] for m in cell.per_layer} <= {m["name"] for m in BENCH["per_layer"]}


def test_a_metric_is_added_by_adding_files(tmp_path):
    here = tmp_path / "portbench"
    shutil.copytree(bench.HERE, here, ignore=shutil.ignore_patterns("__pycache__"))
    (here / "metrics" / "ipm.passes_twice.py").write_text(
        "def read(t):\n    return 2.0 * t.call['passes']\n")
    mod, data = spec.metric_reader("ipm.passes_twice", here=here)
    assert data == {} and mod.read(type("T", (), {"call": {"passes": 3}})()) == 6.0


def test_names_are_checked():
    with pytest.raises(ValueError):
        spec.metric_reader("../run")
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no_such.cell")
