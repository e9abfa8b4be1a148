"""A run end to end on the CPU at a small size (the plain versions of the
kernels), and the run's refusals."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

import run as bench
from portbench_helpers import args, small_cell


@pytest.mark.parametrize("workload", ["bilinear_n51.rollout8192", "scaled_n51.d4x8192"])
def test_cpu_run_result_line(workload):
    cell = small_cell(workload)
    out = bench.run(cell, args(workload), torch.device("cpu"))
    assert list(out)[-1] == "compared" and out["correct"] is True
    assert out["attempted"] % cell.traffic["lanes"] == 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["metrics"]["setup_s"]["value"] > 0
    assert set(out["compared"]) == set(cell.limits["numbers"])
    json.dumps(out)


def test_cpu_trace_run_reads_the_host_side_metrics():
    w = "bilinear_n51.rollout8192"
    cell = small_cell(w)
    out = bench.run(cell, args(w, trace=1), torch.device("cpu"))
    got = out["metrics"]
    assert got["solve.passes_per_call"]["value"] >= 2
    assert got["stage.polish_s"]["value"] > 0 and got["setup.warmup_s"]["value"] > 0
    assert got["ipm.ms_per_pass"]["unit"] == "ms/pass"
    # no device on the CPU: the device's metrics find nothing to read
    assert not {"roofline.riccati", "roofline.expv", "ipm.kernels_per_pass"} & set(got)
    assert out["device"]["busy_s"] == 0.0 and "breakdown" in out


def test_runs_are_the_same_for_the_same_seed():
    w = "scaled_n51.d8x2048"
    cell = small_cell(w, N=6, lanes=3)
    a = bench.Program(cell, 2**33 + 5, torch.device("cpu")).call(0)
    b = bench.Program(cell, 2**33 + 5, torch.device("cpu")).call(0)
    c = bench.Program(cell, 2**33 + 6, torch.device("cpu")).call(0)
    assert torch.equal(a["answer"]["Z"], b["answer"]["Z"])
    assert all(torch.equal(v, b["problem"][k]) for k, v in a["problem"].items())
    assert not torch.equal(a["problem"]["Gd"], c["problem"]["Gd"])


def test_without_a_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--workload", "bilinear_n51.rollout8192", "--seed", "1", "--seconds",
                       "1"]) == 2
    assert capsys.readouterr().out == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(bench.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "bilinear_n51.rollout8192", "--seed", "1", "--seconds", "1"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
