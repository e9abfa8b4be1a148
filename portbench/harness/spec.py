"""Find a cell's files by the names ``BENCHMARK.json`` gives.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in files of its own under ``portbench/``, so a cell or a metric
is added by adding files:

- ``configs/<config>.json``: the configuration (its sizes, options and
  source); its ``family`` names ``systems/<family>.py`` (the system under
  test) and its ``reference`` names ``configs/<reference>.py`` (the plain
  reference beside it);
- ``traffic/<traffic>.json``: the traffic mix, read by the family's draw;
- ``limits/<workload>.json``: each number that decides ``correct``, its
  limit and the readings the limit was set from;
- ``metrics/<metric>.py``: a per-layer metric's reader (``read(trace)``,
  returning a number or None), with ``metrics/<metric>.json`` beside it
  where the reader takes data (kernel-name patterns, the functions whose
  calls it counts).

The harness names no problem's data. A family (``systems/<family>.py``)
gives:

- ``setup(device)``: what the program builds or loads once;
- ``draw(cfg, traffic, seed, call, device)``: one call's problems, drawn on
  the device from ``harness/traffic.py``'s ``call_generator(seed, call)``:
  a dict that ``build`` takes, whose ``problem`` holds the lane-first
  tensors that define each lane's problem, for the reference to read;
- ``build(cfg, drawn, device)``: the program's batch of problems;
- ``solve(cfg, traffic, problem, spans, max_iter=None)``: every stage of
  the configuration; returns the answer, a dict of lane-first tensors with
  the flag ``converged`` (``max_iter`` caps every phase, for the warm-up);
- ``counters()``: the program's launch counters, copied;
- ``guess(cfg, drawn)``: the drawn initial guess as an answer's ``Z``.

Its reference (``configs/<reference>.py``, plain PyTorch that imports
nothing of the program) gives:

- ``layout(cfg, traffic)``: what ``certificate`` needs of the answers'
  shape;
- ``certificate(cfg, layout, answer, problem)``: the per-lane numbers
  (float64, (lanes,) each) of a block of flagged lanes, from every key of
  their answer and of their drawn problem, each a dict;
- ``NUMBERS``: the names of those numbers, which ``limits/`` may compare;
- ``BLOCK`` (optional): the lanes it reads at once, where 1024
  (``run.REFERENCE_BLOCK``) would not fit the card;
- for ``readings.py``'s faults: ``feasible(cfg, layout, Z, problem)``, the
  feasible point nearest Z's controls; ``objective(cfg, layout, Z)``;
  ``controls(cfg, layout)``, the columns of Z that hold the controls and
  their bound.

A new family is those two files, a configuration, a traffic mix and a
cell's limits; no file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent.parent  # portbench/
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


class Cell(NamedTuple):
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    run_seconds: int


def _checked(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark(root: Path) -> dict:
    return read_json(root / "BENCHMARK.json")


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(bench: dict, workload: str, here: Path = HERE) -> Cell:
    """The files of workload ``workload``."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = by_name[workload]
    config = read_json(here / "configs" / f"{_checked(w['config'])}.json")
    traffic = read_json(here / "traffic" / f"{_checked(w['traffic'])}.json")
    limits = read_json(here / "limits" / f"{_checked(workload)}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload)]
    layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(w, config, traffic, limits, e2e, layer, int(bench["run_seconds"]))


def system(config: dict, here: Path = HERE):
    fam = _checked(config["family"])
    return load_module(here / "systems" / f"{fam}.py", f"portbench_system_{fam}")


def reference(config: dict, here: Path = HERE):
    ref = _checked(config["reference"])
    return load_module(here / "configs" / f"{ref}.py", f"portbench_reference_{ref}")


def metric_reader(name: str, here: Path = HERE):
    """The reader of per-layer metric ``name`` and its data (``{}``
    without a data file)."""
    _checked(name)
    mod = load_module(here / "metrics" / f"{name}.py",
                      "portbench_metric_" + re.sub(r"\W", "_", name))
    data_path = here / "metrics" / f"{name}.json"
    return mod, (read_json(data_path) if data_path.exists() else {})
