"""What ``correct`` is held to: the program's sound answers pass the cells'
limits, and their control (the answers held in TF32) and the faults a cell
can have fail them, on the CPU at a small size; on the card, the control at
a size the test can hold (marked ``chip``). The faults that no feasibility
number sees (a feasible answer that is not optimal, a stage skipped, lanes
left uncertified) fail the optimality numbers and the uncertified share."""

import pytest
import torch

import readings
import run as bench
from harness import judge, spec
from portbench_helpers import args, small_cell

WORKLOADS = ["bilinear_n51.rollout8192", "scaled_n51.d4x8192", "scaled_n51.d8x2048"]


def _sound_and_control(cell, device, seeds=(2**31 + 3,)):
    lines = readings.readings(cell, list(seeds), ["sound", "answer_tf32"], 1, device,
                              emit=lambda line: None)
    return ([judge.compare(x["numbers"], cell.limits)[0] for x in lines
             if x["mode"] == "sound"],
            [judge.compare(x["numbers"], cell.limits)[0] for x in lines
             if x["mode"] == "answer_tf32"])


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails_where_the_program_passes(workload):
    """At the cells' own N: the control's readings grow with the horizon
    (the state's size along it) and the lanes."""
    sound, control = _sound_and_control(small_cell(workload, N=51, lanes=8),
                                        torch.device("cpu"))
    assert all(sound) and not any(control)


@pytest.mark.chip
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_on_the_card(workload, cuda_device):
    sound, control = _sound_and_control(small_cell(workload, N=51, lanes=256), cuda_device,
                                        seeds=(2**31 + 3, 2**31 + 4, 2**31 + 5))
    assert all(sound) and not any(control)


@pytest.mark.parametrize("workload", WORKLOADS[:1])
def test_feasible_faults_fail_the_optimality_numbers(workload):
    """The solve's feasible start returned as its answer, the answer's
    controls moved and rolled out again, and the polish skipped: every
    feasibility number passes, the optimality numbers fail."""
    cell = small_cell(workload, N=51, lanes=8)
    faults = ["start_feasible", "perturbed", "skip_polish"]
    lines = readings.readings(cell, [2**31 + 3], ["sound", *faults], 1, torch.device("cpu"),
                              emit=lambda line: None)
    by_mode = {x["mode"]: judge.compare(x["numbers"], cell.limits) for x in lines}
    assert by_mode["sound"][0] is True
    for mode in faults:
        ok, compared = by_mode[mode]
        assert ok is False, mode
        assert compared["feas"]["value"] <= compared["feas"]["limit"], mode
        assert compared["opt_gap"]["value"] > compared["opt_gap"]["limit"], mode


@pytest.mark.parametrize("workload", WORKLOADS[1:2])
def test_loosened_tolerances_fail(workload):
    """The program run with its tolerances 100 times the stated ones."""
    cell = small_cell(workload, N=51, lanes=8)
    lines = readings.readings(cell, [2**31 + 3], ["loose_tol"], 1, torch.device("cpu"),
                              emit=lambda line: None)
    assert judge.compare(lines[0]["numbers"], cell.limits)[0] is False


def test_nothing_flagged_reads_infinite():
    ref = spec.reference(small_cell(WORKLOADS[0]).config)
    nums = judge.numbers(8, 0, [], ref.NUMBERS)
    assert nums["uncertified_share"] == 1.0
    assert all(nums[k] == float("inf") for k in ref.NUMBERS)


def _unchanged(ans, problem):
    return dict(ans, Z=problem.trajectory.to_zvec())


def _half_left_out(ans, problem):
    Z = ans["Z"].clone()
    half = Z.shape[0] // 2
    Z[half:] = problem.trajectory.to_zvec()[half:]
    return dict(ans, Z=Z, converged=torch.cat([ans["converged"][:half]] * 2)[:Z.shape[0]])


def _altered(ans, problem):
    Z = ans["Z"].clone()
    d = problem.trajectory.layout.dim
    Z[1, 5 * d] += 0.05  # x_5's first entry of lane 1
    return dict(ans, Z=Z)


def _none_flagged(ans, problem):
    return dict(ans, converged=torch.zeros_like(ans["converged"]))


@pytest.mark.parametrize("fault", [_unchanged, _half_left_out, _altered, _none_flagged])
@pytest.mark.parametrize("workload", WORKLOADS[:2])
def test_faults_make_the_run_incorrect(workload, fault, monkeypatch):
    """The timed path broken underneath the harness: the solve returns its
    state unchanged, leaves half the batch out, alters an answer, or
    certifies no lane."""
    real = spec.system

    def broken_system(config, *a, **kw):
        drv = real(config, *a, **kw)
        solve = drv.solve

        def solve_broken(cfg, traffic, problem, spans, max_iter=None):
            ans = solve(cfg, traffic, problem, spans, max_iter=max_iter)
            return ans if max_iter is not None else fault(ans, problem)

        drv.solve = solve_broken
        return drv

    monkeypatch.setattr(spec, "system", broken_system)
    cell = small_cell(workload, N=11, lanes=4)
    out = bench.run(cell, args(workload), torch.device("cpu"))
    assert out["correct"] is False
