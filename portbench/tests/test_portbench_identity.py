"""The harness asks each family for its problems and each reference for what
it reads; the existing cells read exactly what they read before that
interface (the tree at commit 8c9babf, where ``harness/traffic.py`` drew every
family's problems with ``draw_call`` and ``run.py`` handed the reference
``Z, zL, zU, objective, Gd, Gv`` by position). On the CPU, bitwise:

- each cell's drawn problems at a small size (``small_cell``), two seeds and
  three calls (the warm-up's, the first, a later one): every tensor's
  shape, type and SHA-256 (its first 24 hex digits);
- the reference's five numbers of one fixed answer a cell: the first call's
  guess in float32, bound multipliers drawn from ``torch.Generator`` seed
  17, the objective at the guess plus 1e-9;
- one ``readings.py`` line a mode (the numbers, lanes, flagged lanes and
  passes): the bilinear cell in every mode but ``switch_tf32``, the
  state_dim-8 cell in the modes that read its drawn problem.

``PARENT`` was printed at 8c9babf by :func:`record` with
``traffic.draw_call(cfg, traffic, seed, call, device)`` in place of
``drv.draw`` (its ``Gd``, ``Gv`` at the top level in place of
``problem``) and ``ref.certificate(cfg, ref.layout(cfg,
traffic.state_dim(cfg, tr)), Z, zL, zU, obj, Gd, Gv)``; the same numbers
with 1 and 8 threads. ``python portbench/tests/test_portbench_identity.py``
prints the record of this tree.
"""

import hashlib
import json

import pytest
import torch

import readings
from harness import spec
from portbench_helpers import small_cell

CPU = torch.device("cpu")
WORKLOADS = ["bilinear_n51.rollout8192", "scaled_n51.d4x8192", "scaled_n51.d8x2048"]
SEEDS = [2**31 + 11, 7]
CALLS = (-1, 0, 3)
MODES = {"bilinear_n51.rollout8192": ["sound", "answer_tf32", "start_feasible", "perturbed",
                                      "half_flags", "skip_polish", "loose_tol"],
         "scaled_n51.d8x2048": ["sound", "start_feasible", "perturbed", "half_flags"]}


def digest(t):
    t = t.detach().contiguous()
    return [list(t.shape), str(t.dtype).replace("torch.", ""),
            hashlib.sha256(t.numpy().tobytes()).hexdigest()[:24]]


def draws(workload, seed):
    cell = small_cell(workload)
    drv = spec.system(cell.config)
    out = {}
    for call in CALLS:
        drawn = drv.draw(cell.config, cell.traffic, seed, call, CPU)
        out[f"{workload}|{seed}|{call}"] = {k: digest(v) for part in ("data", "problem")
                                           for k, v in drawn[part].items()}
    return out


def certificate(workload):
    cell = small_cell(workload)
    cfg, drv, ref = cell.config, spec.system(cell.config), spec.reference(cell.config)
    drawn = drv.draw(cfg, cell.traffic, SEEDS[0], 0, CPU)
    Z = drv.guess(cfg, drawn)
    lay = ref.layout(cfg, cell.traffic)
    g = torch.Generator().manual_seed(17)
    zL = 1e-3 * torch.rand(Z.shape, generator=g, dtype=torch.float64)
    zU = 1e-3 * torch.rand(Z.shape, generator=g, dtype=torch.float64)
    obj = ref.objective(cfg, lay, Z) + 1e-9
    c = ref.certificate(cfg, lay, dict(Z=Z.float(), zL=zL.float(), zU=zU.float(),
                                       objective=obj.float()), drawn["problem"])
    return {k: [float(v).hex() for v in t.reshape(-1).tolist()] for k, t in c.items()}


def reading_lines(workload):
    lines = readings.readings(small_cell(workload), [2**31 + 3], MODES[workload], 1, CPU,
                              emit=lambda line: None)
    return {f"{workload}|{x['mode']}": dict(
        numbers={k: float(v).hex() for k, v in x["numbers"].items()},
        lanes=x["lanes"], flagged=x["flagged"], passes=x["passes"]) for x in lines}


def record() -> dict:
    out = {"draws": {}, "certificate": {}, "readings": {}}
    for w in WORKLOADS:
        for seed in SEEDS:
            out["draws"].update(draws(w, seed))
        out["certificate"][w] = certificate(w)
    for w in MODES:
        out["readings"].update(reading_lines(w))
    return out


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_draws_are_bitwise_the_same(workload, seed):
    got = draws(workload, seed)
    assert got == {k: PARENT["draws"][k] for k in got}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_certificate_numbers_are_bitwise_the_same(workload):
    assert certificate(workload) == PARENT["certificate"][workload]


@pytest.mark.parametrize("workload", list(MODES))
def test_readings_lines_are_bitwise_the_same(workload):
    got = reading_lines(workload)
    assert set(got) == {f"{workload}|{m}" for m in MODES[workload]}
    assert got == {k: PARENT["readings"][k] for k in got}


PARENT = {
    "certificate": {
        "bilinear_n51.rollout8192": {
            "comp": [
                "0x1.8dc1f980bd7a0p-12", "0x1.6e57e31c4db50p-12", "0x1.8435218156478p-12",
                "0x1.803f64b4c8d68p-12",
            ],
            "feas": [
                "0x1.03dbce7bf6eb6p+1", "0x1.2c8422956a57ap+1", "0x1.85f16319b5498p+1",
                "0x1.85dc4e17d732ap+1",
            ],
            "obj_gap": [
                "0x1.4135d5e000000p-28", "0x1.b4153a0000000p-30", "0x1.6baa30b000000p-27",
                "0x1.aedb9e0000000p-28",
            ],
            "opt_gap": [
                "0x1.398124beca2a2p-4", "0x1.1fe99792fab18p-4", "0x1.46efdb6baa30bp-3",
                "0x1.d6cc27aedb9e0p-4",
            ],
            "stat": [
                "0x1.56b677ff26656p-3", "0x1.24474c3caa6a2p-2", "0x1.33b2b9b41023cp-3",
                "0x1.6b70c985d43e2p-2",
            ],
        },
        "scaled_n51.d4x8192": {
            "comp": [
                "0x1.03a62d77a4330p-10", "0x1.174d0ba0b8338p-10", "0x1.14b551d7d2274p-10",
                "0x1.163488b7a082cp-10",
            ],
            "feas": [
                "0x1.f209ee9a920f2p+1", "0x1.1d19b31c37299p+2", "0x1.06a7b7fdc2a3ep+2",
                "0x1.65ed961e6d87cp+1",
            ],
            "obj_gap": [
                "0x1.16cbdb5400000p-30", "0x1.1c8cdd4d00000p-30", "0x1.0d03593400000p-30",
                "0x1.0513b37f00000p-30",
            ],
            "opt_gap": [
                "0x1.0a9d3a93424acp-10", "0x1.453bfc37322b3p-10", "0x1.69d6252fca6ccp-10",
                "0x1.35fab3aec4c81p-10",
            ],
            "stat": [
                "0x1.7d2cfa963d7e4p-9", "0x1.e47dc1a1b0b00p-9", "0x1.6df05d379608bp-9",
                "0x1.c2a937db62e7dp-9",
            ],
        },
        "scaled_n51.d8x2048": {
            "comp": [
                "0x1.01f7d54936520p-10", "0x1.f932605bb55a0p-11", "0x1.094d17563eae6p-10",
                "0x1.fe0698e8c0cdep-11",
            ],
            "feas": [
                "0x1.d39b8d4d854fap+1", "0x1.ce45b4447192dp+1", "0x1.c3636cad15083p+1",
                "0x1.cca445ae06705p+1",
            ],
            "obj_gap": [
                "0x1.0ebd1c8800000p-30", "0x1.0461e82780000p-30", "0x1.1438985400000p-30",
                "0x1.f522da4000000p-31",
            ],
            "opt_gap": [
                "0x1.6eae9e285c6f0p-11", "0x1.c6725f73c2fb1p-11", "0x1.25371f78ecf58p-11",
                "0x1.6f79ae56e92e0p-10",
            ],
            "stat": [
                "0x1.fd37688f608c2p-12", "0x1.9fd8f254fd4eap-10", "0x1.17783ce918806p-10",
                "0x1.8ca8d807ea74ap-12",
            ],
        },
    },
    "draws": {
        "bilinear_n51.rollout8192|2147483659|-1": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "886bc1dcc8a66a2320d0892e"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "030ba48bb8f527d33f9d4701"],
            "u": [[4, 11, 2], "float64", "28f70ce5d2facc03dc11a364"],
            "x": [[4, 11, 4], "float64", "f26c200a809bcfbfebf5b4a9"],
        },
        "bilinear_n51.rollout8192|2147483659|0": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "3027cd3f7f443d2310905de7"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "337dbce12d6ffd718fcea368"],
            "u": [[4, 11, 2], "float64", "bb26f6a5e19a0e0fb4cf01c3"],
            "x": [[4, 11, 4], "float64", "d85a92c71b3eb295a8b130cb"],
        },
        "bilinear_n51.rollout8192|2147483659|3": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "63cbdb5194f70d01bfe498ba"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "c31c6ea7607eb8dfc083b152"],
            "u": [[4, 11, 2], "float64", "79ee70c08732ba75e3b8347c"],
            "x": [[4, 11, 4], "float64", "ed30fa45a89d582b1c66b53e"],
        },
        "bilinear_n51.rollout8192|7|-1": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "f0488c133f4620b33376ad77"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "204fb84adbf678a9921ee280"],
            "u": [[4, 11, 2], "float64", "bc036478922f9649539cca8b"],
            "x": [[4, 11, 4], "float64", "8928913bae6132674bcef6a3"],
        },
        "bilinear_n51.rollout8192|7|0": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "9eeaf10e35faa0ac914346bb"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "560500502d74c4547dd55c85"],
            "u": [[4, 11, 2], "float64", "11ffcb3166aaea9c74e327d1"],
            "x": [[4, 11, 4], "float64", "c03e08eda473823d05764013"],
        },
        "bilinear_n51.rollout8192|7|3": {
            "Gd": [[4, 4, 4], "float64", "1c72b9af8f7e0a8834f442d9"],
            "Gv": [[4, 2, 4, 4], "float64", "821269897cc9bbfd697e76ef"],
            "ddu": [[4, 11, 2], "float64", "1f5ba1ca6bb6d737efdcd556"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "0960404f7499aa94dd47ca75"],
            "u": [[4, 11, 2], "float64", "a3d44a9b5c998e4deeea20f4"],
            "x": [[4, 11, 4], "float64", "bee454255233b95c6821c4ce"],
        },
        "scaled_n51.d4x8192|2147483659|-1": {
            "Gd": [[4, 4, 4], "float64", "761e18018c1f3e855c986dc9"],
            "Gv": [[4, 2, 4, 4], "float64", "b3ad74d0c74ed64dd2ce246f"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "9ddbf194d83e04362989d257"],
            "u": [[4, 11, 2], "float64", "f850944d86edebe382823eb3"],
            "x": [[4, 11, 4], "float64", "589f7752a437dd325ee4c2d4"],
        },
        "scaled_n51.d4x8192|2147483659|0": {
            "Gd": [[4, 4, 4], "float64", "ce5077001bafa7a2272a1d05"],
            "Gv": [[4, 2, 4, 4], "float64", "d91e8e3a967a942b1ef55f1c"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "61b4c85e8c04aa38c6f740c3"],
            "u": [[4, 11, 2], "float64", "f0870cc3b7f5e2ca6a3d2832"],
            "x": [[4, 11, 4], "float64", "12d518b3c26eac86ed69fcda"],
        },
        "scaled_n51.d4x8192|2147483659|3": {
            "Gd": [[4, 4, 4], "float64", "e7271f1c093bdcc8ae69854a"],
            "Gv": [[4, 2, 4, 4], "float64", "6de6158dece944eb4963e248"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "ebfd6fb6595572b83367bdfd"],
            "u": [[4, 11, 2], "float64", "d87fdc1a20823675bc25e557"],
            "x": [[4, 11, 4], "float64", "f374f23f3459499ccb278e26"],
        },
        "scaled_n51.d4x8192|7|-1": {
            "Gd": [[4, 4, 4], "float64", "557f162b718914f07f5c1a86"],
            "Gv": [[4, 2, 4, 4], "float64", "93e4ac928e785cb2af9647ed"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "ef90b723fb86df8364d05ede"],
            "u": [[4, 11, 2], "float64", "f8f52e8b7d1dcd351dac5b89"],
            "x": [[4, 11, 4], "float64", "2d9c1bae6b1baf49365dfa9c"],
        },
        "scaled_n51.d4x8192|7|0": {
            "Gd": [[4, 4, 4], "float64", "40ebc8aae33632441f07c5be"],
            "Gv": [[4, 2, 4, 4], "float64", "71c82ac94b27cf364270dc01"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "5a10aa4af44c8cdc5c8c0692"],
            "u": [[4, 11, 2], "float64", "34769d793fed5740c72cda6b"],
            "x": [[4, 11, 4], "float64", "252a42254d02d089fd34c968"],
        },
        "scaled_n51.d4x8192|7|3": {
            "Gd": [[4, 4, 4], "float64", "512ddda058a0ba4eb72993d5"],
            "Gv": [[4, 2, 4, 4], "float64", "8f128282c88a10451f479d42"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "e4e3355f934895ce7944cda8"],
            "u": [[4, 11, 2], "float64", "bc5344cd168e4cc201c8762d"],
            "x": [[4, 11, 4], "float64", "041d805a0cdcea5edd245100"],
        },
        "scaled_n51.d8x2048|2147483659|-1": {
            "Gd": [[4, 8, 8], "float64", "c48ae695eb9f77e335cf450e"],
            "Gv": [[4, 2, 8, 8], "float64", "8bb7f79ec1e3d24797914996"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "ffc723f06fdcc939465ba8e5"],
            "u": [[4, 11, 2], "float64", "d6eb4776974242688a4509e6"],
            "x": [[4, 11, 8], "float64", "781ba68a88f174c52f4015e6"],
        },
        "scaled_n51.d8x2048|2147483659|0": {
            "Gd": [[4, 8, 8], "float64", "15714359982ef73c864a0061"],
            "Gv": [[4, 2, 8, 8], "float64", "50bc8af4e4d779449ee61640"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "ee396d5d2cfcee301d7bbd9b"],
            "u": [[4, 11, 2], "float64", "276731086131c251c8498f26"],
            "x": [[4, 11, 8], "float64", "c70551c3ed1592318329a39a"],
        },
        "scaled_n51.d8x2048|2147483659|3": {
            "Gd": [[4, 8, 8], "float64", "32dfe39fd77349716c6d68c1"],
            "Gv": [[4, 2, 8, 8], "float64", "a3050a68da7be033df8b1135"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "c3e749af76580f9e51c139c3"],
            "u": [[4, 11, 2], "float64", "8d612bffba3d94a92d66e40c"],
            "x": [[4, 11, 8], "float64", "e51f6ae1a414da329d3c1b4b"],
        },
        "scaled_n51.d8x2048|7|-1": {
            "Gd": [[4, 8, 8], "float64", "c3487c2dd4500f0da36cc242"],
            "Gv": [[4, 2, 8, 8], "float64", "acc3ce49a5e11247eb21c168"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "7ad65ec84b698a3ce8b84195"],
            "u": [[4, 11, 2], "float64", "86fa8562adc94dde93b585db"],
            "x": [[4, 11, 8], "float64", "005223828b9bf57f85ef18f5"],
        },
        "scaled_n51.d8x2048|7|0": {
            "Gd": [[4, 8, 8], "float64", "5a557d87ef7b1517ec717d1a"],
            "Gv": [[4, 2, 8, 8], "float64", "284bd6e57507046b57987ac9"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "4f00e421fd73dcba5e2baab0"],
            "u": [[4, 11, 2], "float64", "feef48e2dc76d4482d289c33"],
            "x": [[4, 11, 8], "float64", "ca7d58a7ce5a583b2557a2f8"],
        },
        "scaled_n51.d8x2048|7|3": {
            "Gd": [[4, 8, 8], "float64", "42ca4757debde08bb4080da6"],
            "Gv": [[4, 2, 8, 8], "float64", "27eda970d16733d3c7248d37"],
            "dt": [[4, 11, 1], "float64", "86824a0b91a673d1bc07a30d"],
            "du": [[4, 11, 2], "float64", "96ad53c07be0d9cf4eb40321"],
            "u": [[4, 11, 2], "float64", "b23c65fbba968dfee88659a0"],
            "x": [[4, 11, 8], "float64", "678d823bcae7db987db7d6c1"],
        },
    },
    "readings": {
        "bilinear_n51.rollout8192|answer_tf32": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.17bbd47ae147bp-25",
                "feas": "0x1.d985aa907a800p-12",
                "obj_gap": "0x1.1886f4f7e8000p-65",
                "opt_gap": "0x1.336e7790b0818p-53",
                "stat": "0x1.192b4af25f1d8p-31",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [30],
        },
        "bilinear_n51.rollout8192|half_flags": {
            "flagged": 2,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.17ddc0382b8dcp-25",
                "feas": "0x1.520aac7800000p-24",
                "obj_gap": "0x1.3bc8737000000p-77",
                "opt_gap": "0x1.336ee13bc8737p-53",
                "stat": "0x1.18d01efc4013ep-31",
                "uncertified_share": "0x1.0000000000000p-1",
            },
            "passes": [30],
        },
        "bilinear_n51.rollout8192|loose_tol": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.0c8bec9b45000p-20",
                "feas": "0x1.bf63dfa000000p-25",
                "obj_gap": "0x1.16b5e38000000p-85",
                "opt_gap": "0x1.81e0dce94a1c8p-61",
                "stat": "0x1.e3cf6ade0ae21p-38",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [20],
        },
        "bilinear_n51.rollout8192|perturbed": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.1d2abc6abfe19p-25",
                "feas": "0x1.0000000000000p-57",
                "obj_gap": "0x0.0p+0",
                "opt_gap": "0x1.670958c717b29p-13",
                "stat": "0x1.36264d73dc60fp-11",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [30],
        },
        "bilinear_n51.rollout8192|skip_polish": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.87d4ead36a46cp-23",
                "feas": "0x1.4173e8f800000p-24",
                "obj_gap": "0x1.caddb70000000p-67",
                "opt_gap": "0x1.44d7c11a91248p-42",
                "stat": "0x1.1a78905a35172p-26",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [29],
        },
        "bilinear_n51.rollout8192|sound": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.17ddc0382b8dcp-25",
                "feas": "0x1.520aac7800000p-24",
                "obj_gap": "0x1.3bc8737000000p-77",
                "opt_gap": "0x1.336ee13bc8737p-53",
                "stat": "0x1.18d01efc4013ep-31",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [30],
        },
        "bilinear_n51.rollout8192|start_feasible": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x0.0p+0",
                "feas": "0x1.0000000000000p-52",
                "obj_gap": "0x0.0p+0",
                "opt_gap": "0x1.20e6a76497c6dp-4",
                "stat": "0x1.117a3450865e2p-2",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [30],
        },
        "scaled_n51.d8x2048|half_flags": {
            "flagged": 2,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.183af3811cbc4p-20",
                "feas": "0x1.3f9091b608000p-12",
                "obj_gap": "0x1.8012f30000000p-58",
                "opt_gap": "0x1.4443e6c009798p-33",
                "stat": "0x1.733edb1b15680p-24",
                "uncertified_share": "0x1.0000000000000p-1",
            },
            "passes": [44],
        },
        "scaled_n51.d8x2048|perturbed": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.256f0c935150cp-20",
                "feas": "0x1.0000000000000p-57",
                "obj_gap": "0x0.0p+0",
                "opt_gap": "0x1.dce7d9df724e1p-13",
                "stat": "0x1.9fdb6b29cf0f1p-13",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [44],
        },
        "scaled_n51.d8x2048|sound": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x1.183af3811cbc4p-20",
                "feas": "0x1.854478aa98000p-12",
                "obj_gap": "0x1.8012f30000000p-58",
                "opt_gap": "0x1.4443e6c009798p-33",
                "stat": "0x1.733edb1b15680p-24",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [44],
        },
        "scaled_n51.d8x2048|start_feasible": {
            "flagged": 4,
            "lanes": 4,
            "numbers": {
                "comp": "0x0.0p+0",
                "feas": "0x1.0000000000000p-55",
                "obj_gap": "0x0.0p+0",
                "opt_gap": "0x1.7babe30bbf4e7p-10",
                "stat": "0x1.db5c665f5f496p-10",
                "uncertified_share": "0x0.0p+0",
            },
            "passes": [44],
        },
    },
}


if __name__ == "__main__":
    print(json.dumps(record(), indent=1, sort_keys=True))
