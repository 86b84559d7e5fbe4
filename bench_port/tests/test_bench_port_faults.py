"""A whole run of a cell, on the CPU at a small size, with the look for a
card left out: a sound program comes out correct, and each fault planted
under the timed path comes out not correct, on the number that should
see it."""

import pytest
import torch

from bench_port import control, run

SMALL = {
    "molecules": {"unique": 48, "atoms": [8, 16],
                  "attach_weight": [1.0, 1.0, 0.3, 0.1],
                  "ring_bond_prob": 0.12, "ring_size": 6, "node_dim": 28,
                  "edge_dim": 7, "coord_std": 2.0},
    "entries": {"actives": 30, "inactives": 290},
    "batch_size": 16,
}
FAULTS = {
    "state_unchanged": (control.state_unchanged, "change_gap"),
    "half_batch": (control.half_batch, "grad_gap"),
    "altered_answers": (control.altered_answers, "valid_gap"),
    "bond_slots_rolled": (control.bond_slots_rolled, "valid_gap"),
}
# Each cell with the faults its model can have.
CASES = [(w, f) for w in ("schnet-train-b1024", "kgnn-train-b1024")
         for f in sorted(FAULTS)
         if not (w.startswith("schnet") and f == "bond_slots_rolled")]


def _run(workload, tamper=None):
    return run.run_cell(workload, 2 ** 31 + 5, 0.0, False, device="cpu",
                        traffic_over=SMALL, tamper=tamper)["result"]


def test_sound_run_is_correct():
    result = _run("schnet-train-b1024")
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"train_graphs_per_s.schnet",
                                     "setup_s"}


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_not_correct(workload, fault):
    tamper, number = FAULTS[fault]
    result = _run(workload, tamper)
    assert not result["correct"]
    check = result["checks"][number]
    assert check["value"] > check["limit"], result["checks"]


def test_bond_slots_fault_needs_bond_supports():
    class NoBonds:
        model = torch.nn.Linear(2, 2)

    with pytest.raises(ValueError):
        control.bond_slots_rolled(NoBonds())
