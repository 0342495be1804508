"""On the card, at each cell's own size: the program's compared numbers
stay under the cell's limits and the control's (the reference computed in
the nearest precision below the configuration's, in the program's place)
do not, on one seed each; and a serving, training and evaluation fault
planted in the timed path turns `correct` false. Skipped without a card.

    python3 -m pytest -p no:cacheprovider -q h100_bench/test_h100_card.py
"""

import importlib

import pytest
import torch

from h100_bench import calibrate, spec
from h100_bench import run as bench_run
from h100_bench import test_h100_faults as faults
from h100_bench.record import Run

BENCH = spec.benchmark()
SEED = 4_200_000_001


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    yield "cuda"
    torch.cuda.empty_cache()


def fails(numbers: dict, limits: dict) -> bool:
    return any(numbers[k] > v for k, v in limits.items() if k in numbers)


@pytest.mark.cuda
@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_control_fails_and_program_passes(w, card):
    limits = spec.traffic(w["traffic"])["limits"]
    out = calibrate.calibrate_seed(w, SEED, 3.0, control=True, device=card)
    assert not fails(out["program"], limits), out
    assert fails(out["control"], limits), out


def full_size_run(workload, device):
    w = spec.workload(BENCH, workload)
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    cell = importlib.import_module(f"h100_bench.cells.{tr['kind']}").Cell(
        cfg, tr, SEED, device)
    run = Run(workload, cfg, tr, spec.flops(workload))
    checks, _ = bench_run.execute(run, cell, 3.0, False, device)
    return bench_run.verdict(checks, tr["limits"])[0], checks


@pytest.mark.cuda
@pytest.mark.parametrize("workload,fault", [
    ("large_serve_bs32", faults._altered_infer),
    ("trav_label_bs32", faults._half_batch_infer),
    ("large_train_bs32", faults._state_unchanged),
    ("large_train_bs32", faults._half_batch_steps),
    ("large_eval_msf_fp32", faults._half_group),
], ids=["serve-label_altered", "trav-half_batch", "train-state_unchanged",
        "train-half_batch", "eval-half_group"])
def test_fault_turns_correct_false(workload, fault, card, monkeypatch):
    fault(monkeypatch)
    correct, checks = full_size_run(workload, card)
    assert not correct, checks
