"""The benchmark's reference against the program on the CPU, float32, at a
tiny size: the same weights, inputs and seeded draws give the same
logits, training readings and evaluation histograms."""

import numpy as np
import pytest
import torch

from h100_bench import inputs, program, tiny
from h100_bench.cells import train_steps
from h100_bench.reference import evaluate as ref_eval
from h100_bench.reference import train as ref_train
from h100_bench.reference.model import Precision, forward
from h100_bench.weights import PROGRAM, derive, make_weights

SEED = 3_000_000_017


@pytest.mark.parametrize("name", ["dformer_large_nyu", "dformer_trav_base"])
def test_forward_matches_program(name, monkeypatch):
    cfg = tiny.config(name)
    with tiny.registered(monkeypatch, trav="lidar" in cfg):
        model, _ = program.build(cfg, "float32", "cpu", 1)
        W = make_weights(cfg, SEED, "cpu")
        program.load(model, W)
        x = inputs.pool(cfg, 2, SEED, "cpu")
        with torch.no_grad():
            got = model(x["rgb"], x["modal"])
            want = forward(W, cfg, x["rgb"], x["modal"], Precision("fp32"))
    assert got.shape == want.shape
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_fp8_control_departs():
    cfg = tiny.config("dformer_large_nyu")
    W = make_weights(cfg, SEED, "cpu")
    x = inputs.pool(cfg, 2, SEED, "cpu")
    with torch.no_grad():
        want = forward(W, cfg, x["rgb"], x["modal"], Precision("fp32"))
        low = forward(W, cfg, x["rgb"], x["modal"], Precision("fp8"))
    rel = ((low - want).abs().max() / want.abs().max()).item()
    assert 1e-3 < rel < 0.5


def test_train_readings_match_program(monkeypatch):
    from dformer_torch import entry

    cfg = tiny.config("dformer_large_nyu")
    tr = tiny.traffic("large_train_bs32")
    with tiny.registered(monkeypatch):
        cell = train_steps.Cell(cfg, tr, SEED, "cpu")
        cell.dtype = "float32"
        cell.setup()
        got = cell.readings
        want = cell.reference()
    assert entry.TRAIN_RECIPE["lr"] == cfg["train"]["lr"]
    gaps = ref_train.gaps(got, want)
    assert gaps["loss_gap"] < 1e-5, gaps
    assert gaps["grad_gap"] < 1e-3, gaps
    assert gaps["update_gap"] < 1e-2, gaps
    assert len(want.losses) == tr["checked_steps"]


def test_recompute_is_exact():
    cfg = tiny.config("dformer_large_nyu")
    W = make_weights(cfg, SEED, "cpu")
    x = inputs.pool(cfg, 2, SEED, "cpu", labels=True, ignore_share=0.05)
    batches = [(x["rgb"], x["modal"], x["gt"])]
    seed = derive(SEED, PROGRAM)
    a = ref_train.steps(cfg, W, batches, seed, Precision(), recompute=True)
    b = ref_train.steps(cfg, W, batches, seed, Precision(), recompute=False)
    assert a.losses == b.losses
    for n in a.grads:
        assert abs(a.grads[n] - b.grads[n]) <= 1e-6 * max(b.grads[n], 1e-12)


def test_msf_hist_matches_evaluator(monkeypatch):
    from dformer_torch.eval.evaluate import Evaluator

    cfg = tiny.config("dformer_large_nyu")
    tr = tiny.traffic("large_eval_msf_fp32")
    with tiny.registered(monkeypatch):
        model, _ = program.build(cfg, "float32", "cpu", 1)
        W = make_weights(cfg, SEED, "cpu")
        program.load(model, W)
        ev = Evaluator(model, program.program_config(cfg), device="cpu")
        x = inputs.pool(cfg, 2, SEED, "cpu", labels=True, ignore_share=0.05)
        got = ev.evaluate_msf([{"rgb": x["rgb"], "modal_x": x["modal"],
                                "gt": x["gt"]}], tr["scales"],
                              flip=tr["flip"]).hist
    want = ref_eval.msf_hist(W, cfg, x["rgb"], x["modal"], x["gt"],
                             tr["scales"], tr["flip"], Precision("fp32"))
    assert np.abs(got - want).sum() // 2 <= 2
    assert want.sum() == (x["gt"] != cfg["background"]).sum().item()
