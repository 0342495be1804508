"""A whole run of each cell on the CPU at a tiny size, past the look for a
card, with the cells' own limits: sound, `correct` comes out true; with
the timed path broken underneath, false, once for each fault the cell can
have (one card: no exchange between chips to leave out):

- serving: a label altered where it is produced; half of the batch left
  out;
- training: a step that returns its state unchanged; half of the batch
  left out, the mean taken over the rest;
- evaluation: an answer altered where it is produced; half of each group
  left out.
"""

import importlib

import pytest
import torch

from h100_bench import run as bench_run
from h100_bench import spec, tiny
from h100_bench.record import Run

SEED = 4_100_000_001
CELLS = {"large_serve_bs32": "dformer_large_nyu",
         "trav_label_bs32": "dformer_trav_base",
         "large_train_bs32": "dformer_large_nyu",
         "large_eval_msf_fp32": "dformer_large_nyu"}


def run_cell(workload, monkeypatch):
    cfg = tiny.config(CELLS[workload])
    tr = tiny.traffic(workload)
    with tiny.registered(monkeypatch, trav="lidar" in cfg):
        cell = importlib.import_module(
            f"h100_bench.cells.{tr['kind']}").Cell(cfg, tr, SEED, "cpu")
        cell.dtype = "float32"
        run = Run(workload, cfg, tr, spec.flops(workload))
        checks, _ = bench_run.execute(run, cell, 0.3, False, "cpu")
    assert run.items >= 1
    limits = spec.traffic(workload)["limits"]
    assert limits, f"{workload} has no limits"
    return bench_run.verdict(checks, limits)[0], checks


@pytest.mark.parametrize("workload", list(CELLS))
def test_sound_run_is_correct(workload, monkeypatch):
    correct, checks = run_cell(workload, monkeypatch)
    assert correct, checks


def _altered_infer(monkeypatch):
    from dformer_torch import entry

    def infer(model, rgb, modal):
        with torch.inference_mode():
            logits = model(rgb, modal)
        labels = torch.argmax(logits, -1).to(torch.int32)
        labels[:, : labels.shape[1] // 4] = torch.argmin(
            logits, -1)[:, : labels.shape[1] // 4].to(torch.int32)
        return labels
    monkeypatch.setattr(entry, "infer", infer)


def _half_batch_infer(monkeypatch):
    from dformer_torch import entry

    real = entry.infer

    def infer(model, rgb, modal):
        n = rgb.shape[0] // 2
        out = torch.zeros(rgb.shape[:3], dtype=torch.int32,
                          device=rgb.device)
        out[:n] = real(model, rgb[:n], modal[:n])
        return out
    monkeypatch.setattr(entry, "infer", infer)


@pytest.mark.parametrize("workload", ["large_serve_bs32", "trav_label_bs32"])
@pytest.mark.parametrize("fault", [_altered_infer, _half_batch_infer],
                         ids=["label_altered", "half_batch"])
def test_serving_faults_are_caught(workload, fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = run_cell(workload, monkeypatch)
    assert not correct, checks


def _state_unchanged(monkeypatch):
    real = torch.optim.AdamW.step

    def step(self, closure=None):
        saved = [p.detach().clone() for g in self.param_groups
                 for p in g["params"]]
        out = real(self, closure)
        with torch.no_grad():
            for p, s in zip((p for g in self.param_groups
                             for p in g["params"]), saved):
                p.copy_(s)
        return out
    monkeypatch.setattr(torch.optim.AdamW, "step", step)


def _half_batch_steps(monkeypatch):
    from dformer_torch import entry

    real = entry.train_steps

    def train_steps(model, opt, sched, gen, batches, first_step=0,
                    ignore_index=255):
        half = [tuple(t[: t.shape[0] // 2] for t in b) for b in batches]
        return real(model, opt, sched, gen, half, first_step, ignore_index)
    monkeypatch.setattr(entry, "train_steps", train_steps)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch_steps],
                         ids=["state_unchanged", "half_batch"])
def test_training_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = run_cell("large_train_bs32", monkeypatch)
    assert not correct, checks


def _altered_hist(monkeypatch):
    from dformer_torch.eval import evaluate

    real = evaluate.confusion_matrix

    def confusion_matrix(pred, target, num_classes, ignore_index=255):
        pred = pred.clone()
        pred[0] = (pred[0] + 1) % num_classes
        return real(pred, target, num_classes, ignore_index)
    monkeypatch.setattr(evaluate, "confusion_matrix", confusion_matrix)


def _half_group(monkeypatch):
    from dformer_torch.eval.evaluate import Evaluator

    real = Evaluator.evaluate_msf

    def evaluate_msf(self, batches, scales, flip, save_hook=None):
        half = [{k: v[: v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        return real(self, half, scales, flip, save_hook)
    monkeypatch.setattr(Evaluator, "evaluate_msf", evaluate_msf)


@pytest.mark.parametrize("fault", [_altered_hist, _half_group],
                         ids=["answer_altered", "half_group"])
def test_evaluation_faults_are_caught(fault, monkeypatch):
    fault(monkeypatch)
    correct, checks = run_cell("large_eval_msf_fp32", monkeypatch)
    assert not correct, checks
