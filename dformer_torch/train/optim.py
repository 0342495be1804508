"""Optimizer construction (counterpart of `dformer_tpu/train/optim.py`):
AdamW with decay / no-decay grouping and the warm-up poly schedule."""

from typing import Callable

import torch
from torch import nn

from dformer_torch.ops.schedule import warmup_poly_lr


def decay_mask(model: nn.Module) -> dict:
    """{parameter name: True if it receives weight decay}. Decayed: conv and
    linear weights of ndim >= 2. Never: biases, LayerNorm / BatchNorm
    affines (1-D weights) and the LayerScales."""
    return {name: name.endswith(".weight") and p.ndim >= 2
            for name, p in model.named_parameters()}


def make_schedule(cfg) -> Callable[[int], float]:
    total = cfg.nepochs * cfg.niters_per_epoch
    warmup = cfg.niters_per_epoch * cfg.warm_up_epoch

    def sched(step):
        return warmup_poly_lr(step, cfg.lr, total, warmup, cfg.lr_power)
    return sched


def make_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8) with decoupled weight decay on the
    `decay_mask` leaves only. The learning rate is written into the groups
    by the train step from the schedule."""
    if cfg.get("optimizer", "AdamW") != "AdamW":
        raise NotImplementedError(
            f"optimizer {cfg.optimizer!r} is not ported yet (ROADMAP.md "
            f"Queue 1: SGDM)")
    mask = decay_mask(model)
    params = dict(model.named_parameters())
    groups = [
        {"params": [params[n] for n in mask if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [params[n] for n in mask if not mask[n]],
         "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8)
