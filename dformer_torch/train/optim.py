"""Optimizer construction (counterpart of `dformer_tpu/train/optim.py`):
AdamW or SGDM with decay / no-decay grouping, the warm-up poly schedule,
and the frozen-parameter mask.

A frozen parameter (one loaded from the pretrained encoder: the reference
freezes every successfully loaded encoder tensor) is left out of the
optimizer's groups, so it gets no update and no weight decay, as optax's
`set_to_zero` gives it in the JAX package. Its gradient is still computed,
as in JAX. The groups are always [decayed, not decayed], in
`named_parameters()` order: a checkpoint's optimizer state, which torch
indexes by position, restores into the groups of the same frozen set.
"""

from typing import Callable, Dict, Iterable, Optional

import torch
from torch import nn

from dformer_torch.ops.schedule import warmup_poly_lr


def decay_mask(model: nn.Module) -> dict:
    """{parameter name: True if it receives weight decay}. Decayed: conv and
    linear weights and packed attention in-projections (`in_proj_weight`)
    of ndim >= 2. Never: biases, LayerNorm / BatchNorm affines (1-D
    weights), the LayerScales and learned queries."""
    return {name: name.rsplit(".", 1)[-1] in ("weight", "in_proj_weight")
            and p.ndim >= 2 for name, p in model.named_parameters()}


def trainable_mask_from_matched(model: nn.Module, matched: Iterable[str],
                                prefix: str = "encoder_backbone."
                                ) -> Dict[str, bool]:
    """{parameter name: False if frozen}: a parameter under `prefix` whose
    name (relative to the model) is in `matched`, the names the pretrained
    load filled."""
    frozen = set(matched)
    return {name: not (name.startswith(prefix) and name in frozen)
            for name, _ in model.named_parameters()}


def make_schedule(cfg) -> Callable[[int], float]:
    total = cfg.nepochs * cfg.niters_per_epoch
    warmup = cfg.niters_per_epoch * cfg.warm_up_epoch

    def sched(step):
        return warmup_poly_lr(step, cfg.lr, total, warmup, cfg.lr_power)
    return sched


def make_optimizer(cfg, model: nn.Module,
                   trainable_mask: Optional[Dict[str, bool]] = None
                   ) -> torch.optim.Optimizer:
    """cfg.optimizer "AdamW" (b1 0.9, b2 0.999, eps 1e-8, decoupled decay)
    or "SGDM" (optax `add_decayed_weights` then `sgd(momentum)`: the decay
    added to the gradient, heavy-ball momentum with no dampening, no
    Nesterov), with weight decay on the `decay_mask` parameters only and the
    frozen parameters of `trainable_mask` in no group. The learning rate is
    written into the groups by the train step from the schedule."""
    kind = cfg.get("optimizer", "AdamW")
    if kind not in ("AdamW", "SGDM"):
        raise NotImplementedError(kind)
    mask = decay_mask(model)
    trainable = trainable_mask or {}
    params = [(n, p) for n, p in model.named_parameters()
              if trainable.get(n, True)]
    groups = [
        {"params": [p for n, p in params if mask[n]],
         "weight_decay": cfg.weight_decay},
        {"params": [p for n, p in params if not mask[n]],
         "weight_decay": 0.0}]
    if kind == "AdamW":
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8)
    return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                           dampening=0.0, nesterov=False)


def zero_missing_grads(optimizer: torch.optim.Optimizer):
    """Give each parameter of the optimizer's groups that the backward did
    not reach (the aux head at aux_rate 0) a zero gradient, as `jax.grad`
    gives it: `torch.optim` skips a parameter whose gradient is None, while
    optax decays it. Parameters in no group (frozen) stay untouched."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
