"""One training step (counterpart of `make_train_step` in
`dformer_tpu/train/loop.py`): forward in train mode with BatchNorm batch
statistics, masked cross entropy, backward, AdamW at the schedule's rate."""

from typing import Callable, Optional

import torch

from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], step: int, rgb, gt, modal_x,
               generator: torch.Generator,
               bases: Optional[torch.Tensor] = None,
               ignore_index: int = 255) -> torch.Tensor:
    """Take optimizer step number `step` (0-based) on one batch and return
    the loss (a 0-d tensor on the model's device, detached).

    The learning rate of step k is `schedule(k)`, written into the parameter
    groups before the update, so step 0 of a warm-up runs at rate 0.
    rgb [B,H,W,3] and modal_x [B,H,W,C] in fp32, gt [B,H,W] integer labels,
    all on the model's device. `generator` draws the DropPath and dropout
    masks and the NMF bases; `bases` pins the NMF bases instead."""
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)
    model.train()
    logits, _ = model.forward_with_aux(rgb, modal_x, bases=bases,
                                       generator=generator)
    loss = softmax_cross_entropy_masked_mean(logits, gt, ignore_index)
    loss.backward()
    optimizer.step()
    return loss.detach()
