"""Training (counterpart of `dformer_tpu/train/loop.py`): one step (forward
in train mode with BatchNorm batch statistics, masked cross entropy plus
`aux_rate` times the aux head's, backward, the optimizer at the schedule's
rate) and the epoch loop
`Trainer`, which augments each uint8 batch on the device and steps.

Every random draw is seeded from the run's seed and a counter, never from
a stream that runs on: the augmentation of iteration `it` of epoch `e` from
(seed, e * 100003 + it), the DropPath, dropout and NMF draws of step k from
(seed, k). A run resumed from a checkpoint (which holds k) therefore takes
the same steps as one that ran straight through.

Data-parallel (one process per card under `torchrun`, `parallel/dist.py`):
each rank steps on its rows of the global batch, with the draws of the
global batch, and the gradients are summed over the ranks after the
backward, so every rank takes the step a single process takes on the
global batch.
"""

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from dformer_torch.data.augment import device_train_augment
from dformer_torch.data.loader import val_x_stats
from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean
from dformer_torch.parallel import dist
from dformer_torch.train.audit import coverage_audit, param_paths
from dformer_torch.train.optim import zero_missing_grads

# the two seed streams of `derived_seed`
AUGMENT_STREAM, STEP_STREAM = 0, 1


def derived_seed(seed: int, stream: int, counter: int) -> int:
    """A 64-bit generator seed for (run seed, stream, counter)."""
    state = np.random.SeedSequence([seed, stream, counter]).generate_state(
        1, np.uint64)
    return int(state[0])


def coverage_flags(model, optimizer: torch.optim.Optimizer):
    """(gradient != 0, update != 0) per parameter in `named_parameters()`
    order, as numpy bools, after a step (one host transfer).

    The update is read from the optimizer's state, not from the parameter's
    change: at a warm-up rate of 6e-11 most updates round away in fp32. A
    parameter in no group (frozen) or a step at rate 0 has no update;
    otherwise SGD's momentum buffer (the decay already in it) or AdamW's
    first moment, plus AdamW's decoupled decay, decide."""
    group_of = {p: g for g in optimizer.param_groups for p in g["params"]}
    no = torch.zeros((), dtype=torch.bool,
                     device=next(model.parameters()).device)
    grads, updates = [], []
    for _, p in model.named_parameters():
        grads.append(no if p.grad is None else (p.grad != 0).any())
        group, state = group_of.get(p), optimizer.state.get(p, {})
        direction = state.get("momentum_buffer", state.get("exp_avg"))
        if group is None or group["lr"] == 0 or direction is None:
            updates.append(no)
            continue
        moved = (direction != 0).any()
        if "exp_avg" in state and group["weight_decay"]:
            moved = moved | (p != 0).any()
        updates.append(moved)
    flags = torch.stack([torch.stack(grads), torch.stack(updates)]).cpu()
    return flags[0].numpy(), flags[1].numpy()


def train_step(model, optimizer: torch.optim.Optimizer,
               schedule: Callable[[int], float], step: int, rgb, gt, modal_x,
               generator: torch.Generator,
               bases: Optional[torch.Tensor] = None,
               ignore_index: int = 255, with_coverage_flags: bool = False,
               aux_rate: float = 0.0):
    """Take optimizer step number `step` (0-based) on one batch and return
    the loss (a 0-d tensor on the model's device, detached), and with
    `with_coverage_flags` also `coverage_flags` of the step.

    The loss is the masked cross entropy of the logits plus `aux_rate`
    times that of the aux head's logits when the model has an aux head and
    the rate is not 0. An aux head still runs at rate 0 (its BatchNorm
    statistics move) and gets zero gradients, which the optimizer's decay
    acts on, as in the JAX step.

    The learning rate of step k is `schedule(k)`, written into the parameter
    groups before the update, so step 0 of a warm-up runs at rate 0.
    rgb [B,H,W,3] and modal_x [B,H,W,C] in fp32, gt [B,H,W] integer labels,
    all on the model's device. `generator` draws the DropPath and dropout
    masks and the NMF bases; `bases` pins the NMF bases instead.

    Under a process group the inputs are this rank's rows of the global
    batch; the loss is the global batch's (each rank's term is its share
    of the global mean, `softmax_cross_entropy_masked_mean`), the gradients
    of the optimizer's parameters are summed over the ranks before the
    update (`parallel.dist.sync_grads`; a parameter in no group keeps its
    rank's gradient) and the loss returned is the sum of the terms, the
    same on every rank."""
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    # the model's, not the optimizer's: frozen parameters get gradients too
    model.zero_grad(set_to_none=True)
    model.train()
    logits, aux = model.forward_with_aux(rgb, modal_x, bases=bases,
                                         generator=generator)
    loss = softmax_cross_entropy_masked_mean(logits, gt, ignore_index)
    if aux is not None and aux_rate:
        loss = loss + aux_rate * softmax_cross_entropy_masked_mean(
            aux, gt, ignore_index)
    loss.backward()
    loss = loss.detach()
    if dist.active():
        # the parameters the optimizer updates: a frozen encoder's
        # gradients are never read by an update, and stay this rank's own
        dist.sync_grads(p for g in optimizer.param_groups
                        for p in g["params"])
        loss = dist.all_sum(loss)
    zero_missing_grads(optimizer)
    optimizer.step()
    if with_coverage_flags:
        return loss, coverage_flags(model, optimizer)
    return loss


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


class Trainer:
    """Epoch loop: augment on the device, step, audit the first steps'
    coverage. `step` counts the optimizer steps taken; a checkpoint saves
    and restores it with the model and optimizer (`train/checkpoint.py`).

    trainable_mask: {parameter name: trainable} of the optimizer
    (`optim.trainable_mask_from_matched`), None when nothing is frozen.
    debug_nans: raise on the first non-finite loss (one host transfer per
    step)."""

    def __init__(self, model, optimizer: torch.optim.Optimizer,
                 schedule: Callable[[int], float], cfg, logger=None,
                 seed: int = 8964, tb=None,
                 trainable_mask: Optional[Dict[str, bool]] = None,
                 debug_nans: bool = False):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.cfg = cfg
        self.logger = logger
        self.seed = seed
        self.tb = tb
        self.trainable_mask = trainable_mask
        self.frozen = sorted(n for n, t in (trainable_mask or {}).items()
                             if not t)
        self.debug_nans = debug_nans
        self.step = 0
        self.device = next(model.parameters()).device
        x_mean, x_std = val_x_stats(cfg)
        self._stats = [torch.as_tensor(np.asarray(s), dtype=torch.float32,
                                       device=self.device)
                       for s in (cfg.norm_mean, cfg.norm_std, x_mean, x_std)]
        self._scales = torch.as_tensor(cfg.train_scale_array,
                                       dtype=torch.float32, device=self.device)
        self._augment_gen = torch.Generator(device=self.device)
        self._step_gen = torch.Generator(device=self.device)
        # the update checks need a step at a rate above 0 (the warm-up's
        # step 0 runs at 0), so the audit runs until one has been checked
        self._audited = False
        self._audit_verbose = True
        self._replicas_checked = False
        self._paths = param_paths(model)
        # (epoch, iterations done, host seconds) at each log line, where the
        # host has waited for the card: the s/it of the log
        self.log_times = []

    def log(self, msg):
        if self.logger:
            self.logger.info(msg)
        else:
            print(msg, flush=True)

    def augment(self, batch: dict, epoch: int, it: int):
        """The loader's uint8 batch on the device, augmented with the draws
        of (seed, epoch * 100003 + it)."""
        cfg = self.cfg
        arrs = [_to_device(batch[k], self.device)
                for k in ("rgb", "gt", "modal_x")]
        self._augment_gen.manual_seed(
            derived_seed(self.seed, AUGMENT_STREAM, epoch * 100003 + it))
        true_hw = _to_device(batch["hw"], self.device) if "hw" in batch \
            else None
        return device_train_augment(
            *arrs, self._augment_gen, (cfg.image_height, cfg.image_width),
            self._scales, *self._stats, true_hw=true_hw)

    def run_epoch(self, loader, epoch: int, total_epochs: int = None,
                  guard=None) -> float:
        """One pass over `loader` (uint8 batches; `set_epoch` first);
        returns the mean loss. guard: a `runtime.preempt.PreemptionGuard`;
        once it is requested the epoch stops before its next step."""
        loader.set_epoch(epoch)
        losses = []
        t0 = time.perf_counter()
        n = len(loader)
        for it, batch in enumerate(loader):
            if guard is not None and guard.requested:
                self.log(f"epoch {epoch} stopped by preemption after "
                         f"{it}/{n} iterations")
                break
            rgb, gt, modal_x = self.augment(batch, epoch, it)
            self._step_gen.manual_seed(
                derived_seed(self.seed, STEP_STREAM, self.step))
            out = train_step(self.model, self.optimizer, self.schedule,
                             self.step, rgb, gt, modal_x, self._step_gen,
                             ignore_index=self.cfg.background,
                             with_coverage_flags=not self._audited,
                             aux_rate=self.cfg.get("aux_rate", 0.0))
            self.step += 1
            if dist.world() > 1 and not self._replicas_checked:
                # every rank starts from the seed and takes the summed
                # gradients: their parameters must agree
                dist.check_replicas_equal(list(self.model.parameters()))
                self._replicas_checked = True
            if not self._audited:
                loss, flags = out
                report = coverage_audit(
                    self._paths, *flags, trainable_mask=self.trainable_mask,
                    logger=self.logger, verbose_grad=self._audit_verbose)
                self._audit_verbose = False
                self._audited = report["complete"]
            else:
                loss = out
            if self.debug_nans and not bool(torch.isfinite(loss)):
                raise FloatingPointError(
                    f"epoch {epoch} iteration {it + 1}: loss {float(loss)}")
            # the loss stays on the device: one transfer per epoch, and a
            # wait for the card only at the log lines
            losses.append(loss)
            if it % max(n // 10, 1) == 0:
                value = float(loss)
                now = time.perf_counter()
                self.log_times.append((epoch, it + 1, now))
                remaining = (n - it - 1) + \
                    n * (max(total_epochs - epoch, 0) if total_epochs else 0)
                sec_per_it = (now - t0) / (it + 1)
                self.log(f"epoch {epoch} iter {it + 1}/{n} loss {value:.4f} "
                         f"({sec_per_it:.2f}s/it, ETA "
                         f"{sec_per_it * remaining / 60:.1f}m)")
        losses = torch.stack(losses).cpu().tolist() if losses else []
        if self.tb is not None:
            base = (epoch - 1) * n
            for i, value in enumerate(losses):
                self.tb.scalar("train/loss_iter", value, base + i)
        return float(np.mean(losses)) if losses else float("nan")
