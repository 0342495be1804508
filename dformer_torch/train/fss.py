"""Few-shot episodic training (counterpart of `dformer_tpu/train/fss.py`).

The FSS recipe fine-tunes only the lidar expansion (`attn_expand_e`), the
first stage's blocks and the decoder; everything else is frozen (left out
of the optimizer). The loss is masked cross entropy on `meta_forward`'s
fused prototype + decoder logits, plus, in the class-episode recipe, the
contrastive prototype term.

Random draws follow `train/loop.py`: the mirror flips of iteration `it` of
epoch `e` come from (seed, e * 10007 + it), the DropPath, dropout and NMF
draws of step k from (seed, k).

Data-parallel (one process per card under `torchrun`, `parallel/dist.py`):
each rank steps on its episodes of the global batch, with the global
batch's draws (the flips, and in `meta_forward` those of the support and
query blocks), BatchNorm statistics and loss, and the optimizer's
gradients are summed over the ranks, so every rank takes the step one
process takes on the global batch.
"""

from typing import Dict, Optional

import numpy as np
import torch

from dformer_torch.data.trav import trav_mirror_draws, trav_prepare_batch
from dformer_torch.models.fewshot import contrastive_loss
from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean
from dformer_torch.ops.metrics import Metrics
from dformer_torch.ops.resize import resize_bilinear
from dformer_torch.parallel import dist
from dformer_torch.train.loop import (AUGMENT_STREAM, STEP_STREAM, _to_device,
                                      derived_seed)
from dformer_torch.train.optim import zero_missing_grads

# parameter name prefixes the FSS recipe trains
FSS_TRAINABLE = ("encoder_backbone.attn_expand_e.",
                 "encoder_backbone.stages.0.", "decode_head.", "aux_head.")


def fss_trainable_mask(model) -> Dict[str, bool]:
    """{parameter name: trainable}: True for the lidar expansion, the
    stage-0 blocks (not the stem or the downsample layers) and the heads.
    A model without the lidar expansion is refused: there the mask would
    freeze the whole encoder."""
    names = [n for n, _ in model.named_parameters()]
    if not any(n.startswith(FSS_TRAINABLE[0]) for n in names):
        raise ValueError(
            "fss_trainable_mask expects a DFormerTrav model "
            "(encoder_backbone.attn_expand_e.*); on a stock DFormer this "
            "mask would freeze the entire encoder")
    return {n: n.startswith(FSS_TRAINABLE) for n in names}


def fss_train_step(model, optimizer: torch.optim.Optimizer, schedule,
                   step: int, s_img, s_gt, s_depth, q_img, q_gt, q_depth,
                   generator: torch.Generator,
                   bases: Optional[torch.Tensor] = None,
                   contrastive_weight: float = 0.0, background: int = 255):
    """Take optimizer step `step` on one episode batch and return the loss
    (0-d, detached), or (loss, contrastive term) when contrastive_weight >
    0. The rate is `schedule(step)`.

    s_img [B,S,H,W,3], s_gt [B,S,H,W], s_depth [B,S,360], q_img [B,H,W,3],
    q_gt [B,H,W], q_depth [B,360], prepared (`trav_prepare_batch`) on the
    model's device. The contrastive term takes the query mask with ignored
    pixels set to background, bilinearly resized to the top-stage grid and
    rounded. `generator` draws DropPath, dropout and the NMF bases; `bases`
    pins the NMF bases instead.

    Under a process group the inputs are this rank's episodes of the
    global batch: the loss (and the contrastive term) is the global
    batch's, the same on every rank, and the gradients of the optimizer's
    parameters are summed over the ranks before the update (the frozen
    encoder's stay this rank's own)."""
    lr = schedule(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    model.zero_grad(set_to_none=True)
    model.train()
    with_con = contrastive_weight > 0
    out = model.meta_forward(s_img, s_depth, s_gt, q_img, q_depth,
                             bases=bases, generator=generator,
                             return_episode=with_con)
    logits, ep = out if with_con else (out, None)
    loss = softmax_cross_entropy_masked_mean(logits, q_gt, background)
    if with_con:
        qm = torch.where(q_gt == background, 0, q_gt)
        qm = resize_bilinear(qm[..., None].float(),
                             ep["q_top"].shape[1:3])[..., 0]
        protos = torch.stack([ep["bg"], ep["fg"]])  # [K=2, B, C]
        con = contrastive_loss(ep["q_top"].float(), protos.float(),
                               torch.round(qm).long())
        if dist.world() > 1:  # this rank's share of the global mean
            con = con / dist.world()
        loss = loss + contrastive_weight * con
    loss.backward()
    loss = loss.detach()
    con = con.detach() if with_con else None
    if dist.active():
        dist.sync_grads(p for g in optimizer.param_groups
                        for p in g["params"])
        loss = dist.all_sum(loss)
        con = dist.all_sum(con) if with_con else None
    zero_missing_grads(optimizer)
    optimizer.step()
    if with_con:
        return loss, con
    return loss


@torch.inference_mode()
def fss_evaluate(model, batches, cfg) -> Metrics:
    """Single-scale episode evaluation: the query's fused logits against
    its labels, accumulated in `Metrics(cfg.num_classes, cfg.background)`.
    Batches are prepared episodes (the `fss_train_step` layout) on the
    model's device; the NMF takes its seeded bases."""
    model.eval()
    metrics = Metrics(cfg.num_classes, cfg.background)
    for b in batches:
        logits = model.meta_forward(b["s_img"], b["s_depth"], b["s_gt"],
                                    b["q_img"], b["q_depth"])
        metrics.update(logits, b["q_gt"])
    return metrics


class TravPrep:
    """Device-side preparation of Trav batches and the run's seeded draws,
    shared by the FSS trainer and the semi-supervised tool: the mirror
    flips of iteration `it` of epoch `e` come from (seed, e * 10007 + it),
    a step's DropPath, dropout and NMF generator from (seed, step)."""

    def __init__(self, cfg, seed: int, device: torch.device):
        self.seed, self.device = seed, device
        self._stats = [torch.as_tensor(np.asarray(s), dtype=torch.float32,
                                       device=device)
                       for s in (cfg.norm_mean, cfg.norm_std)]
        self._mirror_gen = torch.Generator(device=device)
        self._step_gen = torch.Generator(device=device)

    def mirror_draws(self, epoch: int, it: int, *sizes: int):
        """The flips of iteration `it` of epoch `epoch`: one [n] bool draw
        for each n of `sizes`, in order, from one seeded generator."""
        self._mirror_gen.manual_seed(
            derived_seed(self.seed, AUGMENT_STREAM, epoch * 10007 + it))
        return [trav_mirror_draws(self._mirror_gen, n) for n in sizes]

    def step_generator(self, step: int) -> torch.Generator:
        self._step_gen.manual_seed(derived_seed(self.seed, STEP_STREAM, step))
        return self._step_gen

    def __call__(self, rgb, laser, gt=None, flips=None):
        """`trav_prepare_batch` of host arrays (uint8 rgb [N,H,W,3], scans
        [N,...] taken as [N,360], gt [N,H,W]) on the device."""
        laser = _to_device(laser, self.device)
        return trav_prepare_batch(
            _to_device(rgb, self.device), laser.reshape(len(laser), -1),
            *self._stats, flips,
            None if gt is None else _to_device(gt, self.device))


class FSSTrainer:
    """The state of an FSS run (model, optimizer, schedule, step, frozen
    names: what `train/checkpoint.CheckpointManager` saves) and its episode
    preparation and step."""

    def __init__(self, model, optimizer, schedule, cfg,
                 trainable_mask: Dict[str, bool], seed: int = 8964,
                 contrastive_weight: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.schedule = schedule
        self.cfg = cfg
        self.contrastive_weight = contrastive_weight
        self.frozen = sorted(n for n, t in trainable_mask.items() if not t)
        self.step = 0
        self.prep = TravPrep(cfg, seed, next(model.parameters()).device)
        self._replicas_checked = False

    def prepare(self, b: dict, epoch: Optional[int] = None,
                it: Optional[int] = None) -> dict:
        """A collated episode batch (uint8 images, labels, [.., 360]
        scans) on the device, normalised; mirrored with the draws of
        iteration `it` of `epoch` when epoch is given (training), not
        mirrored otherwise (evaluation)."""
        B, S = b["s_img"].shape[:2]
        flips = (None, None) if epoch is None else \
            self.prep.mirror_draws(epoch, it, B * S, B)

        def shots(a):  # [B,S,...] -> [B*S,...]
            a = np.asarray(a)
            return a.reshape((B * S,) + a.shape[2:])

        s_img, s_laser, s_gt = self.prep(shots(b["s_img"]),
                                         shots(b["s_depth"]),
                                         shots(b["s_gt"]), flips[0])
        q_img, q_laser, q_gt = self.prep(b["q_img"], b["q_depth"], b["q_gt"],
                                         flips[1])
        return dict(s_img=s_img.unflatten(0, (B, S)),
                    s_gt=s_gt.unflatten(0, (B, S)),
                    s_depth=s_laser.unflatten(0, (B, S)),
                    q_img=q_img, q_gt=q_gt, q_depth=q_laser)

    def train_step(self, e: dict):
        """`fss_train_step` on a prepared episode batch at the trainer's
        step, with the step's draws; advances the step."""
        out = fss_train_step(
            self.model, self.optimizer, self.schedule, self.step, e["s_img"],
            e["s_gt"], e["s_depth"], e["q_img"], e["q_gt"], e["q_depth"],
            self.prep.step_generator(self.step), contrastive_weight=self.contrastive_weight,
            background=self.cfg.background)
        self.step += 1
        if dist.world() > 1 and not self._replicas_checked:
            # every rank starts from the seed and takes the summed
            # gradients: their parameters must agree
            dist.check_replicas_equal(list(self.model.parameters()))
            self._replicas_checked = True
        return out
