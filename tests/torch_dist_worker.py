"""One rank of the port's data-parallel check (tests/test_torch_dist.py),
run as `python tests/torch_dist_worker.py OUT_DIR` with torchrun's
environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): the engine joins
the gloo group. The test calls `run` in its own process with no group for
the world-1 run. Imports torch and the port only.

`run(out_dir)` takes, on the CPU in fp32 with one torch thread:
  * two train steps (one epoch of one iteration each) of a narrow DFormer
    + ham (one block per stage, drop_path_rate 0.1, dropout, fresh NMF
    bases) through `Trainer.run_epoch`, with SGDM, on this rank's rows of
    two global uint8 batches of GLOBAL_BATCH, most of whose last half is
    labelled 255; a checkpoint after step 1 (rank 0 writes), and a second
    trainer restored from it that takes step 2 again;
  * one step of a fresh trainer whose encoder is frozen (the train tool's
    mask for a pretrained encoder): a frozen and a trained parameter's
    gradients after it;
  * a sharded single-scale evaluation of VAL_IMAGES synthetic val images
    by a seeded serving model, the hists summed over the group, at batch
    VAL_BATCH and at batch 2;
  * a BatchNorm forward and backward and the masked loss on this rank's
    rows of seeded global tensors;
  * the two Trav tools on a narrow DFormerTrav (the DFormer-Base widths cut
    to NARROW1) at a global batch of TRAV_BATCH, where every rank loads
    one row of each global batch, as world 1 loads both: one step of
    `tools.train_trav_fss.run` on class episodes (the contrastive term on),
    its evaluation of TRAV_VAL_EPISODES episodes sharded and merged, its
    checkpoint, and a rescue file that rank 0 writes and every rank
    restores into a fresh trainer; one step of `tools.train_trav.run` and its pseudo-labels of
    TRAV_UNLABELED images, sharded, with the one manifest;
and saves what it saw to OUT_DIR/rank{r}.pt.
"""

import logging
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dformer_torch import configs, entry  # noqa: E402
from dformer_torch.data.loader import device_val_batches  # noqa: E402
from dformer_torch.eval.evaluate import Evaluator  # noqa: E402
from dformer_torch.models.encoder import VARIANTS  # noqa: E402
from dformer_torch.models.nn import BatchNorm  # noqa: E402
from dformer_torch.ops.loss import \
    softmax_cross_entropy_masked_mean  # noqa: E402
from dformer_torch.parallel import dist  # noqa: E402
from dformer_torch.runtime.engine import Engine  # noqa: E402
from dformer_torch.runtime.tb import TBWriter  # noqa: E402
from dformer_torch.train.checkpoint import (CheckpointManager,  # noqa: E402
                                            state_difference)
from dformer_torch.train.fss import FSSTrainer  # noqa: E402
from dformer_torch.train.loop import Trainer  # noqa: E402
from dformer_torch.train.optim import (make_optimizer,  # noqa: E402
                                       trainable_mask_from_matched)
from dformer_torch.tools import train_trav, train_trav_fss  # noqa: E402

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
GLOBAL_BATCH, HW, CLASSES, CANVAS = 4, (64, 96), 11, (80, 112)
# batch 1: the seeded NMF bases differ by batch row, so an image's labels
# depend on its row in its batch, and the shards' batches are not the
# world-1 run's (at batch 2 the merged hist depends on the world size)
VAL_IMAGES, VAL_BATCH = 5, 1
BN_SHAPE, LOSS_SHAPE = (GLOBAL_BATCH, 5, 6, 8), (GLOBAL_BATCH, 6, 7, 5)
IGNORED_SHARE = 0.9  # of the pixels of the global batch's last half


def narrow_cfg(root):
    """NYUDepthv2's config cut to the narrow model + ham at 64x96, a global
    batch of GLOBAL_BATCH, one iteration per epoch, no warm-up, SGDM."""
    VARIANTS["DFormer-Narrow1"] = NARROW1
    cfg = configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.update(backbone="DFormer-Narrow1", image_height=HW[0],
               image_width=HW[1], num_classes=CLASSES,
               batch_size=GLOBAL_BATCH, niters_per_epoch=1, nepochs=2,
               warm_up_epoch=0, drop_path_rate=0.1, optimizer="SGDM",
               lr=1e-2, pretrained_model=None, num_eval_imgs=VAL_IMAGES,
               log_dir_base=os.path.join(root, "run"))
    return cfg


def global_batches(n=2):
    """n global uint8 batches of GLOBAL_BATCH on the CANVAS, the last half
    of each mostly ignored (255)."""
    rng = np.random.RandomState(0)
    half = GLOBAL_BATCH // 2
    out = []
    for _ in range(n):
        gt = rng.randint(0, CLASSES, (GLOBAL_BATCH, *CANVAS)).astype(np.int32)
        gt[half:][rng.rand(half, *CANVAS) < IGNORED_SHARE] = 255
        rgb, modal = (rng.randint(0, 256, (GLOBAL_BATCH, *CANVAS, 3)).astype(
            np.uint8) for _ in range(2))
        out.append(dict(rgb=rgb, gt=gt, modal_x=modal))
    return out


class Batches:
    """A loader over fixed batches."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def trainer_of(cfg, seed):
    model, opt, sched, mask = entry.build_training(cfg, None, "cpu", seed=0)
    return Trainer(model, opt, sched, cfg, seed=seed, trainable_mask=mask)


def state(trainer):
    return {k: v.detach().clone()
            for k, v in trainer.model.state_dict().items()}


def train(cfg, seed):
    """Two steps, a checkpoint after the first, the second again from it:
    {"losses", "state", "resumed_loss", "resumed_state"}."""
    b1, b2 = (Batches([{k: dist.rank_rows(v) for k, v in b.items()}])
              for b in global_batches())
    a = trainer_of(cfg, seed)
    losses = [a.run_epoch(b1, 1)]
    path = CheckpointManager(cfg.checkpoint_dir).save(a, 1, 0.0)
    losses.append(a.run_epoch(b2, 2))
    b = trainer_of(cfg, seed)
    CheckpointManager(cfg.checkpoint_dir).restore(b, path)
    resumed = b.run_epoch(b2, 2)
    return dict(losses=losses, state=state(a), resumed_loss=resumed,
                resumed_state=state(b))


FROZEN = "encoder_backbone.downsample_layers.0.0.weight"
TRAINED = "decode_head.conv_seg.weight"


def frozen_encoder_step(cfg, seed):
    """One step of a trainer whose encoder_backbone is left out of the
    optimizer: {"frozen_grad", "trained_grad"} after it."""
    model, _, sched, _ = entry.build_training(cfg, None, "cpu", seed=0)
    mask = trainable_mask_from_matched(
        model, [n for n, _ in model.named_parameters()
                if n.startswith("encoder_backbone.")])
    t = Trainer(model, make_optimizer(cfg, model, mask), sched, cfg,
                seed=seed, trainable_mask=mask)
    t.run_epoch(Batches([{k: dist.rank_rows(v) for k, v in
                          global_batches(1)[0].items()}]), 1)
    grads = dict(model.named_parameters())
    return dict(frozen_grad=grads[FROZEN].grad.clone(),
                trained_grad=grads[TRAINED].grad.clone())


def evaluate(cfg, rank, world, batch=VAL_BATCH):
    """The hist of a seeded serving model over this rank's share of the
    val images, in batches of `batch`, summed over the group."""
    model = entry.build(cfg.backbone, HW, CLASSES, None, "cpu", 0)
    batches = device_val_batches(cfg, batch, "cpu", shard=(rank, world),
                                 synthetic=True, n=VAL_IMAGES)
    m = Evaluator(model, cfg, device="cpu").evaluate(batches)
    return m.merge_across_processes().hist


def bn_and_loss():
    """A training BatchNorm and the masked loss on this rank's rows of
    seeded global tensors: {"bn_out", "bn_dx", "bn_mean", "bn_var",
    "loss" (summed over the group), "dlogits"}."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32) * 2 + 0.5)
    g = torch.from_numpy(rng.randn(*BN_SHAPE).astype(np.float32))
    logits = torch.from_numpy(rng.randn(*LOSS_SHAPE).astype(np.float32))
    labels = rng.randint(0, LOSS_SHAPE[-1], LOSS_SHAPE[:3])
    half = GLOBAL_BATCH // 2
    labels[half:][rng.rand(half, *LOSS_SHAPE[1:3]) < IGNORED_SHARE] = 255
    bn = BatchNorm(BN_SHAPE[-1]).train()
    xl = dist.rank_rows(x).clone().requires_grad_()
    out = bn(xl)
    (out * dist.rank_rows(g)).sum().backward()
    ll = dist.rank_rows(logits).clone().requires_grad_()
    loss = softmax_cross_entropy_masked_mean(
        ll, dist.rank_rows(torch.from_numpy(labels)))
    loss.backward()
    return dict(bn_out=out.detach(), bn_dx=xl.grad,
                bn_mean=bn.running_mean.clone(),
                bn_var=bn.running_var.clone(),
                loss=dist.all_sum(loss.detach()), dlogits=ll.grad)


TRAV_BATCH, TRAV_VAL_EPISODES, TRAV_UNLABELED = 2, 3, 3


def _trav_cfg(root):
    """The Trav config at 64x96, a global batch of TRAV_BATCH, one shot,
    one epoch, no warm-up, SGDM (AdamW's first step, g / (|g| + eps),
    turns the summation-order noise of near-zero gradients into updates
    of the rate's size)."""
    cfg = configs.load_config("local_configs.Trav.DFormer_Base")
    cfg.update(image_height=HW[0], image_width=HW[1], batch_size=TRAV_BATCH,
               shots=1, nepochs=1, epochs=1, warm_up_epoch=0,
               drop_path_rate=0.5, optimizer="SGDM", lr=1e-2,
               pretrained_model=None,
               log_dir_base=os.path.join(root, "trav"),
               save_dir=os.path.join(root, "pseudo"))
    return cfg


def _trav_data():
    """(class episodes, val episodes, labelled rows, unlabelled rows) in
    memory, seed-made: uint8 images, 0/1 labels (some 255), 360-beam
    scans."""
    rng = np.random.RandomState(2)

    def imgs(n):
        return rng.randint(0, 256, (n, *HW, 3)).astype(np.uint8)

    def gts(n):
        g = rng.randint(0, 2, (n, *HW)).astype(np.int32)
        g[:, :3] = 255
        return g

    def scans(n):
        return (rng.rand(n, 360) * 5).astype(np.float32)

    classes = [dict(s_imgs=imgs(1), s_masks=gts(1), s_depths=scans(1),
                    q_imgs=imgs(1), q_masks=gts(1), q_depths=scans(1))
               for _ in range(TRAV_BATCH)]
    val = [dict(s_img=imgs(1), s_gt=gts(1), s_depth=scans(1),
                q_img=imgs(1)[0], q_gt=gts(1)[0], q_depth=scans(1)[0])
           for _ in range(TRAV_VAL_EPISODES)]
    labelled = [dict(rgb=imgs(1)[0], gt=gts(1)[0], laser=scans(1)[0])
                for _ in range(TRAV_BATCH)]
    unlabelled = [dict(rgb=imgs(1)[0], laser=scans(1)[0],
                       rgb_path=f"frames/f{i}.png", depth_path=f"scans/s{i}.pkl")
                  for i in range(TRAV_UNLABELED)]
    return classes, val, labelled, unlabelled


def trav(root):
    """Both Trav tools on the narrow DFormerTrav: {"fss_losses",
    "fss_contrastive", "fss_miou", "fss_state", "fss_checkpoints",
    "trav_losses", "trav_state", "manifest" (rows with the save directory
    cut off), "masks"}."""
    classes, val, labelled, unlabelled = _trav_data()
    base, init = VARIANTS["DFormer-Base"], entry._init_model

    def with_branches(*args, **kw):
        # LayerScales of 1, not the fresh 1e-6: the blocks' branches, and
        # so their DropPath draws, reach the outputs
        model = init(*args, **kw)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if ".layer_scale" in name:
                    p.fill_(1.0)
        return model

    VARIANTS["DFormer-Base"] = NARROW1
    entry._init_model = with_branches
    try:
        cfg = _trav_cfg(root)
        fss = train_trav_fss.run(cfg, train_trav_fss.parse_args(
            ["--device=cpu", "--no-amp", "--class-episodes"]),
            datasets=(classes, val))
        kept = [n for *_, n in fss["checkpoints"]._existing()]
        # a rescue file of the FSS state (rank 0 writes), restored on
        # every rank into a fresh trainer
        ckpt = CheckpointManager(cfg.checkpoint_dir)
        rescue = ckpt.save(fss["trainer"], 2, 0.0, extra={"preempted": True})
        model, opt, sched, mask = entry.build_fss_training(cfg, None, "cpu")
        fresh = FSSTrainer(model, opt, sched, cfg, mask)
        ckpt.restore(fresh, rescue)
        restored = state_difference(fss["trainer"], fresh)
        cfg = _trav_cfg(root)
        semi = train_trav.run(cfg, train_trav.parse_args(
            ["--device=cpu", "--no-amp"]), datasets=(labelled, unlabelled))
    finally:
        VARIANTS["DFormer-Base"], entry._init_model = base, init
    with open(semi["csv_path"]) as f:
        manifest = f.read().replace(cfg.save_dir, "<save_dir>")
    masks = {os.path.basename(p): np.load(p) for p in sorted(
        os.path.join(cfg.save_dir, n) for n in os.listdir(cfg.save_dir)
        if n.endswith(".npy"))}
    return dict(fss_losses=fss["losses"], fss_contrastive=fss["contrastive"],
                fss_miou=fss["miou"], fss_state=state(fss["trainer"]),
                fss_checkpoints=kept,
                fss_rescue_difference=restored,
                trav_losses=semi["losses"],
                trav_state={k: v.detach().clone()
                            for k, v in semi["model"].state_dict().items()},
                manifest=manifest, masks=masks)


def run(out_dir):
    torch.set_num_threads(1)
    cfg = narrow_cfg(out_dir)
    with Engine(cfg, "cpu") as engine:
        rank, world = engine.data_shard()
        syncs = dist.grad_syncs
        record = dict(
            rank=rank, world=world,
            run_dirs=[cfg.log_dir, cfg.tb_dir, cfg.checkpoint_dir,
                      cfg.log_file],
            log_level=engine.logger.level,
            log_files=sum(isinstance(h, logging.FileHandler)
                          for h in engine.logger.handlers),
            tb_writes=TBWriter(cfg.tb_dir, rank=rank)._w is not None)
        record.update(train(cfg, engine.seed))
        record["grad_syncs"] = dist.grad_syncs - syncs
        record.update(frozen_encoder_step(cfg, engine.seed))
        record["hist"] = evaluate(cfg, rank, world)
        record["hist_batch2"] = evaluate(cfg, rank, world, batch=2)
        record.update(bn_and_loss())
        record.update(trav(out_dir))
    torch.save(record, os.path.join(out_dir, f"rank{rank}.pt"))
    return record


if __name__ == "__main__":
    run(sys.argv[1])
