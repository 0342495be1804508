"""Train DFormer + the config's decode head from a config on one card, or
data-parallel on several under torchrun (counterpart of `tools/train.py`):

    python -m dformer_torch.tools.train --config=local_configs.NYUDepthv2.DFormer_Large \\
        [--synthetic-data] [--epochs=N] [--continue_fpath=epoch-E_miou_M.pth] \\
        [--no-amp] [--val_amp] [--no-mst] [--sliding] [--val_batch_size=4] \\
        [--debug_nans] [--native-loader] [--device=cuda]
    torchrun --nproc_per_node=N -m dformer_torch.tools.train --config=...

Each epoch augments the train batches on the card and steps (bf16 compute
on fp32 parameters unless --no-amp); epoch 1, every 10th and every epoch
after cfg.checkpoint_start_epoch are evaluated (multi-scale
[0.5, 0.75, 1, 1.25, 1.5] + flip unless --no-mst; fp32 unless --val_amp),
and a better mIoU saves a checkpoint (the best 5 are kept) under
cfg.checkpoint_dir. SIGTERM or SIGINT stops after the step in flight and
saves the state as a rescue checkpoint to resume from with
--continue_fpath. The encoder is loaded and frozen when
cfg.pretrained_model exists, else everything trains from scratch.

Under torchrun each of the N processes drives one card (NCCL; gloo with
--device=cpu), loads batch_size // N rows of each global batch and steps
as one process would on the global batch (`parallel/dist.py`: global
BatchNorm statistics, loss and draws, summed gradients); each evaluates
its share of the val split and the hists are summed; rank 0 logs and
writes the checkpoints.

The head is the config's `decoder` ("ham", "MLPDecoder", "UPernet",
"deeplabv3+", "nl"; any other name builds the FCN-32s fallback), and the
FCN aux head's loss is weighted by its `aux_rate` (UPernet, deeplabv3+ and
nl carry the aux head whatever the rate; ham only when it is not 0).
"""

import argparse
import time

MSF_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]


def is_eval(epoch: int, cfg) -> bool:
    """The reference's evaluation epochs (utils/train.py:60-61)."""
    return epoch > int(cfg.checkpoint_start_epoch) or epoch == 1 \
        or epoch % 10 == 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--continue_fpath", default=None,
                    help="a checkpoint of this tool to resume from")
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--val_amp", action=argparse.BooleanOptionalAction,
                    default=False, help="bf16 evaluation; default fp32")
    ap.add_argument("--mst", action=argparse.BooleanOptionalAction,
                    default=True, help="multi-scale + flip evaluation")
    ap.add_argument("--sliding", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--syncbn", action=argparse.BooleanOptionalAction,
                    default=True, help="(always on under a process group: "
                    "global BatchNorm statistics)")
    ap.add_argument("--compile", action=argparse.BooleanOptionalAction,
                    default=True, help="(eager PyTorch: no torch.compile)")
    ap.add_argument("--use_seed", action=argparse.BooleanOptionalAction,
                    default=True, help="(always seeded from cfg.seed)")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override cfg.nepochs")
    ap.add_argument("--synthetic-data", action="store_true",
                    help="random images instead of datasets on disk")
    ap.add_argument("--native-loader", action="store_true",
                    help="decode the train files with the C++ pool "
                         "(dformer_torch/native/loader.cpp)")
    ap.add_argument("--val_batch_size", type=int, default=4)
    ap.add_argument("--debug_nans", action="store_true",
                    help="raise on the first non-finite loss")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _evaluate(trainer, cfg, args, log, epoch: int, shard):
    """mIoU of the trainer's model on the val split, of which this process
    evaluates its `shard` (rank, world) and sums the hists with the other
    ranks'; logs the metrics."""
    import torch

    from dformer_torch.data.loader import device_val_batches
    from dformer_torch.eval.evaluate import Evaluator
    from dformer_torch.models.builder import compute_dtype

    model = trainer.model.eval()
    with compute_dtype(model, torch.bfloat16 if args.val_amp else None):
        ev = Evaluator(model, cfg, sliding=args.sliding, device=args.device)
        batches = device_val_batches(cfg, args.val_batch_size, args.device,
                                     shard=shard,
                                     synthetic=args.synthetic_data)
        if args.mst:
            # the reference's --mst validation (utils/train.py:406-415)
            m = ev.evaluate_msf(batches, scales=MSF_SCALES, flip=True)
        else:
            m = ev.evaluate(batches)
    m.merge_across_processes()
    _, miou = m.compute_iou()
    _, macc = m.compute_pixel_acc()
    _, mf1 = m.compute_f1()
    log.info(f"epoch {epoch} mIoU {miou} mAcc {macc} mF1 {mf1}")
    return miou, macc, mf1


def run(cfg, args, guard=None) -> dict:
    """Train `cfg` (a loaded config, which the caller may have cut down)
    with the tool's parsed `args`. guard: a `PreemptionGuard` (default: one
    installed on SIGTERM and SIGINT for the run). Returns {"trainer",
    "checkpoints" (the CheckpointManager), "best_miou", "epoch_seconds",
    "eval_seconds", "losses"}, the last three by epoch."""
    import torch

    from dformer_torch import entry
    from dformer_torch.data.loader import train_batches
    from dformer_torch.runtime.engine import Engine
    from dformer_torch.runtime.preempt import PreemptionGuard
    from dformer_torch.runtime.tb import TBWriter
    from dformer_torch.train.checkpoint import CheckpointManager
    from dformer_torch.train.loop import Trainer

    if args.epochs:
        cfg.nepochs = args.epochs
    with Engine(cfg, args.device) as engine:
        log = engine.logger
        log.info(f"device {args.device}; rank {engine.rank} of "
                 f"{engine.world_size} (--syncbn {args.syncbn}: global "
                 f"BatchNorm statistics under a process group), eager "
                 f"PyTorch (--compile {args.compile})")
        model, optimizer, schedule, mask = entry.build_training(
            cfg, torch.bfloat16 if args.amp else None, args.device,
            engine.seed, logger=log)
        log.info("model: %.2fM parameters" % (
            sum(p.numel() for p in model.parameters()) / 1e6))
        if torch.device(args.device).type == "cuda":
            from dformer_torch.kernels import build

            # both kernels at once, not one after the other at first use
            log.info(f"kernel builds (s): {build.build_all()}")
        tb = TBWriter(cfg.tb_dir, rank=engine.rank)
        trainer = Trainer(model, optimizer, schedule, cfg, logger=log,
                          seed=engine.seed, tb=tb, trainable_mask=mask,
                          debug_nans=args.debug_nans)
        ckpt = CheckpointManager(cfg.checkpoint_dir, keep=5, logger=log)
        start_epoch = 1
        if args.continue_fpath:
            start_epoch = ckpt.restore(trainer, args.continue_fpath)
        loader = train_batches(cfg, shard=engine.data_shard(),
                               synthetic=args.synthetic_data,
                               native=args.native_loader)
        own_guard = guard is None
        if own_guard:
            guard = PreemptionGuard(logger=log).install()
        out = dict(trainer=trainer, checkpoints=ckpt, best_miou=0.0,
                   epoch_seconds={}, eval_seconds={}, losses={})
        try:
            for epoch in range(start_epoch, cfg.nepochs + 1):
                t0 = time.perf_counter()
                loss = trainer.run_epoch(loader, epoch,
                                         total_epochs=cfg.nepochs,
                                         guard=guard)
                out["epoch_seconds"][epoch] = time.perf_counter() - t0
                out["losses"][epoch] = loss
                tb.scalar("train/loss", loss, epoch)
                log.info(f"epoch {epoch}/{cfg.nepochs} loss {loss:.4f} "
                         f"({out['epoch_seconds'][epoch]:.1f}s)")
                if guard.requested:
                    # saved under this epoch with the best mIoU so far, so
                    # retention never drops it first; resume at epoch + 1
                    rescue = ckpt.save(trainer, epoch, out["best_miou"],
                                       extra={"preempted": True})
                    log.info(f"preempted during epoch {epoch}: state saved; "
                             f"resume with --continue_fpath={rescue}")
                    break
                if is_eval(epoch, cfg):
                    t0 = time.perf_counter()
                    miou, macc, mf1 = _evaluate(trainer, cfg, args, log,
                                                epoch, engine.data_shard())
                    out["eval_seconds"][epoch] = time.perf_counter() - t0
                    tb.scalar("val/mIoU", miou, epoch)
                    tb.scalar("val/mAcc", macc, epoch)
                    tb.scalar("val/mF1", mf1, epoch)
                    if miou > out["best_miou"]:
                        out["best_miou"] = miou
                        ckpt.save(trainer, epoch, miou)
        finally:
            if own_guard:
                guard.uninstall()
            tb.close()
        log.info(f"done; best mIoU {out['best_miou']}")
    return out


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    run(load_config(args.config), args)


if __name__ == "__main__":
    main()
