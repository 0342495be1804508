"""Few-shot episodic Trav training on one card, or data-parallel on several
under torchrun (counterpart of `tools/train_trav_fss.py`):

    python -m dformer_torch.tools.train_trav_fss --config=local_configs.Trav.DFormer_Base \\
        [--s_csv=support.csv] [--q_csv=query.csv] [--epochs=N] \\
        [--class-episodes [--queries=1] [--contrastive-weight=0.1]] \\
        [--no-amp] [--device=cuda]
    torchrun --nproc_per_node=N -m dformer_torch.tools.train_trav_fss ...

DFormerTrav-Base + the config's decoder (bf16 compute on fp32 parameters
unless --no-amp) trains on episodes of cfg.shots support images and one query
(batch cfg.batch_size) with `meta_forward`'s fused logits; only the lidar
expansion, stage 0 and the decoder train. With --class-episodes the
episodes are class-grouped (K = cfg.shots support and --queries query
images per class) and the contrastive prototype term is added. Each epoch
is followed by cfg.eval_iterations evaluation episodes; a better episodic
mIoU saves a checkpoint under cfg.checkpoint_dir. SIGTERM or SIGINT stops
at the next epoch and saves a rescue checkpoint. The encoder is loaded
from cfg.pretrained_model when it exists. With cfg.use_wandb each
evaluation's metrics go to wandb (`runtime/wandb.py`) when it is
installed.

Under torchrun each of the N processes drives one card, loads
batch // N episodes of each global batch and steps as one process would
on the global batch (`train/fss.py`: global BatchNorm statistics over the
support and query images, loss and draws, the trainable parameters'
gradients summed); each evaluates its share of the episodes and the
hists are summed; rank 0 logs, writes the checkpoints and logs to wandb.
(The JAX tool shards the episodes but takes no gradient all-reduce: each
of its processes trains a model of its own.)

The support manifest (--s_csv, default cfg.train_source) keeps its
labelled rows; the query manifest is --q_csv (default cfg.eval_source).
Manifests are read with the stdlib csv module (`data/trav.py`).
"""

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.Trav.DFormer_Base")
    ap.add_argument("--s_csv", default=None, help="support manifest")
    ap.add_argument("--q_csv", default=None, help="query manifest")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--class-episodes", action="store_true",
                    help="class-grouped episodes: rows grouped by a class of "
                         "their mask, each episode draws K support + Q "
                         "query from one class's pool; adds the contrastive "
                         "prototype term")
    ap.add_argument("--queries", type=int, default=1,
                    help="Q query images per class episode")
    ap.add_argument("--contrastive-weight", type=float, default=0.1,
                    help="weight of the prototype InfoNCE term in "
                         "--class-episodes mode")
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def datasets_from_csv(cfg, args):
    """(train episodes, val episodes) from the manifests."""
    from dformer_torch.data.trav import (FewShotTravDatasetBinary,
                                         FewShotTravRGBDDataset, has_label,
                                         load_trav_csv)

    s_rows = [r for r in load_trav_csv(args.s_csv or cfg.train_source)
              if has_label(r)]
    q_rows = load_trav_csv(args.q_csv or cfg.eval_source)
    if args.class_episodes:
        train = FewShotTravRGBDDataset(s_rows, class_names=(0, 1),
                                       K=cfg.shots, Q=args.queries)
    else:
        train = FewShotTravDatasetBinary(s_rows, q_rows, n_shots=cfg.shots,
                                         max_iters=cfg.episodes_per_epoch)
    val = FewShotTravDatasetBinary(s_rows, q_rows, n_shots=cfg.shots,
                                   max_iters=cfg.eval_iterations)
    return train, val


def run(cfg, args, datasets=None, guard=None) -> dict:
    """Train `cfg` (a loaded Trav config, which the caller may have cut
    down) with the tool's parsed `args` on `datasets` (train episodes, val
    episodes), by default `datasets_from_csv`. guard: a `PreemptionGuard`
    (default: one installed on SIGTERM and SIGINT for the run). Returns
    {"trainer", "checkpoints", "best_miou", "miou", "losses",
    "contrastive", "epoch_seconds", "eval_seconds"}, the last five by
    epoch."""
    import torch

    from dformer_torch import entry
    from dformer_torch.data.loader import Loader, local_batch
    from dformer_torch.data.trav import class_episodes_to_meta_batch
    from dformer_torch.runtime.engine import Engine
    from dformer_torch.runtime.preempt import PreemptionGuard
    from dformer_torch.runtime.wandb import WandbHook
    from dformer_torch.train.checkpoint import CheckpointManager
    from dformer_torch.train.fss import FSSTrainer, fss_evaluate

    epochs = args.epochs or cfg.get("epochs", cfg.nepochs)
    with Engine(cfg, args.device) as engine:
        log = engine.logger
        train_ds, val_ds = datasets or datasets_from_csv(cfg, args)
        batch = min(cfg.batch_size, len(train_ds)) if args.class_episodes \
            else cfg.batch_size
        train_loader = Loader(train_ds,
                              local_batch(batch, engine.world_size),
                              shuffle=False, drop_last=True,
                              shard=engine.data_shard())
        cfg.niters_per_epoch = max(len(train_loader), 1)

        model, optimizer, schedule, mask = entry.build_fss_training(
            cfg, torch.bfloat16 if args.amp else None, args.device,
            engine.seed, logger=log)
        log.info(f"device {args.device}; {sum(mask.values())} of "
                 f"{len(mask)} parameter tensors train")
        if torch.device(args.device).type == "cuda":
            from dformer_torch.kernels import build

            log.info(f"kernel builds (s): {build.build_all()}")
        con_w = args.contrastive_weight if args.class_episodes else 0.0
        trainer = FSSTrainer(model, optimizer, schedule, cfg, mask,
                             seed=engine.seed, contrastive_weight=con_w)
        ckpt = CheckpointManager(cfg.checkpoint_dir, keep=5, logger=log)
        wb = WandbHook(cfg, rank=engine.rank, logger=log)
        own_guard = guard is None
        if own_guard:
            guard = PreemptionGuard(logger=log).install()
        out = dict(trainer=trainer, checkpoints=ckpt, best_miou=0.0, miou={},
                   losses={}, contrastive={}, epoch_seconds={},
                   eval_seconds={})
        try:
            for epoch in range(1, epochs + 1):
                if guard.requested:
                    rescue = ckpt.save(trainer, epoch - 1, out["best_miou"],
                                       extra={"preempted": True})
                    log.info(f"preempted: state saved; resume from {rescue}")
                    break
                t0 = time.perf_counter()
                train_loader.set_epoch(epoch)
                loss = None
                for it, b in enumerate(train_loader):
                    if args.class_episodes:
                        b = class_episodes_to_meta_batch(b)
                    loss = trainer.train_step(trainer.prepare(b, epoch, it))
                if con_w > 0 and loss is not None:
                    loss, con = (float(v) for v in loss)
                    out["contrastive"][epoch] = con
                    log.info(f"epoch {epoch}/{epochs} loss {loss:.4f} "
                             f"(contrastive {con:.4f} @ w={con_w})")
                elif loss is not None:
                    loss = float(loss)
                    log.info(f"epoch {epoch}/{epochs} loss {loss:.4f}")
                out["losses"][epoch] = loss
                out["epoch_seconds"][epoch] = time.perf_counter() - t0

                t0 = time.perf_counter()
                m = fss_evaluate(model, (
                    trainer.prepare(b) for b in
                    Loader(val_ds, 1, shard=engine.data_shard())), cfg)
                m.merge_across_processes()
                _, miou = m.compute_iou()
                out["eval_seconds"][epoch] = time.perf_counter() - t0
                out["miou"][epoch] = miou
                log.info(f"epoch {epoch} episodic mIoU {miou}")
                wb.log_fss_eval(epoch, m)
                if miou > out["best_miou"]:
                    out["best_miou"] = miou
                    ckpt.save(trainer, epoch, miou)
        finally:
            if own_guard:
                guard.uninstall()
            wb.finish()
        log.info(f"done; best episodic mIoU {out['best_miou']}")
    return out


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
