"""Semi-supervised Trav training on one card, or data-parallel on several
under torchrun (counterpart of `tools/train_trav.py`):

    python -m dformer_torch.tools.train_trav --config=local_configs.Trav.DFormer_Base \\
        [--labeled_csv=labeled.csv] [--unlabeled_csv=unlabeled.csv] \\
        [--epochs=N] [--save_dir=DIR] [--no-amp] [--device=cuda]
    torchrun --nproc_per_node=N -m dformer_torch.tools.train_trav ...

DFormerTrav-Base + the config's decoder (the aux head's loss weighted by
cfg.aux_rate) trains from scratch (no pretrained load) with supervision on the labelled rows of --labeled_csv (default
cfg.train_source; batch cfg.batch_size, mirrored at random, bf16 compute
on fp32 parameters unless --no-amp), then writes an argmax mask for every
row of --unlabeled_csv (default cfg.eval_source) and the manifest
`unlabeled_masks.csv` into --save_dir (default cfg.save_dir). Manifests are
read with the stdlib csv module (`data/trav.py`).

Under torchrun each of the N processes drives one card, loads
batch_size // N rows of each global batch and steps as one process would
on the global batch (`parallel/dist.py`); each pseudo-labels its share of
the unlabelled rows and rank 0 writes the manifest. (The JAX tool shards
the rows but takes no gradient all-reduce: each of its processes trains
a model of its own.)
"""

import argparse
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.Trav.DFormer_Base")
    ap.add_argument("--labeled_csv", default=None)
    ap.add_argument("--unlabeled_csv", default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--save_dir", default=None)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def datasets_from_csv(cfg, args):
    """(labelled train dataset, unlabelled dataset) from the manifests."""
    from dformer_torch.data.trav import (TravRGBDLabeledDataset,
                                         labeled_unlabeled_split)

    train, unlabeled = labeled_unlabeled_split(
        args.labeled_csv or cfg.train_source,
        args.unlabeled_csv or cfg.eval_source)
    return TravRGBDLabeledDataset(train), TravRGBDLabeledDataset(unlabeled)


def run(cfg, args, datasets=None) -> dict:
    """Train `cfg` (a loaded Trav config, which the caller may have cut
    down) with the tool's parsed `args` on `datasets` (labelled train
    dataset, unlabelled dataset: items of rgb, laser, gt and their paths),
    by default `datasets_from_csv`, then write the pseudo-labels. Returns
    {"model", "step", "losses" by epoch, "epoch_seconds", "csv_path",
    "label_seconds"}."""
    import torch

    from dformer_torch import entry
    from dformer_torch.config import AttrDict
    from dformer_torch.data.loader import Loader, local_batch
    from dformer_torch.eval.pseudo_label import infer_unlabeled_masks
    from dformer_torch.runtime.engine import Engine
    from dformer_torch.train.fss import TravPrep
    from dformer_torch.train.loop import train_step

    if args.epochs:
        cfg.nepochs = args.epochs
    save_dir = args.save_dir or cfg.get("save_dir", "output/unlabeled_masks")
    device = torch.device(args.device)
    with Engine(cfg, args.device) as engine:
        log = engine.logger
        train_ds, unlabeled_ds = datasets or datasets_from_csv(cfg, args)
        train_loader = Loader(train_ds,
                              local_batch(cfg.batch_size, engine.world_size),
                              shuffle=True, drop_last=True,
                              shard=engine.data_shard())
        cfg.niters_per_epoch = max(len(train_loader), 1)

        # from scratch: no pretrained load, as in the JAX tool
        model, optimizer, schedule, _ = entry.build_training(
            AttrDict(cfg, pretrained_model=None),
            torch.bfloat16 if args.amp else None, device, engine.seed)
        if device.type == "cuda":
            from dformer_torch.kernels import build

            log.info(f"kernel builds (s): {build.build_all()}")
        prep = TravPrep(cfg, engine.seed, device)

        out = dict(model=model, step=0, losses={}, epoch_seconds={})
        for epoch in range(1, cfg.nepochs + 1):
            t0 = time.perf_counter()
            train_loader.set_epoch(epoch)
            loss = None
            for it, batch in enumerate(train_loader):
                (flips,) = prep.mirror_draws(epoch, it, len(batch["rgb"]))
                rgb, laser, gt = prep(batch["rgb"], batch["laser"],
                                      batch["gt"], flips)
                loss = train_step(model, optimizer, schedule, out["step"],
                                  rgb, gt, laser,
                                  prep.step_generator(out["step"]),
                                  ignore_index=cfg.background,
                                  aux_rate=cfg.get("aux_rate", 0.0))
                out["step"] += 1
            loss = None if loss is None else float(loss)
            out["losses"][epoch] = loss
            out["epoch_seconds"][epoch] = time.perf_counter() - t0
            log.info(f"epoch {epoch}/{cfg.nepochs} loss {loss}")

        # the pseudo-label stage
        def unlabeled_batches():
            for b in Loader(unlabeled_ds, 1, shard=engine.data_shard()):
                rgb, laser = prep(b["rgb"], b["laser"])
                yield dict(rgb=rgb, laser=laser, rgb_path=b["rgb_path"],
                           depth_path=b["depth_path"])

        t0 = time.perf_counter()
        out["csv_path"] = infer_unlabeled_masks(model, unlabeled_batches(),
                                                save_dir, log)
        out["label_seconds"] = time.perf_counter() - t0
        log.info(f"pseudo-label manifest: {out['csv_path']}")
    return out


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
