"""K-fold cross-validated Trav training on one card (counterpart of
`tools/train_trav_kfold.py`):

    python -m dformer_torch.tools.train_trav_kfold --config=local_configs.Trav.DFormer_Base \\
        [--csv=labeled.csv] [--folds=4] [--epochs=N] [--no-amp] [--device=cuda]

The labelled rows of --csv (default cfg.train_source) are split into
--folds folds (sklearn's shuffled `KFold`, seed 42: `data/trav.kfold_indices`).
For each fold a fresh DFormerTrav-Base + the config's decoder, drawn from
the fold's own seed, trains from scratch with supervision on the other
folds (batch cfg.batch_size, mirrored at random, bf16 compute on fp32
parameters unless --no-amp) for cfg.nepochs epochs, and is evaluated on
its fold with the NMF's seeded bases. Each fold's mIoU is logged, then
their mean. One process, as the JAX tool: a launcher's WORLD_SIZE > 1
raises.
"""

import argparse
import time

# the seed stream of a fold's model, flips and step draws (`derived_seed`)
FOLD_STREAM = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.Trav.DFormer_Base")
    ap.add_argument("--csv", default=None, help="labeled manifest")
    ap.add_argument("--folds", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


class _Rows:
    """The items of `dataset` at `indices`."""

    def __init__(self, dataset, indices):
        self.dataset, self.indices = dataset, list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]


def run(cfg, args, rows=None) -> dict:
    """The k-fold runs of `cfg` (a loaded Trav config, which the caller may
    have cut down) with the tool's parsed `args` over `rows`: items of rgb,
    laser and gt (by default the labelled rows of the manifest, decoded
    from their files). Returns {"fold_mious", "mean_miou", "splits"
    ([(train indices, val indices)] into `rows`), "losses" and
    "fold_seconds" by fold}."""
    import numpy as np
    import torch

    from dformer_torch import entry
    from dformer_torch.config import AttrDict
    from dformer_torch.data.loader import Loader
    from dformer_torch.data.trav import (TravRGBDLabeledDataset, has_label,
                                         kfold_indices, read_csv)
    from dformer_torch.ops.metrics import Metrics
    from dformer_torch.runtime.engine import Engine, single_process
    from dformer_torch.train.fss import TravPrep
    from dformer_torch.train.loop import derived_seed, train_step

    single_process("tools.train_trav_kfold")
    if args.epochs:
        cfg.nepochs = args.epochs
    device = torch.device(args.device)
    with Engine(cfg, args.device) as engine:
        log = engine.logger
        if rows is None:
            rows = TravRGBDLabeledDataset(
                [r for r in read_csv(args.csv or cfg.train_source)
                 if has_label(r)])
        splits = kfold_indices(len(rows), args.folds)
        if device.type == "cuda":
            from dformer_torch.kernels import build

            log.info(f"kernel builds (s): {build.build_all()}")
        out = dict(fold_mious=[], splits=splits, losses={}, fold_seconds={})
        for fi, (train_idx, val_idx) in enumerate(splits):
            t0 = time.perf_counter()
            log.info(f"fold {fi + 1}/{len(splits)}: {len(train_idx)} train "
                     f"/ {len(val_idx)} val")
            train_loader = Loader(_Rows(rows, train_idx), cfg.batch_size,
                                  shuffle=True, drop_last=True)
            cfg.niters_per_epoch = max(len(train_loader), 1)
            seed = derived_seed(engine.seed, FOLD_STREAM, fi)
            # from scratch: no pretrained load, as in the JAX tool
            model, optimizer, schedule, _ = entry.build_training(
                AttrDict(cfg, pretrained_model=None),
                torch.bfloat16 if args.amp else None, device, seed)
            prep = TravPrep(cfg, seed, device)
            step, loss = 0, None
            for epoch in range(1, cfg.nepochs + 1):
                train_loader.set_epoch(epoch)
                for it, b in enumerate(train_loader):
                    (flips,) = prep.mirror_draws(epoch, it, len(b["rgb"]))
                    rgb, laser, gt = prep(b["rgb"], b["laser"], b["gt"],
                                          flips)
                    loss = train_step(model, optimizer, schedule, step, rgb,
                                      gt, laser, prep.step_generator(step),
                                      ignore_index=cfg.background,
                                      aux_rate=cfg.get("aux_rate", 0.0))
                    step += 1
                loss = None if loss is None else float(loss)
                out["losses"].setdefault(fi, {})[epoch] = loss
                log.info(f"fold {fi} epoch {epoch} loss {loss}")

            model.eval()
            metrics = Metrics(cfg.num_classes, cfg.background)
            with torch.inference_mode():
                for b in Loader(_Rows(rows, val_idx), 1):
                    rgb, laser, gt = prep(b["rgb"], b["laser"], b["gt"])
                    metrics.update(model(rgb, laser), gt)
            _, miou = metrics.compute_iou()
            out["fold_mious"].append(miou)
            out["fold_seconds"][fi] = time.perf_counter() - t0
            log.info(f"fold {fi} mIoU {miou}")
            del model, optimizer
        out["mean_miou"] = float(np.mean(out["fold_mious"]))
        log.info(f"k-fold mIoUs {out['fold_mious']}, "
                 f"mean {out['mean_miou']:.2f}")
    return out


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
