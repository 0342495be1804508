"""Input-pipeline benchmark (counterpart of `tools/pipeline_bench.py`): can
the host loaders feed the card at the rate a train step consumes, from a
synthetic on-disk dataset with real JPEG/PNG decoding
(`tools.make_synth_dataset`)?

    python -m dformer_torch.tools.pipeline_bench [--root DIR] [--e2e] \\
        [--config=local_configs.NYUDepthv2.DFormer_Large] [--batch 8] \\
        [--threads 4] [--n-train 795] [--iters N] [--device cuda]

Without --root the dataset is written to a temporary directory (in
$TMPDIR) and removed at the end; with --root it is written there unless a
tree is already present. Phases, one JSON line each:
  1. loader only: the sustained img/s of the threaded `Loader` and of the
     C++ `NativeBatchLoader` (decode + collate, nothing on the card), after
     2 warm-up batches;
  2. --e2e: `Trainer.run_epoch` of the config's model (bf16 on fp32
     parameters) consuming each loader for one epoch of `--iters` steps
     (default the config's `niters_per_epoch`) after a warm-up epoch: the
     wall-clock img/s, the seconds the loop waited for the loader, and, as
     the card's ceiling, the same epoch over batches already in memory.
The JAX tool's `--prefetch` branch imports a device-prefetch module that
the JAX package does not have; it is not ported. The native loader raises
if its library cannot be built.
"""

import argparse
import logging
import os
import os.path as osp
import tempfile
import time

from dformer_torch.tools.measure import device_name, emit, synchronize


def bench_loader(loader, warm_batches: int = 2):
    """(img/s, images, seconds) of one epoch of `loader` after its first
    `warm_batches` batches."""
    n_img, t0 = 0, None
    for i, b in enumerate(loader):
        if i + 1 == warm_batches:
            t0 = time.perf_counter()
            continue
        if t0 is not None:
            n_img += len(b["rgb"])
    dt = time.perf_counter() - t0
    return n_img / dt, n_img, dt


class _Timed:
    """A loader whose batches' waits are summed in `wait_s`."""

    def __init__(self, loader):
        self.loader, self.wait_s = loader, 0.0

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t0 = time.perf_counter()
            batch = next(it, None)
            self.wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch


class _InMemory:
    """The same batches again, already decoded."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=None)
    ap.add_argument("--config", default="local_configs.NYUDepthv2.DFormer_Large")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--n-train", type=int, default=795)
    ap.add_argument("--iters", type=int, default=None,
                    help="steps per epoch (default the config's)")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list:
    """Run the phases on a dataset under --root (or a temporary one);
    returns the printed records."""
    args = parse_args(argv)
    if args.root is not None:
        return _run(args, args.root)
    with tempfile.TemporaryDirectory(prefix="synth_nyu_") as root:
        return _run(args, root)


def _run(args, root) -> list:
    from dformer_torch.configs import load_config
    from dformer_torch.data.loader import train_batches
    from dformer_torch.tools.make_synth_dataset import generate

    before = os.environ.get("DFORMER_DATA_ROOT")
    os.environ["DFORMER_DATA_ROOT"] = root
    try:
        cfg = load_config(args.config)
    finally:
        if before is None:
            del os.environ["DFORMER_DATA_ROOT"]
        else:
            os.environ["DFORMER_DATA_ROOT"] = before
    if not osp.isdir(cfg.rgb_root_folder):
        generate(root, n_train=args.n_train, n_val=0,
                 hw=(cfg.image_height, cfg.image_width), quiet=True)
    cfg.batch_size = args.batch
    if args.iters:
        cfg.niters_per_epoch = args.iters

    def loaders():
        thread = train_batches(cfg)
        thread.num_threads = args.threads
        return (("thread", thread),
                ("native", train_batches(cfg, native=True)))

    records = []
    for name, loader in loaders():
        loader.set_epoch(1)
        ips, imgs, seconds = bench_loader(loader)
        records.append({"tool": "pipeline_bench", "phase": "loader",
                        "loader": name, "threads": args.threads,
                        "batch": args.batch, "img_per_s": ips,
                        "images": imgs, "seconds": seconds})
        emit(records[-1])
    if not args.e2e:
        return records

    import torch

    from dformer_torch import entry
    from dformer_torch.train.loop import Trainer

    device = args.device
    cfg.pretrained_model = None
    model, optimizer, schedule, mask = entry.build_training(
        cfg, torch.bfloat16, device, seed=0)
    if torch.device(device).type == "cuda":
        from dformer_torch.kernels import build

        build.build_all()
    trainer = Trainer(model, optimizer, schedule, cfg, seed=0,
                      trainable_mask=mask,
                      logger=logging.getLogger(__name__))
    epoch = 1
    memory = None
    for name, loader in loaders():
        if memory is None:  # warm-up epoch; its batches become the ceiling's
            loader.set_epoch(epoch)
            memory = _InMemory(list(loader))
            trainer.run_epoch(memory, epoch)
            synchronize(device)
            epoch += 1
        timed = _Timed(loader)
        t0 = time.perf_counter()
        trainer.run_epoch(timed, epoch)
        synchronize(device)
        wall = time.perf_counter() - t0
        epoch += 1
        imgs = len(loader) * args.batch
        records.append({"tool": "pipeline_bench", "phase": "e2e",
                        "loader": name, "batch": args.batch, "steps":
                        len(loader), "img_per_s": imgs / wall,
                        "wall_s": wall, "loader_wait_s": timed.wait_s,
                        "device": device_name(device)})
        emit(records[-1])
    t0 = time.perf_counter()
    trainer.run_epoch(memory, epoch)
    synchronize(device)
    wall = time.perf_counter() - t0
    imgs = len(memory) * args.batch
    records.append({"tool": "pipeline_bench", "phase": "e2e",
                    "loader": "in_memory", "batch": args.batch,
                    "steps": len(memory), "img_per_s": imgs / wall,
                    "wall_s": wall, "device": device_name(device)})
    emit(records[-1])
    return records


if __name__ == "__main__":
    main()
