"""Train-step throughput (counterpart of `tools/train_bench.py`): the
config's model and optimizer from scratch (`entry.build_training`, bf16
compute on fp32 parameters) at the config's crop, on one random batch.

    python -m dformer_torch.tools.train_bench [--config=...] [--batch 8] \\
        [--reps 20] [--warmup 3] [--device cuda]

Each of `--reps` steps (`train.loop.train_step`: forward, masked CE,
backward, the optimizer), after `--warmup`, is timed between CUDA events
(the host clock with --device cpu). Prints one JSON line: the median ms
per step, img/s and the epoch of `cfg.num_train_imgs` images it implies.
"""

import argparse
import statistics

import numpy as np
import torch

from dformer_torch import entry
from dformer_torch.tools.measure import (call_ms, device_name, emit,
                                         timing_source)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.NYUDepthv2.DFormer_Large")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from dformer_torch.configs import load_config
    from dformer_torch.train.loop import train_step

    args = parse_args(argv)
    cfg = load_config(args.config)
    cfg.pretrained_model = None
    device = args.device
    model, optimizer, schedule, _ = entry.build_training(
        cfg, torch.bfloat16, device, seed=0)
    if torch.device(device).type == "cuda":
        from dformer_torch.kernels import build

        build.build_all()
    B, H, W = args.batch, cfg.image_height, cfg.image_width
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(B, H, W, 3).astype(np.float32)).to(device)
    gt = torch.from_numpy(rng.randint(0, cfg.num_classes, (B, H, W))
                          ).to(device)
    generator = torch.Generator(device=device).manual_seed(0)
    steps = iter(range(args.warmup + args.reps))
    losses = []

    def step():
        losses.append(train_step(model, optimizer, schedule, next(steps),
                                 rgb, gt, rgb, generator,
                                 ignore_index=cfg.background))

    step_ms = statistics.median(call_ms(step, device, args.reps,
                                        args.warmup))
    ips = B / (step_ms / 1e3)
    record = {"tool": "train_bench", "config": args.config,
              "backbone": cfg.backbone, "decoder": cfg.decoder,
              "batch": B, "hw": [H, W], "dtype": "bfloat16",
              "reps": args.reps, "step_ms": step_ms, "img_per_s": ips,
              "epoch_seconds": cfg.num_train_imgs / ips,
              "last_loss": float(losses[-1]),
              "timing": timing_source(device), "device": device_name(device)}
    emit(record)
    return record


if __name__ == "__main__":
    main()
