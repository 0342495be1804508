"""Inference latency (counterpart of `tools/latency.py`): the config's model
at batch 1, 480x640, bf16 unless --no-amp, weights from seed 0.

    python -m dformer_torch.tools.latency [--config=...] [--batch 1] \\
        [--height 480 --width 640] [--warmup 20] [--reps 100] [--device cuda]

Each of `--reps` forwards through `entry.infer`, after `--warmup`, is
timed between CUDA events (the host clock with --device cpu). Prints one
JSON line with avg / p50 / p90 ms.
"""

import argparse

import numpy as np
import torch

from dformer_torch import entry
from dformer_torch.tools.measure import (call_ms, device_name, emit,
                                         timing_source)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.NYUDepthv2.DFormer_Large")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--reps", type=int, default=100)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    cfg = load_config(args.config)
    hw = (args.height, args.width)
    model = entry.build(cfg.backbone, hw, cfg.num_classes,
                        torch.bfloat16 if args.amp else None, args.device,
                        seed=0, decoder=cfg.decoder, aux_rate=cfg.aux_rate)
    rgb = torch.from_numpy(np.random.RandomState(0).rand(
        args.batch, *hw, 3).astype(np.float32)).to(args.device)
    times = call_ms(lambda: entry.infer(model, rgb, rgb), args.device,
                    args.reps, args.warmup)
    record = {"tool": "latency", "config": args.config,
              "backbone": cfg.backbone, "decoder": cfg.decoder,
              "batch": args.batch, "hw": list(hw),
              "dtype": "bfloat16" if args.amp else "float32",
              "reps": args.reps, "avg_ms": float(np.mean(times)),
              "p50_ms": float(np.percentile(times, 50)),
              "p90_ms": float(np.percentile(times, 90)),
              "timing": timing_source(args.device),
              "device": device_name(args.device)}
    emit(record)
    return record


if __name__ == "__main__":
    main()
