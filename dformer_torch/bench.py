"""Serving throughput of the port (counterpart of the root `bench.py`):
DFormer-Large + LightHamHead at 480x640, batch 8, bf16, weights from seed 0.

    python -m dformer_torch.bench [--skip-train] [--device cuda]

Builds the model with `entry.build`, runs 3 warm-up forwards through
`entry.infer` (labels, as a request gets them) and times 20 more, each
between CUDA events. Prints the headline record as soon as it is known:

    {"metric": "dformer_large_480x640_infer_throughput", "value": img/s,
     "unit": "images/sec/chip", "vs_baseline": value / 60, ...}

from the median forward. The baseline is the root tool's 60 img/s
estimate for DFormer-L fp16 480x640 on one A100 with the reference's
PyTorch stack (`bench.py`'s docstring; `vs_baseline` is null for another
backbone). Unless --skip-train, it then times 20 train steps
(`entry.build_trainer` + `entry.train_steps`, after 3) and prints the
record again with `train_step_ms_bs8` and `train_imgs_per_sec_per_chip`.
With --device cpu (the tests' small runs) the host clock times the calls.
"""

import argparse
import statistics

import numpy as np
import torch

from dformer_torch import entry
from dformer_torch.tools.measure import (call_ms, device_name, emit,
                                         timing_source)

BASELINE_A100_IPS = 60.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--backbone", default="DFormer-Large")
    ap.add_argument("--skip-train", action="store_true",
                    help="headline inference record only")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def inputs(rng, batch: int, hw, device):
    """(rgb, modal_x) [batch, H, W, 3] fp32 drawn from `rng`, on `device`."""
    return tuple(torch.from_numpy(rng.rand(batch, *hw, 3).astype(np.float32))
                 .to(device) for _ in range(2))


def main(argv=None) -> torch.Tensor:
    """Print the records; return the labels of the last timed forward."""
    args = parse_args(argv)
    B, hw, device = args.batch, (args.height, args.width), args.device
    model = entry.build(args.backbone, hw, 40, torch.bfloat16, device,
                        seed=0)
    rng = np.random.RandomState(0)
    rgb, modal = inputs(rng, B, hw, device)
    out = {}

    def forward():
        out["labels"] = entry.infer(model, rgb, modal)

    forward_ms = statistics.median(call_ms(forward, device, args.reps,
                                           args.warmup))
    ips = B / (forward_ms / 1e3)
    slug = args.backbone.lower().replace("dformer-", "dformer_")
    record = {"metric": f"{slug}_{hw[0]}x{hw[1]}_infer_throughput",
              "value": ips, "unit": "images/sec/chip",
              "vs_baseline": (ips / BASELINE_A100_IPS
                              if args.backbone == "DFormer-Large" else None),
              "forward_ms": forward_ms, "batch": B, "dtype": "bfloat16",
              "timing": timing_source(device),
              "device": device_name(device)}
    emit(record)
    if args.skip_train:
        return out["labels"]

    del model
    trainer = entry.build_trainer(args.backbone, hw, 40, torch.bfloat16,
                                  device, seed=0)
    gt = torch.from_numpy(rng.randint(0, 40, (B, *hw))).to(device)
    steps = iter(range(args.warmup + args.reps))

    def step():
        entry.train_steps(*trainer, [(rgb, modal, gt)],
                          first_step=next(steps))

    step_ms = statistics.median(call_ms(step, device, args.reps,
                                        args.warmup))
    record.update(train_step_ms_bs8=step_ms,
                  train_imgs_per_sec_per_chip=B / (step_ms / 1e3))
    emit(record)
    return out["labels"]


if __name__ == "__main__":
    main()
