"""Parameter count and FLOPs of one forward (counterpart of
`tools/benchmark.py`, which reads XLA's cost analysis).

    python -m dformer_torch.tools.benchmark [--config=...] [--height 480 --width 640]

Builds the config's model in fp32 on the CPU and counts the FLOPs of one
1x480x640 forward in eval mode with `torch.utils.flop_counter.
FlopCounterMode` (2 per multiply-add of the matmuls, convolutions and
batched products; elementwise work is not counted). The count runs on the
CPU, where the fused MLP is its plain PyTorch version: the counter cannot
see a kernel launched through ctypes, so on the card it would miss every
MLP product. Prints one JSON line.
"""

import argparse

import torch
from torch.utils.flop_counter import FlopCounterMode

from dformer_torch.tools.measure import emit


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.NYUDepthv2.DFormer_Large")
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from dformer_torch.configs import load_config
    from dformer_torch.models.builder import build_model

    args = parse_args(argv)
    cfg = load_config(args.config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = build_model(cfg, device="cpu").eval()
    n_params = sum(p.numel() for p in model.parameters())
    x = torch.zeros(1, args.height, args.width, 3)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x, x)
    record = {"tool": "benchmark", "config": args.config,
              "backbone": cfg.backbone, "decoder": cfg.decoder,
              "hw": [args.height, args.width], "params": n_params,
              "params_m": n_params / 1e6,
              "flops": counter.get_total_flops(),
              "gflops": counter.get_total_flops() / 1e9,
              "counted_on": "cpu, fp32, the fused MLP's plain version "
                            "(FlopCounterMode)"}
    emit(record)
    return record


if __name__ == "__main__":
    main()
