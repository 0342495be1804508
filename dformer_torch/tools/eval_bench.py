"""Evaluation throughput (counterpart of `tools/eval_bench.py`): ms per image
of multi-scale + flip evaluation, or of MSF with the sliding window, or of
single-scale evaluation, on DFormer-Base / NYUDepthv2 by default (bf16,
weights from seed 0).

    python -m dformer_torch.tools.eval_bench [--config=...] [--batch 4] \\
        [--nbatches 8] [--sliding | --single-scale] [--ops] [--device cuda]

The port's `Evaluator` runs on random batches made on the device; the
scales are the config's `eval_scale_array`, or [0.5, 0.75, 1, 1.25, 1.5]
when it holds one scale. One batch warms up, then `--nbatches` are timed
on the host clock, ending in a synchronise. --ops traces the timed batches
with torch.profiler and adds the kernels with the most device time. Prints
one JSON line.
"""

import argparse
import contextlib
import time

import torch

from dformer_torch.tools.eval import MSF_SCALES
from dformer_torch.tools.measure import (device_name, emit, kernel_rows,
                                         synchronize)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.NYUDepthv2.DFormer_Base")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--nbatches", type=int, default=8)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--sliding", action="store_true")
    mode.add_argument("--single-scale", action="store_true",
                      help="time plain `evaluate` instead of MSF")
    ap.add_argument("--ops", action="store_true",
                    help="add the top kernels of a torch.profiler trace")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.eval.evaluate import Evaluator

    args = parse_args(argv)
    cfg = load_config(args.config)
    device = args.device
    H, W = cfg.image_height, cfg.image_width
    model = entry.build(cfg.backbone, (H, W), cfg.num_classes,
                        torch.bfloat16, device, seed=0, decoder=cfg.decoder,
                        aux_rate=cfg.aux_rate)
    ev = Evaluator(model, cfg, sliding=args.sliding, device=device)
    scales = list(cfg.get("eval_scale_array", ()) or ())
    if len(scales) <= 1:
        scales = MSF_SCALES
    gen = torch.Generator(device=device).manual_seed(0)

    def mk_batch():
        return dict(
            rgb=torch.rand((args.batch, H, W, 3), generator=gen,
                           device=device),
            modal_x=torch.rand((args.batch, H, W, 3), generator=gen,
                               device=device),
            gt=torch.randint(0, cfg.num_classes, (args.batch, H, W),
                             generator=gen, device=device))

    def run(batches):
        if args.single_scale:
            return ev.evaluate(batches)
        return ev.evaluate_msf(batches, scales=scales, flip=True)

    mode = ("single-scale" if args.single_scale else
            "MSF+sliding" if args.sliding else "MSF+flip")
    t0 = time.perf_counter()
    run([mk_batch()])
    synchronize(device)
    first_s = time.perf_counter() - t0

    batches = [mk_batch() for _ in range(args.nbatches)]
    synchronize(device)
    trace = contextlib.nullcontext()
    if args.ops:
        from torch.profiler import ProfilerActivity, profile

        trace = profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA])
    with trace as prof:
        t0 = time.perf_counter()
        run(batches)
        synchronize(device)
        seconds = time.perf_counter() - t0
    imgs = args.nbatches * args.batch
    record = {"tool": "eval_bench", "config": args.config,
              "backbone": cfg.backbone, "decoder": cfg.decoder,
              "mode": mode,
              "scales": None if args.single_scale else scales,
              "batch": args.batch, "hw": [H, W], "dtype": "bfloat16",
              "images": imgs, "seconds": seconds,
              "ms_per_image": 1e3 * seconds / imgs,
              "img_per_s": imgs / seconds, "first_batch_s": first_s,
              "timing": "host clock, synchronised",
              "device": device_name(device)}
    if prof is not None:
        record["top"] = [{"ms": ms, "calls": n, "name": name[:90]} for
                         ms, n, name in kernel_rows(prof, args.nbatches)[:25]]
    emit(record)
    return record


if __name__ == "__main__":
    main()
