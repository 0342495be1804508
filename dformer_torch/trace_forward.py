"""Where the time of one served batch, one train step or one eval batch goes
on the card.

    python -m dformer_torch.trace_forward [--train | --eval] [--decoder ham] [--out DIR]

Builds DFormer-Large + the `--decoder` head (ham, MLPDecoder, UPernet,
deeplabv3+, nl; bf16, 480x640, weights from seed 0), warms up, then traces
10 forwards of a batch of 8 (the main path's), or with --train 3 train
steps on it, or with --eval 2 multi-scale + flip evaluations (scales
0.5-1.5) of one NYUDepthv2 val batch of 4 synthetic images already on the
card, with torch.profiler and prints one JSON line: host ms per forward
(or step, or eval batch) under the profiler, device kernel ms (sum of the
durations of the profiler's kernel events), the device idle share (1 -
kernel time / wall time), the fused-MLP kernels' share, and the kernels
with the most device time. With --out, also writes the Chrome trace there.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dformer_torch import entry
from dformer_torch.tools.measure import kernel_rows

BATCH = 8
DECODERS = ("ham", "MLPDecoder", "UPernet", "deeplabv3+", "nl")


def trace(mode: str = "forward", decoder: str = "ham", out=None,
          reps=None) -> dict:
    """Trace `mode` ("forward", "train" or "eval") with the `decoder` head
    on the card, over `reps` runs after 3 untraced ones (default 10
    forwards, 3 steps, 2 MSF batches); returns the JSON line's record."""
    batch_size = BATCH
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(BATCH, 480, 640, 3)
                           .astype(np.float32)).cuda()
    depth = torch.from_numpy(rng.rand(BATCH, 480, 640, 3)
                             .astype(np.float32)).cuda()
    if mode == "train":
        trainer = entry.build_trainer("DFormer-Large", (480, 640), 40,
                                      torch.bfloat16, "cuda", seed=0,
                                      decoder=decoder)
        gt = torch.from_numpy(rng.randint(0, 40, (BATCH, 480, 640))).cuda()
        steps = iter(range(100))
        default_reps, what = 3, "step"

        def run():
            entry.train_steps(*trainer, [(rgb, depth, gt)],
                              first_step=next(steps))
    elif mode == "eval":
        from dformer_torch.configs import load_config
        from dformer_torch.tools.eval import MSF_SCALES

        batch_size = 4
        cfg = load_config("local_configs.NYUDepthv2.DFormer_Large")
        cfg.decoder = decoder
        ev, batches = entry.build_evaluator(
            cfg, torch.bfloat16, "cuda", seed=0, val_batch_size=batch_size,
            synthetic=True, n=batch_size)
        batch = next(iter(batches))
        default_reps, what = 2, "msf_flip_batch"

        def run():
            ev.evaluate_msf([batch], MSF_SCALES, flip=cfg.eval_flip)
    else:
        model = entry.build("DFormer-Large", (480, 640), 40, torch.bfloat16,
                            "cuda", seed=0, decoder=decoder)
        default_reps, what = 10, "forward"

        def run():
            entry.infer(model, rgb, depth)

    reps = reps or default_reps
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    if out:
        prof.export_chrome_trace(f"{out}/{decoder}_{what}_trace.json")

    rows = kernel_rows(prof, reps)
    kernel_ms = sum(ms for ms, _, _ in rows)
    mlp_ms = sum(ms for ms, _, key in rows if "fused_mlp" in key
                 or "reduce_splits" in key or "layernorm_rows" in key)
    mlp_bwd_ms = sum(ms for ms, _, key in rows if "fused_mlp_bwd" in key)
    return {"decoder": decoder, "batch": batch_size,
            f"host_ms_per_{what}": wall_ms,
            f"device_kernel_ms_per_{what}": kernel_ms,
            "device_idle_share": 1.0 - kernel_ms / wall_ms,
            f"fused_mlp_ms_per_{what}": mlp_ms,
            f"fused_mlp_bwd_ms_per_{what}": mlp_bwd_ms,
            "top": [{"ms": ms, "calls": n, "name": key[:90]}
                    for ms, n, key in rows[:25]],
            "card": torch.cuda.get_device_name(0)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--decoder", default="ham", choices=DECODERS)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="trace train steps instead of served forwards")
    mode.add_argument("--eval", action="store_true",
                      help="trace multi-scale + flip eval of a val batch")
    args = ap.parse_args(argv)
    mode = "train" if args.train else "eval" if args.eval else "forward"
    print(json.dumps(trace(mode, args.decoder, args.out)), flush=True)


if __name__ == "__main__":
    main()
