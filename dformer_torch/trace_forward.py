"""Where the time of one served batch, or of one train step, goes on the card.

    python -m dformer_torch.trace_forward [--train] [--out DIR]

Builds DFormer-Large + LightHamHead (bf16, 480x640, weights from seed 0),
warms up, then traces 10 forwards of a batch of 8 (the main path's), or
with --train 3 train steps on it, with torch.profiler and prints one JSON
line: host ms per forward (or step) under the profiler, device kernel ms
(sum of the durations of the profiler's kernel events), the device idle
share (1 - kernel time / wall time), the fused-MLP kernels' share, and the
kernels with the most device time. With --out, also writes the Chrome trace
there.
"""

import argparse
import json
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from dformer_torch import entry

BATCH = 8


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--train", action="store_true",
                    help="trace train steps instead of served forwards")
    args = ap.parse_args()

    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(BATCH, 480, 640, 3)
                           .astype(np.float32)).cuda()
    depth = torch.from_numpy(rng.rand(BATCH, 480, 640, 3)
                             .astype(np.float32)).cuda()
    if args.train:
        trainer = entry.build_trainer("DFormer-Large", (480, 640), 40,
                                      torch.bfloat16, "cuda", seed=0)
        gt = torch.from_numpy(rng.randint(0, 40, (BATCH, 480, 640))).cuda()
        steps = iter(range(100))
        reps, what = 3, "step"

        def run():
            entry.train_steps(*trainer, [(rgb, depth, gt)],
                              first_step=next(steps))
    else:
        model = entry.build("DFormer-Large", (480, 640), 40, torch.bfloat16,
                            "cuda", seed=0)
        reps, what = 10, "forward"

        def run():
            entry.infer(model, rgb, depth)

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
    if args.out:
        prof.export_chrome_trace(f"{args.out}/{what}_trace.json")

    # kernel events: device_type CUDA, duration = their time on the card;
    # user annotations (the optimizer step's range) are spans, not kernels
    per_kernel = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.is_user_annotation):
            ms, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3,
                                   n + 1)
    rows = sorted(((ms / reps, n // reps, name)
                   for name, (ms, n) in per_kernel.items()), reverse=True)
    kernel_ms = sum(ms for ms, _, _ in rows)
    mlp_ms = sum(ms for ms, _, key in rows if "fused_mlp" in key
                 or "reduce_splits" in key or "layernorm_rows" in key)
    mlp_bwd_ms = sum(ms for ms, _, key in rows if "fused_mlp_bwd" in key)
    print(json.dumps({
        "batch": BATCH, f"host_ms_per_{what}": wall_ms,
        f"device_kernel_ms_per_{what}": kernel_ms,
        "device_idle_share": 1.0 - kernel_ms / wall_ms,
        f"fused_mlp_ms_per_{what}": mlp_ms,
        f"fused_mlp_bwd_ms_per_{what}": mlp_bwd_ms,
        "top": [{"ms": ms, "calls": n, "name": key[:90]}
                for ms, n, key in rows[:25]],
        "card": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
