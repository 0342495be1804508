"""Run one cell of the benchmark once.

    python3 -m h100_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up builds the program and warms up every
shape the cell uses; then the window: requests, steps or groups one after
the other until `--seconds` have passed, each ending on the host. With
`--trace 1` a few more items run under the profiler. Then the peak memory
is read, the program's state is freed and the reference checks what the
timed path produced. The last line of standard output is the result; the
compared numbers, each beside its limit, are the last lines of standard
error and the result's last key.

Exits 2 without a CUDA card (or with fewer than the cell asks for), 3 if
JAX or the JAX package was loaded, and prints no result then.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "dformer_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux), 0 if unknown."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = process_age()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root) -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    base = os.path.join(root, ".bench_cache")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(base, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(base, "torch_extensions"))


def power_limit() -> float:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def window(run, cell, seconds: float) -> None:
    """Items one after the other until `seconds` have passed."""
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        run.images += cell.item()
        end = time.perf_counter()
        run.latencies_ms.append((end - t) * 1e3)
        run.items += 1
        if end - t0 >= seconds:
            break
    run.window_s = end - t0


def execute(run, cell, seconds: float, traced: bool, device,
            age0: float = 0.0):
    """Set-up, window, traced items, peak memory, check. Returns (checks,
    peak bytes). `age0`: the process's age when this module was loaded."""
    import torch

    from h100_bench import trace as tracing

    cell.setup()
    run.build_s, run.warmup_s = cell.build_s, cell.warmup_s
    run.setup_s = time.perf_counter() - T0 + age0
    window(run, cell, seconds)
    if traced:
        n = run.traffic["traced_items"]
        with tracing.ModuleSpans(cell.spans()):
            run.trace = tracing.capture(lambda: cell.item(record=False), n,
                                        device, units=n * cell.per_item)
    peak = torch.cuda.max_memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0
    cell.finish()
    return cell.check(), peak


def verdict(checks: dict, limits: dict):
    """(correct, {name: {"value", "limit"}} of the compared numbers):
    every limit's number present, finite and at or under it. Numbers
    without a limit are for a look only and are not shown."""
    out, ok = {}, True
    for name, value in checks.items():
        if name not in limits:
            continue
        lim = limits[name]
        finite = math.isfinite(value)
        out[name] = {"value": value if finite else repr(value), "limit": lim}
        ok = ok and finite and value <= lim
    missing = set(limits) - set(checks)
    return ok and not missing, out


def report(bench, run) -> dict:
    from h100_bench import spec

    metrics = {}
    for m in spec.metrics_of(bench, run.workload, run.trace is not None):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return metrics


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from h100_bench import spec

    bench = spec.benchmark()
    wl = spec.workload(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload}: needs {wl['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    cache_dirs(str(spec.ROOT))
    from h100_bench.record import Run

    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    run = Run(args.workload, cfg, tr, spec.flops(args.workload))
    cell = importlib.import_module(f"h100_bench.cells.{tr['kind']}").Cell(
        cfg, tr, args.seed, "cuda")
    checks, peak = execute(run, cell, args.seconds, bool(args.trace), "cuda",
                           AGE0)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    correct, shown = verdict(checks, tr["limits"])
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": wl["chips"], "memory_peak_bytes": int(peak),
              "power_limit_w": power_limit()}
    result = {"correct": correct, "attempted": run.items, "failed": 0,
              "metrics": report(bench, run), "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = shown
    print(json.dumps(result), flush=True)
    for name, c in shown.items():
        ok = isinstance(c["value"], float) and c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
