"""What the port's measurement tools share: the device's name and the
per-call timing rule.

On the card a call is timed by CUDA events recorded around it, after a
warm-up, so the time is the card's; on the CPU (the tests' small runs) by
the host clock. Each tool's JSON line names the device and the timing
source, so that a CPU number is never read as the card's.
"""

import json
import time
from typing import Callable, List, Tuple

import torch


def device_name(device) -> str:
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def timing_source(device) -> str:
    return "cuda events" if torch.device(device).type == "cuda" \
        else "host clock"


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def call_ms(fn: Callable[[], object], device, reps: int, warmup: int
            ) -> List[float]:
    """Milliseconds of each of `reps` calls of `fn`, after `warmup` calls."""
    for _ in range(warmup):
        fn()
    synchronize(device)
    if torch.device(device).type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return times
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return [start.elapsed_time(end) for start, end in events]


def kernel_rows(prof, reps: int) -> List[Tuple[float, int, str]]:
    """(ms, calls, name) per one of `reps` repeats of each kernel in a
    torch.profiler trace, most device time first. Kernel events are those
    on the CUDA device; user annotations (the optimizer step's range) are
    spans, not kernels."""
    per_kernel = {}
    for ev in prof.events():
        if (ev.device_type == torch.autograd.DeviceType.CUDA
                and not ev.is_user_annotation):
            ms, n = per_kernel.get(ev.name, (0.0, 0))
            per_kernel[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3,
                                   n + 1)
    return sorted(((ms / reps, n // reps, name)
                   for name, (ms, n) in per_kernel.items()), reverse=True)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)
