"""The traced part of a run: a few requests, steps or groups under
`torch.profiler`, reduced to what the per-layer metrics read.

`capture` runs the items inside a span named `WINDOW` and returns a
`Trace`. From the profiler's events it keeps the device's operations
(kernels, copies and fills, not the device-side copies of user spans),
the host's operations and the host spans. A kernel belongs to a host span
when the host operation that launched it (its linked correlation) started
inside the span; a kernel without a linked operation falls back to the
device-side copy of the span.
"""

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "bench.window"


@dataclass
class Op:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float
    id: int = 0
    linked: int = 0


@dataclass
class Trace:
    items: int                      # requests, steps or groups traced
    window_s: float                 # host clock around them
    device: List[Op] = field(default_factory=list)    # kernels and copies
    host: List[Op] = field(default_factory=list)      # host operations
    spans: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    device_spans: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)

    # ---- reductions ----

    def window(self) -> Tuple[float, float]:
        """The traced window on the profiler's clock."""
        ivs = self.spans.get(WINDOW)
        if ivs:
            return ivs[0]
        if not self.device:
            return 0.0, 0.0
        return (min(o.start for o in self.device),
                max(o.end for o in self.device))

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """Union of the device operations' intervals inside the window."""
        lo, hi = self.window()
        ivs = sorted((max(o.start, lo), min(o.end, hi)) for o in self.device
                     if o.end > lo and o.start < hi)
        out: List[Tuple[float, float]] = []
        for a, b in ivs:
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def kernels(self) -> List[Op]:
        return [o for o in self.device if not is_copy(o.name)]

    def launches_per_item(self) -> float:
        return len(self.kernels()) / self.items

    def device_ms(self, match: Callable[[str], bool]) -> float:
        """Device milliseconds per item of the kernels whose name matches."""
        return sum(o.end - o.start for o in self.device
                   if match(o.name)) / 1e3 / self.items

    def span_ms(self, span: str) -> Optional[float]:
        """Device milliseconds per item of the kernels launched inside the
        host span `span`; None when the span is not in the trace."""
        cpu = sorted(self.spans.get(span, []))
        gpu = sorted(self.device_spans.get(span, []))
        if not cpu and not gpu:
            return None
        # the launching operations: host operations with no link of their
        # own (a runtime call links to the operation that made it)
        starts = {o.id: o.start for o in self.host if not o.linked}
        total = 0.0
        for o in self.kernels():
            t = starts.get(o.linked) if o.linked else None
            ivs = cpu if t is not None else gpu
            if t is None:
                t = o.start
            if _inside(ivs, t):
                total += o.end - o.start
        return total / 1e3 / self.items

    def breakdown(self, top: int = 10) -> dict:
        """The device operations with the most time, and the device's idle
        gaps summed by the innermost host operation running at each gap's
        middle ("host idle" where none ran), in seconds."""
        ops: Dict[str, float] = {}
        for o in self.device:
            ops[o.name] = ops.get(o.name, 0.0) + (o.end - o.start) / 1e6
        host = sorted(self.host, key=lambda o: o.start)
        starts = [o.start for o in host]
        gaps: Dict[str, float] = {}
        lo, hi = self.window()
        edges = [lo]
        for a, b in self.busy_intervals():
            edges += [a, b]
        edges.append(hi)
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            name = _innermost(host, starts, (a + b) / 2) or "host idle"
            gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

        def rank(d):
            return [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:top]]
        return {"device_ops": rank(ops), "idle_gaps": rank(gaps)}


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def _inside(ivs, t) -> bool:
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= t <= ivs[i][1]


def _innermost(host, starts, t, lookback: int = 512) -> Optional[str]:
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - lookback, -1), -1):
        if host[j].end >= t:
            return host[j].name
    return None


def from_profiler(prof, items: int, window_s: float) -> Trace:
    """A `Trace` of the events of a finished `torch.profiler.profile`."""
    cuda = torch.autograd.DeviceType.CUDA
    tr = Trace(items=items, window_s=window_s)
    for ev in prof.events():
        op = Op(ev.name, ev.time_range.start, ev.time_range.end, ev.id,
                getattr(ev, "linked_correlation_id", 0) or 0)
        span = bool(getattr(ev, "is_user_annotation", False))
        if ev.device_type == cuda:
            if span:
                tr.device_spans.setdefault(ev.name, []).append(
                    (op.start, op.end))
            else:
                tr.device.append(op)
        elif span:
            tr.spans.setdefault(ev.name, []).append((op.start, op.end))
        else:
            tr.host.append(op)
    if tr.spans.get(WINDOW):
        lo, hi = tr.spans[WINDOW][0]
        tr.window_s = (hi - lo) / 1e6  # the clock the device's times are on
    return tr


def capture(run_item: Callable[[], None], items: int, device,
            units: int = None) -> Trace:
    """Run `run_item` `items` times under the profiler, inside the span
    `WINDOW`, with the device idle before and synchronised after. The
    trace's per-item numbers are per unit: `units` requests, steps or
    groups in all (`items` if not given)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            for _ in range(items):
                run_item()
            torch.cuda.synchronize(device)
            window_s = time.perf_counter() - t0
    return from_profiler(prof, units or items, window_s)


class ModuleSpans:
    """Host spans named by the caller around the forward of given modules
    (forward hooks), for the traced part of a run only."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.modules = modules
        self.handles = []
        self.open = {}

    def __enter__(self):
        from torch.profiler import record_function

        for name, mod in self.modules.items():
            def pre(_m, _a, name=name):
                rf = record_function(name)
                rf.__enter__()
                self.open[name] = rf

            def post(_m, _a, _o, name=name):
                self.open.pop(name).__exit__(None, None, None)
            self.handles += [mod.register_forward_pre_hook(pre),
                             mod.register_forward_hook(post)]
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        self.handles = []
