"""The yardstick's arithmetic: the card's published peaks, the fused-MLP
block's least time (operations and bytes from its shapes), the shapes of
every fused-MLP call a request, step or evaluation group makes, and the
statistics of a run.

The two bound functions are copies of `chip_smoke.py`'s `mlp_bound` and
`mlp_bwd_bound`: LN + fc1 + 3x3 depthwise + GELU + fc2, each input read
once and each output written once, so the count is the block's work
whatever implements it.
"""

import statistics
from typing import Iterable, List, Tuple

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W limit
PEAKS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEMSIZE = {"bfloat16": 2, "float32": 4}


def mlp_bound(B, H, W, C, Ch, itemsize):
    """(bound ms, 'bytes' or 'operations', ops ms, bytes ms) of one
    fused-MLP forward call."""
    n = B * H * W
    flops = 2 * n * C * Ch * 2 + 2 * 9 * n * Ch
    nbytes = 2 * n * C * itemsize + (2 * C * Ch + 9 * Ch) * itemsize \
        + (3 * C + 2 * Ch) * 4
    peak = PEAKS["bfloat16"] if itemsize == 2 else PEAKS["float32"]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def mlp_bwd_bound(B, H, W, C, Ch, itemsize):
    """The same for one fused-MLP backward call: five products and the
    depthwise taps three times over; x and g read, dx written, the weights
    read and their gradients written."""
    n = B * H * W
    flops = 5 * 2 * n * C * Ch + 27 * 2 * n * Ch
    weights = (2 * C * Ch + 9 * Ch) * itemsize
    nbytes = 3 * n * C * itemsize + 2 * weights + (2 * C + 2 * Ch) * 4 \
        + (3 * C + 2 * Ch) * 4
    peak = PEAKS["bfloat16"] if itemsize == 2 else PEAKS["float32"]
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def ceil32(v: int) -> int:
    return -(-v // 32) * 32


def stage_sizes(h: int, w: int) -> List[Tuple[int, int]]:
    """Feature-map sizes of the four stages of an h x w input: the stem's
    two stride-2 convolutions, then one per stage (k 3, pad 1: ceil)."""
    out = []
    for i in range(4):
        for _ in range(2 if i == 0 else 1):
            h, w = -(-h // 2), -(-w // 2)
        out.append((h, w))
    return out


def mlp_calls(cfg: dict, batch: int, h: int, w: int
              ) -> List[Tuple[int, int, int, int, int]]:
    """(B, H, W, C, Ch) of every fused-MLP call of one forward: each
    block's RGB MLP and, but in the block that drops the depth stream, its
    depth MLP at half the width."""
    calls = []
    sizes = stage_sizes(h, w)
    for i, depth in enumerate(cfg["depths"]):
        C, r = cfg["dims"][i], cfg["mlp_ratios"][i]
        H, W = sizes[i]
        for j in range(depth):
            calls.append((batch, H, W, C, C * r))
            if not (i == 3 and j == depth - 1):
                calls.append((batch, H, W, C // 2, C // 2 * r))
    return calls


def msf_sizes(h: int, w: int, scales: Iterable[float]) -> List[Tuple[int, int]]:
    """The input size of each scale of a multi-scale evaluation."""
    return [(ceil32(int(s * h)), ceil32(int(s * w))) for s in scales]


def forward_bound_ms(cfg: dict, batch: int, sizes, dtype: str,
                     passes: int = 1) -> float:
    """Least fused-MLP forward ms of `passes` forwards at each size."""
    return passes * sum(mlp_bound(*c, ITEMSIZE[dtype])[0]
                        for h, w in sizes for c in mlp_calls(cfg, batch, h, w))


def backward_bound_ms(cfg: dict, batch: int, h: int, w: int,
                      dtype: str) -> float:
    return sum(mlp_bwd_bound(*c, ITEMSIZE[dtype])[0]
               for c in mlp_calls(cfg, batch, h, w))


# ---- statistics of a run ----

def p95(values: List[float]) -> float:
    """95th percentile, linear between order statistics (numpy's default,
    `statistics.quantiles(method="inclusive")`)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def spread(values: List[float]) -> float:
    """Distance between the first and third quartile as a share of the
    median (`statistics.quantiles(values, n=4)`)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def roofline_pct(bound_ms: float, measured_ms: float) -> float:
    return 100.0 * bound_ms / measured_ms


def mfu_pct(flops_per_image: float, images: int, seconds: float,
            dtype: str) -> float:
    return 100.0 * flops_per_image * images / seconds / PEAKS[dtype]
