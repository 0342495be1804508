"""The yardstick's arithmetic: rates, the tail, spreads, the copied bound
functions against `chip_smoke.py`'s at the 8 main-path shapes, the shapes
of every fused-MLP call, the frozen operation counts, and the reduction of
a trace (busy time, spans, idle gaps) on made-up events."""

import statistics

import numpy as np
import pytest

from h100_bench import count_flops, roofline, spec
from h100_bench.readers import is_backward_kernel, is_forward_kernel
from h100_bench.trace import WINDOW, Op, Trace

LARGE = spec.config("dformer_large_nyu")
TRAV = spec.config("dformer_trav_base")


def test_rate_and_tail():
    lat = list(np.linspace(100.0, 120.0, 281))
    assert roofline.p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert roofline.p95([5.0]) == 5.0


def test_spread_uses_python_quartiles():
    values = [100.0, 101.0, 102.0, 103.0, 104.0, 110.0]
    q1, med, q3 = statistics.quantiles(values, n=4)
    assert roofline.spread(values) == pytest.approx((q3 - q1) / med)


def test_bounds_equal_chip_smoke_at_main_path_shapes():
    import chip_smoke

    shapes = sorted(set(roofline.mlp_calls(LARGE, 8, 480, 640)))
    assert len(shapes) == 8
    for shape in shapes:
        for itemsize in (2, 4):
            assert roofline.mlp_bound(*shape, itemsize) == \
                chip_smoke.mlp_bound(*shape, itemsize)
            assert roofline.mlp_bwd_bound(*shape, itemsize) == \
                chip_smoke.mlp_bwd_bound(*shape, itemsize)


def test_bound_sums_match_recorded_figures():
    """PERF.md's bound per bs8 forward and step (0.584, 1.469 ms), per
    MSF + flip batch of 4 (3.36 bf16, 49.58 fp32) and Trav's FSS step of
    12 images (0.512, 1.290)."""
    assert len(roofline.mlp_calls(LARGE, 8, 480, 640)) == 39
    assert len(roofline.mlp_calls(TRAV, 8, 480, 640)) == 39
    fwd = roofline.forward_bound_ms(LARGE, 8, [(480, 640)], "bfloat16")
    assert round(fwd, 3) == 0.584
    bwd = roofline.backward_bound_ms(LARGE, 8, 480, 640, "bfloat16")
    assert round(bwd, 3) == 1.469
    sizes = roofline.msf_sizes(480, 640, LARGE["eval"]["scales"])
    assert round(roofline.forward_bound_ms(LARGE, 4, sizes, "bfloat16", 2),
                 2) == 3.36
    assert round(roofline.forward_bound_ms(LARGE, 4, sizes, "float32", 2),
                 2) == 49.58
    assert round(roofline.forward_bound_ms(TRAV, 12, [(480, 640)],
                                           "bfloat16"), 3) == 0.512
    assert round(roofline.backward_bound_ms(TRAV, 12, 480, 640, "bfloat16"),
                 3) == 1.290


def test_stage_and_msf_sizes():
    assert roofline.stage_sizes(480, 640) == [(120, 160), (60, 80),
                                              (30, 40), (15, 20)]
    assert roofline.msf_sizes(480, 640, [0.5, 0.75, 1.0, 1.25, 1.5]) == [
        (256, 320), (384, 480), (480, 640), (608, 800), (736, 960)]
    assert roofline.stage_sizes(608, 800)[3] == (19, 25)


def test_percentages():
    assert roofline.roofline_pct(1.0, 20.0) == 5.0
    assert roofline.mfu_pct(989e12, 2, 2.0, "bfloat16") == \
        pytest.approx(100.0)


def test_kernel_names():
    assert is_forward_kernel("void (anonymous namespace)::fused_mlp_fwd_mma"
                             "<8, 8, 64, 8>(...)")
    assert is_forward_kernel("layernorm_rows")
    assert is_forward_kernel("reduce_splits_kernel<float>")
    assert not is_forward_kernel("fused_mlp_bwd_reduce")
    assert is_backward_kernel("fused_mlp_bwd_wgrad_mma")
    assert not is_backward_kernel("fused_mlp_fwd_fp32")


@pytest.mark.parametrize("w", spec.benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_frozen_operation_counts(w):
    cfg, tr = spec.config(w["config"]), spec.traffic(w["traffic"])
    assert spec.flops(w["name"])["per_image"] == count_flops.count(cfg, tr)


def test_train_count_is_about_three_forwards():
    cfg = LARGE
    fwd = count_flops.count(cfg, dict(kind="closed_loop", batch=2))
    step = count_flops.count(cfg, dict(kind="train_steps", batch=2))
    assert 2.5 < step / fwd < 3.0


def _trace():
    # window 0..100 us; kernels a (launched in span s) 10..30, b 40..50,
    # a copy 45..60; host op x 0..35 launches a, y 35..70 launches b
    tr = Trace(items=2, window_s=100e-6)
    tr.spans = {WINDOW: [(0.0, 100.0)], "s": [(0.0, 34.0)]}
    tr.host = [Op("x", 0.0, 35.0, id=1), Op("y", 35.0, 70.0, id=2),
               Op("cudaLaunchKernel", 5.0, 6.0, id=9, linked=1)]
    tr.device = [Op("a", 10.0, 30.0, linked=1), Op("b", 40.0, 50.0, linked=2),
                 Op("Memcpy DtoH", 45.0, 60.0, linked=2)]
    return tr


def test_trace_reductions():
    tr = _trace()
    assert tr.busy_intervals() == [(10.0, 30.0), (40.0, 60.0)]
    assert tr.busy_s() == pytest.approx(40e-6)
    assert tr.launches_per_item() == 1.0
    assert tr.span_ms("s") == pytest.approx(20e-3 / 2)
    assert tr.span_ms("missing") is None
    assert tr.device_ms(lambda n: n == "b") == pytest.approx(10e-3 / 2)
    gaps = dict(tr.breakdown()["idle_gaps"])
    # the gap 0..10 has its middle in the launch call (5..6), 30..40 in y
    # (starting at 35), 60..100 (middle 80) under no operation
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["y"] == pytest.approx(10e-6)
    assert gaps["host idle"] == pytest.approx(40e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
    ops = dict(tr.breakdown()["device_ops"])
    assert ops["a"] == pytest.approx(20e-6)
