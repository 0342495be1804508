"""The CUDA forward kernel's parts that can be checked without a card: its
GELU polynomial (read from the source) against the JAX package's, which the
TPU kernel uses, and its launch plan. The kernel itself is held against the
plain version in tests/test_torch_cuda.py and chip_smoke.py."""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dformer_torch.kernels import fused_mlp as tfm
from dformer_torch.kernels.fused_mlp import (forward_plan, forward_tile_cols,
                                             fused_mlp_reference)
from dformer_torch.models.encoder import VARIANTS
from dformer_tpu.ops.activations import _ERF_COEF, poly_gelu

# (B, H, W, C, ratio) of the forward card tests (tests/test_torch_cuda.py
# SHAPES; that file imports no JAX, so the list is kept here too): every
# width the four variants use, with their stages' ratios, ragged small maps,
# and a half-full last chunk
FWD_CARD_SHAPES = [
    (2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (2, 15, 20, 576, 4),
    (2, 24, 32, 16, 8), (2, 24, 32, 32, 8), (2, 12, 16, 64, 8),
    (1, 9, 11, 64, 4), (1, 12, 16, 128, 8), (1, 10, 9, 128, 4),
    (1, 10, 9, 144, 4), (2, 12, 16, 192, 8), (1, 15, 20, 256, 4),
    (1, 10, 9, 288, 4), (1, 8, 10, 512, 4), (1, 9, 11, 32, 3)]

SOURCE = (Path(__file__).resolve().parents[1] / "dformer_torch" / "kernels"
          / "csrc" / "fused_mlp_fwd.cu")


def _kernel_poly():
    """(coefficients, clamp) of the bf16 kernel's erf, from its source."""
    text = SOURCE.read_text()
    table = re.search(r"kErfCoef\[7\]\s*=\s*\{([^}]*)\}", text).group(1)
    coef = [float(v.strip().rstrip("f")) for v in table.split(",")
            if v.strip()]
    clamp = float(re.search(r"kErfClamp\s*=\s*([0-9.eE+-]+)f", text)
                  .group(1))
    return coef, clamp


def test_kernel_gelu_polynomial_is_the_tpu_kernels():
    coef, clamp = _kernel_poly()
    # the same seven coefficients, to the last bit of fp32, and the same
    # clamp as dformer_tpu/ops/activations.py::poly_erf
    np.testing.assert_array_equal(np.float32(coef), np.float32(_ERF_COEF))
    assert clamp == 2.5
    # the kernel's formula, replayed in fp32 numpy, against poly_gelu
    h = np.linspace(-6, 6, 4001, dtype=np.float32)
    x = np.clip(h * np.float32(0.7071067811865476), -clamp, clamp)
    t = x * x
    p = np.float32(coef[-1])
    for c in coef[-2::-1]:
        p = p * t + np.float32(c)
    got = np.float32(0.5) * h * (np.float32(1) + x * p)
    want = np.asarray(poly_gelu(jnp.asarray(h)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


# ---------------------------------------------------------------- plan ---
# The CUDA forward's launch plan (kernels/fused_mlp.py::forward_plan): its
# decomposition into halo tiles and hidden splits, replayed in plain
# PyTorch, and its coverage of every pixel and hidden channel.

def _replay_forward_plan(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                         fc2_b, plan, eps=1e-6):
    """The forward as the kernel cuts it, in fp32: per TH x 8 tile with its
    1-px halo (h zeroed outside the image), per split of hidden chunks, an
    fp32 partial sum of fc2; the splits added in order, then fc2_b."""
    B, H, W, C = x.shape
    Ch = fc1_w.shape[1]
    th, tw = plan.tile_rows, plan.tile_cols
    y = F.layer_norm(x, (C,), ln_w, ln_b, eps)
    part = torch.zeros(plan.nsplit, B, H, W, C)
    taps = pos_w.permute(2, 0, 1).unsqueeze(1)  # [Ch, 1, 3, 3]
    for b, ti, tj in itertools.product(range(B), range(plan.tiles_h),
                                       range(plan.tiles_w)):
        r0, c0 = ti * th, tj * tw
        rows = torch.arange(r0 - 1, r0 + th + 1)
        cols = torch.arange(c0 - 1, c0 + tw + 1)
        valid = (((rows >= 0) & (rows < H))[:, None]
                 & ((cols >= 0) & (cols < W))[None, :])
        halo = y[b, rows.clamp(0, H - 1)][:, cols.clamp(0, W - 1)]
        out_r, out_c = min(th, H - r0), min(tw, W - c0)
        for s in range(plan.nsplit):
            lo = s * plan.chunks_per_split * plan.chunk
            hi = min(Ch, lo + plan.chunks_per_split * plan.chunk)
            for k0 in range(lo, hi, plan.chunk):
                k1 = min(k0 + plan.chunk, hi)
                h = (halo @ fc1_w[:, k0:k1] + fc1_b[k0:k1]) \
                    * valid[..., None]
                conv = F.conv2d(h.permute(2, 0, 1)[None], taps[k0:k1],
                                groups=k1 - k0)[0].permute(1, 2, 0)
                g = F.gelu(conv + pos_b[k0:k1] + h[1:-1, 1:-1])
                part[s, b, r0:r0 + out_r, c0:c0 + out_c] += \
                    (g @ fc2_w[k0:k1])[:out_r, :out_c]
    return part.sum(0) + fc2_b


@pytest.mark.parametrize("shape,tile_rows,tile_cols,chunk", [
    ((1, 7, 13, 48, 8), 8, 8, 64),    # ragged tiles, six splits
    ((2, 9, 19, 32, 3), 8, 16, 64),   # Ch = 96: the last chunk half full
    ((1, 5, 9, 64, 4), 4, 8, 32)])    # the wide-C tile shape
def test_forward_plan_decomposition_matches_reference(shape, tile_rows,
                                                      tile_cols, chunk):
    B, H, W, C, r = shape
    rng = np.random.RandomState(5)
    Ch = C * r
    x = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32))
    ps = [torch.from_numpy((rng.randn(*s) * 0.2).astype(np.float32)) for s
          in [(C,), (C,), (C, Ch), (Ch,), (3, 3, Ch), (Ch,), (Ch, C), (C,)]]
    ps[0] += 1.0
    plan = forward_plan(B, H, W, C, Ch, tile_rows, tile_cols, chunk, 1, 132)
    assert plan.nsplit > 1 and (H % tile_rows or W % tile_cols)
    got = _replay_forward_plan(x, *ps, plan)
    want = fused_mlp_reference(x, *ps)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-5 * max(want.abs().max().item(), 1.0))


def _main_path_shapes():
    """(B, H, W, C, Ch) of every fused-MLP call of DFormer-Large at bs8,
    480x640: mlp and mlp_e2 of each stage."""
    spec = VARIANTS["DFormer-Large"]
    out = []
    for i in range(4):
        h, w = 480 // (4 * 2 ** i), 640 // (4 * 2 ** i)
        c, r = spec["dims"][i], spec["mlp_ratios"][i]
        out += [(8, h, w, c, c * r), (8, h, w, c // 2, c // 2 * r)]
    return out


# the 8 main-path shapes and the card tests' forward shapes
# (tests/test_torch_cuda.py)
PLAN_SHAPES = _main_path_shapes() + [
    (B, H, W, C, C * r) for B, H, W, C, r in FWD_CARD_SHAPES]


@pytest.mark.parametrize("tile_rows,tile_cols,chunk",
                         [(8, 16, 64), (8, 8, 64), (4, 8, 32), (8, 8, 32)])
def test_forward_plan_covers_every_pixel_and_channel_once(tile_rows,
                                                          tile_cols, chunk):
    """At each tile shape and chunk the kernels have, one or two blocks per
    SM, and the SM counts of an H100 SXM (132) and PCIe (114)."""
    for (B, H, W, C, Ch), blocks, sms in itertools.product(
            PLAN_SHAPES, (1, 2), (132, 114)):
        plan = forward_plan(B, H, W, C, Ch, tile_rows, tile_cols, chunk,
                            blocks, sms)
        assert (plan.tile_rows, plan.tile_cols, plan.chunk) == \
            (tile_rows, tile_cols, chunk)
        count = np.zeros(H, np.int64)
        for r0 in range(0, plan.tiles_h * tile_rows, tile_rows):
            assert r0 < H
            count[r0:r0 + tile_rows] += 1
        assert (count == 1).all()
        count = np.zeros(W, np.int64)
        for c0 in range(0, plan.tiles_w * tile_cols, tile_cols):
            assert c0 < W
            count[c0:c0 + tile_cols] += 1
        assert (count == 1).all()
        # every split holds at least one chunk; together all of Ch once
        span = plan.chunks_per_split * chunk
        count = np.zeros(Ch, np.int64)
        for lo in range(0, plan.nsplit * span, span):
            assert lo < Ch
            count[lo:lo + span] += 1
        assert (count == 1).all()
        assert B * plan.nsplit <= 65535  # the C entry point's grid limit


def test_forward_tile_cols_computes_the_fewest_halo_columns():
    # DFormer-Large's map widths at 480x640: 16-wide tiles where they divide
    # the map (160, 80), 8-wide where 16 would leave a ragged tile (40, 20)
    assert [forward_tile_cols(W, 16) for W in (160, 80, 40, 20)] == \
        [16, 16, 8, 8]
    assert forward_tile_cols(13, 16) == 16 and forward_tile_cols(8, 16) == 8
    assert all(forward_tile_cols(W, 8) == 8 for W in range(1, 200))
    for W in range(1, 200):
        cols = forward_tile_cols(W, 16)
        assert -(-W // cols) * (cols + 2) <= min(-(-W // 8) * 10,
                                                 -(-W // 16) * 18)
