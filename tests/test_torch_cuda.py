"""The port's CUDA kernels (fused-MLP forward and backward) against their
plain PyTorch versions, on the card, and the card's runs of the model, the
evaluation and the train augmentation against the CPU's.

Imports no JAX, so that it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test skips where torch sees no CUDA card (the kernels have no CPU
mode).
"""

import numpy as np
import pytest
import torch

from dformer_torch import entry
from dformer_torch.data.augment import (apply_train_augment,
                                        train_augment_draws)
from dformer_torch.kernels.fused_mlp import (card_forward_plan, forward_plan,
                                             fused_mlp,
                                             fused_mlp_backward_reference,
                                             fused_mlp_reference)
from dformer_torch.models.encoder import VARIANTS, MLPBlock


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _inputs(B, H, W, C, r, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    Ch = C * r

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    # fc1_w, fc2_w: transposed views of Linear-layout weights, as MLPBlock
    # passes them
    return (rnd(B, H, W, C).to(dtype), rnd(C, scale=0.1, shift=1.0),
            rnd(C, scale=0.1), rnd(Ch, C, scale=C ** -0.5).to(dtype).t(),
            rnd(Ch, scale=0.1), rnd(3, 3, Ch, scale=1 / 3).to(dtype),
            rnd(Ch, scale=0.1), rnd(C, Ch, scale=Ch ** -0.5).to(dtype).t(),
            rnd(C, scale=0.1))


# (B, H, W, C, ratio): a large map (one split), ragged small maps (hidden
# channels split over blocks), the wide-C tile shape, and every width the
# four variants (Tiny, Small, Base, Large) put through the kernel, at the
# ratio of their stage (8, 8, 4, 4); (1, 9, 11, 32, 3), Ch = 96, leaves
# either kernel's last 64-channel chunk half full; the last six are the odd
# stage maps of DFormer-Large's multi-scale eval of 480x640 (inputs
# 384x480, 608x800 and 736x960) at the widths where they occur.
# tests/test_torch_fused_mlp_fwd.py keeps the same list (FWD_CARD_SHAPES)
# for its CPU test of the plan.
SHAPES = [
    (2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (2, 15, 20, 576, 4),
    (2, 24, 32, 16, 8), (2, 24, 32, 32, 8), (2, 12, 16, 64, 8),
    (1, 9, 11, 64, 4), (1, 12, 16, 128, 8), (1, 10, 9, 128, 4),
    (1, 10, 9, 144, 4), (2, 12, 16, 192, 8), (1, 15, 20, 256, 4),
    (1, 10, 9, 288, 4), (1, 8, 10, 512, 4), (1, 9, 11, 32, 3),
    (1, 12, 15, 576, 4), (1, 19, 25, 576, 4), (1, 23, 30, 288, 4),
    (1, 38, 50, 288, 4), (1, 76, 100, 192, 8), (1, 184, 240, 96, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_kernel_matches_reference(shape, dtype):
    _card()
    args = _inputs(*shape, dtype)
    n0 = fused_mlp.launches
    got = fused_mlp(*args).float()
    torch.cuda.synchronize()
    assert fused_mlp.launches == n0 + 1
    want = fused_mlp_reference(*args).float()
    # fp32: summation order only; bf16: the plain version rounds h to bf16
    # before the conv where the kernel keeps fp32 (a few bf16 ulps of the
    # output's magnitude)
    tol = 1e-4 if dtype == torch.float32 else 2e-2 * want.abs().max().item()
    assert (got - want).abs().max().item() <= tol
    # no atomics: the hidden splits are added in a fixed order
    assert torch.equal(fused_mlp(*args).float(), got)


# DFormer-Large's eight fused-MLP shapes at bs8, 480x640 (mlp and mlp_e2 of
# each stage; tests/test_torch_fused_mlp_fwd.py::_main_path_shapes) and the
# bf16 kernel's plan of each on an H100 SXM (132 SMs, one block per SM): tile
# rows and columns, chunk, chunks per split, splits. The fp32 kernel has
# tiles of its own; these stay as they are.
BF16_MAIN_PLANS = {
    (8, 120, 160, 96, 768): (8, 16, 64, 12, 1),
    (8, 120, 160, 48, 384): (8, 16, 64, 6, 1),
    (8, 60, 80, 192, 1536): (8, 16, 64, 12, 2),
    (8, 60, 80, 96, 768): (8, 16, 64, 6, 2),
    (8, 30, 40, 288, 1152): (8, 8, 64, 6, 3),
    (8, 30, 40, 144, 576): (8, 8, 64, 3, 3),
    (8, 15, 20, 576, 2304): (4, 8, 32, 18, 4),
    (8, 15, 20, 288, 1152): (8, 8, 64, 4, 5)}


@pytest.mark.cuda
def test_bf16_forward_plans_are_unchanged():
    _card()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, want in BF16_MAIN_PLANS.items():
        plan = card_forward_plan(*shape, torch.bfloat16)
        got = (plan.tile_rows, plan.tile_cols, plan.chunk,
               plan.chunks_per_split, plan.nsplit)
        # on another SM count, the same tiles and chunk at one block per SM
        ref = forward_plan(*shape, *want[:3], 1, sms, 1)
        assert got == (want if sms == 132 else
                       (*want[:3], ref.chunks_per_split, ref.nsplit)), shape


@pytest.mark.cuda
def test_mlp_block_runs_the_kernel_on_the_card():
    _card()
    block = MLPBlock(96, 4, dtype=torch.bfloat16).cuda()
    x = torch.randn(2, 9, 11, 96, device="cuda")
    n0 = fused_mlp.launches
    got = block(x).float()
    assert fused_mlp.launches == n0 + 1
    want = block.cpu()(x.cpu().to(torch.bfloat16)).float()
    assert (got.cpu() - want).abs().max().item() <= \
        2e-2 * want.abs().max().item()


@pytest.mark.cuda
def test_fused_mlp_rejects_what_the_kernel_does_not_take():
    _card()
    args = list(_inputs(1, 8, 8, 40, 4, torch.bfloat16))  # C % 16 != 0
    with pytest.raises(ValueError, match="C % 16"):
        fused_mlp(*args)
    args = list(_inputs(1, 8, 8, 48, 4, torch.bfloat16))
    args[3] = args[3].float()  # fc1_w in the wrong dtype
    with pytest.raises(ValueError, match="fc1_w"):
        fused_mlp(*args)


# (B, H, W, C, ratio): between them the two dtypes reach every tile shape of
# the backward kernel, with ragged tiles at the right and bottom edges; N is
# not a multiple of 16 and the hidden chunks split over blocks at
# (1, 7, 13, 48, 8)
# DFormer-Large's widths, then every width only Tiny, Small and Base train
# with (C 16-512, at their stages' ratios), at the forward's shapes
BWD_SHAPES = [(2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (1, 9, 11, 144, 4),
              (1, 10, 9, 288, 4), (2, 15, 20, 576, 4),
              (2, 24, 32, 16, 8), (2, 24, 32, 32, 8), (2, 12, 16, 64, 8),
              (1, 9, 11, 64, 4), (1, 12, 16, 128, 8), (1, 10, 9, 128, 4),
              (1, 15, 20, 256, 4), (1, 8, 10, 512, 4)]
BWD_NAMES = ["dx", "dln_w", "dln_b", "dfc1_w", "dfc1_b", "dpos_w", "dpos_b",
             "dfc2_w", "dfc2_b"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_fused_mlp_backward_kernel_matches_reference(shape, dtype):
    _card()
    args = [a.requires_grad_() for a in _inputs(*shape, dtype)]
    g = torch.randn(args[0].shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9)
                    ).to(dtype)
    n0 = fused_mlp.backward_launches
    got = torch.autograd.grad(fused_mlp(*args), args, g)
    torch.cuda.synchronize()
    assert fused_mlp.backward_launches == n0 + 1
    want = fused_mlp_backward_reference(*(a.detach() for a in args), g)
    for name, a, b, arg in zip(BWD_NAMES, got, want, args):
        assert a.shape == arg.shape == b.shape and a.dtype == arg.dtype, name
        # fp32: summation order only (dx per pixel; the weight gradients
        # over every pixel). bf16: the plain version rounds h1 and dhc to
        # bf16 where the kernel keeps fp32
        tol = 3e-2 if dtype == torch.bfloat16 else \
            (1e-4 if name == "dx" else 1e-3)
        scale = max(b.float().abs().max().item(), 1e-3)
        err = (a.float() - b.float()).abs().max().item() / scale
        assert err <= tol, (name, err)
    # no atomics: every sum is taken in a fixed order, so all nine outputs
    # are bit-equal from run to run
    again = torch.autograd.grad(fused_mlp(*args), args, g)
    for name, a, b in zip(BWD_NAMES, got, again):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_mlp_block_backward_runs_the_kernel_on_the_card():
    _card()
    block = MLPBlock(96, 4, dtype=torch.float32).cuda()
    x = torch.randn(2, 9, 11, 96, device="cuda", requires_grad=True)
    n0 = fused_mlp.backward_launches
    block(x).square().sum().backward()
    assert fused_mlp.backward_launches == n0 + 1
    got = {n: p.grad.cpu() for n, p in block.named_parameters()}
    got["x"] = x.grad.cpu()
    block = block.cpu()
    block.zero_grad()
    xc = x.detach().cpu().requires_grad_()
    block(xc).square().sum().backward()
    want = {n: p.grad for n, p in block.named_parameters()}
    want["x"] = xc.grad
    for name, b in want.items():
        assert got[name].shape == b.shape and got[name].dtype == b.dtype
        assert (got[name] - b).abs().max().item() <= \
            1e-3 * max(b.abs().max().item(), 1e-3), name


@pytest.mark.cuda
def test_narrow_msf_eval_on_the_card_matches_the_cpu(monkeypatch):
    """MSF + flip (scales 0.5 and 1) of a narrow fp32 DFormer + ham over 2
    images of 64x96: the card through the kernel, the CPU through the plain
    version, on the same weights. fp32 differs by summation order only: the
    accumulators within 1e-4, the hists equal."""
    _card()
    narrow = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 2),
                  num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
                  mlp_ratios=(8, 8, 4, 4))
    monkeypatch.setitem(VARIANTS, "DFormer-Narrow", narrow)
    rng = np.random.RandomState(0)
    rgb, modal = (torch.from_numpy(rng.randn(2, 64, 96, 3)
                                   .astype(np.float32)) for _ in range(2))
    gt = torch.from_numpy(rng.randint(0, 11, (2, 64, 96)))
    (hist_card, acc_card, n_card), (hist_cpu, acc_cpu, n_cpu) = (
        entry.msf_group("DFormer-Narrow", 11, rgb, modal, gt, [0.5, 1.0],
                        True, device) for device in ("cuda", "cpu"))
    assert n_card == 4 * 9 and n_cpu == 0  # 4 forwards, 9 MLP calls each
    assert hist_card.sum() == 2 * 64 * 96
    assert (acc_card - acc_cpu).abs().max().item() <= 1e-4
    np.testing.assert_array_equal(hist_card, hist_cpu)


@pytest.mark.cuda
def test_train_augment_on_the_card_matches_the_cpu():
    """One uint8 batch of NYUDepthv2's size, a canvas batch with true
    extents: the same draws on the card and on the CPU give equal labels
    and images within 1e-5."""
    _card()
    rng = np.random.RandomState(0)
    scales = [0.5, 0.75, 1, 1.25, 1.5, 1.75]
    stats = [torch.tensor(v) for v in ((0.485, 0.456, 0.406),
                                       (0.229, 0.224, 0.225), (0.48,) * 3,
                                       (0.28,) * 3)]
    for hw, true_hw in (((480, 640), None),
                        ((530, 730), [[530, 730], [480, 640], [427, 561],
                                      [530, 700]])):
        batch = [torch.from_numpy(rng.randint(0, 256, (4, *hw, 3))
                                  .astype(np.uint8)),
                 torch.from_numpy(rng.randint(0, 40, (4, *hw))
                                  .astype(np.int32)),
                 torch.from_numpy(rng.randint(0, 256, (4, *hw, 3))
                                  .astype(np.uint8))]
        draws = train_augment_draws(4, len(scales),
                                    torch.Generator().manual_seed(1))
        extents = None if true_hw is None else torch.tensor(true_hw)
        outs = [apply_train_augment(
            *(t.to(dev) for t in batch), *(d.to(dev) for d in draws),
            (480, 640), scales, *(t.to(dev) for t in stats),
            true_hw=None if extents is None else extents.to(dev))
            for dev in ("cuda", "cpu")]
        (card_rgb, card_gt, card_x), (rgb, gt, x) = outs
        assert torch.equal(card_gt.cpu(), gt)
        assert (card_rgb.cpu() - rgb).abs().max().item() <= 1e-5
        assert (card_x.cpu() - x).abs().max().item() <= 1e-5
