"""The port's CUDA kernels (fused-MLP forward and backward) against their
plain PyTorch versions, on the card.

Imports no JAX, so that it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Every test skips where torch sees no CUDA card (the kernels have no CPU
mode).
"""

import pytest
import torch

from dformer_torch.kernels.fused_mlp import (fused_mlp,
                                             fused_mlp_backward_reference,
                                             fused_mlp_reference)
from dformer_torch.models.encoder import MLPBlock


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
# ratio of their stage (8, 8, 4, 4); the last, Ch = 96, leaves the bf16
# kernel's last 64-channel chunk half full. tests/test_torch_fused_mlp_fwd.py
# keeps the same list (FWD_CARD_SHAPES) for its CPU test of the plan.
SHAPES = [
    (2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (2, 15, 20, 576, 4),
    (2, 24, 32, 16, 8), (2, 24, 32, 32, 8), (2, 12, 16, 64, 8),
    (1, 9, 11, 64, 4), (1, 12, 16, 128, 8), (1, 10, 9, 128, 4),
    (1, 10, 9, 144, 4), (2, 12, 16, 192, 8), (1, 15, 20, 256, 4),
    (1, 10, 9, 288, 4), (1, 8, 10, 512, 4), (1, 9, 11, 32, 3)]


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
BWD_SHAPES = [(2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (1, 9, 11, 144, 4),
              (1, 10, 9, 288, 4), (2, 15, 20, 576, 4)]
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
