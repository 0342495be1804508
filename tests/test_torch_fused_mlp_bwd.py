"""The port's fused-MLP backward on the CPU: the plain backward against the
JAX package's XLA backward (fp32) and its Pallas backward kernel (bf16,
interpret mode), the `fused_mlp` op's registered autograd against
autograd through the plain forward, a port `MLPBlock`'s gradients against
the JAX `MLPBlock`'s, and the CUDA backward's launch plan: its decomposition
replayed in plain PyTorch, and its coverage of every pixel and hidden
channel. The CUDA kernel is held against the plain backward in
tests/test_torch_cuda.py and chip_smoke.py."""

import itertools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dformer_torch.kernels import fused_mlp as tfm
from dformer_torch.kernels.fused_mlp import (backward_plan, fused_mlp,
                                             fused_mlp_backward_reference,
                                             fused_mlp_reference)
from dformer_torch.models.encoder import VARIANTS
from dformer_torch.models.encoder import MLPBlock as TMLPBlock
from dformer_tpu.kernels import fused_mlp as fm
from dformer_tpu.models.encoder import MLPBlock as JMLPBlock

NAMES = ["dx", "dln_w", "dln_b", "dfc1_w", "dfc1_b", "dpos_w", "dpos_b",
         "dfc2_w", "dfc2_b"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(B, H, W, C, r, seed=0):
    """x, the eight parameters and the cotangent g, fp32 numpy."""
    rng = np.random.RandomState(seed)
    Ch = C * r
    x = rng.randn(B, H, W, C).astype(np.float32)
    ps = [(rng.randn(*s) * 0.2).astype(np.float32) for s in
          [(C,), (C,), (C, Ch), (Ch,), (3, 3, Ch), (Ch,), (Ch, C), (C,)]]
    ps[0] += 1.0  # LayerNorm weight around 1
    g = rng.randn(B, H, W, C).astype(np.float32)
    return x, ps, g


def _to_torch(a, dtype=None):
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("shape", [(2, 8, 12, 16, 4), (1, 6, 10, 8, 8)])
def test_backward_reference_matches_jax_xla_backward(shape):
    x, ps, g = _inputs(*shape)
    res = tuple(jnp.asarray(a) for a in (x, *ps))
    want = fm._bwd_xla(1e-6, res, jnp.asarray(g))
    got = fused_mlp_backward_reference(
        *(torch.from_numpy(a) for a in (x, *ps)), torch.from_numpy(g))
    assert len(got) == len(want) == 9
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape, name
        # fp32 both sides: summation order only
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * max(np.abs(b).max(), 1.0),
                                   err_msg=name)


def test_backward_reference_matches_pallas_backward_bf16():
    """bf16 operands, as in training. The Pallas kernel (interpret mode)
    keeps h1 and dhc in fp32 where the plain versions round them to bf16,
    and its erf is a polynomial: 3e-2 of each output's max is the bound the
    JAX package holds its own kernel to against its XLA backward."""
    B, H, W, C, r = 2, 8, 12, 64, 8
    Ch = C * r
    x, ps, g = _inputs(B, H, W, C, r, seed=1)
    in_bf16 = (2, 4, 6)  # fc1_w, pos_w, fc2_w are cast at the call site
    jps = [jnp.asarray(p, jnp.bfloat16) if i in in_bf16 else jnp.asarray(p)
           for i, p in enumerate(ps)]
    res = (jnp.asarray(x, jnp.bfloat16), *jps)
    th, cc = fm._pick_bwd_tiling(H, W, C, Ch, 2)
    want = fm._backward_pallas(*res, jnp.asarray(g, jnp.bfloat16), 1e-6, th,
                               cc, True)
    tps = [_to_torch(p, torch.bfloat16 if i in in_bf16 else None)
           for i, p in enumerate(ps)]
    got = fused_mlp_backward_reference(
        _to_torch(x, torch.bfloat16), *tps, _to_torch(g, torch.bfloat16))
    for name, a, b in zip(NAMES, got, want):
        assert str(a.dtype).replace("torch.", "") == str(b.dtype), name
        a = a.float().numpy()
        b = np.asarray(b, np.float32)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a / scale, b / scale, rtol=0, atol=3e-2,
                                   err_msg=name)


def test_fused_mlp_function_gradients_match_autograd_of_plain_forward():
    """`fused_mlp` (the custom op) on the CPU, with the weights passed as
    the transposed views `MLPBlock` passes: its registered backward equals
    autograd through `fused_mlp_reference` for all nine tensor inputs."""
    B, H, W, C, r = 2, 7, 9, 16, 4
    x, ps, g = _inputs(B, H, W, C, r, seed=2)

    def leaves():
        ts = [torch.from_numpy(a.copy()) for a in (x, *ps)]
        # Linear-layout storage; the function sees the transposed views
        ts[3] = ts[3].t().contiguous()
        ts[7] = ts[7].t().contiguous()
        return [t.requires_grad_() for t in ts]

    def call(fn, ts):
        args = list(ts)
        args[3], args[7] = ts[3].t(), ts[7].t()
        return (fn(*args) * torch.from_numpy(g)).sum()

    a_leaves, b_leaves = leaves(), leaves()
    got = torch.autograd.grad(call(fused_mlp, a_leaves), a_leaves)
    want = torch.autograd.grad(call(fused_mlp_reference, b_leaves), b_leaves)
    for name, a, b, leaf in zip(NAMES, got, want, a_leaves):
        assert a.shape == leaf.shape and a.dtype == leaf.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    # no graph and no saved tensors under inference mode
    with torch.inference_mode():
        out = fused_mlp(*(t.detach() for t in a_leaves[:3]),
                             a_leaves[3].detach().t(),
                             *(t.detach() for t in a_leaves[4:7]),
                             a_leaves[7].detach().t(), a_leaves[8].detach())
    assert not out.requires_grad


def test_mlp_block_gradients_match_jax():
    """A port MLPBlock (through the fused_mlp op) against the JAX MLPBlock
    (use_pallas=False) on the same numpy-drawn weights, fp32: output and
    the gradients of x and of every parameter."""
    B, H, W, C, r = 2, 7, 9, 16, 4
    Ch = C * r
    x, ps, g = _inputs(B, H, W, C, r, seed=3)
    ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b = ps
    params = {"norm": {"weight": ln_w, "bias": ln_b},
              "fc1": {"kernel": fc1_w, "bias": fc1_b},
              "pos": {"kernel": pos_w[:, :, None, :], "bias": pos_b},
              "fc2": {"kernel": fc2_w, "bias": fc2_b}}
    jblock = JMLPBlock(dim=C, mlp_ratio=r, use_pallas=False)
    shapes = jax.eval_shape(jblock.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    assert jax.tree.map(lambda s: s.shape, shapes) == \
        jax.tree.map(lambda a: a.shape, params)

    def jloss(p, x_):
        out = jblock.apply({"params": p}, x_)
        return jnp.sum(out * jnp.asarray(g)), out

    (_, jout), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))

    tblock = TMLPBlock(C, r)
    tblock.load_state_dict({
        "norm.weight": torch.from_numpy(ln_w),
        "norm.bias": torch.from_numpy(ln_b),
        "fc1.weight": torch.from_numpy(fc1_w.T.copy()),
        "fc1.bias": torch.from_numpy(fc1_b),
        "pos.weight": torch.from_numpy(
            pos_w.transpose(2, 0, 1)[:, None].copy()),
        "pos.bias": torch.from_numpy(pos_b),
        "fc2.weight": torch.from_numpy(fc2_w.T.copy()),
        "fc2.bias": torch.from_numpy(fc2_b)}, strict=True)
    tx = torch.from_numpy(x).requires_grad_()
    tout = tblock(tx)
    (tout * torch.from_numpy(g)).sum().backward()

    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    got = {"x": tx.grad.numpy(),
           "norm.weight": tblock.norm.weight.grad.numpy(),
           "norm.bias": tblock.norm.bias.grad.numpy(),
           "fc1.kernel": tblock.fc1.weight.grad.numpy().T,
           "fc1.bias": tblock.fc1.bias.grad.numpy(),
           "pos.kernel": tblock.pos.weight.grad.numpy()[:, 0]
           .transpose(1, 2, 0)[:, :, None, :],
           "pos.bias": tblock.pos.bias.grad.numpy(),
           "fc2.kernel": tblock.fc2.weight.grad.numpy().T,
           "fc2.bias": tblock.fc2.bias.grad.numpy()}
    want = {"x": np.asarray(jgx)}
    for mod, leaves in jgp.items():
        for leaf, v in leaves.items():
            want[f"{mod}.{leaf}"] = np.asarray(v)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-4,
            atol=1e-5 * max(np.abs(want[name]).max(), 1.0), err_msg=name)


def _replay_plan(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b, g,
                 plan, eps=1e-6):
    """The CUDA backward's decomposition in plain PyTorch, fp32: K1 per
    hidden split (y, gact and dh1 materialised; dy per split; per-tile sums
    of dpos_w, dpos_b and dfc1_b), K2 per block of ln_pixels pixels, K3 per
    pixel slice, and K4 adding every partial buffer in index order."""
    B, H, W, C = x.shape
    Ch = fc1_w.shape[1]
    N = B * H * W
    mean = x.mean(-1, keepdim=True)
    rstd = torch.rsqrt((x - mean).square().mean(-1, keepdim=True) + eps)
    y0 = (x - mean) * rstd
    y = y0 * ln_w + ln_b
    h1 = y @ fc1_w + fc1_b

    def dwconv(t, taps):
        out = F.conv2d(t.permute(0, 3, 1, 2),
                       taps.permute(2, 0, 1).unsqueeze(1), None, 1, 1, 1, Ch)
        return out.permute(0, 2, 3, 1)

    hc = dwconv(h1, pos_w) + pos_b + h1
    cdf = 0.5 * (1.0 + torch.erf(hc * 0.7071067811865476))
    gact = hc * cdf
    dhc = (g @ fc2_w.t()) * (cdf + hc * torch.exp(-0.5 * hc * hc)
                             * 0.3989422804014327)
    dh1 = dhc + dwconv(dhc, pos_w.flip(0, 1))

    def in_order(parts):  # K4: a partial buffer summed over its leading index
        total = torch.zeros_like(parts[0])
        for part in parts:
            total = total + part
        return total

    # K1: dy per hidden split; per-tile sums of the per-channel gradients
    span = plan.chunks_per_split * tfm.HIDDEN_CHUNK
    dy = in_order([dh1[..., s * span:(s + 1) * span]
                   @ fc1_w[:, s * span:(s + 1) * span].t()
                   for s in range(plan.nsplit)])
    h1_pad = F.pad(h1, (0, 0, 1, 1, 1, 1))
    per_px = torch.stack(
        [dhc * h1_pad[:, k:k + H, l:l + W] for k in range(3) for l in range(3)]
        + [dhc, dh1], 3)                                   # [B,H,W,11,Ch]
    th = plan.tile_rows
    hid = [per_px[b, r:r + th, c:c + tfm.TILE_W].sum((0, 1))
           for b in range(B) for r in range(0, plan.tiles_h * th, th)
           for c in range(0, plan.tiles_w * tfm.TILE_W, tfm.TILE_W)]
    hid = in_order(hid)
    # K2: dx per pixel; per-block sums of dln_w, dln_b, dfc2_b
    dyn = dy * ln_w
    dx = rstd * (dyn - dyn.mean(-1, keepdim=True)
                 - y0 * (dyn * y0).mean(-1, keepdim=True))
    per_ln = torch.stack([dy * y0, dy, g], -2).reshape(N, 3, C)
    ln = in_order([per_ln[i:i + plan.ln_pixels].sum(0)
                   for i in range(0, plan.ln_blocks * plan.ln_pixels,
                                  plan.ln_pixels)])
    # K3: both weight products per pixel slice
    flat = [t.reshape(N, -1) for t in (gact, g, dh1, y)]
    w = in_order([torch.stack([flat[0][i:i + plan.slice_len].t()
                               @ flat[1][i:i + plan.slice_len],
                               flat[2][i:i + plan.slice_len].t()
                               @ flat[3][i:i + plan.slice_len]])
                  for i in range(0, plan.slices * plan.slice_len,
                                 plan.slice_len)])
    return (dx, ln[0], ln[1], w[1].t(), hid[10], hid[:9].reshape(3, 3, Ch),
            hid[9], w[0], ln[2])


@pytest.mark.parametrize("shape,slices", [((1, 7, 13, 16, 4), 1),
                                          ((2, 23, 29, 8, 8), 2)])
def test_backward_plan_decomposition_matches_reference(shape, slices):
    """Ragged shapes (N not a multiple of 16, H and W not multiples of the
    tile) whose hidden chunks split over blocks, the second also over two
    pixel slices in K3: the plan's decomposition gives the plain backward's
    nine outputs."""
    B, H, W, C, r = shape
    x, ps, g = _inputs(*shape, seed=4)
    # the scalar K1's 8-row tiles at C <= 144, one block per SM, 132 SMs
    plan = backward_plan(B, H, W, C, C * r, 8, 1, 132)
    assert plan.nsplit > 1 and (B * H * W) % 16 and plan.slices == slices
    assert H % plan.tile_rows and W % tfm.TILE_W
    args = [torch.from_numpy(a) for a in (x, *ps, g)]
    got = _replay_plan(*args, plan)
    want = fused_mlp_backward_reference(*args)
    for name, a, b in zip(NAMES, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(
            a.numpy(), b.numpy(), rtol=0,
            atol=1e-5 * max(b.abs().max().item(), 1.0), err_msg=name)


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


def _covers_once(n, starts, length):
    """Ranges [s, s + length) clipped to [0, n) cover it exactly once, and
    none is empty."""
    count = np.zeros(n, np.int64)
    for s in starts:
        assert s < n
        count[s:s + length] += 1
    return bool((count == 1).all())


# the 8 main-path shapes and the card tests' BWD_SHAPES
# (tests/test_torch_cuda.py)
PLAN_SHAPES = _main_path_shapes() + [
    (B, H, W, C, C * r) for B, H, W, C, r in
    [(2, 40, 48, 96, 8), (1, 7, 13, 48, 8), (1, 9, 11, 144, 4),
     (1, 10, 9, 288, 4), (2, 15, 20, 576, 4)]]


@pytest.mark.parametrize("tile_rows", [1, 2, 4, 8])
def test_backward_plan_covers_every_pixel_and_channel_once(tile_rows):
    """At each K1 tile height the kernels have, one or two K1 blocks per SM,
    and the SM counts of an H100 SXM (132) and PCIe (114)."""
    for (B, H, W, C, Ch), k1_blocks, sms in itertools.product(
            PLAN_SHAPES, (1, 2), (132, 114)):
        plan = backward_plan(B, H, W, C, Ch, tile_rows, k1_blocks, sms)
        th, N = plan.tile_rows, B * H * W
        assert th == tile_rows
        # K1: the tiles of an image, and the hidden chunks over the splits
        assert _covers_once(H, range(0, plan.tiles_h * th, th), th)
        assert _covers_once(W, range(0, plan.tiles_w * tfm.TILE_W,
                                     tfm.TILE_W), tfm.TILE_W)
        span = plan.chunks_per_split * tfm.HIDDEN_CHUNK
        assert _covers_once(Ch, range(0, plan.nsplit * span, span), span)
        # K2 blocks and K3 slices over the N pixels
        assert plan.ln_pixels % 8 == 0 and 8 <= plan.ln_pixels <= 64
        assert _covers_once(N, range(0, plan.ln_blocks * plan.ln_pixels,
                                     plan.ln_pixels), plan.ln_pixels)
        assert plan.slice_len % tfm.WGRAD_K == 0
        assert _covers_once(N, range(0, plan.slices * plan.slice_len,
                                     plan.slice_len), plan.slice_len)
        # grid limits the C entry point checks
        assert B * plan.nsplit <= 65535 and 2 * plan.slices <= 65535
