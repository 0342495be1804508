"""The port's fused-MLP backward on the CPU: the plain backward against the
JAX package's XLA backward (fp32) and its Pallas backward kernel (bf16,
interpret mode), the `FusedMLP` autograd function against autograd through
the plain forward, and a port `MLPBlock`'s gradients against the JAX
`MLPBlock`'s. The CUDA kernel is held against the plain backward in
tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.kernels.fused_mlp import (FusedMLP,
                                             fused_mlp_backward_reference,
                                             fused_mlp_reference)
from dformer_torch.models.encoder import MLPBlock as TMLPBlock
from dformer_tpu.kernels import fused_mlp as fm
from dformer_tpu.models.encoder import MLPBlock as JMLPBlock

NAMES = ["dx", "dln_w", "dln_b", "dfc1_w", "dfc1_b", "dpos_w", "dpos_b",
         "dfc2_w", "dfc2_b"]


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
    """`FusedMLP.apply` on the CPU, with the weights passed as the transposed
    views `MLPBlock` passes: its hand-written backward equals autograd
    through `fused_mlp_reference` for all nine tensor inputs."""
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
    got = torch.autograd.grad(call(FusedMLP.apply, a_leaves), a_leaves)
    want = torch.autograd.grad(call(fused_mlp_reference, b_leaves), b_leaves)
    for name, a, b, leaf in zip(NAMES, got, want, a_leaves):
        assert a.shape == leaf.shape and a.dtype == leaf.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    # no graph and no saved tensors under inference mode
    with torch.inference_mode():
        out = FusedMLP.apply(*(t.detach() for t in a_leaves[:3]),
                             a_leaves[3].detach().t(),
                             *(t.detach() for t in a_leaves[4:7]),
                             a_leaves[7].detach().t(), a_leaves[8].detach())
    assert not out.requires_grad


def test_mlp_block_gradients_match_jax():
    """A port MLPBlock (through FusedMLP) against the JAX MLPBlock
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
