"""The port's fused-MLP plain version against the JAX reference and the
Pallas kernel (interpret mode), fp32 on the CPU. The CUDA kernel is held
against the plain version in tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dformer_torch.kernels.fused_mlp import fused_mlp, fused_mlp_reference
from dformer_tpu.kernels.fused_mlp import fused_mlp as j_fused_mlp
from dformer_tpu.kernels.fused_mlp import \
    fused_mlp_reference as j_fused_mlp_reference

# (B, H, W, C, ratio); the second has H and W that are not multiples of 8
SHAPES = [(2, 8, 12, 16, 4), (1, 7, 13, 8, 8)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(shape, seed=0):
    B, H, W, C, r = shape
    rng = np.random.RandomState(seed)
    Ch = C * r
    x = rng.randn(B, H, W, C).astype(np.float32)
    ps = [(rng.randn(*s) * 0.2).astype(np.float32) for s in
          [(C,), (C,), (C, Ch), (Ch,), (3, 3, Ch), (Ch,), (Ch, C), (C,)]]
    ps[0] += 1.0  # LayerNorm weight around 1
    return x, ps


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_reference_matches_jax(shape):
    x, ps = _inputs(shape)
    want = np.asarray(j_fused_mlp_reference(jnp.asarray(x),
                                            *map(jnp.asarray, ps)))
    got = fused_mlp_reference(torch.from_numpy(x),
                              *map(torch.from_numpy, ps)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the wrapper takes the plain version for a CPU tensor
    got_wrapper = fused_mlp(torch.from_numpy(x), *map(torch.from_numpy, ps))
    np.testing.assert_array_equal(got_wrapper.numpy(), got)


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_mlp_reference_matches_pallas_interpret(shape):
    x, ps = _inputs(shape, seed=1)
    want = np.asarray(j_fused_mlp(jnp.asarray(x), *map(jnp.asarray, ps),
                                  1e-6, True))
    got = fused_mlp_reference(torch.from_numpy(x),
                              *map(torch.from_numpy, ps)).numpy()
    # the Pallas kernel's polynomial erf budgets ~1e-3 abs at the output
    # (tests/test_kernels.py)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
