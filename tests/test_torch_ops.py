"""The port's resize and pool ops against the JAX ops on the CPU, fp32 (and
bf16 for UPerHead's pyramid pool, which rounds as the JAX op does)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dformer_torch.ops.pool import adaptive_avg_pool2d as t_pool
from dformer_torch.ops.pool import global_avg_pool2d as t_gap
from dformer_torch.models.decoders.upernet import AdaptivePool
from dformer_torch.ops.resize import resize_bilinear as t_resize
from dformer_tpu.ops.pool import adaptive_avg_pool2d as j_pool
from dformer_tpu.ops.pool import global_avg_pool2d as j_gap
from dformer_tpu.ops.resize import resize_bilinear as j_resize


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("in_hw,out_hw", [((7, 9), (16, 20)),   # up
                                          ((16, 20), (5, 7)),   # down
                                          ((6, 8), (6, 8))])    # identity
def test_resize_bilinear_matches_jax(in_hw, out_hw, align_corners):
    x = np.random.RandomState(0).randn(2, *in_hw, 5).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), out_hw, align_corners))
    got = t_resize(torch.from_numpy(x), out_hw, align_corners).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((15, 20), (7, 7)),   # in > out
                                          ((2, 3), (7, 7))])    # in < out
def test_adaptive_avg_pool2d_matches_jax(in_hw, out_hw):
    x = np.random.RandomState(1).randn(2, *in_hw, 6).astype(np.float32)
    want = np.asarray(j_pool(jnp.asarray(x), out_hw))
    got = t_pool(torch.from_numpy(x), out_hw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("in_hw,out_hw", [((15, 20), (6, 6)),   # in > out
                                          ((2, 3), (6, 6)),     # in < out
                                          ((4, 6), (2, 2))])
def test_pyramid_pool_rounds_as_jax(in_hw, out_hw):
    """UPerHead's pool, fp32 within 1e-6; in bf16 the fp32 means rounded
    once, as in the JAX op: within one bf16 ulp of its result (the two fp32
    sums differ in order, so a value near a rounding boundary may land on
    either side)."""
    assert out_hw[0] == out_hw[1]
    pool = AdaptivePool(out_hw[0])
    x = np.random.RandomState(2).randn(2, *in_hw, 64).astype(np.float32)
    want = np.asarray(j_pool(jnp.asarray(x), out_hw))
    got = pool(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    want16 = np.asarray(j_pool(jnp.asarray(x, jnp.bfloat16), out_hw),
                        np.float32)
    got16 = pool(torch.from_numpy(x).bfloat16())
    assert got16.dtype == torch.bfloat16
    _, e = np.frexp(np.abs(want16))
    ulp = np.where(want16 == 0, 0.0, np.ldexp(1.0, e - 8))
    assert (np.abs(got16.float().numpy() - want16) <= ulp).all()


def test_global_avg_pool2d_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 7, 6).astype(np.float32)
    want = np.asarray(j_gap(jnp.asarray(x)))
    got = t_gap(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 1, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
