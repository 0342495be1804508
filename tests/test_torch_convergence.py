"""The port's convergence smoke (`dformer_torch.tools.smoke_convergence`)
against the JAX tool (`tools/smoke_convergence.py`): the same `RandomState`
seed gives the same batches (floats within 1e-6, labels exact), the Trav
batches through the resampling of scans whose mean lies near 0.5; and the
tool's `main` runs two steps of DFormer-Tiny on the CPU. The learning
itself (600 steps, held-out mIoU >= 60) runs on the card, in
`chip_smoke.py`'s `convergence` phase."""

import numpy as np
import pytest
import torch

from dformer_torch.tools import smoke_convergence as t_smoke
from tools import smoke_convergence as j_smoke

FLOAT_LIMIT = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(jax_batch, port_batch):
    (j_rgb, j_gt, j_x), (t_rgb, t_gt, t_x) = jax_batch, port_batch
    assert t_gt.dtype == torch.int32
    np.testing.assert_array_equal(t_gt.numpy(), np.asarray(j_gt))
    for j, t in ((j_rgb, t_rgb), (j_x, t_x)):
        assert t.dtype == torch.float32 and t.shape == j.shape
        assert np.abs(t.numpy() - np.asarray(j)).max() <= FLOAT_LIMIT


@pytest.mark.parametrize("seed", [0, 123])
def test_make_batch_matches_jax(seed):
    _same(j_smoke.make_batch(np.random.RandomState(seed)),
          t_smoke.make_batch(np.random.RandomState(seed)))


@pytest.mark.parametrize("seed", [0, 1])
def test_make_trav_batch_matches_jax(seed):
    """Seed 1 draws 3 of its 8 scans with a mean within 0.03 of 0.5, so the
    resampling loop runs; seed 0 draws none."""
    rng = np.random.RandomState(seed)
    rng.rand(8, 8, 12, 1)
    rng.randn(8, 64, 96, 3)
    first = t_smoke.resize_linear(
        rng.rand(8, 1, 12, 1).astype(np.float32), (1, 360))[:, 0, :, 0]
    assert int((np.abs(first.mean(1) - 0.5) < 0.03).sum()) == \
        (3 if seed else 0)
    j = j_smoke.make_trav_batch(np.random.RandomState(seed))
    t = t_smoke.make_trav_batch(np.random.RandomState(seed))
    _same(j, t)
    assert (np.abs(t[2].numpy().mean(1) - 0.5) >= 0.03).all()


def test_main_takes_two_steps_of_tiny(capsys):
    out = t_smoke.main(["--steps", "2", "--min_miou", "0",
                        "--device", "cpu"])
    printed = capsys.readouterr().out
    assert "it 0 loss" in printed and "held-out mIoU" in printed
    assert "CONVERGENCE SMOKE: PASS" in printed
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    assert 0 <= out["miou"] <= 100 and len(out["ious"]) == 4
    assert out["launches"] == [(0, 0), (0, 0)]  # plain versions on the CPU
    cfg = t_smoke.smoke_config(False, 600)
    assert (cfg.backbone, cfg.num_classes, cfg.image_height,
            cfg.image_width, cfg.niters_per_epoch, cfg.lr) == \
        ("DFormer-Tiny", 4, 64, 96, 60, 3e-4)
