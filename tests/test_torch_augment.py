"""The port's train augmentation against the JAX package's on the CPU: the
same uint8 batch and the same random draws (JAX's, replayed from its key
and handed to the port's `apply_train_augment`) give equal labels and
images within 1e-5, over every scale of the train scale array, the pad
path, flips, and a canvas batch of variable-size images."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.data import augment as t_aug
from dformer_tpu.data import augment as j_aug

SCALES = (0.5, 0.75, 1.0, 1.25, 1.5, 1.75)  # cfg.train_scale_array
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
X_MEAN, X_STD = (0.48,) * 3, (0.28,) * 3
OUT_HW = (24, 32)
IMAGE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _jax_draws(key, batch, n_scales):
    """The draws `dformer_tpu.data.augment.device_train_augment` makes from
    `key`, replayed outside its jit."""
    k_flip, k_scale, k_crop = jax.random.split(key, 3)
    return (np.array(jax.random.bernoulli(k_flip, 0.5, (batch,))),
            np.array(jax.random.randint(k_scale, (batch,), 0, n_scales)),
            np.array(jax.random.uniform(k_crop, (batch, 2))))


def _batch(rng, batch, hw):
    return (rng.randint(0, 256, (batch, *hw, 3)).astype(np.uint8),
            rng.randint(0, 40, (batch, *hw)).astype(np.int32),
            rng.randint(0, 256, (batch, *hw, 3)).astype(np.uint8))


def _both(rgb, gt, modal, key, true_hw=None):
    stats = [np.asarray(s, np.float32) for s in (MEAN, STD, X_MEAN, X_STD)]
    want = j_aug.device_train_augment(
        jnp.asarray(rgb), jnp.asarray(gt), jnp.asarray(modal), key, OUT_HW,
        SCALES, *map(jnp.asarray, stats),
        true_hw=None if true_hw is None else jnp.asarray(true_hw))
    flips, scale_idx, u = _jax_draws(key, rgb.shape[0], len(SCALES))
    got = t_aug.apply_train_augment(
        torch.from_numpy(rgb), torch.from_numpy(gt), torch.from_numpy(modal),
        torch.from_numpy(flips), torch.from_numpy(scale_idx).long(),
        torch.from_numpy(u), OUT_HW, SCALES, *map(torch.from_numpy, stats),
        true_hw=None if true_hw is None else torch.from_numpy(true_hw))
    return [np.asarray(w) for w in want], [g.numpy() for g in got], \
        (flips, scale_idx)


def _assert_match(want, got):
    (w_rgb, w_gt, w_x), (g_rgb, g_gt, g_x) = want, got
    assert g_rgb.shape == w_rgb.shape and g_rgb.dtype == np.float32
    assert g_gt.shape == w_gt.shape
    np.testing.assert_array_equal(g_gt, w_gt)
    np.testing.assert_allclose(g_rgb, w_rgb, atol=IMAGE_TOL, rtol=0)
    np.testing.assert_allclose(g_x, w_x, atol=IMAGE_TOL, rtol=0)


def test_fixed_canvas_every_scale_and_flip_matches_jax():
    """12 samples of 32x40 cropped to 24x32: the key's draws hit all six
    scales (0.5 and 0.75 take the pad path on both axes, 1.0 pads a row
    and a column at most, the rest crop) and both flip values. The canvas
    is one where XLA's rewrite of the division by the constant canvas size
    changes no label (see the cv2 test below)."""
    rng = np.random.RandomState(0)
    rgb, gt, modal = _batch(rng, 12, (32, 40))
    want, got, (flips, scale_idx) = _both(rgb, gt, modal,
                                          jax.random.PRNGKey(2))
    assert set(scale_idx.tolist()) == set(range(len(SCALES)))
    assert flips.any() and not flips.all()
    _assert_match(want, got)
    # the pad path: labels 255 and images 0 outside the scaled extent
    small = int(np.flatnonzero(scale_idx == 0)[0])  # scale 0.5: 16x20
    assert (got[1][small] == 255).sum() == 24 * 32 - 16 * 20


def test_canvas_batch_with_true_extents_matches_jax():
    """A canvas batch (SUNRGBD): four images of other sizes in the top left
    of a 30x40 canvas, garbage outside; flip, ratios, crop range and pad
    masks follow each true extent."""
    rng = np.random.RandomState(1)
    rgb, gt, modal = _batch(rng, 4, (30, 40))
    true_hw = np.asarray([[30, 40], [22, 31], [27, 18], [15, 40]], np.int32)
    want, got, (flips, _) = _both(rgb, gt, modal, jax.random.PRNGKey(11),
                                  true_hw)
    assert flips.any() and not flips.all()
    _assert_match(want, got)


@pytest.mark.parametrize("scale,origin,nearest", [
    (1.0, (0.0, 0.0), False), (1.75, (13.0, 27.0), False),
    (0.5, (-8.0, -12.0), False), (1.3, (5.0, 0.0), False),
    (1.75, (13.0, 27.0), True), (0.5, (-8.0, -12.0), True),
    (1.3, (5.0, 3.0), True)])
def test_scale_crop_sample_matches_jax(scale, origin, nearest):
    """One sample at a fixed scale and origin, the JAX primitive eagerly:
    a crop from an upscaled image, the centre-pad case and a ratio where
    floor(in * scale) differs from in * scale."""
    rng = np.random.RandomState(2)
    if nearest:
        img = rng.randint(0, 40, (40, 56)).astype(np.int32)
    else:
        img = rng.rand(40, 56, 3).astype(np.float32)
    pad = 255 if nearest else 0.0
    want = np.asarray(j_aug.scale_crop_sample(
        jnp.asarray(img), jnp.float32(scale),
        (jnp.float32(origin[0]), jnp.float32(origin[1])), (40, 56), pad,
        nearest=nearest))

    def one(v):
        return torch.tensor([v], dtype=torch.float32)

    got = t_aug.scale_crop_sample(
        torch.from_numpy(img)[None], one(scale),
        (one(origin[0]), one(origin[1])), (40, 56), pad,
        true_hw=(one(40), one(56)), nearest=nearest)[0].numpy()
    if nearest:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=IMAGE_TOL, rtol=0)


@pytest.mark.parametrize("scale", [0.75, 1.25, 1.5, 1.75])
def test_nearest_labels_match_cv2_at_the_nyu_height(scale):
    """Label rows of a 480-row canvas (NYUDepthv2) at each scale whose
    ratio is not a power of two: the port's fp32 `1 / (sh / 480)` picks
    cv2's source row everywhere. The JAX package, jitted with a constant
    canvas, picks another row at some of them: XLA turns the division by
    the constant 480 into a product with its reciprocal (ROADMAP.md Queue
    3)."""
    cv2 = pytest.importorskip("cv2")
    h, w = 480, 8
    rows = np.repeat(np.arange(h, dtype=np.int32)[:, None], w, 1)
    sh, sw = (int(np.floor(np.float32(n) * np.float32(scale)))
              for n in (h, w))
    want = cv2.resize(rows.astype(np.float32), (sw, sh),
                      interpolation=cv2.INTER_NEAREST).astype(np.int32)
    zero = torch.zeros(1)
    got = t_aug.scale_crop_sample(
        torch.from_numpy(rows)[None], torch.tensor([scale]), (zero, zero),
        (sh, sw), 255, true_hw=(torch.tensor([float(h)]),
                               torch.tensor([float(w)])),
        nearest=True)[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_draws_support():
    gen = torch.Generator().manual_seed(0)
    flips, scale_idx, u = t_aug.train_augment_draws(4000, len(SCALES), gen)
    assert flips.dtype == torch.bool and flips.shape == (4000,)
    assert 0.45 < flips.float().mean().item() < 0.55
    assert scale_idx.dtype == torch.int64
    assert set(scale_idx.tolist()) == set(range(len(SCALES)))
    assert u.shape == (4000, 2) and u.dtype == torch.float32
    assert 0.0 <= u.min().item() and u.max().item() < 1.0
    # the same generator state gives the same draws
    again = t_aug.train_augment_draws(
        4000, len(SCALES), torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip((flips, scale_idx, u),
                                                 again))
