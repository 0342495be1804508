"""The port's remaining ops against the JAX package on the CPU, fp32: every
loss of `ops/loss.py` (value and gradient against `jax.grad`), the
standalone augmentation primitives, nearest resize, the step schedules and
the Trav manifest utilities."""

import os
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.data import augment as t_aug
from dformer_torch.data import trav as t_trav
from dformer_torch.ops import loss as t_loss
from dformer_torch.ops import resize as t_resize
from dformer_torch.ops import schedule as t_schedule
from dformer_tpu.data import augment as j_aug
from dformer_tpu.data import trav as j_trav
from dformer_tpu.ops import loss as j_loss
from dformer_tpu.ops import resize as j_resize
from dformer_tpu.ops import schedule as j_schedule

LOSS_REL = 1e-5   # of max |JAX value|, for the loss and each gradient
SHAPE, CLASSES = (2, 16, 16), 5
BLUR_ROTATE_REL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)
    assert err <= rel, f"{name}: {err:.3g} of max > {rel}"


def _inputs():
    """logits [2,16,16,5] and labels with a tenth of the pixels ignored."""
    rng = np.random.RandomState(0)
    logits = (2 * rng.randn(*SHAPE, CLASSES)).astype(np.float32)
    labels = rng.randint(0, CLASSES, SHAPE)
    labels[rng.rand(*SHAPE) < 0.1] = 255
    return logits, labels


def _binary_inputs():
    rng = np.random.RandomState(1)
    logits = rng.randn(*SHAPE).astype(np.float32)
    labels = rng.randint(0, 2, SHAPE)
    labels[rng.rand(*SHAPE) < 0.1] = 255
    return logits, labels


def _regression_inputs():
    rng = np.random.RandomState(2)
    pred, target = (rng.rand(*SHAPE).astype(np.float32) * 4 for _ in "ab")
    return pred, target, rng.rand(*SHAPE) < 0.8


# case ("<loss>[-variant]") -> (inputs, keyword arguments)
LOSSES = {
    "per_pixel_cross_entropy": (_inputs, {}),
    "softmax_cross_entropy_masked_mean": (_inputs, {}),
    "dice_loss": (_inputs, {}),
    "focal_loss": (_inputs, {}),
    "tversky_loss": (_inputs, dict(alpha=0.3, beta=0.7)),
    "lovasz_softmax_loss": (_inputs, {}),
    "ohem_cross_entropy": (_inputs, {}),
    "ohem_cross_entropy-min_kept": (_inputs, dict(min_kept=100)),
    "berhu_loss": (_regression_inputs, {}),
    "class_balanced_ce": (_inputs, {}),
    "rce_loss": (_inputs, {}),
    "sigmoid_focal_loss": (_binary_inputs, {}),
}


@pytest.fixture(scope="module")
def jax_losses():
    """{case: (JAX value, jax.grad of its sum)} of every case, from one
    jitted program (one compile, not one per case)."""
    inputs = {case: make() for case, (make, _) in LOSSES.items()}

    @jax.jit
    def run(inputs):
        out = {}
        for case, args in inputs.items():
            jfn, kw = getattr(j_loss, case.split("-")[0]), LOSSES[case][1]

            def total(u, args=args, jfn=jfn, kw=kw):
                return jnp.sum(jfn(u, *args[1:], **kw))
            out[case] = (jfn(*args, **kw), jax.grad(total)(args[0]))
        return out

    return run({case: tuple(jnp.asarray(a) for a in args)
                for case, args in inputs.items()})


@pytest.mark.parametrize("case", list(LOSSES))
def test_loss_and_gradient_match_jax(case, jax_losses):
    """Each loss and its gradient with respect to the logits (BerHu: the
    prediction, with a mask) against the JAX function and `jax.grad`;
    per_pixel_cross_entropy's gradient is that of its sum."""
    name = case.split("-")[0]
    make, kw = LOSSES[case]
    args = make()
    x = torch.from_numpy(args[0]).requires_grad_()
    got = getattr(t_loss, name)(
        x, *(torch.from_numpy(np.asarray(a)) for a in args[1:]), **kw)
    got.sum().backward()
    want, grad = jax_losses[case]
    _close(got.detach().numpy(), want, LOSS_REL, f"{case} value")
    _close(x.grad.numpy(), grad, LOSS_REL, f"{case} gradient")
    if name != "sigmoid_focal_loss":
        assert np.abs(x.grad.numpy()).max() > 0, case


# --- augmentation primitives ---------------------------------------------------

def _image(hw=(21, 30), channels=3, seed=3):
    return np.random.RandomState(seed).rand(*hw, channels).astype(np.float32)


@pytest.mark.parametrize("shape", [(20, 30), (32, 32), (21, 30, 3)])
def test_pads_and_crops_match_jax_exactly(shape):
    img = np.random.RandomState(4).rand(*shape).astype(np.float32)
    t_img, j_img = torch.from_numpy(img), jnp.asarray(img)
    for target in ((24, 36), (16, 40)):
        got, gm = t_aug.pad_to_shape(t_img, target, 7.0)
        want, wm = j_aug.pad_to_shape(j_img, target, 7.0)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(gm, wm)
    got, gm = t_aug.pad_to_multiple(t_img, 32, 255.0)
    want, wm = j_aug.pad_to_multiple(j_img, 32, 255.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gm, wm)
    np.testing.assert_array_equal(
        t_aug.center_crop(t_img, (11, 13)).numpy(),
        np.asarray(j_aug.center_crop(j_img, (11, 13))))


@pytest.mark.parametrize("edge", [12, 40])
def test_resize_shortest_edge_matches_jax(edge):
    for img in (_image(), _image((30, 21), 1)[..., 0]):
        got = t_aug.resize_shortest_edge(torch.from_numpy(img), edge)
        want = j_aug.resize_shortest_edge(jnp.asarray(img), edge)
        _close(got.numpy(), want, BLUR_ROTATE_REL, f"shortest edge {edge}")


@pytest.mark.parametrize("angle", [7.5, -10.0, 33.0])
def test_rotate_matches_jax(angle):
    """Bilinear images and nearest labels at a fixed angle, with a pad
    value; random_rotation draws its angle in [-10, 10]."""
    img = _image()
    labels = np.random.RandomState(5).randint(0, 9, (21, 30)).astype(
        np.float32)
    got = t_aug.rotate(torch.from_numpy(img), angle, pad_value=0.5)
    want = j_aug.rotate(jnp.asarray(img), angle, pad_value=0.5)
    _close(got.numpy(), want, BLUR_ROTATE_REL, f"rotate {angle}")
    got = t_aug.rotate(torch.from_numpy(labels), angle, nearest=True)
    want = j_aug.rotate(jnp.asarray(labels), angle, nearest=True)
    assert (got.numpy() != np.asarray(want)).mean() < 0.01
    gen = torch.Generator().manual_seed(0)
    r_img, r_gt = t_aug.random_rotation(gen, torch.from_numpy(img),
                                        torch.from_numpy(labels))
    assert r_img.shape == img.shape and r_gt.shape == labels.shape
    assert set(np.unique(r_gt.numpy())) <= set(np.unique(labels)) | {0.0}


@pytest.mark.parametrize("ksize", [1, 3, 5, 7])
def test_gaussian_blur_matches_jax(ksize):
    for img in (_image(), _image((9, 11), 1)[..., 0]):
        got = t_aug.gaussian_blur(torch.from_numpy(img), ksize)
        want = j_aug.gaussian_blur(jnp.asarray(img), ksize)
        _close(got.numpy(), want, BLUR_ROTATE_REL, f"blur {ksize}")
    gen = torch.Generator().manual_seed(ksize)
    out = t_aug.random_gaussian_blur(gen, torch.from_numpy(_image()))
    assert out.dtype == torch.float32 and out.shape == _image().shape


@pytest.mark.parametrize("size", [(7, 9), (40, 50), (16, 24)])
def test_resize_nearest_matches_jax_exactly(size):
    rng = np.random.RandomState(6)
    x = rng.rand(2, 16, 24, 3).astype(np.float32)
    labels = rng.randint(0, 40, (2, 16, 24))
    for a in (x, labels):
        np.testing.assert_array_equal(
            t_resize.resize_nearest(torch.from_numpy(a), size).numpy(),
            np.asarray(j_resize.resize_nearest(jnp.asarray(a), size)))


def test_step_schedules_match_jax():
    stages = [(10, 1e-3), (25, 5e-4), (40, 1e-4)]
    for step in range(0, 50, 3):
        assert np.float32(t_schedule.multi_stage_lr(step, stages)) == \
            np.asarray(j_schedule.multi_stage_lr(step, stages))
        # JAX rounds to fp32 after each of its three operations, the port
        # computes in float64: up to 3 fp32 ulps apart
        got = t_schedule.linear_increase_lr(step, 1e-5, 1e-3, 30)
        want = np.asarray(j_schedule.linear_increase_lr(step, 1e-5, 1e-3, 30))
        assert abs(np.float32(got) - want) <= 3 * np.spacing(want)


# --- Trav manifest utilities ---------------------------------------------------

def _scans_manifest(root):
    rng = np.random.RandomState(7)
    os.makedirs(f"{root}/a/b/scans")
    rows = []
    for i in range(3):
        path = f"{root}/a/b/scans/s{i}.pkl"
        with open(path, "wb") as f:
            pickle.dump({"ranges": (rng.rand(1080) * 5).tolist()}, f)
        rows.append((f"/old/x/y/images/f{i}.png", path,
                     "" if i == 1 else f"/old/x/y/labels/f{i}.npy"))
    with open(f"{root}/m.csv", "w") as f:
        f.write(",img,laser,label\n")
        f.writelines(f"{i},{a},{b},{c}\n" for i, (a, b, c) in enumerate(rows))
    return f"{root}/m.csv"


def test_trav_manifest_utilities_match_jax(tmp_path):
    """The lidar statistics of a manifest, and its paths rebased onto new
    roots: the file the port writes equals the one pandas writes, and its
    rows are those pandas reads back."""
    csv = _scans_manifest(str(tmp_path))
    got = t_trav.calc_depth_mean_std(csv, depth_col="laser")
    want = j_trav.calc_depth_mean_std(csv, depth_col="laser")
    assert got == pytest.approx(want, rel=1e-6)
    rows = t_trav.rebase_manifest_paths(csv, "/new/img", "/new/lidar", 3,
                                        out_csv=str(tmp_path / "t.csv"))
    df = j_trav.rebase_manifest_paths(csv, "/new/img", "/new/lidar", 3,
                                      out_csv=str(tmp_path / "j.csv"))
    assert (tmp_path / "t.csv").read_text() == \
        (tmp_path / "j.csv").read_text()
    assert rows == [{k: (None if isinstance(v, float) else v)
                     for k, v in r.items()}
                    for r in df.to_dict("records")]
    assert rows[0]["img"] == "/new/img/y/images/f0.png"
