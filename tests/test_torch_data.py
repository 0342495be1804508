"""The port's val data path, config loader and checkpoint loader against the
JAX package, on the CPU: RGBXDataset items from files written with cv2,
the loader's collate and iteration, the synthetic dataset, the val
normalisation, every leaf config, and a torch checkpoint round trip."""

import argparse
import copy
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dformer_torch import configs as t_configs
from dformer_torch import entry
from dformer_torch.data import augment as t_augment
from dformer_torch.data import datasets as t_datasets
from dformer_torch.data import loader as t_loader
from dformer_torch.utils.checkpoint import (load_checkpoint,
                                            load_torch_checkpoint)
from dformer_tpu import config as j_config
from dformer_tpu.data import augment as j_augment
from dformer_tpu.data import datasets as j_datasets
from dformer_tpu.data import loader as j_loader

NAMES = ["a", "b", "c"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """3 samples of mixed sizes: RGB .jpg, single-channel and 3-channel
    depth .png, labels .png with 0 (invalid) among them, and a split
    file."""
    import cv2

    root = tmp_path_factory.mktemp("rgbx")
    for d in ("RGB", "Depth", "Depth3", "Label"):
        (root / d).mkdir()
    rng = np.random.RandomState(0)
    for name, (h, w) in zip(NAMES, [(20, 28), (20, 28), (16, 24)]):
        cv2.imwrite(str(root / "RGB" / f"{name}.jpg"),
                    rng.randint(0, 256, (h, w, 3), np.uint8))
        cv2.imwrite(str(root / "Depth" / f"{name}.png"),
                    rng.randint(0, 256, (h, w), np.uint8))
        cv2.imwrite(str(root / "Depth3" / f"{name}.png"),
                    rng.randint(0, 256, (h, w, 3), np.uint8))
        cv2.imwrite(str(root / "Label" / f"{name}.png"),
                    rng.randint(0, 6, (h, w)).astype(np.uint8))
    split = root / "split.txt"
    split.write_text("".join(f"RGB/{n}.jpg\tLabel/{n}.png\n" for n in NAMES))
    return root


def _setting(root, transform_gt, single):
    return dict(rgb_root=str(root / "RGB"), gt_root=str(root / "Label"),
                x_root=str(root / ("Depth" if single else "Depth3")),
                transform_gt=transform_gt, x_single_channel=single,
                train_source=str(root / "split.txt"),
                eval_source=str(root / "split.txt"))


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("transform_gt, single", [(True, True),
                                                  (False, False)])
def test_rgbx_dataset_matches_jax(files, transform_gt, single):
    """Items (BGR pixels, label shift, X replicated to 3 channels), and the
    oversampled epoch order under set_epoch."""
    s = _setting(files, transform_gt, single)
    for split, length in (("val", None), ("train", 7)):
        got = t_datasets.RGBXDataset(s, split, file_length=length)
        want = j_datasets.RGBXDataset(s, split, file_length=length)
        got.set_epoch(3)
        want.set_epoch(3)
        assert len(got) == len(want)
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    item = got[0]
    assert item["modal_x"].shape[-1] == 3
    if transform_gt:
        assert (item["gt"] == 255).any() and item["gt"][item["gt"] != 255] \
            .max() < 5


def test_gt_transform_matches_jax():
    gt = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(t_datasets.gt_transform(gt),
                                  j_datasets.gt_transform(gt))


def test_collate_pads_mixed_shapes_like_jax(files):
    """Mixed shapes pad to one canvas (uint8 with 0, labels with 255) and
    record each sample's extent in "hw"; one shape stacks as it is."""
    ds = t_datasets.RGBXDataset(_setting(files, True, True), "val")
    items = [ds[i] for i in range(3)]
    for group in (items, items[:2]):
        got = t_loader.Loader(None, 3)._collate(group)
        want = j_loader.Loader(None, 3)._collate(group)
        _assert_items_equal(got, want)
    assert got.get("hw") is None and "hw" in t_loader.Loader(
        None, 3)._collate(items)


def test_loader_iterates_like_jax():
    """Shuffled, sharded, dropped-last batches of the synthetic dataset."""
    kw = dict(shuffle=True, drop_last=True, seed=5, shard=(1, 2))
    got_l = t_loader.Loader(t_datasets.SyntheticRGBXDataset(
        9, (6, 8), 7, file_length=13), 2, **kw)
    want_l = j_loader.Loader(j_datasets.SyntheticRGBXDataset(
        9, (6, 8), 7, file_length=13), 2, **kw)
    got_l.set_epoch(1)
    want_l.set_epoch(1)
    got, want = list(got_l), list(want_l)
    assert len(got) == len(want) == len(got_l) == 3
    for g, w in zip(got, want):
        _assert_items_equal(g, w)


def test_synthetic_dataset_matches_jax():
    got = t_datasets.SyntheticRGBXDataset(4, (10, 12), 37, seed=3,
                                          file_length=6)
    want = j_datasets.SyntheticRGBXDataset(4, (10, 12), 37, seed=3,
                                           file_length=6)
    assert len(got) == len(want) == 6
    for i in range(6):
        _assert_items_equal(got[i], want[i])


def _small_configs(files=None):
    """The JAX and the port's NYUDepthv2 DFormer-Large config, cut to 12x16
    images, 3 val images, batch 2 and 2 iterations per epoch, reading the
    files of the `files` fixture when given."""
    path = "local_configs.NYUDepthv2.DFormer_Large"
    out = (j_config.load_config(path), t_configs.load_config(path))
    for cfg in out:
        cfg.image_height, cfg.image_width, cfg.num_eval_imgs = 12, 16, 3
        cfg.batch_size, cfg.niters_per_epoch = 2, 2
        if files is not None:
            cfg.rgb_root_folder = str(files / "RGB")
            cfg.x_root_folder = str(files / "Depth")
            cfg.gt_root_folder = str(files / "Label")
            cfg.train_source = cfg.eval_source = str(files / "split.txt")
    return out


@pytest.mark.parametrize("synthetic", [True, False])
def test_train_and_val_loaders_match_jax(files, synthetic):
    """train_batches (oversampled, shuffled) and val_batches, synthetic and
    from files of mixed sizes (canvas batches with "hw")."""
    jcfg, tcfg = _small_configs(None if synthetic else files)
    for t_fn, j_fn in ((t_loader.train_batches, j_loader.train_batches),
                       (t_loader.val_batches, j_loader.val_batches)):
        got = list(t_fn(tcfg, synthetic=synthetic))
        want = list(j_fn(jcfg, synthetic=synthetic))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            _assert_items_equal(g, w)


@pytest.mark.parametrize("single", [True, False])
def test_device_val_batches_match_jax_val_iter(single):
    """The port's normalised val batches against the JAX val iterator of
    tools/train.py (the same synthetic images; the X statistics of a
    single-channel X, or the RGB ones), within 1e-6."""
    from tools.train import _val_iter

    class _Engine:
        @staticmethod
        def data_shard():
            return (0, 1)

    jcfg, tcfg = _small_configs()
    for cfg in (jcfg, tcfg):
        cfg.x_is_single_channel = single
    args = argparse.Namespace(val_batch_size=2, synthetic_data=True)
    want = list(_val_iter(jcfg, _Engine, args))
    got = list(t_loader.device_val_batches(tcfg, 2, "cpu", synthetic=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in ("rgb", "modal_x"):
            assert g[k].dtype == torch.float32
            np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                       rtol=0, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(g["gt"].numpy(), w["gt"])
        assert g["fn"] == w["fn"]


def test_normalize_batch_matches_jax():
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (2, 5, 6, 3), np.uint8)
    x = rng.randint(0, 256, (2, 5, 6, 3), np.uint8)
    stats = [np.asarray(v, np.float32) for v in
             ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225], [0.48] * 3,
              [0.28] * 3)]
    want = j_augment.normalize_batch(jnp.asarray(rgb), jnp.asarray(x),
                                     *map(jnp.asarray, stats))
    got = t_augment.normalize_batch(torch.from_numpy(rgb),
                                    torch.from_numpy(x),
                                    *map(torch.from_numpy, stats))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def _assert_configs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert isinstance(got[k], np.ndarray), k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert type(got[k]) is type(w) and got[k] == w, k


@pytest.mark.parametrize("path", sorted(t_configs.LEAVES))
def test_config_matches_jax(path):
    got = t_configs.load_config(path)
    assert isinstance(got, t_configs.AttrDict)
    _assert_configs_equal(got, j_config.load_config(path))
    got.num_classes = -1  # a fresh copy each time
    assert t_configs.load_config(path).num_classes != -1


def test_config_honours_data_root(monkeypatch):
    """DFORMER_DATA_ROOT read when the config is built (the JAX leaf module
    reads it at import: reloaded here under the variable, then again
    without it)."""
    path = "local_configs.NYUDepthv2.DFormer_Large"
    module = importlib.import_module(path)
    monkeypatch.setenv("DFORMER_DATA_ROOT", "/data/rgbd")
    try:
        importlib.reload(module)
        got = t_configs.load_config(path)
        assert got.eval_source == "/data/rgbd/NYUDepthv2/test.txt"
        _assert_configs_equal(got, j_config.load_config(path))
    finally:
        monkeypatch.delenv("DFORMER_DATA_ROOT")
        importlib.reload(module)


@pytest.fixture(scope="module")
def tiny_models():
    """Two Tiny models (64x96, 11 classes, fp32, CPU) drawn from seeds 0
    and 1, one input with fixed NMF bases, and each model's logits on it."""
    a, b = (entry.build("DFormer-Tiny", (64, 96), 11, None, "cpu", seed=s)
            for s in (0, 1))
    rng = np.random.RandomState(8)
    inputs = [torch.from_numpy(rng.rand(1, 64, 96, 3).astype(np.float32))
              for _ in range(2)]
    bases = torch.from_numpy(rng.rand(1, 512, 64).astype(np.float32))
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    with torch.no_grad():
        logits = [m(*inputs, bases=bases) for m in (a, b)]
    return a, b, inputs, bases, logits


@pytest.mark.parametrize("wrapper", ["model", "state_dict", "state_dict_ema",
                                     None])
def test_torch_checkpoint_round_trip(tiny_models, tmp_path, wrapper):
    src, dst, inputs, bases, (want, before) = tiny_models
    dst = copy.deepcopy(dst)
    sd = dict(src.state_dict())
    sd["decode_head.squeeze.bn.num_batches_tracked"] = torch.tensor(5)
    path = tmp_path / "ckpt.pth"
    torch.save(sd if wrapper is None else {wrapper: sd, "epoch": 3}, path)
    assert sorted(load_torch_checkpoint(str(path))) == sorted(
        src.state_dict())
    assert not torch.equal(before, want)
    with torch.no_grad():
        got = load_checkpoint(dst, str(path))(*inputs, bases=bases)
    assert torch.equal(got, want)


def test_torch_checkpoint_load_is_strict(tiny_models, tmp_path):
    src, dst, *_ = tiny_models
    sd = dict(src.state_dict())
    sd["decode_head.extra.weight"] = torch.zeros(1)
    del sd["decode_head.conv_seg.bias"]
    path = tmp_path / "bad.pth"
    torch.save({"model": sd}, path)
    with pytest.raises(RuntimeError, match="Missing key.*conv_seg.bias"
                       "(.|\n)*Unexpected key.*decode_head.extra.weight"):
        load_checkpoint(dst, str(path))
