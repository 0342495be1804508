"""The port's native loader (`dformer_torch/native/loader.cpp` through
`data/native_loader.py` and `data/loader.NativeBatchLoader`) on a small
JPEG/PNG tree in `tmp_path`, written by the port's `make_synth_dataset`:
its batches equal the JAX package's `NativeBatchLoader`'s exactly and the
port's Python `Loader`'s (PNG exact, JPEG within a mean absolute
difference of 3, as `tests/test_native_loader.py` allows); a failed build
raises instead of falling back to `Loader`; the train tool takes a step
with `--native-loader`; the pipeline bench prints its records; and the
port's dataset writer writes the root tool's files."""

import json
import os

import numpy as np
import pytest
import torch

from dformer_torch import configs as t_configs
from dformer_torch.data import loader as t_loader
from dformer_torch.data import native_loader as t_native
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import make_synth_dataset as t_synth
from dformer_torch.tools import pipeline_bench
from dformer_torch.tools import train as t_train_tool
from dformer_tpu.data import datasets as j_datasets
from dformer_tpu.data import loader as j_loader
from tools import make_synth_dataset as j_synth

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
HW = (64, 96)
N_TRAIN, N_VAL = 6, 2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    t_synth.generate(root, n_train=N_TRAIN, n_val=N_VAL, hw=HW,
                     num_classes=11, quiet=True)
    return root


def _cfg(root, monkeypatch, **over):
    """NYUDepthv2's Tiny config reading the tree, cut to the Narrow1 model
    at 64x96, batch 2, 2 iterations per epoch."""
    monkeypatch.setenv("DFORMER_DATA_ROOT", root)
    cfg = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.update(backbone="DFormer-Narrow1", image_height=HW[0],
               image_width=HW[1], eval_crop_size=list(HW), num_classes=11,
               batch_size=2, niters_per_epoch=2, num_train_imgs=N_TRAIN,
               num_eval_imgs=N_VAL, pretrained_model=None)
    cfg.update(over)
    return cfg


def _epochs(loader, epochs=(1, 2)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.extend(loader)
    return out


def test_native_batches_equal_the_jax_native_loader(tree, monkeypatch):
    cfg = _cfg(tree, monkeypatch)
    setting = t_loader._data_setting(cfg)
    kw = dict(batch_size=2, hw=HW, shuffle=True, drop_last=True, seed=5)
    port = t_loader.NativeBatchLoader(
        t_loader.RGBXDataset(setting, "train", file_length=4), **kw)
    jax_loader = j_loader.NativeBatchLoader(
        j_datasets.RGBXDataset(setting, "train", file_length=4), **kw)
    got, want = _epochs(port), _epochs(jax_loader)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in ("rgb", "gt", "modal_x"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
        assert g["fn"] == w["fn"]


def test_native_batches_equal_the_python_loader(tree, monkeypatch):
    """Same items in the same order as `train_batches`' `Loader`: labels
    and X (PNG) exact, rgb (JPEG, libjpeg against cv2's decoder) close;
    each batch a copy that the next decodes do not overwrite; an epoch
    left early waits for the decode in flight."""
    cfg = _cfg(tree, monkeypatch)
    native = t_loader.train_batches(cfg, native=True)
    assert isinstance(native, t_loader.NativeBatchLoader)
    epoch = iter(native)  # left after one batch, with the next in flight
    next(epoch)
    epoch.close()
    got, want = _epochs(native), _epochs(t_loader.train_batches(cfg))
    assert len(got) == len(want) == 4
    first = got[0]["rgb"].copy()
    for g, w in zip(got, want):
        assert g["rgb"].shape == w["rgb"].shape == (2, *HW, 3)
        np.testing.assert_array_equal(g["gt"], w["gt"])
        np.testing.assert_array_equal(g["modal_x"], w["modal_x"])
        diff = np.abs(g["rgb"].astype(int) - w["rgb"].astype(int))
        assert diff.mean() < 3.0
        assert (g["gt"] == 255).any() and g["gt"][g["gt"] != 255].max() < 11
    np.testing.assert_array_equal(got[0]["rgb"], first)


@pytest.mark.parametrize("broken", ["compiler", "source"])
def test_a_failed_build_raises(broken, tree, tmp_path, monkeypatch):
    """No library, no loader: `train_batches(native=True)` raises with the
    compiler's complaint and never returns the Python `Loader`."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path / "build")
    if broken == "compiler":
        monkeypatch.setattr(t_native, "CXX", str(tmp_path / "no-such-g++"))
        match = "cannot run"
    else:
        bad = tmp_path / "loader.cpp"
        bad.write_text("this is not C++\n")
        monkeypatch.setattr(t_native, "SOURCE", bad)
        match = "failed"
    with pytest.raises(RuntimeError, match=match):
        t_loader.train_batches(_cfg(tree, monkeypatch), native=True)
    assert not list((tmp_path / "build").glob("libdfloader_*.so"))


def test_train_tool_steps_with_the_native_loader(tree, tmp_path,
                                                 monkeypatch):
    monkeypatch.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
    cfg = _cfg(tree, monkeypatch, niters_per_epoch=1, nepochs=1,
               warm_up_epoch=0, log_dir_base=str(tmp_path / "run"))
    args = t_train_tool.parse_args(
        ["--config=x", "--device=cpu", "--native-loader", "--no-mst",
         "--no-amp", "--val_batch_size=2"])
    out = t_train_tool.run(cfg, args)
    assert out["trainer"].step == 1 and np.isfinite(out["losses"][1])


def test_pipeline_bench_prints_its_records(tree, monkeypatch, capsys):
    monkeypatch.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Test.Narrow1",
                        lambda: _cfg(tree, monkeypatch))
    records = pipeline_bench.main(
        ["--root", tree, "--config=local_configs.Test.Narrow1", "--batch",
         "2", "--threads", "2", "--iters", "3", "--e2e", "--device", "cpu"])
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert printed == records
    assert [(r["phase"], r["loader"]) for r in records] == [
        ("loader", "thread"), ("loader", "native"), ("e2e", "thread"),
        ("e2e", "native"), ("e2e", "in_memory")]
    for r in records:
        assert np.isfinite(r["img_per_s"]) and r["img_per_s"] > 0
    assert all(r["steps"] == 3 for r in records[2:])


def test_make_synth_dataset_writes_the_root_tools_files(tmp_path):
    kw = dict(n_train=2, n_val=1, hw=(48, 64), num_classes=11, seed=3,
              quiet=True)
    port = t_synth.generate(str(tmp_path / "port"), **kw)
    root = j_synth.generate(str(tmp_path / "root"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, fs in os.walk(root) for f in fs)
    assert len(files) == 3 * 3 + 2
    assert files == sorted(os.path.relpath(os.path.join(d, f), port)
                           for d, _, fs in os.walk(port) for f in fs)
    for f in files:
        with open(os.path.join(port, f), "rb") as a, \
                open(os.path.join(root, f), "rb") as b:
            assert a.read() == b.read(), f
