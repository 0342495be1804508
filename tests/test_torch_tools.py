"""The port's measurement tools on the CPU at a small size: `bench`,
`tools.latency`, `tools.benchmark`, `tools.train_bench` and
`tools.eval_bench` each print one JSON line (two for the bench) with their
documented keys, on a model with one block per stage at 64x96; the bench
serves `entry.infer`'s labels; `tools.benchmark` counts DFormer-Tiny +
ham's parameters leaf for leaf as the JAX model holds them; the card-only
`tools.grad_determinism` measures a spread between runs as it says. Their
card numbers come from `chip_smoke.py`'s `tools` phase."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dformer_torch import bench, configs as t_configs, entry
from dformer_torch.models.builder import build_model as t_build_model
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import (benchmark, eval_bench, grad_determinism,
                                 latency, train_bench)
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import load_config as j_load_config
from dformer_tpu.models import build_model as j_build_model

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
HW = (64, 96)
CONFIG = "local_configs.Test.Narrow1"
SMALL = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def narrow():
    """One torch thread, and a config of the Narrow1 model at 64x96."""
    def cfg():
        c = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
        c.update(backbone="DFormer-Narrow1", image_height=HW[0],
                 image_width=HW[1], eval_crop_size=list(HW), num_classes=11)
        return c

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(t_configs.LEAVES, CONFIG, cfg)
        yield
    torch.set_num_threads(before)


def _records(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def _positive(record, keys):
    for key in keys:
        assert np.isfinite(record[key]) and record[key] > 0, (key, record)


def test_bench_prints_the_headline_then_the_train_record(capsys):
    labels = bench.main(["--backbone", "DFormer-Narrow1", "--batch", "2",
                         "--height", str(HW[0]), "--width", str(HW[1]),
                         "--warmup", "1", "--reps", "2", *SMALL])
    head, full = _records(capsys)
    assert head["metric"] == "dformer_narrow1_64x96_infer_throughput"
    assert head["unit"] == "images/sec/chip" and head["vs_baseline"] is None
    assert (head["device"], head["timing"]) == ("cpu", "host clock")
    _positive(head, ("value", "forward_ms"))
    assert full == {**head, "train_step_ms_bs8": full["train_step_ms_bs8"],
                    "train_imgs_per_sec_per_chip":
                        full["train_imgs_per_sec_per_chip"]}
    _positive(full, ("train_step_ms_bs8", "train_imgs_per_sec_per_chip"))
    model = entry.build("DFormer-Narrow1", HW, 40, torch.bfloat16, "cpu",
                        seed=0)
    rgb, modal = bench.inputs(np.random.RandomState(0), 2, HW, "cpu")
    assert torch.equal(entry.infer(model, rgb, modal), labels)


def test_latency_prints_avg_p50_p90(capsys):
    latency.main([f"--config={CONFIG}", "--height", str(HW[0]), "--width",
                  str(HW[1]), "--warmup", "1", "--reps", "4", *SMALL])
    (rec,) = _records(capsys)
    assert (rec["batch"], rec["hw"], rec["dtype"], rec["reps"]) == \
        (1, list(HW), "bfloat16", 4)
    _positive(rec, ("avg_ms", "p50_ms", "p90_ms"))
    assert rec["p50_ms"] <= rec["p90_ms"]


def test_train_bench_prints_ms_per_step(capsys):
    train_bench.main([f"--config={CONFIG}", "--batch", "2", "--warmup", "1",
                      "--reps", "2", *SMALL])
    (rec,) = _records(capsys)
    assert (rec["batch"], rec["hw"], rec["device"]) == (2, list(HW), "cpu")
    _positive(rec, ("step_ms", "img_per_s", "epoch_seconds", "last_loss"))


@pytest.mark.parametrize("argv, mode", [
    ([], "MSF+flip"), (["--sliding"], "MSF+sliding"),
    (["--single-scale", "--ops"], "single-scale")])
def test_eval_bench_prints_ms_per_image(argv, mode, capsys):
    eval_bench.main([f"--config={CONFIG}", "--batch", "2", "--nbatches",
                     "1", *argv, *SMALL])
    (rec,) = _records(capsys)
    assert (rec["mode"], rec["images"]) == (mode, 2)
    _positive(rec, ("ms_per_image", "img_per_s", "first_batch_s"))
    assert ("top" in rec) == ("--ops" in argv)


def test_benchmark_counts_tiny_parameters_as_jax_holds_them(capsys):
    """DFormer-Tiny + ham at 64x96: the tool's count equals the JAX
    model's parameters (from `jax.eval_shape` of its init: no compile), and
    every port parameter has the JAX leaf of its name and shape."""
    config = "local_configs.NYUDepthv2.DFormer_Tiny"
    benchmark.main([f"--config={config}", "--height", str(HW[0]),
                    "--width", str(HW[1])])
    (rec,) = _records(capsys)
    _positive(rec, ("params", "flops"))
    assert rec["counted_on"].startswith("cpu")

    jcfg = j_load_config(config)
    z = jax.ShapeDtypeStruct((1, *HW, 3), jnp.float32)
    shapes = jax.eval_shape(j_build_model(jcfg).init,
                            jax.random.PRNGKey(0), z, z)
    assert rec["params"] == sum(int(np.prod(s.shape)) for s in
                                jax.tree.leaves(shapes["params"]))
    want = from_jax_variables(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), shapes))
    port = dict(t_build_model(t_configs.load_config(config),
                              device="cpu").named_parameters())
    assert {k: tuple(v.shape) for k, v in port.items()} == \
        {k: tuple(want[k].shape) for k in port}
    assert rec["params"] == sum(p.numel() for p in port.values())


def test_grad_determinism_spread_names_the_leaf_that_varies():
    """The card tool's measure: the largest spread between runs of one
    leaf, as a share of that leaf's max (leaves below NULL_GRAD are
    counted, not scaled), and how many leaves vary."""
    a = {"w": torch.tensor([1.0, -4.0]), "b": torch.tensor([2.0])}
    b = {"w": torch.tensor([1.0, -3.0]), "b": torch.tensor([2.0])}
    c = {"w": torch.tensor([1.5, -4.0]), "b": torch.tensor([2.0])}
    assert grad_determinism._spread([a, b, c]) == (0.25, "w", 1)
    assert grad_determinism._spread([a, a]) == (0.0, "", 0)
    null = [{"b": torch.tensor([1e-9])}, {"b": torch.tensor([3e-9])}]
    assert grad_determinism._spread(null) == (0.0, "", 1)  # counted only
