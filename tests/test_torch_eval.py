"""The port's evaluation path against the JAX package, fp32 on the CPU: the
confusion-matrix metrics, the Evaluator's single-scale, MSF + flip and
sliding-window modes on a small shared seg model, the true-extent
regrouping of canvas batches, and MSF + flip of a narrow DFormer + ham.

Hists are compared pixel by pixel where the JAX probabilities separate the
top two classes by more than twice the probability tolerance (closer pixels
may rank the other way within the tolerance): such pixels are counted,
printed and taken out of both hists before they are compared."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from dformer_torch import entry
from dformer_torch.configs import load_config
from dformer_torch.eval.evaluate import Evaluator as TEvaluator
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.ops import metrics as tm
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.eval.evaluate import Evaluator as JEvaluator
from dformer_tpu.eval.evaluate import ceil32
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.decoders.ham import _uniform_bases
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.ops import metrics as jm
from tests.test_eval_parity import FakeSeg
from tests.test_torch_model import _random_variables

NC = 5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _labels(rng, shape, nc, ignored=0.05):
    gt = rng.randint(0, nc, shape)
    return np.where(rng.rand(*shape) < ignored, 255, gt).astype(np.int32)


# -- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("ignore_index", [255, 2])
def test_confusion_matrix_matches_jax(ignore_index):
    rng = np.random.RandomState(0)
    pred = rng.randint(0, NC, (2, 9, 13))
    target = rng.randint(0, NC, (2, 9, 13))
    # targets outside [0, nc) besides the ignore label, and out-of-range
    # predictions: the JAX one-hot form drops them all
    target.flat[rng.choice(target.size, 40, replace=False)] = \
        rng.choice([-1, NC, NC + 3, 255], 40)
    pred.flat[rng.choice(pred.size, 10, replace=False)] = NC + 1
    want = np.asarray(jm.confusion_matrix(jnp.asarray(pred),
                                          jnp.asarray(target), NC,
                                          ignore_index))
    got = tm.confusion_matrix(torch.from_numpy(pred),
                              torch.from_numpy(target), NC, ignore_index)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_hist_scores_and_accumulator_match_jax():
    rng = np.random.RandomState(1)
    hist = rng.randint(0, 50, (NC, NC))
    hist[3] = 0  # a class never in the ground truth
    hist[:, 3] = 0  # ... nor predicted: its IoU and F1 are 0/0
    for fn in ("iou_from_hist", "f1_from_hist", "pixel_acc_from_hist"):
        assert getattr(tm, fn)(hist) == getattr(jm, fn)(hist), fn
    logits = rng.randn(2, 6, 7, NC).astype(np.float32)
    target = _labels(rng, (2, 6, 7), NC)
    mj, mt = jm.Metrics(NC), tm.Metrics(NC)
    for m, arr in ((mj, jnp.asarray), (mt, torch.from_numpy)):
        m.update_hist(hist)
        m.update(arr(logits), arr(target))
        assert m.merge_across_processes() is m  # no process group: a no-op
    assert mt.hist.dtype == np.int64
    np.testing.assert_array_equal(mt.hist, mj.hist)
    assert mt.compute_iou() == mj.compute_iou()
    assert mt.compute_f1() == mj.compute_f1()
    assert mt.compute_pixel_acc() == mj.compute_pixel_acc()


@pytest.mark.parametrize("topk", [1, (1, 5)])
@pytest.mark.parametrize("thresh", [None, 0.5])
def test_accuracy_matches_jax(topk, thresh):
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 5, 6, 11).astype(np.float32)
    labels = _labels(rng, (2, 5, 6), 11, ignored=0.2)
    want = jm.accuracy(jnp.asarray(logits), jnp.asarray(labels), topk,
                       thresh=thresh)
    got = tm.accuracy(torch.from_numpy(logits), torch.from_numpy(labels),
                      topk, thresh=thresh)
    if isinstance(topk, int):
        want, got = [want], [got]
    assert len(got) == len(want)
    np.testing.assert_allclose([float(g) for g in got],
                               [float(w) for w in want], rtol=0, atol=1e-6)


def test_merge_across_processes_sums_over_the_group(tmp_path):
    import torch.distributed as dist

    m = tm.Metrics(NC)
    m.hist[1, 2] = 7
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            world_size=1, rank=0)
    try:
        m.merge_across_processes()
    finally:
        dist.destroy_process_group()
    assert m.hist.dtype == np.int64 and m.hist.sum() == 7 and m.hist[1, 2] == 7


# -- Evaluator logic on a shared small model ----------------------------------

def _assert_hists_match(hist_t, hist_j, probs_t, probs_j, gt, tol):
    """Probabilities within `tol`; predictions and hists equal where the
    JAX top-two margin is at least 2 * tol."""
    probs_t, probs_j = np.asarray(probs_t), np.asarray(probs_j)
    assert probs_t.shape == probs_j.shape
    np.testing.assert_allclose(probs_t, probs_j, rtol=0, atol=tol)
    nc = probs_j.shape[-1]
    top2 = np.sort(probs_j, axis=-1)[..., -2:]
    close = (top2[..., 1] - top2[..., 0]) < 2 * tol
    print(f"{int(close.sum())} of {close.size} pixels within {2 * tol} of "
          f"a tie: excluded from the hist comparison")
    pred_t, pred_j = probs_t.argmax(-1), probs_j.argmax(-1)
    np.testing.assert_array_equal(pred_t[~close], pred_j[~close])

    def hist_of(pred):
        keep = close & (gt != 255)
        return np.bincount(gt[keep] * nc + pred[keep],
                           minlength=nc * nc).reshape(nc, nc)

    np.testing.assert_array_equal(np.asarray(hist_t) - hist_of(pred_t),
                                  np.asarray(hist_j) - hist_of(pred_j))


@pytest.fixture(scope="module")
def fake_seg():
    """FakeSeg (3x3 conv over concat(rgb, modal)) in JAX and its torch
    mirror on the same weights, as forward= callables, and one batch."""
    model = FakeSeg(num_classes=NC)
    x = jnp.zeros((1, 8, 8, 3))
    variables = model.init(jax.random.PRNGKey(0), x, x)
    conv = variables["params"]["Conv_0"]
    w = torch.from_numpy(np.asarray(conv["kernel"]).transpose(3, 2, 0, 1)
                         .copy())
    b = torch.from_numpy(np.asarray(conv["bias"]).copy())

    def t_forward(rgb, modal):
        x = torch.cat([rgb, modal], dim=-1).permute(0, 3, 1, 2)
        return F.conv2d(x, w, b, padding=1).permute(0, 2, 3, 1)

    def j_forward(rgb, modal):
        return model.apply(variables, rgb, modal)

    rng = np.random.RandomState(3)
    batch = dict(rgb=rng.rand(2, 32, 48, 3).astype(np.float32),
                 modal_x=rng.rand(2, 32, 48, 3).astype(np.float32),
                 gt=_labels(rng, (2, 32, 48), NC))
    return j_forward, t_forward, batch


def _cfg(crop=(16, 24)):
    return AttrDict(num_classes=NC, background=255,
                    eval_crop_size=list(crop), eval_stride_rate=2 / 3)


@pytest.mark.parametrize("mode", ["single", "sliding", "sliding_upscale"])
def test_single_scale_and_sliding_match_jax(fake_seg, mode):
    """Single scale; sliding with a 3x3 window grid; sliding on an input
    smaller than the crop (upscaled, logits resized back)."""
    j_forward, t_forward, batch = fake_seg
    cfg = _cfg((64, 96) if mode == "sliding_upscale" else (16, 24))
    sliding = mode != "single"
    ev_j = JEvaluator(None, {}, cfg, sliding=sliding, forward=j_forward)
    ev_t = TEvaluator(None, cfg, sliding=sliding, forward=t_forward,
                      device="cpu")
    hist_j = ev_j.evaluate([batch]).hist
    hist_t = ev_t.evaluate([batch]).hist
    probs_j, _ = ev_j._get_jit("single")(jnp.asarray(batch["rgb"]),
                                         jnp.asarray(batch["modal_x"]),
                                         jnp.asarray(batch["gt"]))
    probs_t = ev_t.single_probs(torch.from_numpy(batch["rgb"]),
                                torch.from_numpy(batch["modal_x"]), (32, 48))
    assert hist_t.sum() == (batch["gt"] != 255).sum()
    _assert_hists_match(hist_t, hist_j, probs_t, probs_j, batch["gt"], 1e-5)


def _jax_msf_acc(ev, rgb, modal, hw, scales, flip):
    """The accumulator `evaluate_msf` builds, from the JAX Evaluator's own
    per-scale programs."""
    H, W = hw
    acc = 0.0
    for scale in scales:
        fn = ev._get_jit("scale", new_hw=(ceil32(int(scale * H)),
                                          ceil32(int(scale * W))),
                         out_hw=(H, W))
        acc = acc + fn(rgb, modal)
        if flip:
            acc = acc + fn(rgb[:, :, ::-1], modal[:, :, ::-1])[:, :, ::-1]
    return np.asarray(acc)


def test_msf_flip_matches_jax(fake_seg):
    j_forward, t_forward, batch = fake_seg
    scales = [0.75, 1.0, 1.25]
    ev_j = JEvaluator(None, {}, _cfg(), forward=j_forward)
    ev_t = TEvaluator(None, _cfg(), forward=t_forward, device="cpu")
    hist_j = ev_j.evaluate_msf([batch], scales, flip=True).hist
    hist_t = ev_t.evaluate_msf([batch], scales, flip=True).hist
    acc_j = _jax_msf_acc(ev_j, jnp.asarray(batch["rgb"]),
                         jnp.asarray(batch["modal_x"]), (32, 48), scales,
                         True)
    acc_t = ev_t.msf_probs(torch.from_numpy(batch["rgb"]),
                           torch.from_numpy(batch["modal_x"]), (32, 48),
                           scales, True)
    np.testing.assert_allclose(acc_t.sum(-1).numpy(), 2 * len(scales),
                               atol=1e-5)
    _assert_hists_match(hist_t, hist_j, acc_t, acc_j, batch["gt"], 1e-5)


def test_true_extent_batches_match_jax():
    """Canvas batches of three geometries: the same groups in the same
    order, the same nb, the same padding (last sample repeated, gt =
    background), from one cross-batch pool."""
    from dformer_torch.data.loader import Loader

    rng = np.random.RandomState(4)
    geoms = {"A": (20, 30), "B": (24, 28), "C": (16, 16)}

    def item(g, i):
        h, w = geoms[g]
        return dict(rgb=rng.rand(h, w, 3).astype(np.float32),
                    modal_x=rng.rand(h, w, 3).astype(np.float32),
                    gt=_labels(rng, (h, w), NC), fn=f"{g}{i}")

    collate = Loader(None, 3)._collate
    batches = [collate([item(g, i) for i, g in enumerate(gs)])
               for gs in ("ABA", "AAC", "BBC")]
    assert all("hw" in b for b in batches)
    got = list(TEvaluator(None, _cfg(), device="cpu")
               ._true_extent_batches(batches))
    want = list(JEvaluator(None, {}, _cfg())._true_extent_batches(batches))
    assert [g["nb"] for g in got] == [g["nb"] for g in want] == [3, 3, 1, 2]
    # A's tail of 1 pads to the cap of 3: A already flushed a full group
    assert [g["rgb"].shape[0] for g in got] == [3, 3, 3, 2]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


# -- the slice: narrow DFormer + ham, MSF + flip ------------------------------

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))


def test_narrow_dformer_msf_flip_matches_jax():
    """One narrow DFormer + LightHamHead (depth 1 per stage) on the same
    weights, 1x64x96, MSF scales [0.5, 1.0] with flip. The port's forward
    takes the JAX package's deterministic NMF bases for its batch size."""
    scales, hw = [0.5, 1.0], (64, 96)
    cfg = AttrDict(backbone="DFormer-Narrow1", decoder="ham", num_classes=11,
                   decoder_embed_dim=64, drop_path_rate=0.1, aux_rate=0.0,
                   bn_eps=1e-3, background=255)
    rng = np.random.RandomState(5)
    batch = dict(rgb=rng.randn(1, *hw, 3).astype(np.float32),
                 modal_x=rng.randn(1, *hw, 3).astype(np.float32),
                 gt=_labels(rng, (1, *hw), 11))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        jmodel = j_build_model(cfg, pallas="off")
        x = jnp.asarray(batch["rgb"])
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), x, x)
        variables = _random_variables(dict(shapes), seed=6)
        ev_j = JEvaluator(jmodel, variables, cfg)
        hist_j = ev_j.evaluate_msf([batch], scales, flip=True).hist
        acc_j = _jax_msf_acc(ev_j, x, jnp.asarray(batch["modal_x"]), hw,
                             scales, True)
        tmodel = t_build_model(cfg, device="cpu").eval()
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    bases = {}

    def forward(rgb, modal):
        b = rgb.shape[0]
        if b not in bases:
            bases[b] = torch.from_numpy(np.array(
                _uniform_bases(jax.random.PRNGKey(0), b, 512, 64)))
        return tmodel(rgb, modal, bases=bases[b])

    ev_t = TEvaluator(tmodel, cfg, forward=forward, device="cpu")
    hist_t = ev_t.evaluate_msf([batch], scales, flip=True).hist
    acc_t = ev_t.msf_probs(torch.from_numpy(batch["rgb"]),
                           torch.from_numpy(batch["modal_x"]), hw, scales,
                           True)
    assert hist_t.sum() == (batch["gt"] != 255).sum()
    _assert_hists_match(hist_t, hist_j, acc_t, acc_j, batch["gt"], 1e-4)


# -- entry point and tool -------------------------------------------------------

def test_build_evaluator_runs_msf_on_synthetic_batches():
    """entry.build_evaluator on a loaded config (Tiny, cut to 64x96): MSF +
    flip over 3 synthetic images in batches of 2; every labelled pixel
    lands in the hist."""
    cfg = load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.image_height, cfg.image_width = 64, 96
    ev, batches = entry.build_evaluator(cfg, device="cpu", synthetic=True,
                                        n=3, val_batch_size=2)
    m = ev.evaluate_msf(batches, scales=[0.5, 1.0], flip=cfg.eval_flip)
    assert m.hist.sum() == 3 * 64 * 96
    assert all(np.isfinite(v) for v in (m.compute_iou()[1],
                                         m.compute_pixel_acc()[1],
                                         m.compute_f1()[1]))
