"""The port's few-shot and semi-supervised Trav training against the JAX
package on the CPU, fp32: the prototype functions and the prototype
matching forward, one FSS step (loss,
contrastive term, gradients, the trainable mask, frozen parameters, the
coverage audit), the Trav data (lidar, manifests without pandas, k-fold
splits, datasets, episodic samplers, device preparation with JAX's flips),
the pseudo-labels, and both tools end to end over an on-disk fixture."""

import copy
import os
import pickle
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from dformer_torch import configs as t_configs
from dformer_torch.data import trav as t_trav
from dformer_torch.data.loader import Loader as TLoader
from dformer_torch.eval.pseudo_label import \
    infer_unlabeled_masks as t_infer_masks
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models import fewshot as t_fs
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import train_trav as t_trav_tool
from dformer_torch.tools import train_trav_fss as t_fss_tool
from dformer_torch.train.audit import coverage_audit as t_audit
from dformer_torch.train.audit import param_paths as t_param_paths
from dformer_torch.train.fss import fss_train_step
from dformer_torch.train.fss import fss_trainable_mask as t_fss_mask
from dformer_torch.train.loop import coverage_flags
from dformer_torch.train.optim import make_optimizer as t_make_optimizer
from dformer_torch.train.optim import make_schedule as t_make_schedule
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.data import trav as j_trav
from dformer_tpu.data.loader import Loader as JLoader
from dformer_tpu.eval.pseudo_label import \
    infer_unlabeled_masks as j_infer_masks
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models import fewshot as j_fs
from dformer_tpu.models.builder import EncoderDecoder as JEncoderDecoder
from dformer_tpu.models.decoders import ham as j_ham
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.ops.loss import \
    softmax_cross_entropy_masked_mean as j_masked_ce
from dformer_tpu.ops.resize import resize_bilinear as j_resize
from dformer_tpu.train.audit import coverage_audit as j_audit
from dformer_tpu.train.audit import flags_from as j_flags_from
from dformer_tpu.train.audit import param_paths as j_param_paths
from dformer_tpu.train.fss import fss_trainable_mask as j_fss_mask
from dformer_tpu.utils.convert import convert_model_state

from test_torch_model import NARROW, _random_variables
from test_torch_runtime import WandbStub
from test_torch_train import _IdentityDropout
from test_torch_trav import HW, _max_rel, trav_cfg, trav_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# DFormer-Base's widths with stages 0-1 cut to two blocks and stages 2-3 to
# one; stage 0, which the FSS mask trains, keeps more than one. The FSS
# step and the tools run on this body in both frameworks (the JAX step's
# gradient program at full depth takes ~30 s to compile);
# tests/test_torch_trav.py holds two blocks a stage.
SHORT_BASE = dict(J_VARIANTS["DFormer-Base"], depths=(2, 1, 1, 1))


@pytest.fixture(scope="module", autouse=True)
def short_base():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Base", SHORT_BASE)
        mp.setitem(T_VARIANTS, "DFormer-Base", SHORT_BASE)
        yield


def _flax_names(model):
    """{flax path: port parameter name}, through the JAX converter (each
    parameter carried across as a tensor filled with its index)."""
    named = list(model.named_parameters())
    params, _ = convert_model_state(
        {n: np.full(p.shape, i, np.float32) for i, (n, p) in enumerate(named)})
    return {tuple(k.key for k in path): named[int(np.asarray(leaf).flat[0])][0]
            for path, leaf in jax.tree_util.tree_leaves_with_path(params)}


# --- prototypes and the contrastive term -------------------------------------

def test_fewshot_functions_match_jax():
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 6, 7, 16).astype(np.float32)
    masks = rng.randint(0, 3, (3, 6, 7)).astype(np.int64)
    masks[0, :2] = 255
    want = np.asarray(j_fs.compute_prototypes(feats, masks, 3))
    got = t_fs.compute_prototypes(torch.from_numpy(feats),
                                  torch.from_numpy(masks), 3)
    assert got.shape == (3, 3, 16)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    q = rng.randn(3, 5, 4, 16).astype(np.float32)
    ids = t_fs.match_prototypes(torch.from_numpy(q), got)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(j_fs.match_prototypes(q, want)))

    q_masks = rng.randint(0, 3, (3, 5, 4))
    for protos in (want, want[:2]):
        con_j = float(j_fs.contrastive_loss(q, protos, q_masks))
        con_t = float(t_fs.contrastive_loss(
            torch.from_numpy(q), torch.from_numpy(np.ascontiguousarray(
                protos)), torch.from_numpy(q_masks)))
        assert abs(con_t - con_j) <= 1e-6, (con_t, con_j)


def test_fewshot_segmentation_matches_jax():
    """The prototype-matching episode forward on a narrow DFormer + ham
    (one block per stage, same numpy-drawn weights): equal class ids."""
    narrow1 = dict(NARROW, depths=(1, 1, 1, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow", narrow1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow", narrow1)
        cfg = trav_cfg(backbone="DFormer-Narrow")
        jmodel = j_build_model(cfg, pallas="off")
        rng = np.random.RandomState(3)
        s_imgs = rng.randn(2, *HW, 3).astype(np.float32)
        s_depths = rng.randn(2, *HW, 3).astype(np.float32)
        s_masks = rng.randint(0, 2, (2, *HW)).astype(np.int32)
        q_imgs = rng.randn(2, *HW, 3).astype(np.float32)
        q_depths = rng.randn(2, *HW, 3).astype(np.float32)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), q_imgs,
                                q_depths)
        variables = _random_variables(dict(shapes), seed=4)
        want = jax.jit(j_fs.FewShotSegmentation(jmodel, variables))(
            s_imgs, s_depths, s_masks, q_imgs, q_depths)
        tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    got = t_fs.FewShotSegmentation(tmodel)(
        *(torch.from_numpy(a) for a in
          (s_imgs, s_depths, s_masks, q_imgs, q_depths)))
    assert got.shape == (2, 2, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- one FSS step ------------------------------------------------------------

CON_W = 0.5


@pytest.fixture(scope="module")
def fss_step():
    """One FSS step (B 1, S 1, 64x96, contrastive weight CON_W) from the
    same numpy-drawn weights: JAX's loss terms, gradients and BatchNorm
    statistics from `jax.value_and_grad` of the JAX step's loss (gradients
    of the trainable parameters), dropout
    off and the NMF bases pinned on both sides; the port's model before and
    after `fss_train_step`, its gradients and optimizer."""
    cfg = trav_cfg(optimizer="AdamW", lr=1e-3, lr_power=0.9,
                   weight_decay=0.01, momentum=0.9, nepochs=2,
                   niters_per_epoch=2, warm_up_epoch=0)
    rng = np.random.RandomState(7)
    s_img = rng.randn(1, 1, *HW, 3).astype(np.float32)
    s_gt = np.zeros((1, 1, *HW), np.int32)
    s_gt[..., :HW[1] // 2] = 1
    s_gt[..., :8, :] = 255
    s_depth = rng.randn(1, 1, 360).astype(np.float32)
    q_img = rng.randn(1, *HW, 3).astype(np.float32)
    q_gt = rng.randint(0, 2, (1, *HW)).astype(np.int32)
    q_gt[:, :, :40] = 1
    q_gt[rng.rand(*q_gt.shape) < 0.05] = 255
    q_depth = rng.randn(1, 360).astype(np.float32)
    bases = rng.rand(1, 512, 64).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)

    jmodel = j_build_model(cfg, pallas="off")
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            q_img, q_depth)
    variables = trav_variables(dict(shapes), seed=8)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ham, "Dropout", _IdentityDropout)
        mp.setattr(j_ham, "_uniform_bases",
                   lambda key, b, d, r: jnp.asarray(bases))

        mask = j_fss_mask(variables["params"])

        def loss_fn(params):  # the loss of dformer_tpu.train.fss
            # frozen parameters as constants: their gradients are not
            # compared, and XLA then leaves their products out
            params = jax.tree.map(
                lambda p, t: p if t else jax.lax.stop_gradient(p), params,
                mask)
            (logits, ep), new_vars = jmodel.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                s_img, s_depth, s_gt, q_img, q_depth, train=True,
                deterministic_bases=False, return_episode=True,
                method=JEncoderDecoder.meta_forward, mutable=["batch_stats"],
                rngs={"dropout": jax.random.PRNGKey(1),
                      "nmf": jax.random.PRNGKey(2)})
            ce = j_masked_ce(logits, q_gt, 255)
            qm = jnp.where(q_gt == 255, 0, q_gt)
            qm = j_resize(qm[..., None].astype(jnp.float32),
                          ep["q_top"].shape[1:3])[..., 0]
            qm = jnp.round(qm).astype(jnp.int32)
            protos = jnp.stack([ep["bg"], ep["fg"]])
            con = j_fs.contrastive_loss(ep["q_top"].astype(jnp.float32),
                                        protos.astype(jnp.float32), qm)
            return ce + CON_W * con, (ce, con, new_vars["batch_stats"])

        (loss, (ce, con, stats)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])

    tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    tmodel.decode_head.dropout.rate = 0.0
    before = copy.deepcopy(tmodel)
    mask = t_fss_mask(tmodel)
    opt = t_make_optimizer(cfg, tmodel, mask)
    batch = [torch.from_numpy(a) for a in
             (s_img, s_gt, s_depth, q_img, q_gt, q_depth)]
    got_loss, got_con = fss_train_step(
        tmodel, opt, t_make_schedule(cfg), 0, *batch,
        torch.Generator().manual_seed(0), bases=torch.from_numpy(bases),
        contrastive_weight=CON_W)
    flags = coverage_flags(tmodel, opt)
    return dict(cfg=cfg, variables=variables, batch=batch, bases=bases,
                loss=float(loss), ce=float(ce), con=float(con),
                grads=grads, stats=stats, tmodel=tmodel, before=before,
                mask=mask, opt=opt, got_loss=float(got_loss),
                got_con=float(got_con), flags=flags)


def test_fss_step_loss_and_gradients_match_jax(fss_step):
    r = fss_step
    assert abs(r["got_loss"] - r["loss"]) <= 1e-4 * abs(r["loss"])
    assert abs(r["got_con"] - r["con"]) <= 1e-4 * abs(r["con"])
    assert r["con"] > 0
    want = from_jax_variables({"params": jax.tree.map(np.asarray,
                                                      r["grads"])})
    # Leaves whose JAX gradient is below NULL everywhere are structurally
    # null (a bias whose shift the next BatchNorm removes; query2): their
    # rounding noise is held to NULL, not compared.
    NULL = 3e-7
    checked, null = 0, []
    for name, p in r["tmodel"].named_parameters():
        if not r["mask"][name]:
            continue
        scale = want[name].abs().max().item()
        if scale < NULL:
            assert p.grad.abs().max().item() < NULL, name
            null.append(name)
            continue
        assert (p.grad - want[name]).abs().max().item() <= 1e-3 * scale, name
        checked += 1
    assert checked > 100 and len(null) < 10, null
    # the BatchNorm statistics of the concatenated episode batch
    stats = from_jax_variables({"batch_stats": jax.tree.map(np.asarray,
                                                            r["stats"])})
    for name, buf in r["tmodel"].named_buffers():
        assert _max_rel(buf, stats[name]) <= 1e-4, name


def test_fss_step_trains_only_the_fss_mask(fss_step):
    """The trainable set is the JAX mask's; frozen parameters are
    bit-unchanged after the step, trainable ones with a gradient moved;
    query2 has a zero gradient, which both coverage audits report."""
    r = fss_step
    names = _flax_names(r["tmodel"])
    want = {names[tuple(k.key for k in path)] for path, t in
            jax.tree_util.tree_leaves_with_path(
                j_fss_mask(r["variables"]["params"])) if t}
    got = {n for n, t in r["mask"].items() if t}
    assert got == want
    assert "encoder_backbone.downsample_layers.0.0.weight" not in got
    assert "encoder_backbone.stages.1.0.mlp.fc1.weight" not in got
    before = dict(r["before"].named_parameters())
    for name, p in r["tmodel"].named_parameters():
        if not r["mask"][name]:
            assert torch.equal(p, before[name]), name
        elif bool((p.grad != 0).any()):
            assert not torch.equal(p, before[name]), name
    assert torch.count_nonzero(
        r["tmodel"].encoder_backbone.attn_expand_e.query2.grad) == 0

    q2 = ("encoder_backbone", "attn_expand_e", "query2")
    t_report = t_audit(t_param_paths(r["tmodel"]), *r["flags"],
                       trainable_mask=r["mask"], verbose_grad=False)
    j_paths = j_param_paths(r["grads"])
    j_report = j_audit(j_paths, j_flags_from(r["grads"]),
                       np.zeros(len(j_paths), bool),
                       trainable_mask=j_fss_mask(r["variables"]["params"]),
                       verbose_grad=False)
    assert q2 in t_report["disconnected"] and q2 in j_report["disconnected"]
    assert {".".join(p) for p in t_report["disconnected"]} == \
        {names[p] for p in j_report["disconnected"]}


def test_fss_step_without_the_contrastive_term(fss_step):
    """The cross-entropy-only step's loss is JAX's CE term."""
    r = fss_step
    model = copy.deepcopy(r["before"])
    mask = t_fss_mask(model)
    loss = fss_train_step(model, t_make_optimizer(r["cfg"], model, mask),
                          t_make_schedule(r["cfg"]), 0, *r["batch"],
                          torch.Generator().manual_seed(0),
                          bases=torch.from_numpy(r["bases"]))
    assert abs(float(loss) - r["ce"]) <= 1e-4 * abs(r["ce"])


def test_fss_mask_refuses_a_stock_dformer():
    model = t_build_model(trav_cfg(backbone="DFormer-Tiny"), device="cpu")
    with pytest.raises(ValueError, match="DFormerTrav"):
        t_fss_mask(model)
    with pytest.raises(ValueError, match="DFormerTrav"):
        j_fss_mask({"encoder_backbone": {"stem": {}}})


# --- data --------------------------------------------------------------------

def _write_fixture(root, n=8, hw=HW):
    """Images (png), masks (npy) and LaserScan pickles under `root`, and
    the manifests the tools read: support.csv / query.csv (an unnamed index
    column, img, image, depth, label; some labels missing or "NA"),
    labeled.csv
    (image, depth, label), unlabeled.csv (img_path, depth_path)."""
    import cv2

    rng = np.random.RandomState(11)
    for d in ("images", "labels", "scans"):
        os.makedirs(f"{root}/{d}", exist_ok=True)
    rows = []
    for i in range(n):
        img = f"{root}/images/f{i}.png"
        cv2.imwrite(img, rng.randint(0, 256, hw + (3,), np.uint8))
        gt = np.full(hw, i % 2, np.int64) if i < 6 else \
            rng.randint(0, 2, hw).astype(np.int64)
        if i == 7:
            gt[:4] = 255
        np.save(f"{root}/labels/f{i}.npy", gt)
        scan = f"{root}/scans/s{i}.pkl"
        ranges = rng.rand(1080).astype(np.float32) * 5
        with open(scan, "wb") as f:
            pickle.dump({"ranges": ranges if i % 2 else ranges.tolist()}, f)
        label = "" if i == 5 else ("NA" if i == 6 else
                                   f"{root}/labels/f{i}.npy")
        rows.append((img, scan, label))
    # the episode manifests carry the image path twice: the binary sampler
    # reads "image", the class-grouped one "img"
    with open(f"{root}/support.csv", "w") as f:
        f.write(",img,image,depth,label\n")
        f.writelines(f"{i},{a},{a},{b},{c}\n"
                     for i, (a, b, c) in enumerate(rows))
    with open(f"{root}/query.csv", "w") as f:
        f.write(",img,image,depth,label\n")
        f.writelines(f"{i},{a},{a},{b},"
                     f"{a[:-4].replace('images', 'labels')}.npy\n"
                     for i, (a, b, _) in enumerate(rows[:4]))
    with open(f"{root}/labeled.csv", "w") as f:
        f.write(",image,depth,label\n")
        f.writelines(f"{i},{a},{b},{c}\n" for i, (a, b, c) in enumerate(rows))
    with open(f"{root}/unlabeled.csv", "w") as f:
        f.write("img_path,depth_path\n")
        f.writelines(f"{a},{b}\n" for a, b, _ in rows[5:])
    return root


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    return _write_fixture(str(tmp_path_factory.mktemp("trav")))


def _records(df):
    return [{k: None if pd.isna(v) else str(v) for k, v in r.items()}
            for r in df.to_dict("records")]


def test_read_lidar_matches_jax(fixture_dir):
    for i in (0, 1):
        path = f"{fixture_dir}/scans/s{i}.pkl"
        got = t_trav.read_lidar(path)
        assert got.shape == (360,) and got.dtype == np.float32
        np.testing.assert_array_equal(got, j_trav.read_lidar(path))


def test_manifests_match_pandas(fixture_dir):
    rows = t_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    assert rows == _records(j_trav.load_trav_csv(f"{fixture_dir}/support.csv"))
    assert rows[5]["label"] is None and rows[6]["label"] is None
    train, unlabeled = t_trav.labeled_unlabeled_split(
        f"{fixture_dir}/labeled.csv", f"{fixture_dir}/unlabeled.csv")
    j_train, j_unlabeled = j_trav.labeled_unlabeled_split(
        f"{fixture_dir}/labeled.csv", f"{fixture_dir}/unlabeled.csv")
    assert train == _records(j_train) and len(train) == 6
    assert unlabeled == _records(j_unlabeled)
    assert set(unlabeled[0]) == {"image", "depth"}


@pytest.mark.parametrize("n", [7, 8, 421])
def test_kfold_indices_match_sklearn(n):
    from sklearn.model_selection import KFold

    want = KFold(4, shuffle=True, random_state=42).split(np.zeros(n))
    got = t_trav.kfold_indices(n)
    for (tr, va), (wtr, wva) in zip(got, want, strict=True):
        np.testing.assert_array_equal(tr, wtr)
        np.testing.assert_array_equal(va, wva)


def test_kfold_splits_match_jax(fixture_dir):
    got = t_trav.kfold_splits(f"{fixture_dir}/labeled.csv")
    want = j_trav.kfold_splits(f"{fixture_dir}/labeled.csv")
    assert len(got) == len(want) == 4
    for (tr, va), (wtr, wva) in zip(got, want):
        assert tr == _records(wtr) and va == _records(wva)


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


def test_datasets_match_jax(fixture_dir):
    s_rows = t_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    s_df = j_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    got, want = t_trav.TravRGBDDataset(s_rows), j_trav.TravRGBDDataset(s_df)
    assert len(got) == len(want) == 8
    for i in range(8):
        _assert_items_equal(got[i], want[i])
    train, unlabeled = t_trav.labeled_unlabeled_split(
        f"{fixture_dir}/labeled.csv", f"{fixture_dir}/unlabeled.csv")
    j_train, j_unlabeled = j_trav.labeled_unlabeled_split(
        f"{fixture_dir}/labeled.csv", f"{fixture_dir}/unlabeled.csv")
    for rows, df in ((train, j_train), (unlabeled, j_unlabeled)):
        got = t_trav.TravRGBDLabeledDataset(rows)
        want = j_trav.TravRGBDLabeledDataset(df)
        for i in range(len(want)):
            _assert_items_equal(got[i], want[i])
    assert "gt" not in got[0]


def test_episodic_samplers_match_jax(fixture_dir):
    s_rows = [r for r in t_trav.load_trav_csv(f"{fixture_dir}/support.csv")
              if t_trav.has_label(r)]
    q_rows = t_trav.load_trav_csv(f"{fixture_dir}/query.csv")
    s_df = j_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    s_df = s_df[s_df["label"].notna() & (s_df["label"] != "")]
    q_df = j_trav.load_trav_csv(f"{fixture_dir}/query.csv")
    got = t_trav.FewShotTravDatasetBinary(s_rows, q_rows, n_shots=3,
                                          max_iters=4)
    want = j_trav.FewShotTravDatasetBinary(s_df, q_df, n_shots=3, max_iters=4)
    for epoch in (0, 3):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(4):
            _assert_items_equal(got[i], want[i])

    all_rows = t_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    all_df = j_trav.load_trav_csv(f"{fixture_dir}/support.csv")
    got = t_trav.FewShotTravRGBDDataset(all_rows, K=2, Q=1, seed=5)
    want = j_trav.FewShotTravRGBDDataset(all_df, K=2, Q=1, seed=5)
    assert got.class_to_rows == want.class_to_rows
    assert len(got) == len(want) == 2
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(2):
            _assert_items_equal(got[i], want[i])
    (b_t,) = list(TLoader(got, 2))
    (b_j,) = list(JLoader(want, 2))
    _assert_items_equal(t_trav.class_episodes_to_meta_batch(b_t),
                        j_trav.class_episodes_to_meta_batch(b_j))


def test_trav_prepare_batch_with_jax_flips():
    """JAX's bernoulli flips fed to the port: labels equal, images and
    lidar within 1e-6; the port's own draws are bool, p = 0.5."""
    rng = np.random.RandomState(12)
    B = 8
    rgb = rng.randint(0, 256, (B, 16, 24, 3)).astype(np.uint8)
    laser = (rng.rand(B, 360) * 5).astype(np.float32)
    gt = rng.randint(0, 2, (B, 16, 24)).astype(np.int32)
    mean, std = np.array([0.52, 0.49, 0.51]), np.array([0.27, 0.28, 0.29])
    key = jax.random.PRNGKey(3)
    flips = np.asarray(jax.random.bernoulli(key, 0.5, (B,)))
    assert 0 < flips.sum() < B
    want = j_trav.trav_prepare_batch(rgb, laser, key, jnp.asarray(mean),
                                     jnp.asarray(std), True, gt)
    got = t_trav.trav_prepare_batch(
        torch.from_numpy(rgb), torch.from_numpy(laser),
        torch.tensor(mean, dtype=torch.float32),
        torch.tensor(std, dtype=torch.float32), torch.from_numpy(flips),
        torch.from_numpy(gt))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    plain = t_trav.trav_prepare_batch(
        torch.from_numpy(rgb), torch.from_numpy(laser),
        torch.tensor(mean, dtype=torch.float32),
        torch.tensor(std, dtype=torch.float32))
    assert len(plain) == 2
    draws = t_trav.trav_mirror_draws(torch.Generator().manual_seed(0), 4000)
    assert draws.dtype == torch.bool and 0.45 < draws.float().mean() < 0.55


# --- pseudo-labels -----------------------------------------------------------

class _JShared(fnn.Module):
    """A model of the serving signature: per-pixel logits from the rgb and
    the scan's projection."""

    @fnn.compact
    def __call__(self, rgb, laser, train=False, deterministic_bases=True):
        w = self.param("w", fnn.initializers.normal(1.0), (3, 2))
        v = self.param("v", fnn.initializers.normal(0.1), (360, 2))
        return rgb @ w + (laser @ v)[:, None, None, :]


class _TShared(torch.nn.Module):
    def __init__(self, w, v):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(np.asarray(w)))
        self.v = torch.nn.Parameter(torch.from_numpy(np.asarray(v)))

    def forward(self, rgb, laser):
        return rgb @ self.w + (laser @ self.v)[:, None, None, :]


def test_pseudo_labels_match_jax(tmp_path):
    rng = np.random.RandomState(13)
    batches = [dict(rgb=rng.randn(2, 16, 24, 3).astype(np.float32),
                    laser=rng.randn(2, 360).astype(np.float32),
                    rgb_path=[f"/data/images/a{i}{j}.png" for j in range(2)],
                    depth_path=[f"/data/scans/s{i}{j}.pkl" for j in range(2)])
               for i in range(2)]
    jm = _JShared()
    variables = jm.init(jax.random.PRNGKey(0), batches[0]["rgb"],
                        batches[0]["laser"])
    j_csv = j_infer_masks(jm, variables, [dict(b) for b in batches],
                          str(tmp_path / "jax"))
    tm = _TShared(variables["params"]["w"], variables["params"]["v"])
    t_csv = t_infer_masks(tm, [dict(b, rgb=torch.from_numpy(b["rgb"]),
                                    laser=torch.from_numpy(b["laser"]))
                               for b in batches], str(tmp_path / "port"))
    with open(j_csv) as f:
        want = f.read()
    with open(t_csv) as f:
        got = f.read()
    assert got == want.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    rows = t_trav.read_csv(t_csv)
    assert len(rows) == 4 and list(rows[0]) == ["image", "depth", "label"]
    for row in rows:
        mask = np.load(row["label"])
        want_mask = np.load(row["label"].replace(str(tmp_path / "port"),
                                                 str(tmp_path / "jax")))
        assert mask.dtype == np.uint8 and mask.shape == (16, 24)
        np.testing.assert_array_equal(mask, want_mask)
    assert os.path.basename(rows[0]["label"]) == "a00_s00.npy"


# --- the tools ---------------------------------------------------------------

TRAV_LEAF = t_configs.LEAVES["local_configs.Trav.DFormer_Base"]


def _tool_cfg(fixture_dir):
    """The Trav config cut to 64x96, batch 1, one shot, one train and one
    eval episode per epoch, one epoch, the fixture's manifests."""
    cfg = TRAV_LEAF()
    cfg.update(image_height=HW[0], image_width=HW[1], batch_size=1, shots=1,
               episodes_per_epoch=1, eval_iterations=1, epochs=1, nepochs=1,
               pretrained_model=None,
               train_source=f"{fixture_dir}/support.csv",
               eval_source=f"{fixture_dir}/query.csv")
    return cfg


@pytest.mark.parametrize("mode", ["binary", "class_episodes"])
def test_fss_tool_main_trains_and_keeps_its_checkpoint(fixture_dir, tmp_path,
                                                       monkeypatch, mode):
    root = str(tmp_path)
    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Trav.DFormer_Base",
                        lambda: _cut(fixture_dir, root, use_wandb=True))
    wandb = WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", wandb)
    argv = ["--device=cpu", "--no-amp"]
    if mode == "class_episodes":
        argv += ["--class-episodes", "--contrastive-weight=0.1"]
    out = t_fss_tool.main(argv)
    trainer = out["trainer"]
    steps = 2 if mode == "class_episodes" else 1
    assert trainer.step == steps and np.isfinite(out["losses"][1])
    assert (1 in out["contrastive"]) == (mode == "class_episodes")
    assert list(out["miou"]) == [1]
    kept = [n for *_, n in out["checkpoints"]._existing()]
    miou = out["best_miou"]
    assert kept == ([f"epoch-1_miou_{round(miou, 2)}.pth"] if miou > 0
                    else [])
    assert any(t for t in trainer.frozen) and \
        "encoder_backbone.stages.3.0.mlp.fc1.weight" in trainer.frozen
    # cfg.use_wandb: the evaluation's metrics went to wandb
    assert [p["epoch"] for p in wandb.logged] == [1] and wandb.finished
    assert wandb.logged[0]["mIoU"] == out["miou"][1]


def _cut(fixture_dir, root, **over):
    cfg = _tool_cfg(fixture_dir)
    cfg.update(log_dir_base=f"{root}/runs/trav", save_dir=f"{root}/pseudo",
               **over)
    return cfg


def test_train_trav_tool_main_writes_pseudo_labels(fixture_dir, tmp_path,
                                                   monkeypatch):
    root = str(tmp_path)
    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Trav.DFormer_Base",
                        lambda: _cut(fixture_dir, root, batch_size=2))
    out = t_trav_tool.main([
        "--device=cpu", "--no-amp", f"--labeled_csv={fixture_dir}/labeled.csv",
        f"--unlabeled_csv={fixture_dir}/unlabeled.csv", "--epochs=1"])
    assert out["step"] == 3 and np.isfinite(out["losses"][1])
    assert out["csv_path"] == f"{root}/pseudo/unlabeled_masks.csv"
    rows = t_trav.read_csv(out["csv_path"])
    assert [r["image"] for r in rows] == \
        [f"{fixture_dir}/images/f{i}.png" for i in range(5, 8)]
    for row in rows:
        mask = np.load(row["label"])
        assert mask.dtype == np.uint8 and mask.shape == HW
        assert set(np.unique(mask)) <= {0, 1}
