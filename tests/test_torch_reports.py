"""The port's prediction saving, report drawing, SUNRGBD rehearsal and Trav
k-fold tool against the JAX package on the CPU, at a narrow model (dims
32-256, one block per stage): palettes and PNGs, the eval tool's
--save_path and `tools.infer` (the PNGs' labels are the Evaluator's),
`tools.infer_trav` (the model's argmax), the curves, grid and deck, the
rehearsal's stream and grouping, and `tools.train_trav_kfold.run`."""

import os
import os.path as osp

import numpy as np
import pytest
import torch

from dformer_torch import configs as t_configs
from dformer_torch import entry
from dformer_torch.config import AttrDict
from dformer_torch.data.trav import TravRGBDLabeledDataset, load_trav_csv
from dformer_torch.eval import draw as t_draw
from dformer_torch.eval import visualize as t_vis
from dformer_torch.eval.evaluate import Evaluator as TEvaluator
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import eval as t_eval_tool
from dformer_torch.tools import infer as t_infer
from dformer_torch.tools import infer_trav as t_infer_trav
from dformer_torch.tools import sunrgbd_eval_rehearsal as t_rehearsal
from dformer_torch.tools import train_trav_kfold as t_kfold
from dformer_torch.train.fss import TravPrep
from dformer_tpu.data import trav as j_trav
from dformer_tpu.eval import visualize as j_vis
from dformer_tpu.eval.evaluate import Evaluator as JEvaluator
from tools import sunrgbd_eval_rehearsal as j_rehearsal

from test_draw import _count_pdf_pages
from test_draw import _write_fixture as _draw_fixture
from test_torch_fss import _write_fixture as _trav_fixture

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
HW, CLASSES = (64, 96), 11
NARROW_CFG = "local_configs.Test.Narrow"


@pytest.fixture(scope="module", autouse=True)
def narrow():
    """One intra-op thread; the narrow widths registered as
    "DFormer-Narrow1" and in place of DFormer-Base (the Trav body); the
    NYUDepthv2 config cut to them at 64x96 as NARROW_CFG."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)

    def cfg():
        c = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
        c.update(backbone="DFormer-Narrow1", image_height=HW[0],
                 image_width=HW[1], num_classes=CLASSES, num_eval_imgs=3,
                 pretrained_model=None)
        return c

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Base", NARROW1)
        mp.setitem(t_configs.LEAVES, NARROW_CFG, cfg)
        yield
    torch.set_num_threads(before)


# --- palettes and PNGs -----------------------------------------------------------

@pytest.mark.parametrize("dataset, classes", [("NYUDepthv2", 40),
                                              ("KITTI-360", 19),
                                              ("MFNet", 9)])
def test_palettes_and_pngs_match_jax(tmp_path, dataset, classes):
    """The palette of each dataset family equals JAX's; a label map saved
    by both decodes (cv2) to the same pixels, and the port reads its labels
    back; the per-class table is JAX's."""
    import cv2

    cfg = AttrDict(dataset_name=dataset, num_classes=classes)
    np.testing.assert_array_equal(t_vis.voc_colormap(), j_vis.voc_colormap())
    palette = t_vis.palette_for(cfg)
    np.testing.assert_array_equal(palette, j_vis.palette_for(cfg))
    pred = np.random.RandomState(0).randint(0, classes, (21, 30))
    t_vis.save_pred_png(pred.astype(np.uint8), str(tmp_path / "t.png"),
                        palette)
    j_vis.save_pred_png(pred.astype(np.uint8), str(tmp_path / "j.png"),
                        palette)
    got = cv2.imread(str(tmp_path / "t.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "j.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        t_vis.read_png(str(tmp_path / "t.png")), palette[pred])
    np.testing.assert_array_equal(
        t_vis.labels_from_png(str(tmp_path / "t.png"), palette), pred)
    ious, accs = np.linspace(10, 90, 3), np.linspace(20, 80, 3)
    names = ["wall", "floor", "a class with a long name"]
    assert t_vis.print_iou(ious, accs, names, logger=None) == \
        j_vis.print_iou(ious, accs, names, logger=None)


# --- eval --save_path and tools.infer ----------------------------------------------

def _evaluator_labels(msf):
    """{file name: labels} of the Evaluator on the eval tool's model (seed
    0) and synthetic val images, by the save hook."""
    cfg = t_configs.load_config(NARROW_CFG)
    ev, batches = entry.build_evaluator(
        cfg, device="cpu", synthetic=True, val_batch_size=1 if msf else 2)
    seen = {}

    def hook(preds, batch):
        seen.update(zip(batch["fn"], preds))

    if msf:
        m = ev.evaluate_msf(batches, scales=t_eval_tool.MSF_SCALES,
                            flip=cfg.eval_flip, save_hook=hook)
    else:
        m = ev.evaluate(batches, save_hook=hook)
    return seen, m.hist


@pytest.mark.parametrize("tool", ["eval", "infer"])
def test_saved_pngs_hold_the_evaluators_labels(tmp_path, capsys, tool):
    """`tools.eval --no-mst --save_path` (batches of 2) and `tools.infer`
    (MSF + flip, batches of 1): one PNG per val image, whose labels equal
    the Evaluator's; the same hist; the per-class table printed."""
    out = str(tmp_path / "preds")
    if tool == "eval":
        m = t_eval_tool.main([f"--config={NARROW_CFG}", "--device=cpu",
                              "--synthetic-data", "--no-mst",
                              "--val_batch_size=2", f"--save_path={out}"])
    else:
        m = t_infer.main([f"--config={NARROW_CFG}", "--device=cpu",
                          "--synthetic-data", f"--save_path={out}"])
    want, hist = _evaluator_labels(msf=tool == "infer")
    np.testing.assert_array_equal(m.hist, hist)
    assert "class" in capsys.readouterr().out
    palette = t_vis.palette_for(t_configs.load_config(NARROW_CFG))
    assert len(want) == 3 and sorted(os.listdir(osp.join(out, "synthetic"))) \
        == sorted(t_vis.pred_png_name(fn).split("/")[1] for fn in want)
    for fn, labels in want.items():
        got = t_vis.labels_from_png(osp.join(out, t_vis.pred_png_name(fn)),
                                    palette)
        np.testing.assert_array_equal(got, labels)


def test_infer_trav_pngs_hold_the_models_labels(tmp_path, monkeypatch):
    """`tools.infer_trav` over a manifest of 3 rows with img / laser
    columns: each PNG's labels equal the argmax of `entry.build_trav`'s
    model (seed 0) on the prepared row."""
    root = _trav_fixture(str(tmp_path / "data"), n=3)
    with open(f"{root}/rows.csv", "w") as f:
        f.write(",img,laser\n")
        f.writelines(f"{i},{root}/images/f{i}.png,{root}/scans/s{i}.pkl\n"
                     for i in range(3))

    trav = t_configs.LEAVES["local_configs.Trav.DFormer_Base"]

    def cfg():
        c = trav()
        c.update(image_height=HW[0], image_width=HW[1])
        return c

    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Trav.DFormer_Base",
                        cfg)
    out = t_infer_trav.main(["--device=cpu", "--no-amp",
                             f"--csv={root}/rows.csv",
                             f"--save_path={tmp_path / 'preds'}"])
    assert [osp.basename(p) for p in out["paths"]] == \
        [f"f{i}_pred.png" for i in range(3)]
    model = entry.build_trav(cfg(), None, "cpu", 0)
    prep = TravPrep(cfg(), 0, torch.device("cpu"))
    rows = [dict(image=r["img"], depth=r["laser"])
            for r in load_trav_csv(f"{root}/rows.csv")]
    palette = t_vis.palette_for(cfg())
    for path, item in zip(out["paths"], TravRGBDLabeledDataset(rows)):
        rgb, laser = prep(item["rgb"][None], item["laser"][None])
        with torch.inference_mode():
            want = torch.argmax(model(rgb, laser), dim=-1)[0].numpy()
        np.testing.assert_array_equal(t_vis.labels_from_png(path, palette),
                                      want)


# --- report drawing --------------------------------------------------------------

def test_curves_grid_and_deck(tmp_path):
    """The curves and the grid are written; the deck over a manifest of the
    fixture of tests/test_draw.py (images, scans, labels; an epoch
    directory that lacks one mask) has a page per row, the count
    tests/test_draw.py holds JAX's deck to."""
    log = tmp_path / "train.log"
    log.write_text("x INFO epoch 1/5 loss 3.9357 (390.5s)\n"
                   "x INFO epoch 1 mIoU 41.32 mAcc 52.5 mF1 55.64\n"
                   "x INFO epoch 2/5 loss 2.1 (390.5s)\n")
    assert osp.exists(t_draw.plot_training_curves(
        str(log), str(tmp_path / "c" / "curves.png")))
    rows = _draw_fixture(str(tmp_path / "data"))
    assert osp.exists(t_draw.prediction_grid(
        [r[0] for r in rows], str(tmp_path / "grid.png"),
        titles=["a", "b", "c"], cols=2))
    d = tmp_path / "ep"
    d.mkdir()
    for img, _ in rows[:2]:
        stem = osp.splitext(osp.basename(img))[0]
        np.save(d / f"{stem}.npy", np.ones((24, 32), np.uint8))
    with open(tmp_path / "df.csv", "w") as f:
        f.write(",img,laser\n")
        f.writelines(f"{i},{a},{b}\n" for i, (a, b) in enumerate(rows))
    out = t_draw.deck_from_csv(str(tmp_path / "df.csv"), [("ep", str(d))],
                               str(tmp_path / "csv.pdf"))
    assert _count_pdf_pages(out) == len(rows)


# --- the SUNRGBD rehearsal ---------------------------------------------------------

def test_rehearsal_stream_and_grouping_match_jax():
    """`make_stream` draws JAX's batches; the Evaluator regroups them as
    JAX's does: the same (size, group) shapes, pixels and pad overhead."""
    got = t_rehearsal.make_stream(13, 4, 37)
    want = j_rehearsal.make_stream(13, 4, 37)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    cfg = AttrDict(num_classes=37, background=255)
    port = t_rehearsal.grouping(TEvaluator(None, cfg, device="cpu"), got)
    jax_ = t_rehearsal.grouping(JEvaluator(None, {}, cfg), want)
    assert port == jax_
    groups, true_px, fwd_px = port
    assert len(groups) > 1 and fwd_px > true_px


def test_rehearsal_run_is_exact(monkeypatch):
    """`run` on small sizes (the sensor mix scaled down) and the narrow
    model: the hist counts every true pixel once (checked inside), and the
    forward saw one input shape per (size, group) shape and scale."""
    monkeypatch.setattr(t_rehearsal, "SENSOR_MIX",
                        {(64, 96): 0.5, (70, 90): 0.3, (48, 64): 0.2})
    cfg = t_configs.load_config(NARROW_CFG)
    args = t_rehearsal.parse_args(["--images=7", "--batch=3", "--scales",
                                   "0.5", "1.0", "--no-amp",
                                   "--device=cpu", f"--config={NARROW_CFG}"])
    rec = t_rehearsal.run(cfg, args)
    assert rec["hist_exact"] and rec["steady_img_per_s"] > 0
    want = {(b, -(-int(s * h) // 32) * 32, -(-int(s * w) // 32) * 32)
            for h, w, b in (tuple(map(int, k.split("x")))
                            for k in rec["groups"]) for s in (0.5, 1.0)}
    assert rec["forward_shapes"] == len(want)
    assert rec["geometries"] > 1 and rec["pad_overhead_pct"] > 0


# --- the Trav k-fold tool ------------------------------------------------------------

def _kfold_rows(n):
    rng = np.random.RandomState(8)
    return [dict(rgb=rng.randint(0, 256, (*HW, 3)).astype(np.uint8),
                 gt=rng.randint(0, 2, HW).astype(np.int32),
                 laser=(rng.rand(360) * 5).astype(np.float32))
            for _ in range(n)]


def test_kfold_tool_runs_jaxs_folds(tmp_path):
    """`run` over 4 in-memory rows, 2 folds of one step: JAX's k-fold
    splits of 4 labelled rows, a finite loss and mIoU per fold, and their
    mean."""
    cfg = t_configs.load_config("local_configs.Trav.DFormer_Base")
    cfg.update(image_height=HW[0], image_width=HW[1], batch_size=2,
               nepochs=1, warm_up_epoch=0, pretrained_model=None,
               log_dir_base=str(tmp_path / "kfold"))
    out = t_kfold.run(cfg, t_kfold.parse_args(
        ["--device=cpu", "--no-amp", "--folds=2"]), rows=_kfold_rows(4))
    with open(tmp_path / "rows.csv", "w") as f:
        f.write("image,depth,label\n")
        f.writelines(f"i{i},d{i},l{i}\n" for i in range(4))
    want = j_trav.kfold_splits(str(tmp_path / "rows.csv"), n_splits=2)
    assert [(list(tr), list(va)) for tr, va in out["splits"]] == \
        [(list(tr.index), list(va.index)) for tr, va in want]
    assert len(out["fold_mious"]) == 2
    assert all(np.isfinite(m) for m in out["fold_mious"])
    assert all(np.isfinite(out["losses"][f][1]) for f in (0, 1))
    assert out["mean_miou"] == pytest.approx(np.mean(out["fold_mious"]))


def test_kfold_tool_runs_as_one_process(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    cfg = t_configs.load_config("local_configs.Trav.DFormer_Base")
    with pytest.raises(NotImplementedError, match="one process"):
        t_kfold.run(cfg, t_kfold.parse_args(["--device=cpu"]), rows=[])
