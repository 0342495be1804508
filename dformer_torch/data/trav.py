"""Trav (robot traversability) data: RGB camera frames paired with 360-beam
lidar scans from pickled ROS LaserScan messages, driven by CSV manifests
(counterpart of `dformer_tpu/data/trav.py`).

A manifest is a list of rows, each a dict {column: str, or None for a
missing cell}, read with the stdlib `csv` module as pandas' `read_csv`
reads it: the same columns (an empty header is named "Unnamed: <i>"), the
first column dropped with `index_col=0`, and pandas' default missing-value
strings ("", "NA", "nan", ...) read as None. Rows keep file order.

  * TravRGBDDataset / TravRGBDLabeledDataset: rows with img/depth(/label)
    paths; lidar = pickle['ranges'][::-1][540:900] (the front 90 degrees).
  * FewShotTravDatasetBinary, FewShotTravRGBDDataset: episodic samplers;
    their numpy draws are the JAX package's, so the episodes are equal.
  * labeled/unlabeled and k-fold splits of a manifest; the lidar
    statistics of a manifest and its paths moved onto new roots.

Host code only decodes (cv2 is imported at the first image read); the
lidar z-score and the rgb normalisation run on the device
(`trav_prepare_batch`), with the mirror draws apart from the math
(`trav_mirror_draws`).
"""

import csv
import os
import os.path as osp
import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

# the Trav lidar scan's z-score statistics (configs.TRAV_LIDAR_MEAN/STD)
from dformer_torch.configs import TRAV_LIDAR_MEAN, TRAV_LIDAR_STD
from dformer_torch.parallel import dist

Rows = List[Dict[str, Optional[str]]]

# pandas' default missing-value strings (`read_csv(keep_default_na=True)`)
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
       "nan", "null"}


def read_csv(path: str, index_col: Optional[int] = None) -> Rows:
    """The rows of a CSV manifest as pandas reads them (module docstring);
    `index_col=0` drops the first column, as pandas moves it to the
    index."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        names = [h if h else f"Unnamed: {i}" for i, h in enumerate(header)]
        keep = [i for i in range(len(names)) if i != index_col]
        rows = []
        for cells in reader:
            if not cells:
                continue
            cells += [""] * (len(names) - len(cells))
            rows.append({names[i]: None if cells[i] in _NA else cells[i]
                         for i in keep})
    return rows


def has_label(row) -> bool:
    """pandas' `label.notna() & (label != "")`."""
    return row.get("label") not in (None, "")


def load_trav_csv(path: str) -> Rows:
    """`pd.read_csv(path, index_col=0)`."""
    return read_csv(path, index_col=0)


def labeled_unlabeled_split(labeled_csv: str, unlabeled_csv: str):
    """(train rows: the labelled rows of `labeled_csv`, unlabeled rows with
    `depth_path` and `img_path` renamed to `depth` and `image`), as the
    semi-supervised loaders split them."""
    train = [r for r in read_csv(labeled_csv) if has_label(r)]
    rename = {"depth_path": "depth", "img_path": "image"}
    unlabeled = [{rename.get(k, k): v for k, v in r.items()}
                 for r in read_csv(unlabeled_csv)]
    return train, unlabeled


def kfold_indices(n: int, n_splits: int = 4, seed: int = 42):
    """[(train indices, val indices)] of sklearn's
    `KFold(n_splits, shuffle=True, random_state=seed).split` over n rows:
    `RandomState(seed).shuffle(arange(n))` cut into folds in order, the
    first n % n_splits folds one longer; both index lists ascending."""
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(n_splits, n // n_splits)
    sizes[:n % n_splits] += 1
    out, start = [], 0
    for size in sizes:
        val = np.zeros(n, bool)
        val[order[start:start + size]] = True
        out.append((np.flatnonzero(~val), np.flatnonzero(val)))
        start += size
    return out


def kfold_splits(csv_file: str, n_splits: int = 4, seed: int = 42):
    """[(train rows, val rows)]: k-fold splits of the labelled rows."""
    rows = [r for r in read_csv(csv_file) if has_label(r)]
    return [([rows[i] for i in tr], [rows[i] for i in va])
            for tr, va in kfold_indices(len(rows), n_splits, seed)]


def read_lidar(path: str) -> np.ndarray:
    """The 360-beam front sector of a pickled LaserScan."""
    with open(path, "rb") as f:
        data = pickle.load(f)
    return np.asarray(data["ranges"][::-1], np.float32)[540:900]


def calc_depth_mean_std(csv_file: str, depth_col: str = "depth"):
    """(mean, std) of every lidar value of a manifest's scans: the z-score
    statistics of `configs.TRAV_LIDAR_MEAN` / `TRAV_LIDAR_STD`."""
    scans = np.concatenate([read_lidar(r[depth_col])
                            for r in read_csv(csv_file)])
    return float(np.mean(scans)), float(np.std(scans))


def rebase_manifest_paths(csv_file: str, img_base: str, depth_base: str,
                          level: int = 4, out_csv: Optional[str] = None
                          ) -> Rows:
    """Move a manifest's image and scan paths onto new roots, keeping the
    last `level` components of each, and write it to `out_csv` (default:
    over `csv_file`) as pandas' `to_csv` writes the frame that
    `read_csv(index_col=0)` read: the index column first, missing cells
    empty, a "laser" column renamed "depth". Returns its rows
    (`load_trav_csv`'s reading of the file written)."""
    with open(csv_file, newline="") as f:
        table = [r for r in csv.reader(f) if r]
    header, body = table[0], table[1:]
    depth_col = "laser" if "laser" in header[1:] else "depth"
    img_col = "img" if "img" in header[1:] else "image"
    moves = {header.index(depth_col, 1): depth_base,
             header.index(img_col, 1): img_base}
    for row in body:
        row += [""] * (len(header) - len(row))
        for i in range(1, len(header)):
            if i in moves:  # a missing path rebases as pandas' "nan"
                path = "nan" if row[i] in _NA else row[i]
                row[i] = osp.join(moves[i], *path.split(os.sep)[-level:])
            elif row[i] in _NA:
                row[i] = ""
    header = header[:1] + ["depth" if h == "laser" else h
                           for h in header[1:]]
    out_csv = out_csv or csv_file
    with open(out_csv, "w", newline="") as f:
        csv.writer(f, lineterminator="\n").writerows([header] + body)
    return load_trav_csv(out_csv)


def _imread_rgb(path):
    # cv2's native BGR order, as the reference reader leaves it
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _mask_path(image_path: str) -> str:
    return osp.splitext(image_path.replace("/images/", "/labels/"))[0] \
        + ".npy"


class TravRGBDDataset:
    """Rows with 'img' and 'depth' columns; the label path is derived from
    the image path (images/ -> labels/, .npy)."""

    def __init__(self, rows: Rows):
        self.rows = list(rows)

    def __len__(self):
        return len(self.rows)

    def set_epoch(self, seed):
        pass

    def _load(self, rgb_path, laser_path, gt_path=None):
        out = dict(rgb=_imread_rgb(rgb_path), laser=read_lidar(laser_path),
                   rgb_path=rgb_path, depth_path=laser_path, n=len(self.rows))
        if gt_path is not None:
            out["gt"] = np.load(gt_path).astype(np.int32)
            out["gt_path"] = gt_path
        return out

    def __getitem__(self, index):
        row = self.rows[index]
        return self._load(row["img"], row["depth"], _mask_path(row["img"]))


class TravRGBDLabeledDataset(TravRGBDDataset):
    """Rows with 'image', 'depth' and an optional 'label' column (missing
    in the unlabelled pool)."""

    def __getitem__(self, index):
        row = self.rows[index]
        label = row.get("label")
        return self._load(row["image"], row["depth"], label or None)


class FewShotTravDatasetBinary:
    """Episodic sampler: n_shots support rows and one query row per
    episode, drawn by `RandomState(seed * 1000003 + index)`. Episodes of
    several queries: `FewShotTravRGBDDataset(Q=...)`."""

    def __init__(self, support_rows: Rows, query_rows: Rows, n_shots=5,
                 max_iters=1000, seed=0):
        self.support = TravRGBDLabeledDataset(support_rows)
        self.query = TravRGBDLabeledDataset(query_rows)
        self.n_shots = n_shots
        self.max_iters = max_iters
        self.seed = seed

    def __len__(self):
        return self.max_iters

    def set_epoch(self, seed):
        self.seed = seed

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed * 1000003 + index)
        si = rng.choice(len(self.support), self.n_shots, replace=False)
        qi = rng.choice(len(self.query), 1, replace=False)
        s = [self.support[int(i)] for i in si]
        q = self.query[int(qi[0])]
        return dict(
            s_img=np.stack([x["rgb"] for x in s]),
            s_gt=np.stack([x["gt"] for x in s]),
            s_depth=np.stack([x["laser"] for x in s]),
            q_img=q["rgb"], q_gt=q["gt"], q_depth=q["laser"],
            fn=q["rgb_path"],
        )


class FewShotTravRGBDDataset:
    """Class-grouped episodic sampler: rows are grouped by a class drawn
    from those present in their mask (`RandomState(seed)`), and each
    episode draws K support + Q query items from one class's pool."""

    def __init__(self, rows: Rows, class_names=(0, 1), K=5, Q=1, seed=0):
        self.K, self.Q = K, Q
        self.seed = seed
        self.class_names = list(class_names)
        self.rows = list(rows)
        self.class_to_rows = self._group_by_class()

    def _group_by_class(self):
        rng = np.random.RandomState(self.seed)
        groups = {c: [] for c in self.class_names}
        for row in self.rows:
            gt = np.load(_mask_path(row["img"]))
            classes = np.unique(gt)
            classes = classes[(classes != 255)
                              & np.isin(classes, self.class_names)]
            if len(classes) == 0:
                continue
            c = int(rng.choice(classes))
            groups[c].append(dict(rgb=row["img"], gt=_mask_path(row["img"]),
                                  depth=row["depth"]))
        return groups

    def __len__(self):
        return len(self.class_names)

    def set_epoch(self, seed):
        self.seed = seed

    def __getitem__(self, index):
        cls = self.class_names[index]
        pool = self.class_to_rows[cls]
        if len(pool) < self.K + self.Q:
            raise ValueError(f"not enough samples for class {cls}")
        rng = np.random.RandomState(self.seed * 1000003 + index)
        picks = rng.choice(len(pool), self.K + self.Q, replace=False)

        def load(sample):
            return (_imread_rgb(sample["rgb"]),
                    np.load(sample["gt"]).astype(np.int32),
                    read_lidar(sample["depth"]))

        sup = [load(pool[int(i)]) for i in picks[:self.K]]
        qry = [load(pool[int(i)]) for i in picks[self.K:]]
        return dict(
            s_imgs=np.stack([s[0] for s in sup]),
            s_masks=np.stack([s[1] for s in sup]),
            s_depths=np.stack([s[2] for s in sup]),
            q_imgs=np.stack([q[0] for q in qry]),
            q_masks=np.stack([q[1] for q in qry]),
            q_depths=np.stack([q[2] for q in qry]),
            cls=cls,
        )


def class_episodes_to_meta_batch(b):
    """A collated class-episode batch (s_imgs/s_masks/s_depths [B,K,...],
    q_* [B,Q,...]) -> the meta_forward layout (s_img [B*Q,K,...], q_img
    [B*Q,...]): each of the Q query images becomes an episode sharing its
    class's K-shot support set."""
    Q = b["q_imgs"].shape[1]
    Bq = b["q_imgs"].shape[0] * Q
    rep = lambda a: np.repeat(np.asarray(a), Q, axis=0)  # noqa: E731
    flat = lambda a: np.asarray(a).reshape((Bq,) + a.shape[2:])  # noqa: E731
    return dict(s_img=rep(b["s_imgs"]), s_gt=rep(b["s_masks"]),
                s_depth=rep(b["s_depths"]), q_img=flat(b["q_imgs"]),
                q_gt=flat(b["q_masks"]), q_depth=flat(b["q_depths"]))


def trav_mirror_draws(generator: torch.Generator, batch: int
                      ) -> torch.Tensor:
    """[batch] bool: which samples a training batch mirrors (p = 0.5), on
    the generator's device; under a process group drawn for the global
    batch, of which this rank keeps its `batch` rows."""
    return dist.rand_rows((batch,), generator) < 0.5


def trav_prepare_batch(rgb, laser, rgb_mean, rgb_std,
                       flips: Optional[torch.Tensor] = None, gt=None):
    """Device-side Trav preprocessing: rgb uint8 [B,H,W,3] -> (rgb / 255 -
    mean) / std, lidar [B,360] z-scored, and where `flips` ([B] bool) is
    given the flagged samples' rgb (and gt) mirrored left-right. Returns
    (rgb, laser) or (rgb, laser, gt)."""
    rgb = (rgb.float() / 255.0 - rgb_mean) / rgb_std
    laser = (laser.float() - TRAV_LIDAR_MEAN) / TRAV_LIDAR_STD
    if flips is not None:
        rgb = torch.where(flips[:, None, None, None], rgb.flip(2), rgb)
        if gt is not None:
            gt = torch.where(flips[:, None, None], gt.flip(2), gt)
    if gt is not None:
        return rgb, laser, gt
    return rgb, laser
