"""Host-side datasets: file decode only (counterpart of
`dformer_tpu/data/datasets.py`).

`RGBXDataset` reads a split file of tab-separated "RGB/<name>\tLabel/<name>"
lines. Pixels stay in cv2's native BGR order: the reference reader passes
the colour-conversion constant `cv2.COLOR_BGR2RGB` (4) as an *imread flag*
(IMREAD_ANYCOLOR), so it never converts, and its checkpoints were trained on
BGR. Labels are read as grayscale, optionally shifted down by one with 0
made invalid (`gt_transform`); a single-channel X is replicated to 3
channels. With `file_length`, an epoch oversamples the file list to that
length (`set_epoch`). Items are raw uint8 HWC numpy arrays; normalisation
runs on the device (`data/augment.py`). cv2 is imported at the first read.
"""

import os.path as osp

import numpy as np


def _imread(path, gray=False):
    import cv2

    mode = cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR
    img = cv2.imread(path, mode)
    if img is None:
        raise FileNotFoundError(path)
    return img


def gt_transform(gt: np.ndarray) -> np.ndarray:
    """Shift labels down by one, 0 -> 255 invalid."""
    gt = gt.astype(np.int32) - 1
    return np.where(gt < 0, 255, gt).astype(np.int32)


class RGBXDataset:
    def __init__(self, setting: dict, split_name: str, file_length=None):
        self._split = split_name
        self._s = dict(setting)
        source = setting["train_source"] if split_name == "train" \
            else setting["eval_source"]
        with open(source) as f:
            self._file_names = [ln.strip() for ln in f if ln.strip()]
        self._file_length = file_length
        self._epoch_names = None

    def __len__(self):
        return self._file_length or len(self._file_names)

    def set_epoch(self, seed: int):
        """Regenerate the oversampled name list from a seeded shuffle."""
        if self._file_length is None:
            return
        n = len(self._file_names)
        rng = np.random.RandomState(seed)
        names = self._file_names * (self._file_length // n)
        extra = rng.permutation(n)[: self._file_length % n]
        self._epoch_names = names + [self._file_names[i] for i in extra]

    def _name(self, index):
        if self._file_length is not None:
            if self._epoch_names is None:
                self.set_epoch(0)
            return self._epoch_names[index]
        return self._file_names[index]

    def __getitem__(self, index):
        item = self._name(index).split("\t")
        item[-1] = item[-1].strip()
        rgb_path = osp.join(self._s["rgb_root"], item[0].replace("RGB/", ""))
        x_path = osp.join(self._s["x_root"], item[-1].replace("Label/", ""))
        gt_path = osp.join(self._s["gt_root"], item[-1].replace("Label/", ""))

        rgb = _imread(rgb_path)
        gt = _imread(gt_path, gray=True).astype(np.int32)
        if self._s["transform_gt"]:
            gt = gt_transform(gt)
        if self._s["x_single_channel"]:
            x = _imread(x_path, gray=True)
            x = np.stack([x, x, x], axis=-1)
        else:
            x = _imread(x_path)
        return dict(rgb=rgb, gt=gt, modal_x=x, fn=item[0],
                    n=len(self._file_names))


class SyntheticRGBXDataset:
    """Fixed-shape synthetic RGB-X data (no dataset on disk); shapes and
    dtypes match RGBXDataset's items, each drawn from its own
    `RandomState(seed + index % n)`."""

    def __init__(self, n: int, hw=(480, 640), num_classes=40, seed=0,
                 file_length=None):
        self.n = n
        self.hw = hw
        self.num_classes = num_classes
        self.seed = seed
        self._file_length = file_length

    def __len__(self):
        return self._file_length or self.n

    def set_epoch(self, seed: int):
        pass

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed + index % self.n)
        h, w = self.hw
        return dict(
            rgb=rng.randint(0, 256, (h, w, 3), np.uint8),
            gt=rng.randint(0, self.num_classes, (h, w)).astype(np.int32),
            modal_x=rng.randint(0, 256, (h, w, 3), np.uint8),
            fn=f"synthetic/{index}",
            n=self.n,
        )
