"""Batching + prefetch loaders (counterpart of `dformer_tpu/data/loader.py`).

`Loader`: a thread pool decodes the items of a batch in parallel (cv2 and
numpy release the GIL) and a worker thread keeps `prefetch` collated
batches ready. `NativeBatchLoader`: the C++ decode pool
(`data/native_loader.py`) decodes whole batches into reusable buffers.
`shard=(rank, world)` reads only this process's slice of the indices.
`device_val_batches` normalises the val batches on the device.
"""

import os.path as osp
import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from dformer_torch.data.augment import normalize_batch
from dformer_torch.data.datasets import (RGBXDataset, SyntheticRGBXDataset,
                                         gt_transform)


class Loader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 shard=(0, 1), prefetch: int = 2, num_threads: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(self.seed + epoch)

    def __len__(self):
        n = len(self.dataset)
        rank, world = self.shard
        n = (n + world - 1) // world if not self.drop_last else n // world
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _indices(self):
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + self.epoch)
            idx = rng.permutation(n)
        rank, world = self.shard
        return idx[rank::world]

    def _collate(self, items):
        batch = {}
        for k in items[0]:
            vals = [it[k] for it in items]
            if isinstance(vals[0], np.ndarray):
                shapes = {v.shape for v in vals}
                if len(shapes) == 1:
                    batch[k] = np.stack(vals)
                else:
                    # variable-size dataset (SUNRGBD): pad to a common
                    # canvas, labels with 255; each sample's true extent
                    # goes in batch["hw"]
                    maxs = tuple(max(v.shape[d] for v in vals)
                                 for d in range(vals[0].ndim))
                    out = np.zeros((len(vals),) + maxs, vals[0].dtype)
                    if vals[0].dtype != np.uint8:  # labels pad as ignore
                        out[...] = 255
                    for i, v in enumerate(vals):
                        out[(i,) + tuple(slice(0, s) for s in v.shape)] = v
                    batch[k] = out
                    batch.setdefault("hw", np.asarray(
                        [[v.shape[0], v.shape[1]] for v in vals], np.int32))
            else:
                batch[k] = vals
        return batch

    def __iter__(self) -> Iterator[dict]:
        from concurrent.futures import ThreadPoolExecutor

        idx = self._indices()
        nb = len(idx) // self.batch_size if self.drop_last else \
            (len(idx) + self.batch_size - 1) // self.batch_size
        batches = [idx[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def worker():
            with ThreadPoolExecutor(self.num_threads) as pool:
                try:
                    for b in batches:
                        if stop.is_set():
                            return
                        items = list(pool.map(
                            self.dataset.__getitem__, [int(i) for i in b]))
                        q.put(self._collate(items))
                except Exception as e:  # handed to the consumer, re-raised
                    failure.append(e)
                finally:
                    q.put(None)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()
            # unblock a worker waiting on a full queue, then let it finish
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()


class NativeBatchLoader:
    """Batches of an `RGBXDataset` decoded by the C++ pool: batch k + 1 is
    decoded into one of two reusable uint8 buffer sets while batch k is
    consumed, with no Python in the decode path.

    Every image must decode at the canvas `hw` (the config's image size),
    as NYUDepthv2's do; a file of another size raises. X is decoded as
    grayscale and repeated to 3 channels, labels go through `gt_transform`
    when the dataset asks for it. Each yielded array is a copy: the decode
    after next overwrites the buffer it came from. Same batches, order,
    epochs and shards as `Loader`. Raises if the library cannot be built or
    loaded."""

    def __init__(self, dataset, batch_size: int, hw, shuffle=False,
                 drop_last=False, seed=0, shard=(0, 1), num_threads=4):
        from dformer_torch.data.native_loader import NativeLoader

        self.dataset = dataset
        self.batch_size = batch_size
        self.hw = hw
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.shard = shard
        self.epoch = 0
        self._nl = NativeLoader(num_threads)

    set_epoch = Loader.set_epoch
    __len__ = Loader.__len__
    _indices = Loader._indices

    def _paths(self, index):
        """(rgb, gt, x) paths of a dataset item, as `RGBXDataset` reads."""
        item = self.dataset._name(index).split("\t")
        item[-1] = item[-1].strip()
        s = self.dataset._s
        return (osp.join(s["rgb_root"], item[0].replace("RGB/", "")),
                osp.join(s["gt_root"], item[-1].replace("Label/", "")),
                osp.join(s["x_root"], item[-1].replace("Label/", "")))

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        B = self.batch_size
        nb = len(idx) // B if self.drop_last else (len(idx) + B - 1) // B
        H, W = self.hw
        bufs = [dict(rgb=np.empty((B, H, W, 3), np.uint8),
                     gt=np.empty((B, H, W, 1), np.uint8),
                     x=np.empty((B, H, W, 1), np.uint8)) for _ in range(2)]
        submitted = []

        def submit(k):
            rows = idx[k * B:(k + 1) * B]
            paths = [self._paths(int(i)) for i in rows]
            slot, n = bufs[k % 2], len(rows)
            tickets = [self._nl.submit([p[j] for p in paths],
                                       slot[key][:n], key == "rgb")
                       for j, key in enumerate(("rgb", "gt", "x"))]
            submitted.extend(tickets)
            return tickets, n, slot

        try:
            pending = submit(0) if nb else None
            for k in range(nb):
                tickets, n, slot = pending
                pending = submit(k + 1) if k + 1 < nb else None
                for t in tickets:
                    self._nl.wait(t)
                gt = slot["gt"][:n, ..., 0].astype(np.int32)
                if self.dataset._s["transform_gt"]:
                    gt = gt_transform(gt)
                yield dict(rgb=slot["rgb"][:n].copy(), gt=gt,
                           modal_x=np.repeat(slot["x"][:n], 3, axis=-1),
                           fn=[str(i) for i in idx[k * B:(k + 1) * B]])
        finally:
            # an epoch left early or a failed decode: the pool's threads may
            # still write into the buffers, which must outlive them (a wait
            # on a finished batch returns at once)
            for t in submitted:
                try:
                    self._nl.wait(t)
                except IOError:
                    pass  # that batch is discarded


def local_batch(batch_size: int, world: int) -> int:
    """The rows of a global batch of `batch_size` that each of `world`
    processes loads."""
    if batch_size % world:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"world {world}")
    return batch_size // world


def train_batches(cfg, dataset_cls=None, shard=(0, 1),
                  synthetic: bool = False, native: bool = False):
    """The training loader: an epoch is batch_size * niters_per_epoch items
    by oversampling; each of `world` processes loads batch_size // world
    rows per step. native: decode with `NativeBatchLoader` (files on disk
    at the config's canvas; raises if the library cannot be built)."""
    local_bs = local_batch(cfg.batch_size, shard[1])
    file_length = cfg.batch_size * cfg.niters_per_epoch
    if synthetic:
        if native:
            raise ValueError("the native loader decodes files on disk; "
                             "synthetic data has none")
        ds = SyntheticRGBXDataset(cfg.num_train_imgs,
                                  (cfg.image_height, cfg.image_width),
                                  cfg.num_classes, file_length=file_length)
    else:
        ds = (dataset_cls or RGBXDataset)(_data_setting(cfg), "train",
                                          file_length=file_length)
        if native:
            return NativeBatchLoader(
                ds, local_bs, (cfg.image_height, cfg.image_width),
                shuffle=True, drop_last=True, seed=cfg.get("seed", 0),
                shard=shard)
    return Loader(ds, local_bs, shuffle=True, drop_last=True,
                  seed=cfg.get("seed", 0), shard=shard)


def val_batches(cfg, dataset_cls=None, batch_size: int = 1, shard=(0, 1),
                synthetic: bool = False, n: Optional[int] = None):
    """The val loader, in file order; `n` synthetic images (default
    cfg.num_eval_imgs) at cfg's image size when `synthetic`."""
    if synthetic:
        ds = SyntheticRGBXDataset(n or cfg.num_eval_imgs,
                                  (cfg.image_height, cfg.image_width),
                                  cfg.num_classes)
    else:
        ds = (dataset_cls or RGBXDataset)(_data_setting(cfg), "val")
    return Loader(ds, batch_size, shuffle=False, drop_last=False, shard=shard)


def val_x_stats(cfg):
    """(mean, std) of the X modality for val normalisation: 0.48 / 0.28
    per channel for a single-channel X, else the RGB statistics."""
    if cfg.x_is_single_channel:
        return np.asarray([0.48] * 3), np.asarray([0.28] * 3)
    return np.asarray(cfg.norm_mean), np.asarray(cfg.norm_std)


def device_val_batches(cfg, batch_size: int, device="cuda",
                       shard=(0, 1), synthetic: bool = False,
                       n: Optional[int] = None):
    """Val batches for `Evaluator`: rgb and modal_x normalised on `device`
    (fp32 NHWC), gt moved there, and "fn" and a canvas batch's "hw" kept."""
    x_mean, x_std = val_x_stats(cfg)

    def stat(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    stats = (stat(cfg.norm_mean), stat(cfg.norm_std), stat(x_mean),
             stat(x_std))
    for b in val_batches(cfg, batch_size=batch_size, shard=shard,
                         synthetic=synthetic, n=n):
        rgb, modal = normalize_batch(
            torch.from_numpy(b["rgb"]).to(device),
            torch.from_numpy(b["modal_x"]).to(device), *stats)
        out = dict(rgb=rgb, modal_x=modal,
                   gt=torch.from_numpy(b["gt"]).to(device), fn=b.get("fn"))
        if "hw" in b:
            out["hw"] = b["hw"]
        yield out


def _data_setting(cfg):
    return dict(
        rgb_root=cfg.rgb_root_folder, rgb_format=cfg.rgb_format,
        gt_root=cfg.gt_root_folder, gt_format=cfg.gt_format,
        transform_gt=cfg.gt_transform, x_root=cfg.x_root_folder,
        x_format=cfg.x_format, x_single_channel=cfg.x_is_single_channel,
        class_names=cfg.class_names, train_source=cfg.train_source,
        eval_source=cfg.eval_source,
    )
