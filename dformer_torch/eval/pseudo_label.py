"""Pseudo-labels for the semi-supervised Trav pipeline (counterpart of
`dformer_tpu/eval/pseudo_label.py`): run the model on unlabelled RGB +
lidar pairs, save the argmax masks as uint8 `.npy` files named
`<rgb stem>_<depth stem>.npy`, and write `unlabeled_masks.csv` (columns
image, depth, label; no index), usable as a labelled training manifest.

Under a process group each rank labels its shard of the rows (a `Loader`
with `shard=(rank, world)`: the rows i with i % world == rank, in order)
and writes their masks; rank 0 writes the one manifest, in row order, as
one process writes it.
"""

import csv
import os
import os.path as osp
from pathlib import Path

import numpy as np
import torch
import torch.distributed

from dformer_torch.parallel import dist


@torch.inference_mode()
def infer_unlabeled_masks(model, batches, save_dir: str, logger=None) -> str:
    """batches: dicts of rgb [B,H,W,3] and laser [B,360], prepared on the
    model's device, with their "rgb_path" and "depth_path" lists. Returns
    the manifest's path."""
    os.makedirs(save_dir, exist_ok=True)
    model.eval()
    rows = []
    for batch in batches:
        masks = torch.argmax(model(batch["rgb"], batch["laser"]), dim=-1)
        masks = masks.cpu().numpy()
        for i in range(masks.shape[0]):
            rgb_path = batch["rgb_path"][i]
            depth_path = batch["depth_path"][i]
            name = f"{Path(rgb_path).stem}_{Path(depth_path).stem}"
            mask_path = osp.join(save_dir, f"{name}.npy")
            np.save(mask_path, masks[i].astype(np.uint8))
            rows.append((rgb_path, depth_path, mask_path))
    csv_path = osp.join(save_dir, "unlabeled_masks.csv")
    world = dist.world()
    if world > 1:  # rank r holds rows r, r + world, ...: interleave them
        shards = [None] * world
        torch.distributed.all_gather_object(shards, rows)
        rows = [shards[i % world][i // world]
                for i in range(sum(map(len, shards)))]
    if dist.rank() == 0:
        with open(csv_path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(("image", "depth", "label"))
            writer.writerows(rows)
    if world > 1:
        torch.distributed.barrier()
    if logger:
        logger.info(f"wrote {len(rows)} pseudo-labels -> {csv_path}")
    return csv_path
