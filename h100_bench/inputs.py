"""The general generator of a cell's inputs: images, depth maps or lidar
scans and labels, drawn on the device from the run's seed as a traffic
file's parameters ask. Every row of a pool is its own draw, so no two
rows are alike; the same seed gives the same pool.

With `coarse` ([rows, columns] of a grid) an image, depth map or scan is a
draw on that coarse grid, bilinearly upsampled, plus `fine` times pixel
noise: scenes with large regions, as camera frames and scans have, rather
than noise alone.
"""

import torch
import torch.nn.functional as F

from h100_bench.weights import INPUTS, generator


def _field(g, rows, channels, size, coarse, fine, device):
    """[rows, *size, channels]: a coarse draw upsampled plus fine noise,
    or noise alone without `coarse`."""
    noise = torch.randn((rows, *size, channels), generator=g, device=device)
    if not coarse:
        return noise
    grid = coarse if len(size) == 2 else coarse[-1:]
    low = torch.randn((rows, channels, *grid), generator=g, device=device)
    mode = "bilinear" if len(size) == 2 else "linear"
    up = F.interpolate(low, size=tuple(size), mode=mode, align_corners=False)
    return up.movedim(1, -1) + fine * noise


def pool(cfg: dict, rows: int, seed: int, device, labels: bool = False,
         ignore_share: float = 0.0, coarse=None, fine: float = 1.0) -> dict:
    """{"rgb": [rows, H, W, 3] normalised image, "modal": the depth map
    [rows, H, W, modal_channels] (one normalised channel repeated, as a
    depth image is read) or the scan [rows, beams], and with `labels`
    "gt": [rows, H, W] int64 class ids with `ignore_share` of the pixels
    at the configuration's background label}, float32 on `device`."""
    g = generator(seed, INPUTS, device)
    H, W = cfg["image_height"], cfg["image_width"]
    out = {"rgb": _field(g, rows, 3, (H, W), coarse, fine, device)}
    if "lidar" in cfg:
        out["modal"] = _field(g, rows, 1, (cfg["lidar"]["beams"],), coarse,
                              fine, device)[..., 0]
    else:
        depth = _field(g, rows, 1, (H, W), coarse, fine, device)
        out["modal"] = depth.expand(-1, -1, -1,
                                    cfg["modal_channels"]).contiguous()
    if labels:
        gt = torch.randint(0, cfg["num_classes"], (rows, H, W), generator=g,
                           device=device)
        drop = torch.rand((rows, H, W), generator=g, device=device) \
            < ignore_share
        out["gt"] = gt.masked_fill(drop, cfg["background"])
    return out


def to_host(tensors: dict, pinned: bool) -> dict:
    """A host copy of each tensor, in page-locked memory when `pinned`."""
    out = {}
    for k, t in tensors.items():
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
        h.copy_(t)
        out[k] = h
    return out
