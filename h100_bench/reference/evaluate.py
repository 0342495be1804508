"""Plain PyTorch reference of multi-scale + flip evaluation: per scale the
inputs resized (bilinear, align_corners=True) to that scale's size rounded
up to a multiple of 32, a forward, the logits resized back and their
softmax summed; with flip the same on the horizontally mirrored inputs,
mirrored back. The argmax of the sum is counted into a confusion
histogram over pixels whose label is a class. Imports nothing of the
program under test."""

import numpy as np
import torch

from h100_bench.reference.model import forward, resize
from h100_bench.roofline import msf_sizes


@torch.no_grad()
def msf_probs(W, cfg, rgb, modal, scales, flip, prec):
    B, H, Wd, _ = rgb.shape
    acc = torch.zeros((B, H, Wd, cfg["num_classes"]), device=rgb.device)
    views = [(rgb, modal, False)]
    if flip:
        views.append((torch.flip(rgb, [2]), torch.flip(modal, [2]), True))
    with prec.scope():
        for size in msf_sizes(H, Wd, scales):
            for r, m, mirrored in views:
                logits = forward(W, cfg, resize(r, size, True),
                                 resize(m, size, True), prec)
                p = torch.softmax(resize(logits, (H, Wd), True), -1)
                acc += torch.flip(p, [2]) if mirrored else p
    return acc


def hist(pred, gt, classes: int, background: int) -> np.ndarray:
    pred, gt = pred.reshape(-1), gt.reshape(-1).long()
    keep = (gt != background) & (gt >= 0) & (gt < classes)
    idx = gt[keep] * classes + pred[keep]
    return torch.bincount(idx, minlength=classes * classes).reshape(
        classes, classes).cpu().numpy()


def msf_hist(W, cfg, rgb, modal, gt, scales, flip, prec) -> np.ndarray:
    pred = msf_probs(W, cfg, rgb, modal, scales, flip, prec).argmax(-1)
    return hist(pred, gt, cfg["num_classes"], cfg["background"])
