"""Confusion-matrix segmentation metrics (mIoU / mAcc / mF1), counterpart of
`dformer_tpu/ops/metrics.py`.

hist[t, p] counts pixels with ground truth t predicted as p. A pixel counts
only when its target and prediction both lie in [0, num_classes) and its
target is not the ignore index: the JAX one-hot form drops every other
pixel, not only label 255. The per-class scores are numpy on the host,
treat NaN as 0 and report percentages rounded to 2 places.
"""

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int, ignore_index: int = 255
                     ) -> torch.Tensor:
    """[num_classes, num_classes] int64 histogram on the inputs' device;
    rows = target, cols = pred. pred/target: integer tensors of one shape."""
    pred = pred.reshape(-1).long()
    target = target.reshape(-1).long()
    keep = ((target != ignore_index) & (target >= 0) & (target < num_classes)
            & (pred >= 0) & (pred < num_classes))
    idx = target[keep] * num_classes + pred[keep]
    return torch.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes)


def _nan_to_zero(x: np.ndarray) -> np.ndarray:
    return np.where(np.isnan(x), 0.0, x)


def iou_from_hist(hist: np.ndarray):
    """Per-class IoU (%) and mIoU (%)."""
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        ious = diag / (hist.sum(0) + hist.sum(1) - diag)
    ious = _nan_to_zero(ious)
    miou = ious.mean()
    return np.round(ious * 100, 2).tolist(), round(miou * 100, 2)


def f1_from_hist(hist: np.ndarray):
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = 2 * diag / (hist.sum(0) + hist.sum(1))
    f1 = _nan_to_zero(f1)
    return np.round(f1 * 100, 2).tolist(), round(f1.mean() * 100, 2)


def pixel_acc_from_hist(hist: np.ndarray):
    hist = np.asarray(hist, dtype=np.float64)
    diag = np.diag(hist)
    with np.errstate(divide="ignore", invalid="ignore"):
        acc = diag / hist.sum(1)
    acc = _nan_to_zero(acc)
    return np.round(acc * 100, 2).tolist(), round(acc.mean() * 100, 2)


def accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=1,
             ignore_index: int = 255, thresh: float = None):
    """Top-k pixel accuracy (%). logits: [..., C]; labels: [...]. An int
    `topk` gives one 0-d tensor, a tuple a list of them."""
    ks = (topk,) if isinstance(topk, int) else tuple(topk)
    valid = labels != ignore_index
    vals, idx = torch.topk(logits, max(ks), dim=-1)
    correct = idx == labels[..., None]
    if thresh is not None:
        correct = correct & (vals > thresh)
    total = valid.sum().clamp(min=1)
    accs = [(correct[..., :k].any(dim=-1) & valid).sum() / total * 100.0
            for k in ks]
    return accs[0] if isinstance(topk, int) else accs


class Metrics:
    """Host-side int64 accumulator over per-batch histograms."""

    def __init__(self, num_classes: int, ignore_index: int = 255):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        self.hist = np.zeros((num_classes, num_classes), dtype=np.int64)

    def update_hist(self, hist) -> None:
        if isinstance(hist, torch.Tensor):
            hist = hist.cpu().numpy()
        self.hist += np.asarray(hist, dtype=np.int64)

    def update(self, probs_or_logits: torch.Tensor, target: torch.Tensor
               ) -> None:
        """probs_or_logits: [B, H, W, C] (argmax over the last dim);
        target: [B, H, W]."""
        pred = torch.argmax(probs_or_logits, dim=-1)
        self.update_hist(confusion_matrix(pred, target, self.num_classes,
                                          self.ignore_index))

    def merge_across_processes(self) -> "Metrics":
        """Sum the hists of every process of the default process group
        (`all_reduce`); nothing to do when no group is initialised."""
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            return self
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
        t = torch.from_numpy(self.hist).to(device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        self.hist = t.cpu().numpy()
        return self

    def compute_iou(self):
        return iou_from_hist(self.hist)

    def compute_f1(self):
        return f1_from_hist(self.hist)

    def compute_pixel_acc(self):
        return pixel_acc_from_hist(self.hist)
