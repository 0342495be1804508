"""Segmentation losses (counterpart of `dformer_tpu/ops/loss.py`): cross
entropy on NHWC logits averaged over the pixels whose label is not the
ignore index (the train step's loss), and the JAX package's other losses
on the same layout: per-pixel CE, Dice, focal, Tversky, Lovász-softmax,
OHEM CE, BerHu, class-balanced CE, reverse-CE-regularised CE and sigmoid
focal. Softmaxes run in fp32 whatever the compute dtype."""

import torch
import torch.nn.functional as F

from dformer_torch.parallel import dist


def _nll(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int):
    """(-log p[label] per pixel, 0 where ignored; the valid mask)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    return torch.where(valid, nll, 0.0), valid


def softmax_cross_entropy_masked_mean(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      ignore_index: int = 255
                                      ) -> torch.Tensor:
    """Mean CE over pixels with label != ignore_index (0 when every pixel is
    ignored: the count is clamped to 1).

    logits [B,H,W,C] raw scores; labels [B,H,W] integer class ids. Under a
    process group of more than one rank the mean is over the global batch:
    this rank's sum over the valid-pixel count summed over the ranks, so
    the ranks' results sum to the global mean (and their gradients to its
    gradient) however the ignored pixels fall among them."""
    nll, valid = _nll(logits, labels, ignore_index)
    count = valid.sum()
    if dist.world() > 1:
        count = dist.all_sum(count)
    return nll.sum() / count.clamp(min=1)


def per_pixel_cross_entropy(logits, labels, ignore_index: int = 255):
    """CE per pixel [B,H,W], 0 at ignored pixels (reduction 'none')."""
    return _nll(logits, labels, ignore_index)[0]


def _probs_onehot(logits, labels, ignore_index):
    """fp32 softmax and one-hot labels, both zeroed at ignored pixels."""
    valid = (labels != ignore_index)[..., None]
    safe = torch.where(labels == ignore_index, 0, labels).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float() * valid
    probs = torch.softmax(logits.float(), dim=-1) * valid
    return probs, onehot


def dice_loss(logits, labels, ignore_index: int = 255, smooth: float = 1.0):
    """1 - the mean over classes of the soft Dice score."""
    probs, onehot = _probs_onehot(logits, labels, ignore_index)
    inter = (probs * onehot).sum((0, 1, 2))
    denom = probs.sum((0, 1, 2)) + onehot.sum((0, 1, 2))
    return 1.0 - ((2.0 * inter + smooth) / (denom + smooth)).mean()


def focal_loss(logits, labels, gamma: float = 2.0, alpha: float = 0.25,
               ignore_index: int = 255):
    """alpha (1 - p)^gamma CE, averaged over the valid pixels."""
    nll, valid = _nll(logits, labels, ignore_index)
    loss = alpha * (1.0 - torch.exp(-nll)) ** gamma * nll
    return torch.where(valid, loss, 0.0).sum() / valid.sum().clamp(min=1)


def tversky_loss(logits, labels, alpha: float = 0.5, beta: float = 0.5,
                 ignore_index: int = 255, smooth: float = 1.0):
    """1 - the mean over classes of the Tversky index (alpha = beta = 0.5
    is Dice)."""
    probs, onehot = _probs_onehot(logits, labels, ignore_index)
    tp = (probs * onehot).sum((0, 1, 2))
    fp = (probs * (1.0 - onehot)).sum((0, 1, 2))
    fn = ((1.0 - probs) * onehot).sum((0, 1, 2))
    return 1.0 - ((tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
                  ).mean()


def lovasz_softmax_loss(logits, labels, ignore_index: int = 255):
    """Lovász-softmax: each present class's errors |fg - p|, sorted
    descending (ignored pixels 0), against the Lovász extension's Jaccard
    gradient; the mean over the classes present."""
    c = logits.shape[-1]
    probs = torch.softmax(logits.float(), dim=-1).reshape(-1, c)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    safe = torch.where(valid, flat, 0)
    losses, present = [], []
    for k in range(c):
        fg = ((safe == k) & valid).float()
        errors = torch.where(valid, (fg - probs[:, k]).abs(), 0.0)
        order = torch.argsort(-errors.detach(), stable=True)
        fg_sorted = fg[order]
        gts = fg_sorted.sum()
        inter = gts - fg_sorted.cumsum(0)
        union = gts + (1.0 - fg_sorted).cumsum(0)
        jaccard = 1.0 - inter / union.clamp(min=1e-8)
        grad = torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])
        losses.append(torch.where(gts > 0, errors[order] @ grad, 0.0))
        present.append(gts > 0)
    return torch.stack(losses).sum() / torch.stack(present).sum().clamp(min=1)


def ohem_cross_entropy(logits, labels, thresh: float = 0.7,
                       min_kept: int = 100000, ignore_index: int = 255):
    """Online hard example mining CE: the mean CE over the valid pixels
    whose true-class probability is at most max(thresh, the min_kept-th
    smallest such probability)."""
    c = logits.shape[-1]
    lf = logits.float().reshape(-1, c)
    flat = labels.reshape(-1)
    valid = flat != ignore_index
    safe = torch.where(valid, flat, 0).long()[:, None]
    logp = torch.log_softmax(lf, dim=-1)
    probs = torch.softmax(lf.detach(), dim=-1)
    true_p = torch.where(valid, probs.gather(1, safe)[:, 0], 1.0)
    k = min(min_kept, true_p.shape[0]) - 1
    dyn_thresh = torch.sort(true_p).values[k].clamp(min=thresh)
    keep = valid & (true_p <= dyn_thresh)
    nll = torch.where(keep, -logp.gather(1, safe)[:, 0], 0.0)
    return nll.sum() / keep.sum().clamp(min=1)


def berhu_loss(pred, target, mask=None):
    """Reverse Huber: |d| up to c = 0.2 max |d|, (d^2 + c^2) / 2c above;
    the mean over the pixels of `mask` (all without one)."""
    diff = (pred.float() - target.float()).abs()
    if mask is not None:
        diff = torch.where(mask, diff, 0.0)
    c = 0.2 * diff.max()
    quad = (diff * diff + c * c) / (2.0 * c).clamp(min=1e-8)
    loss = torch.where(diff <= c, diff, quad)
    if mask is not None:
        return loss.sum() / mask.sum().clamp(min=1)
    return loss.mean()


def class_balanced_ce(logits, labels, ignore_index: int = 255,
                      beta: float = 0.999):
    """CE weighted per class by the inverse effective number of its pixels
    in the batch, (1 - beta^n) / (1 - beta), weights scaled to sum to the
    class count; the weighted mean over the valid pixels."""
    c = logits.shape[-1]
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    counts = (F.one_hot(safe, c) * valid[..., None]).reshape(-1, c).sum(0)
    eff = (1.0 - torch.pow(beta, counts.float())) / (1.0 - beta)
    weights = torch.where(counts > 0, 1.0 / eff.clamp(min=1e-8), 0.0)
    weights = weights / weights.sum().clamp(min=1e-8) * c
    w = weights[safe] * valid
    nll = per_pixel_cross_entropy(logits, labels, ignore_index)
    return (nll * w).sum() / w.sum().clamp(min=1e-8)


def rce_loss(logits, labels, ignore_index: int = 255, beta: float = 0.01):
    """The masked mean CE plus beta times the reference's reverse-CE term:
    -log clip(onehot(label), 1e-9, 1 - 1e-9) at each pixel's argmax class
    (ignored labels one-hot to class 0), whose mean the reference takes
    over [b, b, h, w] (a [b,h,w] term times a [b,1,h,w] mask): the sum over
    pixels of (the term summed over the batch) x (the mask summed over the
    batch), over b^2 h w."""
    valid = labels != ignore_index
    loss1 = softmax_cross_entropy_masked_mean(logits, labels, ignore_index)
    max_id = torch.argmax(logits.float(), dim=-1)
    safe = torch.where(valid, labels, 0).long()
    onehot = F.one_hot(safe, logits.shape[-1]).float()
    picked = -torch.log(onehot.clamp(1e-9, 1.0 - 1e-9).gather(
        -1, max_id[..., None])[..., 0])
    b = picked.shape[0]
    loss2 = (picked.sum(0) * valid.float().sum(0)).mean() / (b * b)
    return loss1 + beta * loss2


def sigmoid_focal_loss(logits, labels, ignore_index: int = 255,
                       gamma: float = 2.0, alpha: float = 0.25):
    """The reference's sigmoid focal loss on one logit per pixel [B,H,W]
    (its raw label value as the target, its log term built from the
    sigmoid), the mean over every pixel with ignored ones 0."""
    b = labels.shape[0]
    p = torch.sigmoid(logits.reshape(b, -1, 1).float())
    t_raw = labels.reshape(b, -1)
    mask = (t_raw != ignore_index).float()
    onehot = (mask * t_raw.float())[..., None]
    max_val = (-p).clamp(min=0.0)
    pos = (1.0 - p) ** gamma * (p - p * onehot)
    neg = p ** gamma * (max_val + torch.log(torch.exp(-max_val)
                                            + torch.exp(-p - max_val)))
    return (-(alpha * pos + (1.0 - alpha) * neg).sum(-1) * mask).mean()
