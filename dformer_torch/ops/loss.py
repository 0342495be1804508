"""Segmentation loss (counterpart of `dformer_tpu/ops/loss.py`): cross
entropy on NHWC logits, averaged over the pixels whose label is not the
ignore index. The log-softmax runs in fp32 whatever the compute dtype."""

import torch

from dformer_torch.parallel import dist


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
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    count = valid.sum()
    if dist.world() > 1:
        count = dist.all_sum(count)
    return nll.sum() / count.clamp(min=1)
