"""Segmentation loss (counterpart of `dformer_tpu/ops/loss.py`): cross
entropy on NHWC logits, averaged over the pixels whose label is not the
ignore index. The log-softmax runs in fp32 whatever the compute dtype."""

import torch


def softmax_cross_entropy_masked_mean(logits: torch.Tensor,
                                      labels: torch.Tensor,
                                      ignore_index: int = 255
                                      ) -> torch.Tensor:
    """Mean CE over pixels with label != ignore_index (0 when every pixel is
    ignored: the count is clamped to 1).

    logits [B,H,W,C] raw scores; labels [B,H,W] integer class ids."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe.unsqueeze(-1)).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
