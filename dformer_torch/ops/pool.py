"""Adaptive average pooling of NHWC tensors (torch `AdaptiveAvgPool2d`
semantics) and the global mean (counterparts of `dformer_tpu/ops/pool.py`'s
`adaptive_avg_pool2d` and `global_avg_pool2d`). Output sizes larger than
the input are valid (the GAA branch pools a 2x3 stage-3 map of a 64x96
input to 7x7): each cell then averages its covering input cells.

UPerHead's pyramid pooling keeps the JAX op's form, two fp32 products with
averaging weights (`models/decoders/upernet.py`), so that it rounds as JAX's
head in bf16.
"""

import torch
import torch.nn.functional as F


def adaptive_avg_pool2d(x: torch.Tensor, output_size) -> torch.Tensor:
    """NHWC adaptive average pool to `output_size = (H, W)`."""
    out_h, out_w = int(output_size[0]), int(output_size[1])
    y = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2), (out_h, out_w))
    return y.permute(0, 2, 3, 1).contiguous()


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """NHWC mean over H and W, kept as [B, 1, 1, C]."""
    return x.mean(dim=(1, 2), keepdim=True)
