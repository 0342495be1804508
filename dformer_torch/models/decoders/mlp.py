"""SegFormer-style all-MLP decoder (counterpart of
`dformer_tpu/models/decoders/mlp.py`): a Linear embed per stage, each
resized to stage 1's size, concatenated in the order c4, c3, c2, c1, a
biased 1x1 conv + BN + ReLU fuse, dropout, a 1x1 classifier.

Keys: `linear_c{1..4}.proj`, `linear_fuse.0` / `.1`, `linear_pred`.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from dformer_torch.models.decoders.fcn import conv_bn_relu
from dformer_torch.models.nn import Dropout, RoundedConv2d, RoundedLinear
from dformer_torch.ops.resize import resize_bilinear


class _Embed(nn.Module):
    def __init__(self, in_ch: int, embed_dim: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.proj = RoundedLinear(in_ch, embed_dim, dtype=dtype)

    def forward(self, x):
        return self.proj(x)


class MLPDecoderHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 40,
                 embed_dim: int = 768, dropout_ratio: float = 0.1,
                 align_corners: bool = False, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.align_corners = align_corners
        for i, c in enumerate(in_channels):
            setattr(self, f"linear_c{i + 1}", _Embed(c, embed_dim, dtype))
        self.linear_fuse = conv_bn_relu(4 * embed_dim, embed_dim, 1, bn_eps,
                                        bn_momentum, dtype)
        self.dropout = Dropout(dropout_ratio)
        self.linear_pred = RoundedConv2d(embed_dim, num_classes, 1,
                                         dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        size = inputs[0].shape[1:3]
        embedded = [resize_bilinear(
            getattr(self, f"linear_c{i + 1}")(inputs[i]), size,
            self.align_corners) for i in (3, 2, 1, 0)]
        x = self.linear_fuse(torch.cat(embedded, dim=-1))
        return self.linear_pred(self.dropout(x, generator))
