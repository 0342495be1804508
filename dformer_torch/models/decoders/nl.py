"""Non-local head (counterpart of `dformer_tpu/models/decoders/nl.py`):
stages 2-4 resized to stage 2 and concatenated, a 1x1 squeeze, an
embedded-gaussian non-local block, a 1x1 align, dropout and a 1x1
classifier.

The block's logits theta . phi / sqrt(inter) and their softmax run in
fp32; the softmax is cast to g's dtype before the product with g, as in the
JAX module (a fused attention call would round elsewhere).

Keys: `squeeze.conv` / `.bn`, `nl_block.{g,theta,phi}.conv`,
`nl_block.conv_out.conv` / `.bn`, `align.conv` / `.bn`, `conv_seg`.
"""

import math
from typing import Optional, Sequence

import torch
from torch import nn

from dformer_torch.models.nn import ConvBNReLU, Dropout, RoundedConv2d
from dformer_torch.ops.resize import resize_bilinear


class NonLocal2d(nn.Module):
    """Embedded-gaussian non-local block with its residual (mmcv
    NonLocal2d): g, theta, phi are biased 1x1 convs to in // reduction
    channels, conv_out a 1x1 conv + BN back to in."""

    def __init__(self, in_ch: int, reduction: int = 2, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.inter = max(in_ch // reduction, 1)
        for name in ("g", "theta", "phi"):
            setattr(self, name, ConvBNReLU(in_ch, self.inter, 1,
                                           with_bn=False, with_relu=False,
                                           dtype=dtype))
        self.conv_out = ConvBNReLU(self.inter, in_ch, 1, with_relu=False,
                                   bn_eps=bn_eps, bn_momentum=bn_momentum,
                                   dtype=dtype)

    def forward(self, x):
        B, H, W, _ = x.shape
        n, inter = H * W, self.inter
        g = self.g(x).reshape(B, n, inter)
        theta = self.theta(x).reshape(B, n, inter).float()
        phi = self.phi(x).reshape(B, n, inter).float()
        logits = torch.bmm(theta, phi.transpose(1, 2)) / math.sqrt(inter)
        attn = torch.softmax(logits, dim=-1)
        y = torch.bmm(attn.to(g.dtype), g).reshape(B, H, W, inter)
        return x + self.conv_out(y)


class NLHead(nn.Module):
    def __init__(self, in_channels: Sequence[int],
                 in_index: Sequence[int] = (1, 2, 3), channels: int = 512,
                 num_classes: int = 40, dropout_ratio: float = 0.1,
                 align_corners: bool = False, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.in_index = tuple(in_index)
        self.align_corners = align_corners
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)
        self.squeeze = ConvBNReLU(sum(in_channels[i] for i in self.in_index),
                                  channels, 1, **bn)
        self.nl_block = NonLocal2d(channels, **bn)
        self.align = ConvBNReLU(channels, channels, 1, **bn)
        self.dropout = Dropout(dropout_ratio)
        self.conv_seg = RoundedConv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        feats = [inputs[i] for i in self.in_index]
        size = feats[0].shape[1:3]
        x = torch.cat([resize_bilinear(f, size, self.align_corners)
                       for f in feats], dim=-1)
        x = self.align(self.nl_block(self.squeeze(x)))
        return self.conv_seg(self.dropout(x, generator))
