"""FCN head: 3x3 conv + BN + ReLU, then a 1x1 classifier (counterpart of
`dformer_tpu/models/decoders/fcn.py`). The FCN-32s fallback decoder on the
top stage, and the auxiliary head on stage 3 (index 2).

The conv is biased before its BatchNorm, as the reference's plain
`nn.Conv2d` is; keys `conv.0` (conv), `conv.1` (BN), `classifier`.
"""

from typing import Optional

import torch
from torch import nn

from dformer_torch.models.nn import BatchNorm, RoundedConv2d


def conv_bn_relu(in_ch: int, out_ch: int, kernel_size: int, bn_eps: float,
                 bn_momentum: float, dtype: Optional[torch.dtype],
                 bias: bool = True) -> nn.Sequential:
    """[conv, BN, ReLU] in the slots 0, 1, 2 of a Sequential, as the
    reference's hand-written heads hold them; the conv biased unless told
    otherwise."""
    return nn.Sequential(
        RoundedConv2d(in_ch, out_ch, kernel_size, padding=kernel_size // 2,
                      bias=bias, dtype=dtype),
        BatchNorm(out_ch, eps=bn_eps, momentum=bn_momentum), nn.ReLU())


class FCNHead(nn.Module):
    """in_channels: the channels of the map it reads (the last of a list
    of maps); channels: the hidden width, in_channels // 4 by default."""

    def __init__(self, in_channels: int, num_classes: int = 40,
                 channels: Optional[int] = None, kernel_size: int = 3,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        channels = channels or in_channels // 4
        self.conv = conv_bn_relu(in_channels, channels, kernel_size, bn_eps,
                                 bn_momentum, dtype)
        self.classifier = RoundedConv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if isinstance(x, (list, tuple)):
            x = x[-1]
        return self.classifier(self.conv(x))
