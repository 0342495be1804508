"""DeepLabV3+ head (counterpart of
`dformer_tpu/models/decoders/deeplabv3p.py`): ASPP on the top stage (a 1x1
branch, 3x3 branches at dilations 12, 24, 36, an image-pool branch
broadcast back), a 1x1 projection and dropout 0.5; a 48-channel 3x3 branch
on stage 1; the ASPP map resized to it with align_corners=True, a 3x3
`block` conv, dropout 0.1 and a 1x1 classifier.

The ASPP convs have no bias; `low_level` and the `block` conv do, drawn at
0 as the JAX module draws them. (The JAX module casts neither input nor
kernel to its `dtype`, so it runs in fp32 only; here every conv computes in
`dtype` as the JAX package's other convs do.)

Keys: `aspp.b0.0` / `.1`, `aspp.b{1,2,3}.block.0` / `.1`, `aspp.b4.gap.1` /
`.2` (slot 0 is the pool), `aspp.project.0` / `.1`, `low_level.0` / `.1`,
`block.0` / `.1` / `.4` (slots 2 and 3 are the ReLU and the dropout).
"""

from typing import Optional, Sequence

import torch
from torch import nn

from dformer_torch.models.nn import BatchNorm, Dropout, RoundedConv2d
from dformer_torch.ops.pool import global_avg_pool2d
from dformer_torch.ops.resize import resize_bilinear


class GlobalPool(nn.Module):
    def forward(self, x):
        return global_avg_pool2d(x)


class DeepLabV3Plus(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 40,
                 aspp_channels: int = 256,
                 atrous_rates: Sequence[int] = (12, 24, 36),
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()

        def conv_bn(cin, cout, kernel, dilation=1, bias=False):
            conv = RoundedConv2d(cin, cout, kernel,
                                 padding=kernel // 2 * dilation, bias=bias,
                                 dilation=dilation, dtype=dtype)
            if bias:
                nn.init.zeros_(conv.bias)
            return [conv, BatchNorm(cout, eps=bn_eps, momentum=bn_momentum),
                    nn.ReLU()]

        c1, c4, a = in_channels[0], in_channels[-1], aspp_channels
        self.aspp = nn.Module()
        self.aspp.b0 = nn.Sequential(*conv_bn(c4, a, 1))
        for i, rate in enumerate(atrous_rates, start=1):
            branch = nn.Module()
            branch.block = nn.Sequential(*conv_bn(c4, a, 3, rate))
            setattr(self.aspp, f"b{i}", branch)
        self.aspp.b4 = nn.Module()
        self.aspp.b4.gap = nn.Sequential(GlobalPool(), *conv_bn(c4, a, 1))
        self.aspp.project = nn.Sequential(
            *conv_bn((len(atrous_rates) + 2) * a, a, 1))
        self.aspp_dropout = Dropout(0.5)
        self.low_level = nn.Sequential(*conv_bn(c1, 48, 3, bias=True))
        self.block = nn.Sequential(
            *conv_bn(a + 48, 256, 3, bias=True), Dropout(0.1),
            RoundedConv2d(256, num_classes, 1, dtype=dtype))
        self.n_rates = len(atrous_rates)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        c1, c4 = inputs[0], inputs[-1]
        aspp = self.aspp
        feats = [aspp.b0(c4)] + [getattr(aspp, f"b{i}").block(c4)
                                 for i in range(1, self.n_rates + 1)]
        feats.append(aspp.b4.gap(c4).expand(*c4.shape[:3], -1))
        x = aspp.project(torch.cat(feats, dim=-1))
        x = self.aspp_dropout(x, generator)
        low = self.low_level(c1)
        x = resize_bilinear(x, low.shape[1:3], align_corners=True)
        x = self.block[:3](torch.cat([x, low], dim=-1))
        return self.block[4](self.block[3](x, generator))
