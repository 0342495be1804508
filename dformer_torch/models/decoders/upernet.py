"""UPerNet head (counterpart of `dformer_tpu/models/decoders/upernet.py`):
a pyramid pooling module on the top stage (adaptive pools 1, 2, 3, 6, each
a 1x1 conv + BN + ReLU, resized back), a 3x3 bottleneck over the top map
and its pools, 1x1 laterals on the other stages, the top-down sum, a 3x3
FPN conv per lower level, all levels resized to stage 1 and fused by a 3x3
`fpn_bottleneck`, then the 1x1 `conv_seg`. Every conv is biased before its
BatchNorm, as the reference's plain `nn.Conv2d`s are.

Keys: `psp_modules.{i}.1` / `.2` (slot 0 is the pool), `bottleneck.0` /
`.1`, `lateral_convs.{i}.0` / `.1`, `fpn_convs.{i}.0` / `.1`,
`fpn_bottleneck.0` / `.1`, `conv_seg`.
"""

from typing import Optional, Sequence

import torch
from torch import nn

from dformer_torch.models.decoders.fcn import conv_bn_relu
from dformer_torch.models.nn import RoundedConv2d
from dformer_torch.ops.resize import resize_bilinear


def _pool_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in] fp32 averaging weights: row i holds fl32(1/n) over the
    n inputs floor(i * n_in / n_out) .. ceil((i + 1) * n_in / n_out)."""
    i = torch.arange(n_out, device=device)
    start = (i * n_in) // n_out
    end = -((-(i + 1) * n_in) // n_out)
    j = torch.arange(n_in, device=device)
    inside = (j >= start[:, None]) & (j < end[:, None])
    return inside.float() / (end - start).float()[:, None]


class AdaptivePool(nn.Module):
    """The pyramid's adaptive average pool in the JAX op's form: two fp32
    products with averaging weights, over H and then over W, rounded once
    to x's dtype. In bf16 this rounds as JAX's head does; `F.adaptive_
    avg_pool2d` on the fp32 map (a sum, then a division) flips enough
    roundings to put the bf16 head 6.9e-3 of max from JAX's, above the
    2**-8 of `tests/test_torch_decoders.py::test_head_bf16_cast_order`."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x):
        B, H, W, C = x.shape
        s = self.size
        y = torch.matmul(_pool_weights(H, s, x.device),
                         x.float().reshape(B, H, W * C))
        y = torch.matmul(_pool_weights(W, s, x.device),
                         y.reshape(B * s, W, C))
        return y.reshape(B, s, s, C).to(x.dtype)


class UPerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], num_classes: int = 40,
                 channels: int = 512,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 align_corners: bool = False, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.align_corners = align_corners

        def cbr(cin, kernel):
            return conv_bn_relu(cin, channels, kernel, bn_eps, bn_momentum,
                                dtype)

        top = in_channels[-1]
        self.psp_modules = nn.ModuleList(
            nn.Sequential(AdaptivePool(s), *cbr(top, 1)) for s in pool_scales)
        self.bottleneck = cbr(top + len(pool_scales) * channels, 3)
        self.lateral_convs = nn.ModuleList(cbr(c, 1)
                                           for c in in_channels[:-1])
        self.fpn_convs = nn.ModuleList(cbr(channels, 3)
                                       for _ in in_channels[:-1])
        self.fpn_bottleneck = cbr(len(in_channels) * channels, 3)
        self.conv_seg = RoundedConv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        ac = self.align_corners
        top = inputs[-1]
        psp = [top] + [resize_bilinear(m(top), top.shape[1:3], ac)
                       for m in self.psp_modules]
        laterals = [conv(x) for conv, x in zip(self.lateral_convs, inputs)]
        laterals.append(self.bottleneck(torch.cat(psp, dim=-1)))
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_bilinear(
                laterals[i], laterals[i - 1].shape[1:3], ac)
        outs = [conv(x) for conv, x in zip(self.fpn_convs, laterals)]
        outs.append(laterals[-1])
        size = outs[0].shape[1:3]
        outs = [outs[0]] + [resize_bilinear(x, size, ac) for x in outs[1:]]
        return self.conv_seg(self.fpn_bottleneck(torch.cat(outs, dim=-1)))
