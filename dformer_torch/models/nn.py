"""Primitive layers, NHWC end-to-end (counterpart of `dformer_tpu/models/nn.py`).

Dtype policy, as in JAX: parameters are stored in fp32; each layer casts its
input and weights to the compute dtype `dtype` (None = the input's dtype);
LayerNorm and BatchNorm statistics run in fp32 and cast back. Convolutions
run on the channels_last NCHW view of the NHWC tensor, so cuDNN sees NHWC
memory and no copy is made. GELU is the exact erf form everywhere.

State-dict key names follow the reference (torch) model, so that
`dformer_tpu.utils.convert.convert_model_state` reads a port state_dict.

Fresh init is the JAX package's (`dformer_tpu/models/nn.py`): Linear and
conv weights uniform in +-sqrt(3 / fan_in), biases uniform in
+-1 / sqrt(fan_in).
"""

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dformer_torch.parallel import dist


def gelu(x):
    return F.gelu(x)  # exact erf


def _uniform_(t, bound):
    with torch.no_grad():
        t.uniform_(-bound, bound)


class Linear(nn.Module):
    """torch nn.Linear layout (weight [out, in]) applied on the last dim."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        _uniform_(self.weight, math.sqrt(3.0 / in_features))
        _uniform_(self.bias, 1.0 / math.sqrt(in_features))

    def forward(self, x):
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Module):
    """NHWC conv with torch Conv2d parameters (weight [out, in/g, kh, kw])
    and zero padding."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0, groups: int = 1,
                 bias: bool = True, dilation: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dilation = dilation
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None
        fan_in = in_ch // groups * kernel_size * kernel_size
        _uniform_(self.weight, math.sqrt(3.0 / fan_in))
        if self.bias is not None:
            _uniform_(self.bias, 1.0 / math.sqrt(fan_in))

    def forward(self, x):
        dt = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding, self.dilation, self.groups)
        return y.permute(0, 2, 3, 1).contiguous()


class RoundedLinear(Linear):
    """`Linear` whose product is rounded to the compute dtype before the
    bias is added in that dtype, as the JAX `Linear` computes `x @ k + b`.
    (`F.linear` with a bias rounds once, after the add.) In bf16 the lidar
    expansion and the decode heads then round where the JAX modules do."""

    def forward(self, x):
        dt = self.dtype or x.dtype
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


class RoundedConv2d(Conv2d):
    """`Conv2d` whose product is rounded to the compute dtype before the
    bias is added in that dtype, as the JAX `Conv` computes it (`F.conv2d`
    with a bias rounds once, after the add): the decode heads' convs. The
    encoder keeps `Conv2d`'s one rounding."""

    def forward(self, x):
        dt = self.dtype or x.dtype
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), None,
                     self.stride, self.padding, self.dilation, self.groups)
        y = y.permute(0, 2, 3, 1)
        if self.bias is not None:
            return y + self.bias.to(dt)
        return y.contiguous()


class LayerNorm(nn.Module):
    """Channels-last LayerNorm over the trailing dim, eps inside the sqrt,
    fp32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight.float(),
                         self.bias.float(), self.eps)
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """BatchNorm over the channel (last) dim of an NHWC tensor, in fp32.

    Eval: the running statistics. Training: the batch mean and the two-pass
    biased batch variance (clamped at 0) normalise, and the running
    statistics move by `momentum` toward the batch mean and the *unbiased*
    batch variance. Under a process group of more than one rank the batch
    is the global one (SyncBN, the moments the JAX package takes over its
    mesh): the mean is the all-summed channel sums over the global count,
    the variance the all-summed squares around that mean over it, both
    differentiable (`parallel.dist.all_sum`), and the count in the
    unbiased variance is global."""

    def __init__(self, dim: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x):
        xf = x.float()
        if self.training:
            n = x.shape[0] * x.shape[1] * x.shape[2]
            if dist.world() > 1:
                n = n * dist.world()  # every rank holds as many rows
                mean = dist.all_sum(xf.sum((0, 1, 2))) / n
                var = dist.all_sum((xf - mean).square().sum((0, 1, 2))) / n
            else:
                mean = xf.mean((0, 1, 2))
                var = (xf - mean).square().mean((0, 1, 2))
            var = var.clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(mean, alpha=m)
                self.running_var.mul_(1 - m).add_(
                    var * (n / max(n - 1, 1)), alpha=m)
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        return ((xf - mean) * scale + self.bias).to(x.dtype)


class GELU(nn.Module):
    def forward(self, x):
        return gelu(x)


class DropPath(nn.Module):
    """Per-sample stochastic depth. Identity in eval; in training the mask
    is drawn from the `generator` the caller passes, never the global RNG,
    for the global batch of a process group, of which the rank keeps its
    rows."""

    def __init__(self, drop_prob: float = 0.0):
        super().__init__()
        self.drop_prob = drop_prob

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.drop_prob == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.drop_prob
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = dist.rand_rows(shape, generator) < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class Dropout(nn.Module):
    """Element dropout. Identity in eval; in training the mask is drawn from
    the `generator` the caller passes, for the global batch of a process
    group, of which the rank keeps its rows."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if generator is None:
            raise ValueError("Dropout in training needs a torch.Generator")
        keep = 1.0 - self.rate
        mask = dist.rand_rows(x.shape, generator) < keep
        return torch.where(mask.to(x.device), x / keep, torch.zeros_like(x))


class ConvBNReLU(nn.Module):
    """mmcv ConvModule equivalent (conv + optional BN + optional ReLU), in
    the decode heads: the conv is a `RoundedConv2d`.

    conv_bias None follows ConvModule's bias='auto' rule: a bias iff there
    is no norm."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 1,
                 with_bn: bool = True, with_relu: bool = True,
                 conv_bias: Optional[bool] = None, bn_eps: float = 1e-3,
                 bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        use_bias = conv_bias if conv_bias is not None else not with_bn
        self.conv = RoundedConv2d(in_ch, out_ch, kernel_size, 1,
                                  kernel_size // 2, bias=use_bias, dtype=dtype)
        self.bn = (BatchNorm(out_ch, eps=bn_eps, momentum=bn_momentum)
                   if with_bn else None)
        self.with_relu = with_relu

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        if self.with_relu:
            y = F.relu(y)
        return y
