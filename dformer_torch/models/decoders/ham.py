"""LightHamHead, the default decoder (counterpart of
`dformer_tpu/models/decoders/ham.py`).

concat stages 2-4 resized to 1/8 -> 1x1 squeeze ConvModule -> Hamburger
(1x1 in -> NMF2D multiplicative updates -> 1x1+BN out, residual relu) ->
1x1 align ConvModule -> dropout + 1x1 classifier. In training the NMF takes
6 steps from freshly drawn bases, with the one-step gradient or (opt-in,
`one_step_grad=False`) through all its updates; in eval 7 steps from seeded
bases. All NMF math runs in fp32
(its updates are ratios and precision-sensitive); on the card it needs
`torch.backends.cuda.matmul.allow_tf32 = False`, which `entry.build` sets.
"""

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dformer_torch.models.nn import ConvBNReLU, Dropout, RoundedConv2d
from dformer_torch.ops.resize import resize_bilinear
from dformer_torch.parallel import dist


def nmf2d(x, bases, train: bool = False, one_step_grad: bool = True):
    """Non-negative matrix factorisation refinement (6 steps in training, 7
    in eval).

    x: [B, N, D] non-negative features; bases: [B, D, R] initial bases.
    Returns the rank-R reconstruction [B, N, D], in fp32.

    Training gradient: with `one_step_grad` the iterated updates run on
    `x.detach()`, and only the last coefficient update and the
    reconstruction are differentiated (HamNet's one-step gradient);
    without it every update is differentiated, which from a random init can
    give non-finite gradients (the ratios' small denominators square in the
    backward)."""
    x = x.float()
    bases = bases.float()
    eps = 1e-6

    def update_coef(x_, bases_, coef):
        numer = torch.bmm(x_, bases_)
        denom = torch.bmm(coef, torch.bmm(bases_.transpose(1, 2), bases_))
        return coef * numer / (denom + eps)

    x_iter = x.detach() if train and one_step_grad else x
    coef = torch.softmax(torch.bmm(x_iter, bases), dim=-1)
    for _ in range(6 if train else 7):
        coef = update_coef(x_iter, bases, coef)
        numer = torch.bmm(x_iter.transpose(1, 2), coef)
        denom = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
        bases = bases * numer / (denom + eps)
    coef = update_coef(x, bases, coef)
    return torch.bmm(coef, bases.transpose(1, 2))


def uniform_bases(generator: torch.Generator, b: int, d: int, r: int,
                  device) -> torch.Tensor:
    """Fresh uniform NMF bases from `generator`, L2-normalised over the
    channel dim, on `device`: what a training forward draws. Under a
    process group the draw is for the global batch, of which the rank
    keeps its b rows."""
    bases = dist.rand_rows((b, d, r), generator)
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    return bases.to(device)


# rows of the seeded draw kept per (d, r, device): a batch up to this many
# rows slices it, which is also how an exported forward with a symbolic
# batch reads it (`runtime/export.py` bounds the batch by it)
SEEDED_ROWS = 64


@functools.lru_cache(maxsize=8)
def _seeded_draw(n: int, d: int, r: int,
                 device: torch.device) -> torch.Tensor:
    # a normal tensor even when first drawn under inference_mode, so that a
    # later forward with autograd may save it for backward
    with torch.inference_mode(False), torch.no_grad():
        gen = torch.Generator().manual_seed(0)
        bases = torch.rand((n, d, r), generator=gen)
        bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
        return bases.to(device)


def seeded_bases(b, d: int, r: int, device: torch.device) -> torch.Tensor:
    """Uniform NMF bases drawn from a torch.Generator seeded 0, L2-normalised
    over the channel dim: the port's deterministic bases. (The JAX package
    draws its own from its random key 0; the bits differ, so parity tests
    pass JAX's array in through `bases`.)

    Drawn on the CPU, so the bits are the same on every device, and cached
    per device as one draw of max(b, SEEDED_ROWS) rows whose first b rows
    are returned: the CPU generator fills a tensor in order, so these are
    the bits of a draw of b rows. A forward on the card reuses the copy
    already there instead of drawing and copying it mid-forward. `b` may be
    a symbolic batch (torch.export) of at most SEEDED_ROWS; the draw must
    then be in the cache already (`export_forward` runs the forward once
    first). Callers must not modify the result in place."""
    n = max(b, SEEDED_ROWS) if isinstance(b, int) else SEEDED_ROWS
    return _seeded_draw(n, d, r, device)[:b]


class Hamburger(nn.Module):
    """ham_in (1x1, no norm/act) -> relu -> NMF2D -> ham_out (1x1+BN) ->
    relu(x + out)."""

    def __init__(self, ham_channels: int = 512, md_r: int = 64,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 one_step_grad: bool = True):
        super().__init__()
        self.ham_channels, self.md_r = ham_channels, md_r
        self.one_step_grad = one_step_grad
        self.ham_in = RoundedConv2d(ham_channels, ham_channels, 1, dtype=dtype)
        self.ham_out = ConvBNReLU(ham_channels, ham_channels, 1, with_bn=True,
                                  with_relu=False, bn_eps=bn_eps,
                                  bn_momentum=bn_momentum, dtype=dtype)

    def forward(self, x, bases: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """bases [B, ham_channels, md_r] overrides the draw; None = fresh
        `uniform_bases` from `generator` in training, `seeded_bases` in
        eval."""
        B, H, W, D = x.shape
        enjoy = F.relu(self.ham_in(x))
        if bases is None and self.training:
            if generator is None:
                raise ValueError("Hamburger in training needs NMF bases or "
                                 "a torch.Generator to draw them from")
            bases = uniform_bases(generator, B, self.ham_channels, self.md_r,
                                  x.device)
        elif bases is None:
            bases = seeded_bases(B, self.ham_channels, self.md_r, x.device)
        flat = nmf2d(enjoy.reshape(B, H * W, self.ham_channels), bases,
                     train=self.training, one_step_grad=self.one_step_grad)
        enjoy = flat.reshape(B, H, W, self.ham_channels).to(x.dtype)
        enjoy = self.ham_out(enjoy)
        return F.relu(x + enjoy)


class LightHamHead(nn.Module):
    """HamNet light head over backbone stages 2-4."""

    def __init__(self, in_channels: Sequence[int],
                 in_index: Sequence[int] = (1, 2, 3), channels: int = 512,
                 ham_channels: int = 512, num_classes: int = 40,
                 dropout_ratio: float = 0.1, align_corners: bool = False,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None,
                 one_step_grad: bool = True):
        super().__init__()
        self.in_index = tuple(in_index)
        self.align_corners = align_corners
        bn = dict(bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)
        self.squeeze = ConvBNReLU(sum(in_channels), ham_channels, 1, **bn)
        self.hamburger = Hamburger(ham_channels, **bn,
                                   one_step_grad=one_step_grad)
        self.align = ConvBNReLU(ham_channels, channels, 1, **bn)
        self.dropout = Dropout(dropout_ratio)
        self.conv_seg = RoundedConv2d(channels, num_classes, 1, dtype=dtype)

    def forward(self, inputs, bases: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        feats = [inputs[i] for i in self.in_index]
        size = feats[0].shape[1:3]
        feats = [resize_bilinear(f, size, self.align_corners) for f in feats]
        x = self.squeeze(torch.cat(feats, dim=-1))
        x = self.hamburger(x, bases, generator)
        x = self.align(x)
        x = self.dropout(x, generator)
        return self.conv_seg(x)
