"""Trav (traversability) extensions (counterpart of
`dformer_tpu/models/trav.py`): the 1-D lidar -> 2-D pseudo-depth expansion
and the DFormerTrav backbone.

Attention1Dto2D lifts a 360-beam lidar scan to a [B, H, W, 1] pseudo-depth
image through two learned-query multi-head attentions: 360 beams -> W
columns, then one token per column -> H rows. The second attends over a
single key, so its softmax is exactly 1 and every row of a column gets the
same value: the pseudo-depth is constant down each column, and `query2` and
the query/key thirds of `attn2`'s in-projection get gradients of exactly 0.
That is the reference model's design, kept as it is.

Plain PyTorch (the JAX package runs these attentions as plain XLA, not
Pallas). State-dict keys are the reference's: the expansion under
`attn_expand_e.*`, the DFormer-Base body's keys flat beside it.
"""

import math
from typing import Optional, Tuple

import torch
from torch import nn

from dformer_torch.models.encoder import VARIANTS, DFormer
from dformer_torch.models.nn import RoundedLinear

LIDAR_BEAMS = 360


class MultiHeadAttention(nn.Module):
    """torch `nn.MultiheadAttention` (batch_first) with its packed
    in-projection `in_proj_weight` [3E, E] / `in_proj_bias` [3E] and an
    `out_proj` Linear.

    As in the JAX module, the in-projection runs in the promotion of the
    input's dtype and the fp32 parameters (fp32 for a bf16 input), the
    logits are computed in fp32 from q / sqrt(head dim), and the softmax is
    cast to v's dtype before the second product; `out_proj` computes in
    `dtype` (a `RoundedLinear`). A query whose batch is 1 is broadcast
    over the key's batch."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        E = embed_dim
        self.embed_dim, self.num_heads = E, num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * E, E))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * E))
        bound = math.sqrt(6.0 / (E + E))  # xavier_uniform of each third
        with torch.no_grad():
            self.in_proj_weight.uniform_(-bound, bound)
        self.out_proj = RoundedLinear(E, E, dtype=dtype)

    def forward(self, query, key, value):
        E, nh = self.embed_dim, self.num_heads
        hd = E // nh
        w, b = self.in_proj_weight, self.in_proj_bias

        def project(x, i):
            dt = torch.promote_types(x.dtype, w.dtype)
            return nn.functional.linear(x.to(dt), w[i * E:(i + 1) * E].to(dt),
                                        b[i * E:(i + 1) * E].to(dt))

        q, k, v = project(query, 0), project(key, 1), project(value, 2)
        Bq, Lq, _ = q.shape
        B, Lk, _ = k.shape
        q = q.reshape(Bq, Lq, nh, hd).transpose(1, 2)
        k = k.reshape(B, Lk, nh, hd).transpose(1, 2)
        v = v.reshape(B, Lk, nh, hd).transpose(1, 2)
        logits = torch.matmul((q / math.sqrt(hd)).float(),
                              k.float().transpose(-1, -2))
        attn = torch.softmax(logits, dim=-1)
        out = torch.matmul(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(B, Lq, E)
        return self.out_proj(out)


class Attention1Dto2D(nn.Module):
    """[B, 360] lidar -> [B, output_len, mid_len, 1] pseudo-depth."""

    def __init__(self, input_len: int = LIDAR_BEAMS, mid_len: int = 640,
                 output_len: int = 480, embed_dim: int = 64,
                 num_heads: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.input_len, self.mid_len, self.output_len = \
            input_len, mid_len, output_len
        self.embed_dim = embed_dim
        self.input_proj = RoundedLinear(1, embed_dim, dtype=dtype)
        self.query1 = nn.Parameter(torch.randn(mid_len, embed_dim))
        self.attn1 = MultiHeadAttention(embed_dim, num_heads, dtype=dtype)
        self.query2 = nn.Parameter(torch.randn(output_len, embed_dim))
        self.attn2 = MultiHeadAttention(embed_dim, num_heads, dtype=dtype)
        self.output_proj = RoundedLinear(embed_dim, 1, dtype=dtype)

    def forward(self, scan):
        B = scan.shape[0]
        x = self.input_proj(scan.reshape(B, self.input_len, 1))
        x = self.attn1(self.query1[None], x, x)
        x = x.reshape(B * self.mid_len, 1, self.embed_dim)
        x = self.attn2(self.query2[None], x, x)
        x = self.output_proj(x)[..., 0]
        # [B*W, H] -> [B, W, H] -> [B, H, W, 1]
        x = x.reshape(B, self.mid_len, self.output_len)
        return x.transpose(1, 2)[..., None]


class DFormerTrav(DFormer):
    """DFormer-Base fed by the Attention1Dto2D lidar expansion. `x_e` is a
    raw [B, 360] scan; a tensor with more dims is flattened per sample and
    cut to its first 360 values. `expand_hw` is the pseudo-depth size, the
    configured image size, so that it matches the rgb stream."""

    def __init__(self, drop_path_rate: float = 0.1,
                 expand_hw: Tuple[int, int] = (480, 640),
                 dtype: Optional[torch.dtype] = None):
        super().__init__(drop_path_rate=drop_path_rate, dtype=dtype,
                         **VARIANTS["DFormer-Base"])
        self.attn_expand_e = Attention1Dto2D(
            mid_len=expand_hw[1], output_len=expand_hw[0], dtype=dtype)

    def forward(self, x, x_e, generator: Optional[torch.Generator] = None):
        if x_e.ndim > 2:
            x_e = x_e.reshape(x_e.shape[0], -1)[:, :LIDAR_BEAMS]
        return super().forward(x, self.attn_expand_e(x_e), generator)
