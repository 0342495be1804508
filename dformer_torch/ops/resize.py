"""Bilinear resize of NHWC tensors with `F.interpolate` semantics, and
nearest resize with the floor rule.

Counterpart of `dformer_tpu/ops/resize.py`, which expresses the same torch
semantics as two weight matmuls. Both `align_corners` modes are used by the
model stack (False in the model, True in multi-scale eval).
"""

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, size, align_corners: bool = False
                    ) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor to `size = (H, W)`.

    Identity when the size is unchanged. The NCHW view of an NHWC tensor is
    channels_last, which `F.interpolate` keeps; it accumulates bf16 inputs
    in fp32 and rounds once, as the JAX version's fp32 compute + cast does.
    """
    out_h, out_w = int(size[0]), int(size[1])
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """floor(dst * in / out) per output position (torch / cv2 nearest)."""
    src = np.floor(np.arange(out_size, dtype=np.float64)
                   * (in_size / out_size)).astype(np.int64)
    return np.clip(src, 0, in_size - 1)


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize of an NHWC (or NHW label) tensor to `size = (H, W)`;
    identity when the size is unchanged."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = x.shape[1], x.shape[2]
    if (in_h, in_w) == (out_h, out_w):
        return x
    ih = torch.from_numpy(_nearest_index(in_h, out_h)).to(x.device)
    iw = torch.from_numpy(_nearest_index(in_w, out_w)).to(x.device)
    return x[:, ih][:, :, iw]
