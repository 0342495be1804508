"""Device-side preprocessing (counterpart of `dformer_tpu/data/augment.py`):
the train augmentation and the val normalisation.

The train augmentation is the reference's CPU pipeline (mirror with p 0.5,
a random scale from `train_scale_array`, normalise, random crop + pad to
the crop size, 0 for images and 255 for labels) as one resample per batch
on the batch's device. "Random scale then random crop + pad" is one affine
map: output pixel (i, j) of sample b reads the source coordinate

    src = (crop_origin + idx + 0.5) / scale_ratio - 0.5   (cv2 INTER_LINEAR)

and labels take cv2's INTER_NEAREST floor rule on the same grid, so no
image of the scaled size is ever made. Positions outside the scaled image
take the pad value.

Every sample has its own flip, scale, crop origin and, for a canvas batch of
variable-size images (SUNRGBD), its own valid extent: all of them are
tensors over the batch, and the whole batch is a handful of gathers with no
host synchronisation. The random draws (`train_augment_draws`) are apart
from the math (`apply_train_augment`), so the same draws can be fed to both
this module and the JAX one.

The standalone primitives at the end (pad, shortest-edge resize, centre
crop, rotation, Gaussian blur) act on one image [H, W, C] or label map
[H, W] with cv2's semantics; no recipe of the package calls them, they are
there for pipelines that compose their own. The random ones take their
draw from a `torch.Generator`.
"""

import math
from typing import Optional, Tuple

import numpy as np
import torch

from dformer_torch.parallel import dist


def normalize_batch(rgb: torch.Tensor, modal_x: torch.Tensor,
                    rgb_mean: torch.Tensor, rgb_std: torch.Tensor,
                    x_mean: torch.Tensor, x_std: torch.Tensor):
    """uint8 (or float) NHWC in [0, 255] -> fp32 `(v / 255 - mean) / std`
    for both modalities, on the inputs' device."""
    rgb = (rgb.float() / 255.0 - rgb_mean) / rgb_std
    modal_x = (modal_x.float() / 255.0 - x_mean) / x_std
    return rgb, modal_x


def _sample_coords(out_size: int, inv_ratio: torch.Tensor,
                   origin: torch.Tensor) -> torch.Tensor:
    """[B, out_size] source coordinates of each output index, given each
    sample's inverse scale ratio (in_size / floor(in_size * scale): cv2
    derives the ratio from the rounded target size) and crop origin in
    scaled-image space, both [B] fp32."""
    idx = torch.arange(out_size, dtype=torch.float32, device=origin.device)
    pos = idx + origin[:, None]
    return (pos + 0.5) * inv_ratio[:, None] - 0.5


def _take(img: torch.Tensor, index: torch.Tensor, dim: int) -> torch.Tensor:
    """img [B, H, W, C] indexed along dim 1 or 2 by a per-sample index
    [B, n]."""
    shape = list(img.shape)
    shape[dim] = index.shape[1]
    view = [index.shape[0], 1, 1, 1]
    view[dim] = index.shape[1]
    return torch.gather(img, dim, index.view(view).expand(shape))


def _bilinear_gather_1d(img: torch.Tensor, src: torch.Tensor, dim: int,
                        n_true: torch.Tensor,
                        index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Linear interpolation of img [B, H, W, C] along dim 1 or 2 at the
    fractional positions src [B, n], clamped to each sample's valid extent
    n_true [B] (cv2 replicates the edge). `index` [B, size of dim], when
    given, maps a position to the column it reads (the flip)."""
    n1 = (n_true - 1.0)[:, None]
    src = torch.minimum(torch.clamp(src, min=0.0), n1)
    lo = torch.floor(src)
    frac = src - lo
    last = n1.long()
    lo_i = torch.minimum(torch.clamp(lo.long(), min=0), last)
    hi_i = torch.minimum(torch.clamp(lo_i + 1, min=0), last)
    if index is not None:
        lo_i, hi_i = index.gather(1, lo_i), index.gather(1, hi_i)
    a, b = _take(img, lo_i, dim), _take(img, hi_i, dim)
    view = [src.shape[0], 1, 1, 1]
    view[dim] = src.shape[1]
    frac = frac.view(view)
    return a * (1.0 - frac) + b * frac


def _apply_pad_mask(out: torch.Tensor, pos_h: torch.Tensor,
                    pos_w: torch.Tensor, sh: torch.Tensor, sw: torch.Tensor,
                    pad_value) -> torch.Tensor:
    """The pad value where the crop position [B, n] leaves the scaled
    image's extent [0, sh) x [0, sw) (random_crop_pad_to_shape)."""
    valid_h = (pos_h >= 0) & (pos_h < sh[:, None])
    valid_w = (pos_w >= 0) & (pos_w < sw[:, None])
    mask = (valid_h[:, :, None] & valid_w[:, None, :])[..., None]
    return torch.where(mask, out, pad_value)


def valid_flip_index(width: int, flips: torch.Tensor,
                     true_w: torch.Tensor) -> torch.Tensor:
    """[B, width] column each column reads: a mirror inside each sample's
    valid extent, x -> true_w - 1 - x for x < true_w, where its flip is
    set; the identity elsewhere."""
    iw = torch.arange(width, device=flips.device)
    tw = true_w.long()[:, None]
    mirrored = torch.where(iw < tw, torch.clamp(tw - 1 - iw, 0, width - 1),
                           iw)
    return torch.where(flips[:, None], mirrored, iw)


def scale_crop_sample(img: torch.Tensor, scale: torch.Tensor,
                      origin_hw: Tuple[torch.Tensor, torch.Tensor],
                      out_hw: Tuple[int, int], pad_value,
                      true_hw: Tuple[torch.Tensor, torch.Tensor],
                      nearest: bool = False,
                      flip_index: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Scale + crop + pad of every sample of img [B, H, W, C] (or
    [B, H, W]) to out_hw, each at its own scale [B] and crop origin (two
    [B] tensors, in scaled-image space), within its valid extent true_hw
    (two [B] fp32 tensors; a canvas batch holds smaller images in its top
    left corner). Bilinear in fp32, or cv2's nearest rule on the input
    dtype; `flip_index` from `valid_flip_index` mirrors the source first."""
    squeeze = img.dim() == 3
    if squeeze:
        img = img[..., None]
    h_in, w_in = true_hw
    oh, ow = origin_hw
    # cv2 resizes to the floored target size and samples at the ratio of
    # the two sizes, not at the nominal scale
    sh = torch.floor(h_in * scale)
    sw = torch.floor(w_in * scale)
    dev = img.device
    pos_h = torch.arange(out_hw[0], dtype=torch.float32, device=dev) \
        + oh[:, None]
    pos_w = torch.arange(out_hw[1], dtype=torch.float32, device=dev) \
        + ow[:, None]
    if nearest:
        # cv2 INTER_NEAREST: sx = floor(dx * ifx), ifx = 1 / (out / in),
        # both divisions rounded in fp32 (the JAX package's formula; cv2's
        # float64 picks the same rows at the train scales on NYUDepthv2's
        # 480 x 640, tests/test_torch_augment.py)
        def nn_index(pos, n_in, n_scaled):
            ifx = 1.0 / (n_scaled / n_in)
            sx = torch.floor(pos * ifx[:, None]).long()
            return torch.minimum(torch.clamp(sx, min=0),
                                 (n_in - 1.0).long()[:, None])

        ih = nn_index(pos_h, h_in, sh)
        iw = nn_index(pos_w, w_in, sw)
        if flip_index is not None:
            iw = flip_index.gather(1, iw)
        out = _take(_take(img, ih, 1), iw, 2)
    else:
        imgf = img.float()
        src_h = _sample_coords(out_hw[0], h_in / torch.clamp(sh, min=1.0), oh)
        src_w = _sample_coords(out_hw[1], w_in / torch.clamp(sw, min=1.0), ow)
        out = _bilinear_gather_1d(imgf, src_h, 1, h_in)
        out = _bilinear_gather_1d(out, src_w, 2, w_in, flip_index)
    out = _apply_pad_mask(out, pos_h, pos_w, sh, sw, pad_value)
    return out[..., 0] if squeeze else out


def train_augment_draws(batch: int, n_scales: int,
                        generator: torch.Generator
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(flips [B] bool with p 0.5, scale_idx [B] int64 in [0, n_scales),
    u [B, 2] fp32 in [0, 1) for the crop origin), on the generator's
    device. Under a process group each is drawn for the global batch, of
    which the rank keeps its `batch` rows."""
    flips = dist.rand_rows((batch,), generator) < 0.5
    scale_idx = dist.randint_rows(n_scales, (batch,), generator)
    u = dist.rand_rows((batch, 2), generator)
    return flips, scale_idx, u


def _crop_origin(scaled: torch.Tensor, crop: int,
                 u: torch.Tensor) -> torch.Tensor:
    """generate_random_crop_pos: random.randint(0, excess + 1) is inclusive
    at both ends; a scaled image smaller than the crop is centre-padded
    (origin -ceil(pad / 2), negative)."""
    excess = scaled - crop
    rand_o = torch.minimum(torch.floor(u * (excess + 2.0)), excess + 1.0)
    pad_o = torch.ceil(excess / 2.0)
    return torch.where(excess > 0, rand_o, pad_o)


def apply_train_augment(rgb: torch.Tensor, gt: torch.Tensor,
                        modal_x: torch.Tensor, flips: torch.Tensor,
                        scale_idx: torch.Tensor, u: torch.Tensor,
                        out_hw: Tuple[int, int], scales,
                        rgb_mean: torch.Tensor, rgb_std: torch.Tensor,
                        x_mean: torch.Tensor, x_std: torch.Tensor,
                        true_hw: Optional[torch.Tensor] = None):
    """The augmentation for given draws (`train_augment_draws`), on the
    inputs' device: rgb [B,H,W,3] and modal_x [B,H,W,Cx] uint8 (or float in
    [0, 255]), gt [B,H,W] integer -> normalised fp32 rgb and modal_x and
    labels in gt's dtype, all at out_hw. `scales` is the scale list (a
    sequence, or an fp32 tensor on the device, which saves a copy per
    call). true_hw [B, 2] (each sample's valid extent in a canvas batch)
    sets the flip, the scale ratios, the crop range and the pad masks.

    With every tensor argument already on the card (as the Trainer passes
    them), nothing here waits for it: the whole is queued on the current
    stream."""
    B, H, W = rgb.shape[:3]
    dev = rgb.device
    scale = torch.as_tensor(scales, dtype=torch.float32,
                            device=dev)[scale_idx.to(dev)]
    if true_hw is None:
        th = torch.full((B,), float(H), device=dev)
        tw = torch.full((B,), float(W), device=dev)
    else:
        true_hw = torch.as_tensor(true_hw).to(dev)
        th, tw = true_hw[:, 0].float(), true_hw[:, 1].float()
    u = u.to(dev)
    oh = _crop_origin(torch.floor(th * scale), out_hw[0], u[:, 0])
    ow = _crop_origin(torch.floor(tw * scale), out_hw[1], u[:, 1])
    # normalise before the resample, so the constant pad is 0 in normalised
    # space as in TrainPre; bilinear resampling commutes with the affine
    # normalisation
    rgb_n, x_n = normalize_batch(rgb, modal_x, rgb_mean, rgb_std, x_mean,
                                 x_std)
    flip_index = valid_flip_index(W, flips.to(dev), tw)
    common = dict(scale=scale, origin_hw=(oh, ow), out_hw=out_hw,
                  true_hw=(th, tw), flip_index=flip_index)
    return (scale_crop_sample(rgb_n, pad_value=0.0, **common),
            scale_crop_sample(gt, pad_value=255, nearest=True, **common),
            scale_crop_sample(x_n, pad_value=0.0, **common))


def device_train_augment(rgb, gt, modal_x, generator: torch.Generator,
                         out_hw: Tuple[int, int], scales,
                         rgb_mean, rgb_std, x_mean, x_std, true_hw=None):
    """The batched train augmentation with its draws from `generator`
    (TrainPre: mirror p 0.5 -> random scale -> normalise -> random crop +
    pad). See `apply_train_augment` for the arguments."""
    draws = train_augment_draws(rgb.shape[0], len(scales), generator)
    return apply_train_augment(rgb, gt, modal_x, *draws, out_hw, scales,
                               rgb_mean, rgb_std, x_mean, x_std, true_hw)


# --- standalone primitives ---------------------------------------------------

def pad_to_shape(img: torch.Tensor, shape: Tuple[int, int], pad_value):
    """Centred constant pad of H and W to at least `shape`; returns (img,
    margin [top, bottom, left, right] as uint32)."""
    h, w = img.shape[:2]
    ph, pw = max(shape[0] - h, 0), max(shape[1] - w, 0)
    margin = (ph // 2, ph - ph // 2, pw // 2, pw - pw // 2)
    out = img.new_full((h + ph, w + pw) + tuple(img.shape[2:]), pad_value)
    out[margin[0]:margin[0] + h, margin[2]:margin[2] + w] = img
    return out, np.asarray(margin, np.uint32)


def pad_to_multiple(img: torch.Tensor, multiple: int, pad_value):
    """Centred pad so that H and W are multiples of `multiple`."""
    h, w = img.shape[:2]
    return pad_to_shape(img, (-(-h // multiple) * multiple,
                              -(-w // multiple) * multiple), pad_value)


def resize_shortest_edge(img: torch.Tensor, edge_length: int
                         ) -> torch.Tensor:
    """fp32 bilinear resize (cv2 INTER_LINEAR geometry) so that the shorter
    side is `edge_length`, the longer one scaled by the same ratio."""
    from dformer_torch.ops.resize import resize_bilinear

    h, w = img.shape[:2]
    if h < w:
        th, tw = edge_length, max(1, int(edge_length / h * w))
    else:
        th, tw = max(1, int(edge_length / w * h)), edge_length
    x = img[..., None] if img.ndim == 2 else img
    out = resize_bilinear(x.float()[None], (th, tw))[0]
    return out[..., 0] if img.ndim == 2 else out


def center_crop(img: torch.Tensor, shape: Tuple[int, int]) -> torch.Tensor:
    y = (img.shape[0] - shape[0]) // 2
    x = (img.shape[1] - shape[1]) // 2
    return img[y:y + shape[0], x:x + shape[1]]


def rotate(img: torch.Tensor, angle_deg, nearest: bool = False,
           pad_value: float = 0.0) -> torch.Tensor:
    """fp32 rotation about the image centre (w / 2, h / 2) by `angle_deg`
    (counter-clockwise on screen, a float or 0-d tensor), as cv2's
    `warpAffine` with `getRotationMatrix2D(centre, angle, 1)`: bilinear, or
    nearest (half away from zero) for labels; a source pixel outside the
    image reads `pad_value`."""
    x = (img[..., None] if img.ndim == 2 else img).float()
    h, w = x.shape[:2]
    th = -torch.as_tensor(angle_deg, dtype=torch.float32,
                          device=x.device) * (math.pi / 180.0)
    cos, sin = torch.cos(th), torch.sin(th)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=x.device),
                            torch.arange(w, dtype=torch.float32,
                                         device=x.device), indexing="ij")
    cx, cy = w / 2.0, h / 2.0
    sx = cos * (xx - cx) + sin * (yy - cy) + cx
    sy = -sin * (xx - cx) + cos * (yy - cy) + cy

    def taps(coord):  # [(index, weight)] of one axis
        if nearest:
            r = torch.sign(coord) * torch.floor(coord.abs() + 0.5)
            return [(r.long(), None)]
        lower = torch.floor(coord)
        upper_w = coord - lower
        return [(lower.long(), 1.0 - upper_w), (lower.long() + 1, upper_w)]

    out = None
    for iy, wy in taps(sy):
        for ix, wx in taps(sx):
            inside = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            v = x[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
            v = torch.where(inside[..., None], v, pad_value)
            if wy is not None:
                v = (wy * wx)[..., None] * v
            out = v if out is None else out + v
    return out[..., 0] if img.ndim == 2 else out


def random_rotation(generator: torch.Generator, img: torch.Tensor,
                    gt: torch.Tensor):
    """(img, gt) rotated by one angle ~ U(-10, 10) degrees: the image
    bilinear, the labels nearest."""
    angle = torch.rand((), generator=generator,
                       device=generator.device) * 20.0 - 10.0
    return rotate(img, angle), rotate(gt, angle, nearest=True)


# cv2's fixed taps of `getGaussianKernel(k, sigma <= 0)` for k <= 7
_CV2_GAUSS = {
    1: (1.0,),
    3: (0.25, 0.5, 0.25),
    5: (0.0625, 0.25, 0.375, 0.25, 0.0625),
    7: (0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125),
}


def gaussian_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """cv2.GaussianBlur(img, (k, k), 0) in fp32: its fixed taps, a
    reflect-101 border, one pass down H then one along W (`img` itself for
    k <= 1)."""
    if ksize <= 1:
        return img
    taps = _CV2_GAUSS[ksize]
    r = ksize // 2
    x = (img[..., None] if img.ndim == 2 else img).float()

    def pass_axis(a, axis):
        n = a.shape[axis]
        idx = torch.arange(-r, n + r, device=a.device).abs()
        idx = (n - 1) - (n - 1 - idx).abs()  # reflect-101 at both ends
        ap = a.index_select(axis, idx)
        out = None
        for i, t in enumerate(taps):
            term = t * ap.narrow(axis, i, n)
            out = term if out is None else out + term
        return out

    out = pass_axis(pass_axis(x, 0), 1)
    return out[..., 0] if img.ndim == 2 else out


def random_gaussian_blur(generator: torch.Generator, img: torch.Tensor
                         ) -> torch.Tensor:
    """`gaussian_blur` with k drawn from (1, 3, 5, 7); fp32."""
    k = (1, 3, 5, 7)[int(torch.randint(0, 4, (), generator=generator,
                                       device=generator.device))]
    return img.float() if k == 1 else gaussian_blur(img, k)
