"""Device-side preprocessing (counterpart of `dformer_tpu/data/augment.py`):
the val normalisation. The train augmentation, `device_train_augment`, is
not ported yet (ROADMAP.md Queue 1, item 9)."""

import torch


def normalize_batch(rgb: torch.Tensor, modal_x: torch.Tensor,
                    rgb_mean: torch.Tensor, rgb_std: torch.Tensor,
                    x_mean: torch.Tensor, x_std: torch.Tensor):
    """uint8 (or float) NHWC in [0, 255] -> fp32 `(v / 255 - mean) / std`
    for both modalities, on the inputs' device."""
    rgb = (rgb.float() / 255.0 - rgb_mean) / rgb_std
    modal_x = (modal_x.float() / 255.0 - x_mean) / x_std
    return rgb, modal_x
