"""Model assembly: backbone + decode head (counterpart of
`dformer_tpu/models/builder.py`, ham path).

`EncoderDecoder.forward` returns full-resolution NHWC logits, bilinearly
upsampled with align_corners=False. In train mode (`model.train()`) the
BatchNorms use batch statistics, DropPath and dropout draw from the
`generator` argument, and the NMF draws fresh bases from it.
"""

import contextlib
from typing import Optional

import torch
from torch import nn

from dformer_torch.models.decoders.ham import LightHamHead
from dformer_torch.models.encoder import VARIANTS, DFormer
from dformer_torch.ops.resize import resize_bilinear


class EncoderDecoder(nn.Module):
    def __init__(self, backbone: str = "DFormer-Large", decoder: str = "ham",
                 num_classes: int = 40, decoder_embed_dim: int = 512,
                 drop_path_rate: float = 0.1, aux_rate: float = 0.0,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if backbone not in VARIANTS:
            raise NotImplementedError(
                f"backbone {backbone!r} is not ported yet (ROADMAP.md "
                f"Queue 1, item 11: Trav and FSS)")
        if decoder != "ham":
            raise NotImplementedError(
                f"decoder {decoder!r} is not ported yet (ROADMAP.md "
                f"Queue 1, item 10: remaining decoders)")
        if aux_rate != 0:
            raise NotImplementedError(
                "the FCN aux head is not ported yet (ROADMAP.md Queue 1, "
                "item 10: remaining decoders)")
        spec = VARIANTS[backbone]
        self.dtype = dtype
        self.encoder_backbone = DFormer(drop_path_rate=drop_path_rate,
                                        dtype=dtype, **spec)
        self.decode_head = LightHamHead(
            in_channels=spec["dims"][1:], in_index=(1, 2, 3),
            channels=decoder_embed_dim, num_classes=num_classes,
            bn_eps=bn_eps, bn_momentum=bn_momentum, dtype=dtype)

    def encode(self, rgb, modal_x, generator=None):
        return self.encoder_backbone(rgb, modal_x, generator)

    def decode(self, features, out_hw, bases=None, generator=None):
        out = self.decode_head(features, bases, generator)
        return resize_bilinear(out, out_hw, align_corners=False)

    def forward(self, rgb, modal_x, bases: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """rgb [B,H,W,3]; modal_x [B,H,W,C] (first channel used). bases: NMF
        bases [B,512,64], None = the head's seeded bases. Returns
        [B,H,W,num_classes] logits in the compute dtype."""
        features = self.encode(rgb, modal_x, generator)
        return self.decode(features, rgb.shape[1:3], bases, generator)

    def forward_with_aux(self, rgb, modal_x,
                         bases: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """(logits, aux logits). The ham decoder with aux_rate 0 attaches no
        aux head (the constructor refuses the others), so aux is None."""
        return self.forward(rgb, modal_x, bases, generator), None


def build_model(cfg, device="cuda", dtype: Optional[torch.dtype] = None
                ) -> EncoderDecoder:
    """EncoderDecoder from a config with the `local_configs` field names,
    fp32 parameters on `device`, computing in `dtype` (None = fp32)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("build_model: CUDA is not available; pass "
                           "device='cpu' to run on the CPU")
    drop_path_rate = cfg.get("drop_path_rate", None)
    model = EncoderDecoder(
        backbone=cfg.backbone, decoder=cfg.decoder,
        num_classes=cfg.num_classes,
        decoder_embed_dim=cfg.get("decoder_embed_dim", 512),
        drop_path_rate=0.1 if drop_path_rate is None else drop_path_rate,
        aux_rate=cfg.get("aux_rate", 0.0), bn_eps=cfg.get("bn_eps", 1e-3),
        bn_momentum=cfg.get("bn_momentum", 0.1), dtype=dtype)
    return model.to(device)


@contextlib.contextmanager
def compute_dtype(model: nn.Module, dtype: Optional[torch.dtype]):
    """Run `model` in `dtype` (None = fp32 on fp32 inputs) inside the block,
    whatever dtype it was built with; the parameters stay as they are. The
    train tool evaluates a bf16-trained model in fp32 this way."""
    mods = [m for m in model.modules() if hasattr(m, "dtype")]
    before = [m.dtype for m in mods]
    for m in mods:
        m.dtype = dtype
    try:
        yield model
    finally:
        for m, d in zip(mods, before):
            m.dtype = d
