"""Model assembly: backbone + decode head (+ the FCN aux head), plus the
few-shot prototype forward (counterpart of `dformer_tpu/models/builder.py`).

`EncoderDecoder.forward` returns full-resolution NHWC logits, bilinearly
upsampled with align_corners=False; `forward_with_aux` also the aux head's
logits. In train mode (`model.train()`) the BatchNorms use batch
statistics, DropPath and dropout draw from the `generator` argument, and
the ham head's NMF draws fresh bases from it. `meta_forward` is the 1-way
few-shot episode forward of the Trav recipe.
"""

import contextlib
from typing import Optional, Tuple

import torch
from torch import nn

from dformer_torch.models.decoders.deeplabv3p import DeepLabV3Plus
from dformer_torch.models.decoders.fcn import FCNHead
from dformer_torch.models.decoders.ham import LightHamHead
from dformer_torch.models.decoders.mlp import MLPDecoderHead
from dformer_torch.models.decoders.nl import NLHead
from dformer_torch.models.decoders.upernet import UPerHead
from dformer_torch.models.encoder import VARIANTS, DFormer
from dformer_torch.models.trav import DFormerTrav
from dformer_torch.ops.resize import resize_bilinear
from dformer_torch.parallel import dist

TRAV_BACKBONE = "DFormerTrav-Base"
# the decoders that attach the FCN aux head whatever aux_rate is
ALWAYS_AUX = ("UPernet", "deeplabv3+", "nl")


class EncoderDecoder(nn.Module):
    """decoder: "ham" (LightHamHead), "MLPDecoder", "UPernet", "deeplabv3+",
    "nl", and for any other name the FCN-32s fallback (an `FCNHead` on the
    top stage). The FCN aux head reads stage 3 (index 2) when the decoder
    is ham and aux_rate is not 0, and always for UPernet, deeplabv3+ and
    nl. nmf_one_step_grad: the ham head's NMF gradient (`nmf2d`)."""

    def __init__(self, backbone: str = "DFormer-Large", decoder: str = "ham",
                 num_classes: int = 40, decoder_embed_dim: int = 512,
                 drop_path_rate: float = 0.1, aux_rate: float = 0.0,
                 bn_eps: float = 1e-3, bn_momentum: float = 0.1,
                 temperature: float = 1.0, alpha: float = 0.5,
                 image_hw: Tuple[int, int] = (480, 640),
                 nmf_one_step_grad: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if backbone not in VARIANTS and backbone != TRAV_BACKBONE:
            raise ValueError(f"unknown backbone {backbone!r}; known: "
                             f"{', '.join(sorted(VARIANTS))}, {TRAV_BACKBONE}")
        self.decoder, self.aux_rate = decoder, aux_rate
        self.dtype = dtype
        # the few-shot fusion: softmax temperature of the prototype
        # similarities, weight of the decoder logits against them
        self.temperature, self.alpha = temperature, alpha
        if backbone == TRAV_BACKBONE:
            spec = VARIANTS["DFormer-Base"]
            self.encoder_backbone = DFormerTrav(
                drop_path_rate=drop_path_rate, expand_hw=tuple(image_hw),
                dtype=dtype)
        else:
            spec = VARIANTS[backbone]
            self.encoder_backbone = DFormer(drop_path_rate=drop_path_rate,
                                            dtype=dtype, **spec)
        dims = spec["dims"]
        head = dict(num_classes=num_classes, bn_eps=bn_eps,
                    bn_momentum=bn_momentum, dtype=dtype)
        if decoder == "ham":
            self.decode_head = LightHamHead(
                in_channels=dims[1:], in_index=(1, 2, 3),
                channels=decoder_embed_dim,
                one_step_grad=nmf_one_step_grad, **head)
        elif decoder == "MLPDecoder":
            self.decode_head = MLPDecoderHead(
                dims, embed_dim=decoder_embed_dim, **head)
        elif decoder == "UPernet":
            self.decode_head = UPerHead(dims, channels=512, **head)
        elif decoder == "deeplabv3+":
            self.decode_head = DeepLabV3Plus(dims, **head)
        elif decoder == "nl":
            self.decode_head = NLHead(dims, channels=512, **head)
        else:
            self.decode_head = FCNHead(dims[-1], kernel_size=3, **head)
        if (decoder == "ham" and aux_rate != 0) or decoder in ALWAYS_AUX:
            self.aux_index = 2
            self.aux_head = FCNHead(dims[self.aux_index], **head)
        else:
            self.aux_head = None

    def encode(self, rgb, modal_x, generator=None):
        return self.encoder_backbone(rgb, modal_x, generator)

    def decode(self, features, out_hw, bases=None, generator=None):
        """The decode head's logits resized to `out_hw`. `bases` pins the
        ham head's NMF bases; the other heads take none."""
        if self.decoder == "ham":
            out = self.decode_head(features, bases, generator)
        else:
            out = self.decode_head(features, generator)
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
        """(logits, aux logits resized to the input, or None without an
        aux head)."""
        features = self.encode(rgb, modal_x, generator)
        out = self.decode(features, rgb.shape[1:3], bases, generator)
        if self.aux_head is None:
            return out, None
        aux = self.aux_head(features[self.aux_index])
        return out, resize_bilinear(aux, rgb.shape[1:3], align_corners=False)

    # ---- few-shot segmentation ----

    @staticmethod
    def _masked_proto(feat, mask):
        """feat [N,h,w,C]; mask [N,h,w] bool -> [N, C] masked means."""
        m = mask[..., None].to(feat.dtype)
        return (feat * m).sum((1, 2)) / (m.sum((1, 2)) + 1e-5)

    def meta_forward(self, s_rgb, s_depth, s_mask, q_rgb, q_depth,
                     bases: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None,
                     return_episode: bool = False):
        """1-way few-shot episode forward.

        s_rgb [B,S,H,W,3]; s_depth [B,S,...] lidar or depth; s_mask [B,S,H,W]
        labels; q_rgb [B,H,W,3]; q_depth [B,...]. The B*S support and B
        query images go through the encoder as one batch (in training its
        BatchNorm statistics are those of the whole batch). Background and
        foreground prototypes are the masked means of the top-stage support
        features where the support mask, bilinearly resized to that grid,
        is exactly 0 and exactly 1, averaged over the S shots. The query's
        cosine similarities to them (x20) go through a softmax at
        `temperature`, are resized to H x W and fused with the decoder's
        logits as alpha * logits + (1 - alpha) * sim. Returns the fused
        [B,H,W,2] logits; with `return_episode` also {"q_top", "fg", "bg"}
        (query top-stage features, prototypes [B,C]) for the contrastive
        term. bases: NMF bases [B,512,64] of the decoder, as in `forward`."""
        B, S = s_rgb.shape[:2]
        H, W = q_rgb.shape[1:3]
        all_rgb = torch.cat([s_rgb.reshape(B * S, *s_rgb.shape[2:]), q_rgb])
        all_depth = torch.cat([s_depth.reshape(B * S, *s_depth.shape[2:]),
                               q_depth])
        # under a process group a draw for the encoder's batch keeps this
        # rank's rows of the global support and the global query batch
        with dist.row_blocks(B * S, B):
            feats = self.encode(all_rgb, all_depth, generator)
        top_s, top_q = feats[-1][:B * S], feats[-1][B * S:]
        q_feats = [f[B * S:] for f in feats]

        m = resize_bilinear(
            s_mask.reshape(B * S, *s_mask.shape[2:])[..., None].float(),
            top_s.shape[1:3])[..., 0]
        fg = self._masked_proto(top_s, m == 1).reshape(B, S, -1).mean(1)
        bg = self._masked_proto(top_s, m == 0).reshape(B, S, -1).mean(1)

        def cos(feat, proto):  # feat [B,h,w,C], proto [B,C] -> [B,h,w]
            fn = feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
                         + 1e-8)
            pn = proto / (torch.linalg.vector_norm(proto, dim=-1,
                                                   keepdim=True) + 1e-8)
            return torch.einsum("bhwc,bc->bhw", fn, pn) * 20.0

        sim = torch.stack([cos(top_q, bg), cos(top_q, fg)], dim=-1)
        sim = torch.softmax(sim / self.temperature, dim=-1)
        sim = resize_bilinear(sim, (H, W), align_corners=False)

        logits = self.decode(q_feats, (H, W), bases, generator)
        fused = self.alpha * logits + (1.0 - self.alpha) * sim
        if return_episode:
            return fused, dict(q_top=top_q, fg=fg, bg=bg)
        return fused


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
        bn_momentum=cfg.get("bn_momentum", 0.1),
        temperature=cfg.get("temperature", 1.0), alpha=cfg.get("alpha", 0.5),
        image_hw=(cfg.get("image_height", 480), cfg.get("image_width", 640)),
        nmf_one_step_grad=cfg.get("nmf_one_step_grad", True), dtype=dtype)
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
