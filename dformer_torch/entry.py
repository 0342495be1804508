"""Entry points of the port: build a model from explicit arguments, serve
segmentation requests, take training steps (counterpart of
`__graft_entry__._build` and of the forward and the train step that
`bench.py` times), evaluate a loaded config (counterpart of what
`tools/eval.py` assembles), set up the training of a loaded config (what
`tools/train.py` assembles), and serve and fine-tune the Trav config
(`build_trav`, `build_fss_training`, `fss_steps`: what `tools/train_trav.py`
and `tools/train_trav_fss.py` assemble).

The card is the default device. `build`, `build_trainer`,
`build_evaluator`, `build_training`, `build_trav` and `build_fss_training`
raise if CUDA is unavailable unless the caller passes device="cpu".
"""

import os
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from dformer_torch.config import AttrDict
from dformer_torch.data.loader import device_val_batches
from dformer_torch.eval.evaluate import Evaluator
from dformer_torch.kernels.fused_mlp import fused_mlp
from dformer_torch.models.builder import EncoderDecoder, build_model
from dformer_torch.runtime.export import load_exported
from dformer_torch.train.fss import fss_train_step, fss_trainable_mask
from dformer_torch.train.loop import train_step
from dformer_torch.train.optim import (make_optimizer, make_schedule,
                                       trainable_mask_from_matched)
from dformer_torch.utils.checkpoint import (load_checkpoint,
                                            load_pretrained_encoder)

# The NYUDepthv2 DFormer-Large training recipe (the port's own copy of the
# values in `local_configs.NYUDepthv2.DFormer_Large` and its bases):
# 795 training images at batch 8 -> 100 iterations per epoch. The recipe's
# ignored label (background 255) is `train_steps`' default `ignore_index`.
TRAIN_RECIPE = dict(
    optimizer="AdamW", lr=6e-5, weight_decay=0.01, lr_power=0.9,
    drop_path_rate=0.15, aux_rate=0.0, bn_eps=1e-3, bn_momentum=0.1,
    warm_up_epoch=10, niters_per_epoch=100, nepochs=500)


def _use_device(who: str, device):
    """Raise when `device` is the card and there is none; on the card, turn
    TF32 off so that fp32 products (the NMF, fp32 runs) stay fp32."""
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def build(backbone: str = "DFormer-Large", hw: Tuple[int, int] = (480, 640),
          num_classes: int = 40, dtype: Optional[torch.dtype] = torch.bfloat16,
          device="cuda", seed: int = 0, drop_path_rate: float = 0.1,
          bn_eps: float = 1e-3, bn_momentum: float = 0.1,
          decoder: str = "ham", aux_rate: float = 0.0) -> EncoderDecoder:
    """DFormer + the `decoder` head (`models.builder.EncoderDecoder`: ham,
    MLPDecoder, UPernet, deeplabv3+, nl, else the FCN fallback; the FCN aux
    head as `aux_rate` and the decoder ask) in eval mode, with weights
    drawn from `seed`.

    Parameters are fp32 on `device`; activations run in `dtype`. The
    weights come from the layers' default init on the CPU under
    `torch.manual_seed(seed)`, so every device gets the same weights, except
    that LayerScales are set to 1 (not the 1e-6 of a fresh training init,
    which would hide every attention and MLP branch from the output) and
    BatchNorm running statistics are drawn positive around 0/1.

    On the card this sets `torch.backends.cuda.matmul.allow_tf32` and
    `torch.backends.cudnn.allow_tf32` to False: fp32 products (the NMF, fp32
    runs) stay fp32. `hw` is the input size the model serves; the model
    itself takes any size."""
    _use_device("entry.build", device)
    cfg = AttrDict(backbone=backbone, decoder=decoder,
                   num_classes=num_classes, decoder_embed_dim=512,
                   drop_path_rate=drop_path_rate, aux_rate=aux_rate,
                   bn_eps=bn_eps, bn_momentum=bn_momentum,
                   image_height=hw[0], image_width=hw[1])
    return _serving_model(cfg, dtype, device, seed)


def _serving_model(cfg: AttrDict, dtype, device, seed: int) -> EncoderDecoder:
    """`build`'s weights for a config, in eval mode on `device`."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = build_model(cfg, device="cpu", dtype=dtype)
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for name, p in model.named_parameters():
                if "layer_scale" in name:
                    p.fill_(1.0)
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(torch.randn(buf.shape, generator=gen) * 0.1)
                elif name.endswith("running_var"):
                    buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    return model.to(device).eval()


@torch.inference_mode()
def infer(model: EncoderDecoder, rgb: torch.Tensor, modal_x: torch.Tensor
          ) -> torch.Tensor:
    """One request: rgb [B,H,W,3] and modal_x [B,H,W,C] (NHWC, fp32; for a
    Trav model a [B,360] lidar scan) on the model's device -> int32 labels
    [B,H,W], the argmax of the logits."""
    logits = model(rgb, modal_x)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_trainer(backbone: str = "DFormer-Large",
                  hw: Tuple[int, int] = (480, 640), num_classes: int = 40,
                  dtype: Optional[torch.dtype] = torch.bfloat16,
                  device="cuda", seed: int = 0, decoder: str = "ham",
                  **overrides
                  ) -> Tuple[EncoderDecoder, torch.optim.Optimizer,
                             Callable[[int], float], torch.Generator]:
    """(model in train mode, AdamW, schedule step -> lr, generator) for the
    `TRAIN_RECIPE`, any field of which `overrides` replace (`aux_rate`
    among them), with the `decoder` head.

    The weights are `build`'s draw from `seed` (LayerScales at 1: the 1e-6
    of a fresh init would scale every MLP gradient by 1e-6). The generator,
    seeded with `seed` on `device`, draws DropPath and dropout masks and the
    NMF bases of each step."""
    cfg = AttrDict(TRAIN_RECIPE, **overrides)
    model = build(backbone, hw, num_classes, dtype, device, seed,
                  drop_path_rate=cfg.drop_path_rate, bn_eps=cfg.bn_eps,
                  bn_momentum=cfg.bn_momentum, decoder=decoder,
                  aux_rate=cfg.aux_rate).train()
    generator = torch.Generator(device=device).manual_seed(seed)
    return model, make_optimizer(cfg, model), make_schedule(cfg), generator


def train_steps(model: EncoderDecoder, optimizer: torch.optim.Optimizer,
                schedule: Callable[[int], float], generator: torch.Generator,
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]],
                first_step: int = 0, ignore_index: int = 255) -> List[float]:
    """Take one optimizer step per batch (rgb [B,H,W,3] fp32, modal_x
    [B,H,W,C] fp32, labels [B,H,W] integer, on the model's device), steps
    `first_step`, `first_step` + 1, ...; returns the losses (the aux term
    at the model's `aux_rate` included). Leaves the model in train mode."""
    losses = [train_step(model, optimizer, schedule, first_step + i, rgb, gt,
                         modal_x, generator, ignore_index=ignore_index,
                         aux_rate=model.aux_rate)
              for i, (rgb, modal_x, gt) in enumerate(batches)]
    return [float(loss) for loss in losses]


def build_evaluator(cfg: AttrDict, dtype: Optional[torch.dtype] = None,
                    device="cuda", seed: int = 0, sliding: bool = False,
                    checkpoint: Optional[str] = None, val_batch_size: int = 4,
                    synthetic: bool = False, n: Optional[int] = None,
                    shard=(0, 1), exported: Optional[str] = None
                    ) -> Tuple[Evaluator, Iterator[dict]]:
    """(Evaluator, val batches on `device`) for a loaded config
    (`dformer_torch.configs.load_config`).

    The model is `build`'s for the config's backbone, decoder, aux_rate,
    classes, image size and BatchNorm eps, computing in `dtype` (None =
    fp32), with the weights
    of a torch `checkpoint` file when one is given and `build`'s draw from
    `seed` otherwise; or, with `exported`, the program of that
    `tools.export` file (`Evaluator.from_exported`). The batches are
    `data.loader.device_val_batches`: the config's val split (or `n`
    synthetic images) in batches of `val_batch_size`, normalised on the
    device, of which this process takes its `shard` (rank, world)."""
    batches = device_val_batches(cfg, val_batch_size, device, shard=shard,
                                 synthetic=synthetic, n=n)
    if exported is not None:
        return Evaluator.from_exported(load_exported(exported), cfg,
                                       device), batches
    model = build(cfg.backbone, (cfg.image_height, cfg.image_width),
                  cfg.num_classes, dtype, device, seed,
                  drop_path_rate=cfg.drop_path_rate, bn_eps=cfg.bn_eps,
                  bn_momentum=cfg.bn_momentum, decoder=cfg.decoder,
                  aux_rate=cfg.aux_rate)
    if checkpoint is not None:
        load_checkpoint(model, checkpoint)
    return Evaluator(model, cfg, sliding=sliding, device=device), batches


def build_training(cfg: AttrDict, dtype: Optional[torch.dtype] = torch.bfloat16,
                   device="cuda", seed: int = 0, logger=None
                   ) -> Tuple[EncoderDecoder, torch.optim.Optimizer,
                              Callable[[int], float],
                              Optional[Dict[str, bool]]]:
    """(model in train mode, optimizer, schedule step -> lr, trainable mask
    or None) for a loaded config (`dformer_torch.configs.load_config`), as
    `tools/train.py` assembles them.

    The model is the config's backbone + decoder (and aux head) with fp32
    parameters on `device` computing in `dtype` (None = fp32), drawn by the
    layers' own training init under `torch.manual_seed(seed)` (LayerScales
    1e-6). When
    `cfg.pretrained_model` names a file that exists, the encoder is loaded
    from it and every loaded parameter is frozen (left out of the
    optimizer); otherwise the whole model trains from scratch. The
    optimizer is `cfg.optimizer` (AdamW or SGDM), the schedule the warm-up
    poly rate of `cfg`."""
    _use_device("entry.build_training", device)
    model = _init_model(cfg, dtype, seed)
    matched = []
    pretrained = cfg.get("pretrained_model")
    if pretrained and os.path.exists(pretrained):
        matched = load_pretrained_encoder(model, pretrained)
        if logger:
            logger.info(f"loaded pretrained encoder {pretrained}: "
                        f"{len(matched)} parameters, frozen")
    elif pretrained and logger:
        logger.info(f"pretrained model {pretrained} not found; training "
                    "from scratch")
    model = model.to(device).train()
    mask = trainable_mask_from_matched(model, matched) if matched else None
    return model, make_optimizer(cfg, model, mask), make_schedule(cfg), mask


def _init_model(cfg: AttrDict, dtype: Optional[torch.dtype] = torch.bfloat16,
               seed: int = 0) -> EncoderDecoder:
    """The config's model on the CPU with the layers' own training init
    (LayerScales 1e-6) drawn under `torch.manual_seed(seed)`, fp32
    parameters computing in `dtype`: what training from scratch starts
    from."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_model(cfg, device="cpu", dtype=dtype)


def build_trav(cfg: AttrDict, dtype: Optional[torch.dtype] = torch.bfloat16,
               device="cuda", seed: int = 0) -> EncoderDecoder:
    """DFormerTrav-Base + the config's decoder of a Trav config
    (`local_configs.Trav.DFormer_Base`) in eval mode, with `build`'s
    weights from `seed` (LayerScales 1, BatchNorm statistics drawn). The
    lidar expansion follows the config's image size. Serve it with
    `infer(model, rgb [B,H,W,3], lidar [B,360])`."""
    _use_device("entry.build_trav", device)
    if cfg.backbone != "DFormerTrav-Base":
        raise ValueError(f"build_trav: backbone {cfg.backbone!r} is not "
                         "DFormerTrav-Base")
    return _serving_model(cfg, dtype, device, seed)


def build_fss_training(cfg: AttrDict,
                       dtype: Optional[torch.dtype] = torch.bfloat16,
                       device="cuda", seed: int = 0, logger=None
                       ) -> Tuple[EncoderDecoder, torch.optim.Optimizer,
                                  Callable[[int], float], Dict[str, bool]]:
    """(model in train mode, optimizer, schedule step -> lr, trainable
    mask) of the few-shot recipe for a Trav config, as
    `tools/train_trav_fss.py` assembles them.

    The model is drawn as `build_training`'s; when `cfg.pretrained_model`
    names a file that exists, the encoder (lidar expansion and body) is
    loaded from it, but nothing is frozen by the loaded names:
    `fss_trainable_mask` decides (the expansion, stage 0 and the decoder
    train). The optimizer holds the trainable parameters only."""
    _use_device("entry.build_fss_training", device)
    model = _init_model(cfg, dtype, seed)
    pretrained = cfg.get("pretrained_model")
    if pretrained and os.path.exists(pretrained):
        matched = load_pretrained_encoder(model, pretrained)
        if logger:
            logger.info(f"loaded pretrained Trav encoder {pretrained}: "
                        f"{len(matched)} parameters")
    elif pretrained and logger:
        logger.info(f"pretrained model {pretrained} not found; training "
                    "from scratch")
    model = model.to(device).train()
    mask = fss_trainable_mask(model)
    return model, make_optimizer(cfg, model, mask), make_schedule(cfg), mask


def fss_steps(model: EncoderDecoder, optimizer: torch.optim.Optimizer,
              schedule: Callable[[int], float], generator: torch.Generator,
              episodes: Sequence[Tuple[torch.Tensor, ...]],
              first_step: int = 0, ignore_index: int = 255) -> List[float]:
    """One FSS optimizer step per episode batch (s_rgb [B,S,H,W,3], s_lidar
    [B,S,360], s_labels [B,S,H,W], q_rgb [B,H,W,3], q_lidar [B,360],
    q_labels [B,H,W]; fp32 images and scans normalised, integer labels, on
    the model's device), steps `first_step`, `first_step` + 1, ...;
    returns the losses."""
    losses = [fss_train_step(model, optimizer, schedule, first_step + i,
                             s_rgb, s_gt, s_lidar, q_rgb, q_gt, q_lidar,
                             generator, background=ignore_index)
              for i, (s_rgb, s_lidar, s_gt, q_rgb, q_lidar, q_gt)
              in enumerate(episodes)]
    return [float(loss) for loss in losses]


def msf_group(backbone: str, num_classes: int, rgb: torch.Tensor,
              modal_x: torch.Tensor, gt: torch.Tensor,
              scales: Sequence[float], flip: bool = True, device="cuda",
              seed: int = 0) -> Tuple[np.ndarray, torch.Tensor, int]:
    """MSF (+ flip) evaluation of one group by `build`'s fp32 model from
    `seed` on `device`, to hold one device against another: (hist, the
    group's fp32 probability accumulator on the CPU, fused-MLP kernel
    launches of the hist's pass). rgb, modal_x [B,H,W,3] and gt [B,H,W] lie
    on the CPU; the model is built at H x W."""
    hw = tuple(gt.shape[1:])
    model = build(backbone, hw, num_classes, None, device, seed)
    ev = Evaluator(model, AttrDict(num_classes=num_classes, background=255),
                   device=device)
    n0 = fused_mlp.launches
    hist = ev.evaluate_msf([dict(rgb=rgb, modal_x=modal_x, gt=gt)], scales,
                           flip=flip).hist
    launches = fused_mlp.launches - n0
    acc = ev.msf_probs(rgb.to(device), modal_x.to(device), hw, scales,
                       flip).cpu()
    return hist, acc, launches
