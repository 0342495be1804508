"""Checkpoints into the port's model: torch files (`.pth`, `.pt`,
`.pth.tar`) and the JAX trainer's orbax directories (`utils/orbax.py`).

The port's modules keep the reference model's state_dict key names, so a
reference checkpoint loads by name. `load_pretrained_encoder` fills the
encoder from a pretrained backbone file and names what it filled, for the
frozen set of training.
"""

import os.path as osp
from typing import Dict, List

import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file, on the CPU: the file's
    "state_dict_ema", "model" or "state_dict" entry, in that order of
    preference, else the file's top-level dict. BatchNorm
    `num_batches_tracked` counters are dropped: the port's BatchNorm keeps a
    fixed momentum and has no such buffer.

    The file is unpickled in full (`weights_only=False`, as released
    checkpoints hold more than tensors): load only files you trust. A
    directory is read as an orbax checkpoint of the JAX trainer: its
    params and batch_stats."""
    if osp.isdir(path):
        from dformer_torch.utils.orbax import model_state, read_tree

        return model_state(read_tree(path))
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict_ema", "model", "state_dict"):
        if key in ckpt:
            ckpt = ckpt[key]
            break
    return {k: v.detach().cpu() for k, v in ckpt.items()
            if not k.endswith("num_batches_tracked")}


def load_checkpoint(model: torch.nn.Module, path: str) -> torch.nn.Module:
    """Load a torch checkpoint into `model` strictly: a key the model lacks,
    or a model key the file lacks, raises and names them all."""
    model.load_state_dict(load_torch_checkpoint(path), strict=True)
    return model


def strip_prefixes(state_dict: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """Drop a leading "backbone." and then a leading "module." from every
    key (the reference's pretrained load, DFormer.py:261-269)."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("backbone."):
            k = k[len("backbone."):]
        if k.startswith("module."):
            k = k[len("module."):]
        out[k] = v
    return out


def load_pretrained_encoder(model: torch.nn.Module, path: str) -> List[str]:
    """Load a pretrained backbone file into `model.encoder_backbone` by key
    name, leaving out the keys the encoder lacks (a classifier head, say),
    and return the names of the parameters it filled, relative to `model`
    ("encoder_backbone. ..."), which `train.optim.trainable_mask_from_matched`
    freezes. A key whose shape differs from the encoder's raises."""
    enc = model.encoder_backbone
    own = enc.state_dict()
    load = {}
    for k, v in strip_prefixes(load_torch_checkpoint(path)).items():
        if k not in own:
            continue
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{path}: {k} has shape {tuple(v.shape)}, the "
                             f"encoder {tuple(own[k].shape)}")
        load[k] = v
    enc.load_state_dict(load, strict=False)
    params = {n for n, _ in enc.named_parameters()}
    return sorted(f"encoder_backbone.{k}" for k in load if k in params)
