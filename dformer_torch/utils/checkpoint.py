"""Torch checkpoints (`.pth`, `.pt`, `.pth.tar`) into the port's model.

The port's modules keep the reference model's state_dict key names, so a
reference checkpoint loads by name. Orbax directories, which the JAX
trainer writes, are not read yet (ROADMAP.md Queue 1, item 12c).
"""

from typing import Dict

import torch


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a torch checkpoint file, on the CPU: the file's
    "state_dict_ema", "model" or "state_dict" entry, in that order of
    preference, else the file's top-level dict. BatchNorm
    `num_batches_tracked` counters are dropped: the port's BatchNorm keeps a
    fixed momentum and has no such buffer.

    The file is unpickled in full (`weights_only=False`, as released
    checkpoints hold more than tensors): load only files you trust."""
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
