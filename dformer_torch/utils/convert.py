"""Flax variable tree -> port state_dict.

The inverse of the JAX package's torch -> flax converter (its `_store`
rules in `dformer_tpu/utils/convert.py`): a Linear kernel [in, out] becomes
weight [out, in]; a conv HWIO kernel becomes OIHW; `batch_stats` mean/var
become running_mean/running_var; a packed MultiheadAttention in-projection
`in_proj_weight` [E, 3E] becomes [3E, E]; LayerNorm, BatchNorm affine,
LayerScale, learned queries and `in_proj_bias` are copied as they are.
Module paths map to the reference's key names, which the port's modules
use: in a DFormerTrav tree the flax `body` level under `encoder_backbone`
is dropped, so the body's keys sit beside `attn_expand_e`; the heads'
conv / BN pairs go to the slots of the reference's Sequentials (the
inverse of the JAX converter's `_head_key_to_path`).
"""

import re
from typing import Dict

import numpy as np
import torch

_STEM_SLOT = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
# DeepLabV3+'s conv + BN modules (conv kernel on the module, BN under
# "bn") -> the reference Sequential holding them and the conv's slot
_DEEPLAB = {"aspp_b0": (["aspp", "b0"], 0),
            "aspp_b1": (["aspp", "b1", "block"], 0),
            "aspp_b2": (["aspp", "b2", "block"], 0),
            "aspp_b3": (["aspp", "b3", "block"], 0),
            "aspp_pool": (["aspp", "b4", "gap"], 1),
            "aspp_project": (["aspp", "project"], 0),
            "low_level": (["low_level"], 0), "block_conv": (["block"], 0)}
_UPER = {"ppm": ("psp_modules", 1), "lateral": ("lateral_convs", 0),
         "fpn": ("fpn_convs", 0)}


def _head_key(path):
    """Flax path inside a decode or aux head -> the reference's names."""
    head, rest = path[0], path[1:]
    if m := re.fullmatch(r"(ppm|lateral|fpn)_(\d+)", head):
        name, slot = _UPER[m.group(1)]
        return [name, m.group(2), str(slot + (rest[0] == "bn"))] + rest[1:]
    if head in ("conv", "linear_fuse", "bottleneck", "fpn_bottleneck"):
        return [head, "1" if rest[0] == "bn" else "0"] + rest[1:]
    if re.fullmatch(r"linear_c\d", head):
        return [head, "proj"]
    if head in _DEEPLAB:
        prefix, slot = _DEEPLAB[head]
        return prefix + [str(slot + (rest[:1] == ["bn"]))]
    if head == "block_pred":
        return ["block", "4"]
    if head == "nl_block" and rest[0] in ("g", "theta", "phi"):
        return [head, rest[0], "conv"]
    return path


def _module_key(path):
    """Flax module path (tuple of names, leaf excluded) -> torch prefix."""
    path = list(path)
    if path[:2] == ["encoder_backbone", "body"]:
        del path[1]
    if path[:1] == ["encoder_backbone"]:
        head, rest = path[1], path[2:]
        if head in ("stem", "stem_e"):
            name = "downsample_layers_e" if head == "stem_e" else \
                "downsample_layers"
            path[1:] = [name, "0", _STEM_SLOT[rest[0]]] + rest[1:]
        elif m := re.fullmatch(r"downsample(_e)?_(\d+)", head):
            name = "downsample_layers_e" if m.group(1) else "downsample_layers"
            slot = "0" if rest[0] == "norm" else "1"
            path[1:] = [name, m.group(2), slot] + rest[1:]
        elif m := re.fullmatch(r"stage_(\d+)_block_(\d+)", head):
            path[1:] = ["stages", m.group(1), m.group(2)] + rest
    elif path[:1] in (["decode_head"], ["aux_head"]) and len(path) > 1:
        path[1:] = _head_key(path[1:])
    return ".".join(path)


def _leaf(name: str, arr: np.ndarray):
    """(torch leaf name, array in torch layout) for one flax leaf."""
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        return "weight", arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if name == "in_proj_weight":
        return name, arr.T
    if name == "mean":
        return "running_mean", arr
    if name == "var":
        return "running_var", arr
    return name, arr


def _walk(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def from_jax_variables(variables) -> Dict[str, torch.Tensor]:
    """{"params": ..., "batch_stats": ...} flax tree (numpy leaves) of an
    EncoderDecoder (DFormerTrav included) or of one of its modules -> the
    port's `state_dict` (fp32 tensors)."""
    sd = {}
    for collection in ("params", "batch_stats"):
        for path, value in _walk(variables.get(collection, {})):
            arr = np.asarray(value, dtype=np.float32)
            if path[-1].startswith("layer_scale"):
                key, tensor = _module_key(path), arr
            else:
                leaf, tensor = _leaf(path[-1], arr)
                key = ".".join(filter(None, (_module_key(path[:-1]), leaf)))
            sd[key] = torch.from_numpy(np.ascontiguousarray(tensor))
    return sd
