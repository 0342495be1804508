"""Ahead-of-time serving artifact (counterpart of
`dformer_tpu/runtime/export.py`): the eval forward captured by
`torch.export` as one program, weights included, saved as one `.pt2` file.

A serving process loads it with `load_exported` and calls
`.module()(rgb, modal_x)` with no model code and no tracing. The batch is
symbolic by default, so one artifact serves every batch of 1 to
`SEEDED_ROWS` (the JAX artifact's batch is unbounded; here the ham head's
deterministic NMF bases are a constant of that many rows, sliced to the
batch). The fused MLP blocks are calls of the custom op
`dformer_torch::fused_mlp` in the graph: on the card they launch the CUDA
kernel, on the CPU they run the plain version.
"""

import torch

from dformer_torch.models.decoders.ham import SEEDED_ROWS


def export_forward(model, hw, batch=None) -> torch.export.ExportedProgram:
    """The eval forward `(rgb, modal_x) -> logits [B, H, W, num_classes]` of
    `model` (eval mode, the seeded NMF bases) for fp32 NHWC inputs of
    `hw` = (H, W) on the model's device, as a `torch.export` program.

    batch: a fixed int, or None for a symbolic batch "b" in
    [1, SEEDED_ROWS]. The forward runs once eagerly first: it draws the
    seeded bases into their cache, which the traced forward reads."""
    model.eval()
    device = next(model.parameters()).device
    # two tensors: export would read one passed twice as one input
    shape = (2 if batch is None else int(batch), *hw, 3)
    example = (torch.zeros(shape, device=device),
               torch.zeros(shape, device=device))
    with torch.inference_mode():
        model(*example)
    dynamic = None
    if batch is None:
        b = torch.export.Dim("b", min=1, max=SEEDED_ROWS)
        dynamic = {"rgb": {0: b}, "modal_x": {0: b}}
    return torch.export.export(model, example, dynamic_shapes=dynamic)


def save_exported(exported, path: str) -> str:
    torch.export.save(exported, path)
    return path


def load_exported(path: str) -> torch.export.ExportedProgram:
    """The program of `save_exported`; run it through `.module()`. The
    kernel module is imported first: it registers the custom ops the
    program calls."""
    import dformer_torch.kernels.fused_mlp  # noqa: F401

    return torch.export.load(path)
