"""Weights and seeds of a run, made by the benchmark and handed to the
program and to the reference alike.

`make_weights` draws every weight and BatchNorm statistic of a
configuration on the device from the run's seed: one normal draw for all
of them from a `torch.Generator` on that device, cut into the leaves and
scaled and shifted per leaf in two multi-tensor calls, in float32 (the
type the configurations keep their parameters in).

A configuration with `bn_pilot` then sets the running statistics of the
BatchNorms it names to the batch moments that the reference, on the CPU
in eval mode, finds there over `rows` images of the seed at 1/`shrink`
of the configuration's size (a lidar scan expanded at full size, then
shrunk): the statistics training would have left. Drawn statistics leave
a two-class head's input with a large common offset, so that on some
seeds it favours one class at every pixel and no rounding can move a
label.
"""

import math

import numpy as np
import torch

from h100_bench.reference.model import (Moments, Precision, forward,
                                        lidar_expand, parameter_shapes,
                                        resize)

# streams of `derive`
WEIGHTS, INPUTS, PROGRAM, SAMPLE, PILOT = 0, 1, 2, 3, 4


def derive(seed: int, stream: int) -> int:
    """A 63-bit seed for (run seed, stream); any whole run seed works."""
    state = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), stream])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, stream))


def init_rule(name: str, shape) -> tuple:
    """(mean, std) of a leaf: products' weights at 1 / sqrt(fan in), their
    biases at a tenth of that, norm scales and LayerScales around 1, norm
    shifts and running means around 0, running variances around 1."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "running_var":
        return 1.0, 0.1
    if leaf == "running_mean":
        return 0.0, 0.1
    if leaf.startswith("layer_scale"):
        return 1.0, 0.1
    if len(shape) >= 2:
        return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "weight":  # LayerNorm / BatchNorm scale
        return 1.0, 0.1
    return 0.0, 0.1


def make_weights(cfg: dict, seed: int, device) -> dict:
    """{published state-dict name: float32 tensor on `device`}."""
    shapes = parameter_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, WEIGHTS, device),
                       device=device)
    leaves = [part.view(shape) for part, shape
              in zip(flat.split(sizes), shapes.values())]
    rules = [init_rule(n, s) for n, s in shapes.items()]
    torch._foreach_mul_(leaves, [std for _, std in rules])
    torch._foreach_add_(leaves, [mean for mean, _ in rules])
    weights = dict(zip(shapes, leaves))
    if "bn_pilot" in cfg:
        bn_pilot(cfg, weights, seed)
    return weights


def bn_pilot(cfg: dict, weights: dict, seed: int) -> None:
    """Running statistics of the BatchNorms `cfg["bn_pilot"]` names from
    a seeded pilot forward of the reference on the CPU."""
    pilot = cfg["bn_pilot"]
    h = cfg["image_height"] // pilot["shrink"]
    w = cfg["image_width"] // pilot["shrink"]
    small = {k: v for k, v in cfg.items() if k != "lidar"}
    small.update(image_height=h, image_width=w)
    g = torch.Generator().manual_seed(derive(seed, PILOT))
    rows = pilot["rows"]
    rgb = torch.randn((rows, h, w, 3), generator=g)
    cpu = {n: t.cpu() for n, t in weights.items()}
    moments = Moments(pilot["layers"])
    with torch.no_grad():
        if "lidar" in cfg:  # the expansion at its own size, then shrunk
            scan = torch.randn((rows, cfg["lidar"]["beams"]), generator=g)
            modal = resize(lidar_expand(cpu, cfg, scan, Precision("fp32")),
                           (h, w))
        else:
            modal = torch.randn((rows, h, w, 1), generator=g)
        forward(cpu, small, rgb, modal, Precision("fp32"), train=moments)
    for p, (mean, var) in moments.items():
        weights[f"{p}.running_mean"].copy_(mean)
        weights[f"{p}.running_var"].copy_(var)
