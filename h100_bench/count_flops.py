"""Count the operations per image of each cell, once per cell shape, and
freeze them in `flops/<workload>.json`.

    python3 -m h100_bench.count_flops [--check]

`torch.utils.flop_counter.FlopCounterMode` over the benchmark's plain
reference on the meta device (no memory, no arithmetic): 2 per
multiply-add of the matrix products, convolutions and batched products
(a convolution's gradients by `conv_backward`); elementwise work is not
counted. A served image is one forward, a trained one its forward and
backward (the NMF iterations take no gradient, as the recipe's one-step
gradient), an evaluated one every scale's forward, twice with flip; each
counted over the cell's batch or group and divided by its rows. With --check, recount and exit 1 if a
frozen count differs.
"""

import argparse
import json
import math
import sys

import torch
from torch.utils.flop_counter import FlopCounterMode

from h100_bench import roofline, spec
from h100_bench.reference.model import forward, parameter_shapes


def conv_backward(grad_out_shape, x_shape, w_shape, _bias, _stride,
                  _padding, _dilation, transposed, _output_padding, _groups,
                  output_mask, out_shape=None, **kwargs) -> int:
    """A convolution's input and weight gradients, each the forward's
    count (the counter's own formula takes a grouped convolution's weight
    gradient for a dense one)."""
    if transposed:
        raise NotImplementedError("transposed convolution")
    forward_count = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward_count * (int(output_mask[0]) + int(output_mask[1]))


def counter() -> FlopCounterMode:
    return FlopCounterMode(
        display=False,
        custom_mapping={torch.ops.aten.convolution_backward: conv_backward})


def _weights(cfg, grad=False):
    return {n: torch.zeros(s, device="meta", requires_grad=grad
                           and not n.endswith(("running_mean",
                                               "running_var")))
            for n, s in parameter_shapes(cfg).items()}


def _inputs(cfg, rows, h, w):
    rgb = torch.zeros((rows, h, w, 3), device="meta")
    if "lidar" in cfg:
        return rgb, torch.zeros((rows, cfg["lidar"]["beams"]), device="meta")
    return rgb, torch.zeros((rows, h, w, cfg["modal_channels"]),
                            device="meta")


def count(cfg: dict, traffic: dict) -> float:
    """Operations per image of the cell."""
    H, W = cfg["image_height"], cfg["image_width"]
    flops = counter()
    kind = traffic["kind"]
    if kind == "train_steps":
        Wt = _weights(cfg, grad=True)
        with flops:
            out = forward(Wt, cfg, *_inputs(cfg, traffic["batch"], H, W),
                          train=True)
            out.float().sum().backward()
        return float(flops.get_total_flops()) / traffic["batch"]
    Wt = _weights(cfg)
    if kind == "eval_msf":
        rows, sizes = traffic["group"], roofline.msf_sizes(H, W,
                                                            traffic["scales"])
        passes = 2 if traffic["flip"] else 1
    else:
        rows, sizes, passes = traffic["batch"], [(H, W)], 1
    with flops, torch.no_grad():
        for h, w in sizes:
            forward(Wt, cfg, *_inputs(cfg, rows, h, w))
    return float(flops.get_total_flops()) * passes / rows


def describe(traffic: dict) -> str:
    kind = traffic["kind"]
    if kind == "train_steps":
        return (f"one image of an optimizer step of {traffic['batch']}: "
                "forward and backward")
    if kind == "eval_msf":
        return (f"one image of a group of {traffic['group']} at "
                f"{len(traffic['scales'])} scales"
                + (" and their mirrors" if traffic["flip"] else ""))
    return f"one image of a request of {traffic['batch']}: one forward"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    status = 0
    for wl in bench["workloads"]:
        cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
        record = {"per_image": count(cfg, tr), "image": describe(tr),
                  "counted_by": "FlopCounterMode over the reference"}
        path = spec.HERE / "flops" / f"{wl['name']}.json"
        if args.check:
            frozen = json.loads(path.read_text())
            if frozen["per_image"] != record["per_image"]:
                print(f"{wl['name']}: frozen {frozen['per_image']} != "
                      f"counted {record['per_image']}", file=sys.stderr)
                status = 1
            continue
        path.write_text(json.dumps(record, indent=1) + "\n")
        print(wl["name"], record)
    return status


if __name__ == "__main__":
    sys.exit(main())
