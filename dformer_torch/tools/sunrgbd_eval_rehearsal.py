"""Variable-geometry MSF evaluation on SUNRGBD's sensor mix (counterpart of
`tools/sunrgbd_eval_rehearsal.py`):

    python -m dformer_torch.tools.sunrgbd_eval_rehearsal \\
        [--config=local_configs.SUNRGBD.DFormer_Small] [--images=200] \\
        [--batch=4] [--scales 0.5 0.75 1.0 1.25 1.5] [--no-flip] \\
        [--no-amp] [--device=cuda]

SUNRGBD's val images come from four sensors of different sizes. The
stream here draws each image's size from their populations (`SENSOR_MIX`,
the JAX tool's) with seed-made pixels and labels, padded to each loader
batch's canvas with the sample sizes in "hw", as `Loader` collates them.
The `Evaluator` crops every sample to its true size, regroups samples of
one size and pads a short group to a power of two (`_true_extent_batches`).

Printed as one JSON line: the sizes, the (size, group) shapes, the
forward's distinct input shapes (the port compiles no executables per
shape, where the JAX tool counts XLA's; this is the count a compiled or
captured forward would need), the padding's share of the forwarded
pixels, and the steady rate of a second pass over the stream (CUDA events
on the card, the host clock on the CPU), after a check that the hist
counts every true pixel once. The model is the config's, weights from seed
0, bf16 unless --no-amp.
"""

import argparse
import json
import time

import numpy as np

# (h, w) -> share of the val images: Kinect v2, Asus Xtion, Kinect v1,
# Intel RealSense (SUNRGBD's populations of 3,784 / 3,389 / 2,003 / 1,159)
SENSOR_MIX = {
    (530, 730): 0.366,
    (517, 658): 0.328,
    (480, 640): 0.194,
    (468, 628): 0.112,
}


def make_stream(n_images, batch, num_classes, seed=0):
    """Loader-shaped batches: rgb / modal_x (fp32 in [0, 1)) and gt padded
    to each batch's canvas (gt with 255), and each sample's "hw"."""
    rng = np.random.RandomState(seed)
    shapes = list(SENSOR_MIX)
    probs = np.asarray(list(SENSOR_MIX.values()))
    picks = rng.choice(len(shapes), size=n_images, p=probs / probs.sum())
    batches = []
    for s in range(0, n_images, batch):
        hws = [shapes[i] for i in picks[s:s + batch]]
        H = max(h for h, _ in hws)
        W = max(w for _, w in hws)
        n = len(hws)
        b = dict(rgb=np.zeros((n, H, W, 3), np.float32),
                 modal_x=np.zeros((n, H, W, 3), np.float32),
                 gt=np.full((n, H, W), 255, np.int32),
                 hw=np.asarray(hws, np.int32))
        for i, (h, w) in enumerate(hws):
            b["rgb"][i, :h, :w] = rng.rand(h, w, 3)
            b["modal_x"][i, :h, :w] = rng.rand(h, w, 3)
            b["gt"][i, :h, :w] = rng.randint(0, num_classes, (h, w))
        batches.append(b)
    return batches


def grouping(ev, batches):
    """({(h, w, group size): groups}, true pixels, forwarded pixels) of the
    Evaluator's regrouping of `batches`."""
    true_px = fwd_px = 0
    groups = {}
    for sub in ev._true_extent_batches(batches):
        nb, bs = sub["nb"], sub["gt"].shape[0]
        h, w = sub["gt"].shape[1:3]
        groups[(h, w, bs)] = groups.get((h, w, bs), 0) + 1
        true_px += nb * h * w
        fwd_px += bs * h * w
    return groups, true_px, fwd_px


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.SUNRGBD.DFormer_Small")
    ap.add_argument("--images", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--scales", type=float, nargs="+",
                    default=[0.5, 0.75, 1.0, 1.25, 1.5])
    ap.add_argument("--no-flip", action="store_true")
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(cfg, args) -> dict:
    """The rehearsal of `cfg` (a loaded config) with the parsed `args`;
    returns the printed record."""
    import torch

    from dformer_torch import entry
    from dformer_torch.eval.evaluate import Evaluator

    device = torch.device(args.device)
    model = entry.build(cfg.backbone, (cfg.image_height, cfg.image_width),
                        cfg.num_classes, torch.bfloat16 if args.amp else None,
                        device, 0, drop_path_rate=cfg.drop_path_rate,
                        bn_eps=cfg.bn_eps, bn_momentum=cfg.bn_momentum,
                        decoder=cfg.decoder, aux_rate=cfg.aux_rate)
    shapes = set()

    def forward(rgb, modal):
        shapes.add(tuple(rgb.shape))
        return model(rgb, modal)

    ev = Evaluator(model, cfg, forward=forward, device=device)
    batches = make_stream(args.images, args.batch, cfg.num_classes)
    groups, true_px, fwd_px = grouping(ev, batches)
    cuda = device.type == "cuda"

    def one_pass():
        t0 = time.perf_counter()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        m = ev.evaluate_msf(batches, scales=args.scales,
                            flip=not args.no_flip)
        if cuda:
            end.record()
            end.synchronize()
            seconds = start.elapsed_time(end) / 1e3
        else:
            seconds = time.perf_counter() - t0
        if int(m.hist.sum()) != true_px:
            raise RuntimeError(f"hist counts {int(m.hist.sum())} pixels, "
                               f"the images hold {true_px}")
        return seconds, time.perf_counter() - t0

    first_s, first_wall = one_pass()
    steady_s, steady_wall = one_pass()
    record = dict(
        config=args.config, images=args.images, loader_batch=args.batch,
        scales=args.scales, flip=not args.no_flip,
        dtype="bfloat16" if args.amp else "float32", device=str(device),
        geometries=len({(h, w) for h, w, _ in groups}),
        geom_bucket_shapes=len(groups),
        groups={f"{h}x{w}x{b}": n for (h, w, b), n in sorted(groups.items())},
        forward_shapes=len(shapes),
        pad_overhead_pct=100 * (fwd_px / true_px - 1),
        true_pixels=true_px, hist_exact=True,
        first_pass_s=first_s, steady_pass_s=steady_s,
        first_pass_wall_s=first_wall, steady_pass_wall_s=steady_wall,
        steady_img_per_s=args.images / steady_s,
        timer="cuda events" if cuda else "host clock")
    print(json.dumps(record), flush=True)
    return record


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
