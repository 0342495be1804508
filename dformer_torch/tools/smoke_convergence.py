"""End-to-end learning smoke (counterpart of `tools/smoke_convergence.py`):
train DFormer-Tiny on a learnable synthetic task (labels a quantised smooth
field, rgb and depth derived from the field) and check that the held-out
mIoU lands far above chance (25). It exercises the forward, the backward,
AdamW and the BatchNorm statistics together, with no dataset on disk.

    python -m dformer_torch.tools.smoke_convergence [--trav] [--steps 600] \\
        [--min_miou 60] [--device cuda]

--trav: the same for DFormerTrav-Base (`local_configs.Trav.DFormer_Base`).
The label's low bit exists only in the 360-beam lidar scan (whether the
scan's mean is above 0.5), the high bit only in the rgb field, so a
held-out mIoU well above the ~33 of a low bit at chance shows that the
gradients reach the Attention1Dto2D lidar expansion and train it.

The batches are drawn from a numpy `RandomState` in the JAX tool's order,
including the resampling of scans whose mean lies near 0.5, and upsampled
as `jax.image.resize(..., "linear")` does (half-pixel bilinear, weights
renormalised at the border), so the same seed gives the JAX tool's
batches. The model computes in bf16 on fp32 parameters; held-out
evaluation uses the ham head's seeded bases.
"""

import argparse
import time

import numpy as np
import torch


def _linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] fp32 weights of `jax.image.resize`'s "linear" kernel
    along one axis (`jax._src.image.scale.compute_weight_mat`, no
    translation): the triangle kernel at half-pixel sample points, each
    column renormalised to sum 1 over the input pixels it reaches."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    sample = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
              - f32(0.5)).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(f32(0), f32(1) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def resize_linear(x: np.ndarray, out_hw) -> np.ndarray:
    """Upsample NHWC fp32 `x` to `out_hw` as `jax.image.resize(x, (B,
    *out_hw, C), "linear")`: the width contraction first, then the
    height, in fp32."""
    wh = _linear_weights(x.shape[1], out_hw[0])
    ww = _linear_weights(x.shape[2], out_hw[1])
    y = np.einsum("bhwc,wv->bhvc", x, ww).astype(np.float32)
    return np.einsum("bhvc,hu->buvc", y, wh).astype(np.float32)


def _field_and_rgb(rng, B, hw):
    base = rng.rand(B, 8, 12, 1).astype(np.float32)
    field = resize_linear(base, hw)
    rgb = np.concatenate([field, 1 - field, 0.5 + 0 * field], -1) \
        + 0.05 * rng.randn(B, hw[0], hw[1], 3).astype(np.float32)
    return field, rgb.astype(np.float32)


def make_batch(rng, B=8, hw=(64, 96), num_classes=4):
    """(rgb [B,H,W,3] fp32, gt [B,H,W] int32, depth [B,H,W,3] fp32) as CPU
    tensors: gt the field quantised to `num_classes` levels."""
    field, rgb = _field_and_rgb(rng, B, hw)
    gt = np.clip((field[..., 0] * num_classes).astype(np.int32), 0,
                 num_classes - 1)
    depth = np.repeat(field, 3, axis=-1).astype(np.float32)
    return (torch.from_numpy(rgb), torch.from_numpy(gt),
            torch.from_numpy(depth))


def make_trav_batch(rng, B=8, hw=(64, 96), beams=360):
    """(rgb [B,H,W,3] fp32, gt [B,H,W] int32, scan [B,beams] fp32) as CPU
    tensors: gt = 2 * (rgb field > 0.5) + (scan mean > 0.5).

    The bit is a statistic of the scan's values, not of its beam order:
    the expansion embeds each beam by its value with no position, so a
    beam-indexed target could not be learned (the JAX tool's note). Scans
    whose mean lies within 0.03 of 0.5 are drawn again, up to 50 times, so
    that the bit is crisp."""
    field, rgb = _field_and_rgb(rng, B, hw)

    def expand(c):  # 12 smooth control points -> `beams` beams
        return resize_linear(c, (1, beams))[:, 0, :, 0].copy()

    scan = expand(rng.rand(B, 1, 12, 1).astype(np.float32))
    for _ in range(50):
        bad = np.abs(scan.mean(1) - 0.5) < 0.03
        if not bad.any():
            break
        scan[bad] = expand(rng.rand(int(bad.sum()), 1, 12, 1)
                           .astype(np.float32))
    scan_bit = (scan.mean(1) > 0.5).astype(np.int32)
    gt = 2 * (field[..., 0] > 0.5).astype(np.int32) \
        + scan_bit[:, None, None]
    return (torch.from_numpy(rgb), torch.from_numpy(gt.astype(np.int32)),
            torch.from_numpy(scan.astype(np.float32)))


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--min_miou", type=float, default=60.0)
    ap.add_argument("--trav", action="store_true",
                    help="DFormerTrav lidar-expansion convergence smoke")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def smoke_config(trav: bool, steps: int):
    """The Tiny (or Trav) config cut to the task: 4 classes, 64x96, and a
    warm-up poly schedule of 10 epochs (one of warm-up) stretched over
    `steps`, at lr 3e-4, trained from scratch."""
    from dformer_torch.configs import load_config

    cfg = load_config("local_configs.Trav.DFormer_Base" if trav
                      else "local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.num_classes = 4
    cfg.image_height, cfg.image_width = 64, 96
    cfg.nepochs, cfg.warm_up_epoch = 10, 1
    cfg.niters_per_epoch = max(60, steps // cfg.nepochs)
    cfg.lr = 3e-4
    cfg.pretrained_model = None
    return cfg


def main(argv=None) -> dict:
    """Train, evaluate, print the JAX tool's lines and raise if the held-out
    mIoU is below --min_miou. Returns {"losses", "miou", "ious", "seconds",
    "ms_per_step", "launches"}: `launches` holds each step's (forward,
    backward) fused-MLP kernel launches (0 on the CPU)."""
    args = parse_args(argv)
    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.ops.metrics import Metrics
    from dformer_torch.train.loop import _to_device, train_step

    device = torch.device(args.device)
    cfg = smoke_config(args.trav, args.steps)
    mk = make_trav_batch if args.trav else make_batch
    model, optimizer, schedule, _ = entry.build_training(
        cfg, torch.bfloat16, device, seed=0)
    if device.type == "cuda":
        from dformer_torch.kernels import build

        build.build_all()
    generator = torch.Generator(device=device).manual_seed(0)

    rng = np.random.RandomState(0)
    losses, launches = [], []
    t0 = time.perf_counter()
    for it in range(args.steps):
        # pinned, asynchronous copies: the host does not wait for the
        # previous step's kernels before it queues the next step's
        rgb, gt, modal = (_to_device(t.numpy(), device) for t in mk(rng))
        n0 = (fused_mlp.launches, fused_mlp.backward_launches)
        loss = train_step(model, optimizer, schedule, it, rgb, gt, modal,
                          generator)
        launches.append((fused_mlp.launches - n0[0],
                         fused_mlp.backward_launches - n0[1]))
        losses.append(loss)
        if it % 100 == 0:
            print(f"it {it} loss {float(loss):.4f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    losses = torch.stack(losses).float().cpu().tolist()
    seconds = time.perf_counter() - t0

    model.eval()
    metrics = Metrics(4, 255)
    erng = np.random.RandomState(123)
    with torch.inference_mode():
        for _ in range(10):
            rgb, gt, modal = (t.to(device) for t in mk(erng))
            metrics.update(model(rgb, modal), gt)
    ious, miou = metrics.compute_iou()
    print(f"final loss {losses[-1]:.4f}  held-out mIoU {miou} "
          f"(chance 25.0)  per-class {ious}")
    if miou < args.min_miou:
        raise RuntimeError(f"held-out mIoU {miou} < {args.min_miou}")
    print("CONVERGENCE SMOKE: PASS")
    return dict(losses=losses, miou=float(miou), ious=list(map(float, ious)),
                seconds=seconds, ms_per_step=1e3 * seconds / args.steps,
                launches=launches)


if __name__ == "__main__":
    main()
