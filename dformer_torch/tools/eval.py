"""Evaluate DFormer + the config's decode head (its `decoder` and `aux_rate`)
on the config's val split (counterpart of `tools/eval.py`):

    python -m dformer_torch.tools.eval --config=local_configs.NYUDepthv2.DFormer_Large \\
        [--continue_fpath=ckpt.pth] [--no-mst] [--sliding] [--amp] \\
        [--val_batch_size=4] [--synthetic-data] [--parity-check] \\
        [--device=cuda] [--exported=model.pt2]
    torchrun --nproc_per_node=N -m dformer_torch.tools.eval --config=...

Multi-scale + flip by default (scales [0.5, 0.75, 1.0, 1.25, 1.5] when the
config's eval_scale_array is [1], flip from eval_flip); fp32 with TF32 off
unless --amp (bf16). Without --continue_fpath the weights are random from
seed 0. --exported serves an artifact of `tools.export` instead of a
model: single scale at the artifact's H x W (MSF and sliding are turned
off). Under torchrun each process evaluates its share of the val split
and the hists are summed; rank 0 prints each class's IoU, then
{'mIoU': .., 'mAcc': .., 'mF1': ..}.
"""

import argparse
import json

MSF_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]
# published MSF mIoU of the reference checkpoints, tolerance +-0.2
PARITY_TARGETS = {("NYUDepthv2", "DFormer-Large"): 57.2,
                  ("SUNRGBD", "DFormer-Large"): 52.5}
PARITY_TOLERANCE = 0.2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--continue_fpath", default=None,
                    help="torch checkpoint (.pth, .pt, .pth.tar)")
    ap.add_argument("--mst", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--sliding", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=False, help="bf16 eval; default fp32")
    ap.add_argument("--val_batch_size", type=int, default=4)
    ap.add_argument("--synthetic-data", action="store_true")
    ap.add_argument("--save_path", default=None)
    ap.add_argument("--exported", default=None,
                    help="serve a tools.export artifact instead of a "
                         "checkpoint: single-scale eval at the artifact's "
                         "resolution (implies --no-mst --no-sliding)")
    ap.add_argument("--parity-check", action="store_true",
                    help="print the mIoU delta against the published number "
                         "for this config (NYUDepthv2 / SUNRGBD "
                         "DFormer-Large)")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.save_path:
        raise NotImplementedError(
            "--save_path is not ported yet (ROADMAP.md Queue 1, item 8b: "
            "prediction saving)")
    if args.continue_fpath and not args.continue_fpath.endswith(
            (".pth", ".pt", ".pth.tar")):
        raise NotImplementedError(
            "orbax checkpoint directories are not read yet (ROADMAP.md "
            "Queue 1, item 12c: orbax checkpoints)")

    from dformer_torch.parallel import dist

    with dist.group_from_env(args.device):
        _evaluate(args)


def _evaluate(args):
    """Evaluate and, on rank 0, print the metrics."""
    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.parallel import dist

    cfg = load_config(args.config)
    ev, batches = entry.build_evaluator(
        cfg, dtype=torch.bfloat16 if args.amp else None, device=args.device,
        sliding=args.sliding, checkpoint=args.continue_fpath,
        val_batch_size=args.val_batch_size, synthetic=args.synthetic_data,
        shard=(dist.rank(), dist.world()), exported=args.exported)
    if args.exported and (args.mst or args.sliding):
        print("--exported serves the artifact's one input shape: MSF and "
              "sliding are off for this run")
        args.mst = args.sliding = False
    if args.mst:
        scales = cfg.eval_scale_array
        if scales == [1]:
            scales = MSF_SCALES
        m = ev.evaluate_msf(batches, scales=scales, flip=cfg.eval_flip)
    else:
        m = ev.evaluate(batches)
    m.merge_across_processes()
    if dist.rank() != 0:
        return
    ious, miou = m.compute_iou()
    _, macc = m.compute_pixel_acc()
    _, mf1 = m.compute_f1()
    for name, iou in zip(cfg.class_names, ious):
        print(f"  {name}: {iou}")
    print(dict(mIoU=miou, mAcc=macc, mF1=mf1), flush=True)
    if args.parity_check:
        target = PARITY_TARGETS.get((cfg.dataset_name, cfg.backbone))
        if target is None:
            print(json.dumps(dict(
                parity_check="no published target for "
                             f"{cfg.dataset_name}/{cfg.backbone}",
                mIoU=miou)))
        else:
            delta = round(miou - target, 2)
            print(json.dumps(dict(
                mIoU=miou, target=target, delta_vs_target=delta,
                tolerance=PARITY_TOLERANCE,
                within_tolerance=abs(delta) <= PARITY_TOLERANCE,
                synthetic=bool(args.synthetic_data))))


if __name__ == "__main__":
    main()
