"""Evaluate DFormer + the config's decode head (its `decoder` and `aux_rate`)
on the config's val split (counterpart of `tools/eval.py`):

    python -m dformer_torch.tools.eval --config=local_configs.NYUDepthv2.DFormer_Large \\
        [--continue_fpath=ckpt.pth | orbax dir] [--no-mst] [--sliding] \\
        [--amp] [--val_batch_size=4] [--synthetic-data] [--parity-check] \\
        [--save_path=DIR] [--device=cuda] [--exported=model.pt2]
    torchrun --nproc_per_node=N -m dformer_torch.tools.eval --config=...

Multi-scale + flip by default (scales [0.5, 0.75, 1.0, 1.25, 1.5] when the
config's eval_scale_array is [1], flip from eval_flip); fp32 with TF32 off
unless --amp (bf16). Without --continue_fpath the weights are random from
seed 0; a directory is read as the JAX trainer's orbax checkpoint
(`utils/orbax.py`, needs tensorstore). --exported serves an artifact of
`tools.export` instead of a model: single scale at the artifact's H x W
(MSF and sliding are turned off). --save_path writes each image's labels
as a palette PNG `<save_path>/<file name>_pred.png`
(`eval/visualize.py`). Under torchrun each process evaluates its share of
the val split (and saves its images' PNGs) and the hists are summed; rank
0 prints the per-class table (IoU, Acc), then
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
                    help="torch checkpoint (.pth, .pt, .pth.tar) or the JAX "
                         "trainer's orbax checkpoint directory")
    ap.add_argument("--mst", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--sliding", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=False, help="bf16 eval; default fp32")
    ap.add_argument("--val_batch_size", type=int, default=4)
    ap.add_argument("--synthetic-data", action="store_true")
    ap.add_argument("--save_path", default=None,
                    help="write each image's labels as a palette PNG here")
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

    from dformer_torch.parallel import dist

    with dist.group_from_env(args.device):
        return _evaluate(args)


def _evaluate(args):
    """Evaluate and, on rank 0, print the metrics; returns the merged
    `Metrics`."""
    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.eval.visualize import make_save_hook, print_iou
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
    save_hook = make_save_hook(cfg, args.save_path) if args.save_path \
        else None
    if args.mst:
        scales = cfg.eval_scale_array
        if scales == [1]:
            scales = MSF_SCALES
        m = ev.evaluate_msf(batches, scales=scales, flip=cfg.eval_flip,
                            save_hook=save_hook)
    else:
        m = ev.evaluate(batches, save_hook=save_hook)
    m.merge_across_processes()
    if dist.rank() != 0:
        return m
    ious, miou = m.compute_iou()
    accs, macc = m.compute_pixel_acc()
    _, mf1 = m.compute_f1()
    print_iou(ious, accs, cfg.class_names)
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
    return m


if __name__ == "__main__":
    main()
