"""Prediction saving (counterpart of `tools/infer.py`):

    python -m dformer_torch.tools.infer --config=local_configs.NYUDepthv2.DFormer_Large \\
        --save_path=DIR [--continue_fpath=ckpt.pth | orbax dir] \\
        [--exported=model.pt2] [--no-mst] [--sliding] [--amp] \\
        [--val_batch_size=1] [--synthetic-data] [--device=cuda]

The eval tool (`tools/eval.py`) with a save path: the same evaluation of
the config's val split, each image's labels written as a palette PNG
`<save_path>/<file name>_pred.png`, and the metrics printed. As in the JAX
tool, evaluation is fp32 unless --amp and runs batches of one image by
default.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--continue_fpath", default=None)
    ap.add_argument("--exported", default=None,
                    help="serve a tools.export artifact instead of a "
                         "checkpoint")
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--mst", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--sliding", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--val_batch_size", type=int, default=1)
    ap.add_argument("--synthetic-data", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the eval tool with these flags; returns its merged `Metrics`."""
    from dformer_torch.tools import eval as eval_tool

    args = parse_args(argv)
    argv = [f"--config={args.config}", f"--save_path={args.save_path}",
            f"--val_batch_size={args.val_batch_size}",
            f"--device={args.device}",
            "--mst" if args.mst else "--no-mst",
            "--sliding" if args.sliding else "--no-sliding",
            "--amp" if args.amp else "--no-amp"]
    if args.continue_fpath:
        argv.append(f"--continue_fpath={args.continue_fpath}")
    if args.exported:
        argv.append(f"--exported={args.exported}")
    if args.synthetic_data:
        argv.append("--synthetic-data")
    return eval_tool.main(argv)


if __name__ == "__main__":
    main()
