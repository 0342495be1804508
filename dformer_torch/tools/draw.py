"""Report drawing (counterpart of `tools/draw.py`; needs matplotlib):

    python -m dformer_torch.tools.draw curves <train log> [--out=output/curves.png]
    python -m dformer_torch.tools.draw grid <image> [<image> ...] [--out=output/grid.png] [--cols=4]
    python -m dformer_torch.tools.draw deck --csv=<manifest> --epochs name=dir [...] \\
        [--out=output/deck.pdf] [--alpha=0.6]

`curves`: train loss and val mIoU by epoch from a train tool's log.
`grid`: prediction PNGs tiled into one figure. `deck`: a multi-page PDF,
one page per manifest row: the image, its label, the lidar scan and each
epoch directory's `<image stem>.npy` mask (`eval/draw.py`).
"""

import argparse
import os


def _parse_epoch_dirs(specs):
    """"name=dir" pairs, or bare directories (named by their basename)."""
    out = []
    for s in specs:
        name, _, d = s.partition("=")
        if not d:
            name, d = os.path.basename(s.rstrip("/")), s
        out.append((name, d))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("curves", help="loss/mIoU curves from a train log")
    p.add_argument("log")
    p.add_argument("--out", default="output/curves.png")

    p = sub.add_parser("grid", help="tile prediction PNGs into one figure")
    p.add_argument("images", nargs="+")
    p.add_argument("--out", default="output/grid.png")
    p.add_argument("--cols", type=int, default=4)

    p = sub.add_parser("deck", help="per-image epoch-comparison deck (PDF)")
    p.add_argument("--csv", required=True,
                   help="manifest with image/img (+ optional label, laser)")
    p.add_argument("--epochs", nargs="+", required=True,
                   help="prediction dirs as name=dir (or bare dirs); "
                   "each holds <image-stem>.npy masks")
    p.add_argument("--out", default="output/deck.pdf")
    p.add_argument("--alpha", type=float, default=0.6)
    return ap.parse_args(argv)


def main(argv=None) -> str:
    from dformer_torch.eval import draw

    args = parse_args(argv)
    if args.cmd == "curves":
        out = draw.plot_training_curves(args.log, args.out)
    elif args.cmd == "grid":
        out = draw.prediction_grid(args.images, args.out, cols=args.cols)
    else:
        out = draw.deck_from_csv(args.csv, _parse_epoch_dirs(args.epochs),
                                 args.out, alpha=args.alpha)
    print(out)
    return out


if __name__ == "__main__":
    main()
