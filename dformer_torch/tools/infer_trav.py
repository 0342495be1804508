"""Trav predictions as palette PNGs (counterpart of `tools/infer_trav.py`):

    python -m dformer_torch.tools.infer_trav --config=local_configs.Trav.DFormer_Base \\
        [--csv=manifest.csv] [--continue_fpath=ckpt.pth | orbax dir] \\
        [--save_path=output/trav_preds] [--no-amp] [--device=cuda]

DFormerTrav-Base + the config's decoder (`entry.build_trav`: weights from
seed 0, or the checkpoint's; bf16 compute unless --no-amp) labels every
row of the manifest (default cfg.eval_source; its image and scan paths in
"image" and "depth", or in "img" and "laser") one image at a time, and
writes `<save_path>/<image stem>_pred.png` in the config's palette.
"""

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="local_configs.Trav.DFormer_Base")
    ap.add_argument("--csv", default=None)
    ap.add_argument("--continue_fpath", default=None)
    ap.add_argument("--save_path", default="output/trav_preds")
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute on fp32 parameters")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def manifest_dataset(cfg, args):
    """The manifest's rows as a dataset of rgb, laser and their paths."""
    from dformer_torch.data.trav import TravRGBDLabeledDataset, load_trav_csv

    rows = load_trav_csv(args.csv or cfg.eval_source)
    if rows and "image" not in rows[0] and "img" in rows[0]:
        rename = {"img": "image", "laser": "depth"}
        rows = [{rename.get(k, k): v for k, v in r.items()} for r in rows]
    return TravRGBDLabeledDataset(rows)


def run(cfg, args, dataset=None) -> dict:
    """Label `dataset` (items of rgb, laser and rgb_path; by default
    `manifest_dataset`) with the tool's parsed `args` and write the PNGs.
    Returns {"model", "paths" (the PNGs, in row order), "seconds"}."""
    import numpy as np
    import torch

    from dformer_torch import entry
    from dformer_torch.data.loader import Loader
    from dformer_torch.eval.visualize import palette_for, save_pred_png
    from dformer_torch.train.fss import TravPrep
    from dformer_torch.utils.checkpoint import load_checkpoint

    device = torch.device(args.device)
    model = entry.build_trav(cfg, torch.bfloat16 if args.amp else None,
                             device, seed=0)
    if args.continue_fpath:
        load_checkpoint(model, args.continue_fpath)
    prep = TravPrep(cfg, 0, device)
    palette = palette_for(cfg)
    paths = []
    t0 = time.perf_counter()
    with torch.inference_mode():
        for b in Loader(dataset or manifest_dataset(cfg, args), 1):
            rgb, laser = prep(b["rgb"], b["laser"])
            pred = torch.argmax(model(rgb, laser), dim=-1)[0]
            name = os.path.splitext(os.path.basename(b["rgb_path"][0]))[0]
            path = os.path.join(args.save_path, f"{name}_pred.png")
            save_pred_png(pred.cpu().numpy().astype(np.uint8), path, palette)
            paths.append(path)
    seconds = time.perf_counter() - t0
    print(f"saved {len(paths)} predictions -> {args.save_path}", flush=True)
    return dict(model=model, paths=paths, seconds=seconds)


def main(argv=None):
    from dformer_torch.configs import load_config

    args = parse_args(argv)
    return run(load_config(args.config), args)


if __name__ == "__main__":
    main()
