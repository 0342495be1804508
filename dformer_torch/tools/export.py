"""Export DFormer + the config's decode head for serving: one `.pt2` file,
the eval forward captured by `torch.export` with the weights in it,
loadable with no model code and no tracing (counterpart of
`tools/export.py`):

    python -m dformer_torch.tools.export --config=local_configs.NYUDepthv2.DFormer_Large \\
        [--continue_fpath=epoch-E_miou_M.pth] [--out=output/model.pt2] \\
        [--batch=dynamic|N] [--no-amp] [--selftest] [--device=cuda]

Without --continue_fpath the weights are random from seed 0 (an artifact
to check shapes with). --batch dynamic (the default) exports a symbolic
batch of 1 to 64; --amp (the default) computes in bf16, --no-amp in fp32.
--platforms is accepted and ignored: a torch program runs on the device
its weights are on, here --device. Serve the file with
`python -m dformer_torch.tools.eval --exported=<file>`, or
`runtime.export.load_exported(<file>).module()(rgb, modal_x)`.
"""

import argparse
import os
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--continue_fpath", default=None,
                    help="torch checkpoint (.pth, .pt, .pth.tar); random "
                         "weights from seed 0 when omitted")
    ap.add_argument("--out", default="output/model.pt2")
    ap.add_argument("--batch", default="dynamic",
                    help="'dynamic' (a symbolic batch, the default) or a "
                         "fixed int")
    ap.add_argument("--platforms", nargs="+", default=None,
                    help="(ignored: the program runs on --device)")
    ap.add_argument("--amp", action=argparse.BooleanOptionalAction,
                    default=True, help="bf16 compute (serving default); "
                    "--no-amp exports the fp32 graph")
    ap.add_argument("--selftest", action="store_true",
                    help="reload the file and run one zero-input batch")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.runtime.export import (export_forward, load_exported,
                                              save_exported)

    if args.platforms:
        print(f"--platforms {args.platforms} ignored: the program runs on "
              f"{args.device}")
    cfg = load_config(args.config)
    hw = (cfg.image_height, cfg.image_width)
    model = entry.build_evaluator(
        cfg, torch.bfloat16 if args.amp else None, args.device,
        checkpoint=args.continue_fpath)[0].model
    batch = None if args.batch == "dynamic" else int(args.batch)
    t0 = time.perf_counter()
    exported = export_forward(model, hw, batch)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_exported(exported, args.out)
    print(f"exported {args.out}: {os.path.getsize(args.out) / 1e6:.1f} MB "
          f"in {time.perf_counter() - t0:.1f} s, batch "
          f"{'1..64' if batch is None else batch}, {hw[0]}x{hw[1]}, "
          f"{'bf16' if args.amp else 'fp32'} on {args.device}", flush=True)
    if args.selftest:
        module = load_exported(args.out).module()
        x = torch.zeros((batch or 1, *hw, 3), device=args.device)
        with torch.inference_mode():
            out = module(x, x.clone())
        print(f"selftest ok: logits {tuple(out.shape)} {out.dtype}")
    return args.out


if __name__ == "__main__":
    main()
