"""Write a port checkpoint from an orbax checkpoint directory of the JAX
trainer:

    python -m dformer_torch.tools.convert_orbax <dir> <out.pth> \\
        --config=local_configs.NYUDepthv2.DFormer_Large

The directory's params, batch_stats, optimizer moments and step go into a
torch file of `train/checkpoint.py`'s layout ({"model", "optimizer", "step",
"epoch", "frozen"}) for the config's model and optimizer, the frozen set
being the parameters the directory holds no moments for: the eval tool
reads it as a model checkpoint, `tools.train --continue_fpath` resumes
from it. Needs the `tensorstore` package (no orbax, no JAX); where it is
installed the tools also read the directory itself.
"""

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dir", help="an orbax checkpoint directory "
                    "(epoch-E_miou_M)")
    ap.add_argument("out", help="the torch checkpoint file to write")
    ap.add_argument("--config", required=True)
    return ap.parse_args(argv)


def main(argv=None):
    from types import SimpleNamespace

    from dformer_torch.configs import load_config
    from dformer_torch.models import build_model
    from dformer_torch.train.checkpoint import write_checkpoint
    from dformer_torch.train.optim import make_optimizer
    from dformer_torch.utils.orbax import (read_tree, restore_trainer,
                                           trained_names)

    args = parse_args(argv)
    cfg = load_config(args.config)
    tree = read_tree(args.dir)
    trained = set(trained_names(tree))
    model = build_model(cfg, device="cpu")
    mask = {n: n in trained for n, _ in model.named_parameters()}
    trainer = SimpleNamespace(
        model=model, optimizer=make_optimizer(cfg, model, mask), step=0,
        frozen=sorted(n for n, t in mask.items() if not t))
    epoch = restore_trainer(trainer, args.dir, tree) - 1
    write_checkpoint(trainer, epoch, args.out)
    print(f"wrote {args.out}: epoch {epoch}, step {trainer.step}, "
          f"{len(trained)} trained and {len(trainer.frozen)} frozen "
          "parameters", flush=True)
    return args.out


if __name__ == "__main__":
    main()
