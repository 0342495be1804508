"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program's compared numbers on many seeds (the lower
reading), the control's on a few (the reference computed in the nearest
precision below the configuration's, in the program's place: fp8 for
bf16, TF32 for float32) and the reference computed with bf16 operands as
a witness of what bf16 compute gives, both on a few seeds, and for a
training cell the half-batch fault.

    python3 -m h100_bench.calibrate --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--seconds 4] [--out FILE]

One process: each seed builds the cell, runs a short window at the
cell's load (long enough to finish as many checked items as a run
compares) and checks it. One JSON line per seed.
"""

import argparse
import gc
import importlib
import json
import sys

import torch

from h100_bench import spec
from h100_bench.reference import train as ref_train
from h100_bench.reference.model import Precision


def control_precision(cfg: dict, traffic: dict) -> Precision:
    dtype = traffic.get("compute_dtype", cfg["compute_dtype"])
    return Precision("tf32" if dtype == "float32" else "fp8")


def calibrate_seed(wl: dict, seed: int, seconds: float, control: bool,
                   device="cuda") -> dict:
    from h100_bench.record import Run
    from h100_bench.run import window

    cfg, tr = spec.config(wl["config"]), spec.traffic(wl["traffic"])
    cell = importlib.import_module(f"h100_bench.cells.{tr['kind']}").Cell(
        cfg, tr, seed, device)
    cell.setup()
    dtype = tr.get("compute_dtype", cfg["compute_dtype"])
    witness = Precision("bf16") if dtype == "bfloat16" else None
    run = Run(wl["name"], cfg, tr)
    window(run, cell, seconds)
    cell.finish()
    out = {"seed": seed, "items": run.items}
    if tr["kind"] == "train_steps":
        ref = cell.reference()
        out["program"] = ref_train.gaps(cell.readings, ref)
        out["worst_leaves"] = ref_train.worst_leaves(cell.readings, ref)
        out["losses"] = [cell.readings.losses, ref.losses]
        if control:
            out["half_batch"] = ref_train.gaps(
                cell.reference(rows=cell.batch // 2), ref)
            out["control"] = ref_train.gaps(
                cell.reference(control_precision(cfg, tr)), ref)
            if witness is not None:
                out["witness"] = ref_train.gaps(cell.reference(witness), ref)
    else:
        out["program"] = cell.check()
        if control:
            out["control"] = cell.check(control_precision(cfg, tr))
            if witness is not None:
                out["witness"] = cell.check(witness)
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    wl = spec.workload(spec.benchmark(), args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(controls - set(seeds)):
        line = json.dumps(calibrate_seed(wl, seed, args.seconds,
                                         seed in controls))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
