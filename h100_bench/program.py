"""The system under test, reached through its own entry points: the model
of a configuration built by the port's builder, with the benchmark's
weights copied in. The only module of the harness, with the cells, that
imports the program."""

import time

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def build(cfg: dict, compute_dtype: str, device, seed: int, train=False):
    """(model, or (model, optimizer, schedule, generator) with `train`,
    build seconds). `seed` seeds the program's own draws (its fresh init,
    overwritten by the caller, and a training generator)."""
    from dformer_torch import entry

    prog = cfg["program"]
    dtype = DTYPES[compute_dtype]
    hw = (cfg["image_height"], cfg["image_width"])
    t0 = time.perf_counter()
    if train:
        out = entry.build_trainer(prog["backbone"], hw, cfg["num_classes"],
                                  dtype, device, seed,
                                  decoder=cfg["decoder"])
    elif prog["entry"] == "build_trav":
        out = entry.build_trav(program_config(cfg), dtype, device, seed)
    else:
        out = entry.build(prog["backbone"], hw, cfg["num_classes"], dtype,
                          device, seed, decoder=cfg["decoder"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def load(model, weights: dict) -> None:
    """Copy the benchmark's weights into the program's model (every
    parameter and statistic, by its published name)."""
    missing, unexpected = model.load_state_dict(weights, strict=True)
    if missing or unexpected:
        raise RuntimeError(f"weights do not fit the model: {missing} "
                           f"{unexpected}")


def program_config(cfg: dict):
    """The program's own config of the configuration, at its image size and
    classes (the same numbers for every cell of the benchmark)."""
    from dformer_torch.configs import load_config

    pc = load_config(cfg["program"]["config"])
    pc.update(image_height=cfg["image_height"], image_width=cfg["image_width"],
              num_classes=cfg["num_classes"])
    return pc
