"""Tiny configurations for the harness's CPU tests: the cells' own
configuration files cut to narrow widths, one or two blocks a stage and a
64 x 96 image, with the program's backbone registry extended to match for
the duration of a `with` block. Never used by a run of the benchmark."""

import contextlib

from h100_bench import spec

NARROW = dict(dims=[16, 32, 48, 64], depths=[1, 1, 2, 1],
              num_heads=[1, 2, 2, 4], windows=[0, 7, 7, 7],
              mlp_ratios=[4, 4, 4, 4])
HW = (64, 96)


def config(name: str) -> dict:
    """The configuration file `name`, cut to the narrow widths."""
    cfg = dict(spec.config(name), **NARROW)
    cfg["image_height"], cfg["image_width"] = HW
    cfg["num_classes"] = min(cfg["num_classes"], 5)
    cfg["program"] = dict(cfg["program"])
    if cfg["program"]["entry"] == "build":
        cfg["program"]["backbone"] = "DFormer-Narrow"
    return cfg


def traffic(name: str, **over) -> dict:
    """The traffic file `name` at a CPU test's scale."""
    tr = spec.traffic(name)
    small = dict(batch=2, group=2, pool=3, warmup_requests=1, traced_items=1,
                 checked_requests=2, checked_groups=2, warmup_groups=1,
                 steps_per_call=2, recompute=False)
    return dict(tr, **{k: v for k, v in small.items() if k in tr
                       or k == "recompute"}, **over)


@contextlib.contextmanager
def registered(monkeypatch, trav: bool = False):
    """The program's registry with a narrow backbone: "DFormer-Narrow",
    and with `trav` the DFormer-Base entry that DFormerTrav reads."""
    from dformer_torch.models import encoder

    spec_ = dict(dims=tuple(NARROW["dims"]), depths=tuple(NARROW["depths"]),
                 num_heads=tuple(NARROW["num_heads"]),
                 windows=tuple(NARROW["windows"]),
                 mlp_ratios=tuple(NARROW["mlp_ratios"]))
    monkeypatch.setitem(encoder.VARIANTS, "DFormer-Narrow", spec_)
    if trav:
        monkeypatch.setitem(encoder.VARIANTS, "DFormer-Base", spec_)
    yield
