"""The JAX trainer's orbax checkpoint directories, read into the port
(counterpart of the restore half of `dformer_tpu/train/checkpoint.py`).

A directory `epoch-{E}_miou_{M}` holds the tree {"params", "batch_stats",
"opt_state", "step"} that orbax's `StandardCheckpointer` wrote: its
`_METADATA` file (JSON) lists every leaf's key path, and each array is a
zarr array named by the path joined with "." in an OCDBT key-value store
(or, without OCDBT, in a directory of that name). Both are read with
`tensorstore` and `json` alone: no orbax and no JAX.

The model's leaves go through `utils.convert.from_jax_variables`. optax's
states become torch's: AdamW's `mu` / `nu` / `count` (`ScaleByAdamState`)
are `exp_avg` / `exp_avg_sq` / `step`, SGD's momentum `trace`
(`TraceState`) is `momentum_buffer`, wherever they sit in the state
(`multi_transform`'s `inner_states`, `masked`'s `inner_state`). A
parameter that `multi_transform` routed to `set_to_zero` has no moment:
it is frozen, in no optimizer group.

`tensorstore` is imported at the first read; where it is not installed a
directory raises, naming the converter (`tools/convert_orbax.py`) that
writes a port checkpoint on a host that has it.
"""

import json
import os.path as osp
import re
from typing import Dict, Tuple

import numpy as np
import torch

from dformer_torch.utils.convert import from_jax_variables

CONVERTER = ("python -m dformer_torch.tools.convert_orbax <dir> <out.pth> "
             "--config=<config>")
_NAME_RE = re.compile(r"epoch-(\d+)_miou_([0-9.]+)$")
# optax state fields -> torch optimizer state names
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer"}

Tree = Dict[Tuple[str, ...], np.ndarray]


def read_tree(path: str) -> Tree:
    """{key path: array} of every stored leaf of an orbax directory (the
    `step` scalar a 0-d array); leaves orbax stored no value for (optax's
    empty states) are left out."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise RuntimeError(
            f"{path} is an orbax checkpoint directory, and reading it needs "
            "the tensorstore package, which is not installed here; write a "
            f"port checkpoint from it where it is: {CONVERTER}") from e
    with open(osp.join(path, "_METADATA")) as f:
        meta = json.load(f)
    root = osp.abspath(path)
    driver = "zarr3" if meta.get("use_zarr3") else "zarr"
    context = ts.Context()
    opened = {}
    for leaf in meta["tree_metadata"].values():
        if leaf["value_metadata"].get("skip_deserialize"):
            continue
        keys = tuple(k["key"] for k in leaf["key_metadata"])
        name = ".".join(keys)
        kvstore = ({"driver": "ocdbt", "base": f"file://{root}/",
                    "path": name + "/"} if meta.get("use_ocdbt")
                   else {"driver": "file", "path": f"{root}/{name}/"})
        opened[keys] = ts.open({"driver": driver, "kvstore": kvstore},
                               context=context, open=True)
    # every open, then every read, in flight at once
    reads = {keys: f.result().read() for keys, f in opened.items()}
    return {keys: np.asarray(r.result()) for keys, r in reads.items()}


def _nest(leaves: Dict[Tuple[str, ...], np.ndarray]) -> dict:
    tree = {}
    for keys, value in leaves.items():
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


def _under(tree: Tree, prefix: Tuple[str, ...]) -> Tree:
    n = len(prefix)
    return {k[n:]: v for k, v in tree.items() if k[:n] == prefix}


def model_state(tree: Tree) -> Dict[str, torch.Tensor]:
    """The port's state_dict of a checkpoint's params and batch_stats."""
    return from_jax_variables({"params": _nest(_under(tree, ("params",))),
                               "batch_stats": _nest(_under(
                                   tree, ("batch_stats",)))})


def optimizer_moments(tree: Tree):
    """({torch state name: {parameter name: tensor}}, AdamW's step count
    or None) of a checkpoint's opt_state."""
    found, count = {}, None
    for keys in tree:
        if keys[0] != "opt_state":
            continue
        at = next((i for i, k in enumerate(keys) if k in _MOMENTS), None)
        if at is None:
            continue
        found.setdefault(keys[:at + 1], {})[keys[at + 1:]] = tree[keys]
        if keys[at] == "mu":
            count = tree.get(keys[:at] + ("count",))
    moments = {}
    for prefix, leaves in found.items():
        name = _MOMENTS[prefix[-1]]
        if name in moments:
            raise ValueError(f"two optax states hold {prefix[-1]!r}")
        moments[name] = from_jax_variables({"params": _nest(leaves)})
    return moments, None if count is None else int(count)


def checkpoint_epoch(path: str) -> int:
    """The epoch in a checkpoint directory's name (0 when it has none)."""
    m = _NAME_RE.search(osp.basename(osp.normpath(path)))
    return int(m.group(1)) if m else 0


def trained_names(tree: Tree):
    """The parameter names the checkpoint's optimizer holds moments for
    (the others were frozen)."""
    moments, _ = optimizer_moments(tree)
    if not moments:
        raise ValueError("the checkpoint's opt_state holds no AdamW or "
                         "SGD momentum state")
    return sorted(next(iter(moments.values())))


def restore_trainer(trainer, path: str, tree: Tree = None) -> int:
    """Load an orbax directory (or its `read_tree`) into a trainer's model
    (strictly), optimizer (torch AdamW or SGD with momentum; its groups
    must hold exactly the parameters the checkpoint has moments for) and
    step; returns the epoch to continue with (the name's epoch + 1), as the
    JAX manager does."""
    tree = read_tree(path) if tree is None else tree
    trainer.model.load_state_dict(model_state(tree), strict=True)
    moments, count = optimizer_moments(tree)
    opt = trainer.optimizer
    want = ("exp_avg", "exp_avg_sq") if isinstance(
        opt, torch.optim.AdamW) else ("momentum_buffer",)
    missing = [k for k in want if k not in moments]
    if missing:
        raise ValueError(f"{path}: no {missing} for a "
                         f"{type(opt).__name__} optimizer")
    names = {p: n for n, p in trainer.model.named_parameters()}
    grouped = sorted(names[p] for g in opt.param_groups for p in g["params"])
    stored = sorted(moments[want[0]])
    if grouped != stored:
        raise ValueError(
            f"{path} holds optimizer state for {len(stored)} parameters, "
            f"the optimizer's groups {len(grouped)}: the frozen sets differ")
    for g in opt.param_groups:
        for p in g["params"]:
            state = {k: moments[k][names[p]].to(p.device, p.dtype)
                     for k in want}
            if count is not None and "exp_avg" in state:
                state["step"] = torch.tensor(float(count))
            opt.state[p] = state
    trainer.step = int(tree[("step",)])
    return checkpoint_epoch(path) + 1
