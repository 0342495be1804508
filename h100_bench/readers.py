"""What several metric readers share: which kernels are the fused-MLP ops'
(the names of the program's kernels) and the least time of a traced
item's calls."""

from h100_bench import roofline


def is_forward_kernel(name: str) -> bool:
    """The forward op's launches: its LayerNorm rows (bf16), the kernel,
    and the sum of the hidden splits."""
    return any(k in name for k in ("fused_mlp_fwd", "layernorm_rows",
                                   "reduce_splits"))


def is_backward_kernel(name: str) -> bool:
    return "fused_mlp_bwd" in name


def item_sizes(run):
    """(rows, [(h, w) of each forward], forwards per size) of one item."""
    cfg, tr = run.config, run.traffic
    H, W = cfg["image_height"], cfg["image_width"]
    if run.kind == "eval_msf":
        return (tr["group"], roofline.msf_sizes(H, W, tr["scales"]),
                2 if tr["flip"] else 1)
    return tr["batch"], [(H, W)], 1


def mlp_forward_roofline(run):
    if run.trace is None:
        return None
    measured = run.trace.device_ms(is_forward_kernel)
    if measured <= 0:
        return None
    rows, sizes, passes = item_sizes(run)
    bound = roofline.forward_bound_ms(run.config, rows, sizes, run.dtype,
                                      passes)
    return roofline.roofline_pct(bound, measured)


def mlp_backward_roofline(run):
    if run.trace is None:
        return None
    measured = run.trace.device_ms(is_backward_kernel)
    if measured <= 0:
        return None
    cfg = run.config
    bound = roofline.backward_bound_ms(cfg, run.traffic["batch"],
                                       cfg["image_height"],
                                       cfg["image_width"], run.dtype)
    return roofline.roofline_pct(bound, measured)
