"""Fused-MLP forward in a multi-scale + flip evaluation: the least time of
a group's calls at every scale and mirror (operations and bytes from
their shapes) over the device time of the forward op's kernels per traced
group."""

from h100_bench import readers


def read(run):
    return readers.mlp_forward_roofline(run)
