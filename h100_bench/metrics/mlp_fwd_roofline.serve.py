"""Fused-MLP forward: the least time of a request's calls (operations
and bytes from their shapes) over the device time of the forward op's
kernels per traced request."""

from h100_bench import readers


def read(run):
    return readers.mlp_forward_roofline(run)
