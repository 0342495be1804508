"""Fused-MLP backward: the least time of a step's backward calls over the
device time of the backward op's kernels per traced step."""

from h100_bench import readers


def read(run):
    return readers.mlp_backward_roofline(run)
