"""Operations of the window's images (the frozen count per image of the
cell's shapes) over the window's seconds and the peak of the precision
the cell computes in."""

from h100_bench.roofline import mfu_pct


def read(run):
    if run.flops is not None and run.window_s > 0:
        return mfu_pct(run.flops["per_image"], run.images, run.window_s,
                       run.dtype)
