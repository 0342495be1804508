"""95th percentile of request latency over every request of the window:
the start of the upload to the labels on the host."""

from h100_bench.roofline import p95


def read(run):
    if run.kind == "closed_loop":
        return p95(run.latencies_ms)
