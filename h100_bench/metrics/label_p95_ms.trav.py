"""The labelling tail: 95th percentile of request latency over every
request of the window (as `serve_p95_ms` is taken), read in the traced
run of a labelling cell, where the rate and not the tail is the gate."""

from h100_bench.roofline import p95


def read(run):
    if run.kind == "closed_loop":
        return p95(run.latencies_ms)
