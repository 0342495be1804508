"""Device ms per request of the kernels launched under the span around
the backbone's forward."""


def read(run):
    if run.trace is not None:
        return run.trace.span_ms("bench.encoder")
