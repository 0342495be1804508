"""Device ms per request of the kernels launched under the span around
the decode head's forward."""


def read(run):
    if run.trace is not None:
        return run.trace.span_ms("bench.decode_head")
