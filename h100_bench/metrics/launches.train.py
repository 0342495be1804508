"""Device kernels launched per traced item (request, step or group)."""


def read(run):
    if run.trace is not None:
        return run.trace.launches_per_item()
