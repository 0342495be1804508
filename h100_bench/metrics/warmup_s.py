"""Host seconds of the warm-up items (a training cell's checked steps)."""


def read(run):
    return run.warmup_s
