"""Process start to the first timed item: imports, the kernels' build or
load, the model's build, weights, inputs and warm-up."""


def read(run):
    return run.setup_s
