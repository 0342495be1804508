"""Images whose multi-scale + flip probabilities reached the confusion
histogram in the window, over its seconds."""


def read(run):
    if run.kind == "eval_msf":
        return run.images / run.window_s
