"""Images of the optimizer steps completed in the window, over its
seconds."""


def read(run):
    if run.kind == "train_steps":
        return run.images / run.window_s
