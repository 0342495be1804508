"""Images whose labels reached the host, over the window's seconds."""


def read(run):
    if run.kind == "closed_loop":
        return run.images / run.window_s
