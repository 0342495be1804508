"""Device ms per step of the kernels launched under the optimizer's
own step span (`Optimizer.step#<name>.step`)."""


def read(run):
    if run.trace is None:
        return None
    names = [n for n in run.trace.spans if n.startswith("Optimizer.step#")]
    ms = [run.trace.span_ms(n) for n in names]
    return sum(ms) if ms else None
