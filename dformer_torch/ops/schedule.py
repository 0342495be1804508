"""Learning-rate schedules as functions of the step counter, on Python floats
(counterpart of `dformer_tpu/ops/schedule.py`)."""


def poly_lr(step, base_lr: float, total_steps: int, power: float = 0.9
            ) -> float:
    # clamp: past total_steps the base would go negative
    frac = min(max(1.0 - step / float(total_steps), 0.0), 1.0)
    return base_lr * frac ** power


def warmup_poly_lr(step, base_lr: float, total_steps: int, warmup_steps: int,
                   power: float = 0.9) -> float:
    """Linear warm-up to base_lr over `warmup_steps`, then poly decay
    (1 - step/total)^power, 0 past `total_steps`."""
    if step < warmup_steps:
        return base_lr * step / max(float(warmup_steps), 1.0)
    return poly_lr(step, base_lr, total_steps, power)


def multi_stage_lr(step, stages) -> float:
    """stages: [(until_step, lr)]: the rate of the first stage with step <
    until_step, the last stage's past them all."""
    for until, lr in stages:
        if step < until:
            return float(lr)
    return float(stages[-1][1])


def linear_increase_lr(step, start_lr: float, end_lr: float,
                       warm_iters: int) -> float:
    """start_lr rising linearly to end_lr over warm_iters steps (and on
    past them)."""
    return start_lr + step * (end_lr - start_lr) / float(warm_iters)
