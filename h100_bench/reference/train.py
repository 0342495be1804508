"""Plain PyTorch reference of the training recipe: masked cross entropy,
AdamW with decoupled decay on the conv and linear weights, the warm-up
poly learning rate. Imports nothing of the program under test.

`steps` takes the checked steps from the benchmark's weights on its
batches, drawing the forward's random numbers from a generator seeded as
the program's (`model.plan_draws`), each encoder block recomputed in the
backward so that a batch of full-size images fits. `gaps` compares two
sets of readings leaf by leaf.
"""

import statistics
from dataclasses import dataclass
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from h100_bench.reference.model import forward, is_statistic, plan_draws

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a conv bias under a training-mode BatchNorm): it
# moves under Adam by round-off alone and is not compared
NULL_GRAD = 1e-3


@dataclass
class Readings:
    losses: List[float]
    grads: Dict[str, float]    # first gradient's norm per leaf
    change: Dict[str, float]   # norm of each leaf's change after the steps


def masked_ce(logits, gt, ignore):
    valid = gt != ignore
    logp = torch.log_softmax(logits, -1)
    nll = -logp.gather(-1, torch.where(valid, gt, 0)[..., None])[..., 0]
    return torch.where(valid, nll, 0.0).sum() / valid.sum().clamp(min=1)


def lr_at(t: dict, step: int) -> float:
    """Linear warm-up over warm_up_epoch epochs, then poly decay."""
    total = t["nepochs"] * t["niters_per_epoch"]
    warm = t["niters_per_epoch"] * t["warm_up_epoch"]
    if step < warm:
        return t["lr"] * step / max(float(warm), 1.0)
    frac = min(max(1.0 - step / float(total), 0.0), 1.0)
    return t["lr"] * frac ** t["lr_power"]


def decays(name: str, p) -> bool:
    return name.rsplit(".", 1)[-1] in ("weight", "in_proj_weight") \
        and p.ndim >= 2


def steps(cfg: dict, weights: dict, batches, gen_seed: int, prec,
          recompute: bool = True) -> Readings:
    t = cfg["train"]
    b1, b2 = t["betas"]
    params = {n: w.clone().requires_grad_(True) for n, w in weights.items()
              if not is_statistic(n)}
    W = dict(weights, **params)
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    dev = next(iter(params.values())).device
    gen = torch.Generator(device=dev).manual_seed(gen_seed)

    def run_block(fn, a, b):
        return checkpoint(fn, a, b, use_reentrant=False)

    losses, first = [], None
    with prec.scope():
        for k, (rgb, modal, gt) in enumerate(batches):
            draws = plan_draws(cfg, rgb.shape[0], rgb.shape[1:3], gen)
            logits = forward(W, cfg, rgb, modal, prec, train=True,
                             draws=draws,
                             run_block=run_block if recompute else None)
            loss = masked_ce(logits, gt, cfg["background"])
            grads = torch.autograd.grad(loss, list(params.values()))
            del logits, draws
            losses.append(float(loss.detach()))
            if k == 0:
                first = {n: float(torch.linalg.vector_norm(g))
                         for n, g in zip(params, grads)}
            lr = lr_at(t, k)
            with torch.no_grad():
                for (n, p), g in zip(params.items(), grads):
                    if decays(n, p):
                        p.mul_(1.0 - lr * t["weight_decay"])
                    m[n].mul_(b1).add_(g, alpha=1.0 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                    c1, c2 = 1.0 - b1 ** (k + 1), 1.0 - b2 ** (k + 1)
                    denom = (v[n].sqrt() / c2 ** 0.5).add_(t["eps"])
                    p.addcdiv_(m[n], denom, value=-lr / c1)
            del grads
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p - weights[n]))
                  for n, p in params.items()}
    return Readings(losses, first, change)


def _leaf_gaps(got: Dict[str, float], ref: Dict[str, float], leaves):
    """Per leaf |got - ref| over the larger of ref and the median leaf's
    ref."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(got[n] - ref[n]) / max(ref[n], med) for n in leaves}


def gaps(got: Readings, ref: Readings) -> dict:
    """loss_gap: the largest relative gap of a step's loss; grad_gap and
    update_gap: the worst leaf's gap of the first gradient's norm and of
    the change's norm; grad_gap_median and update_gap_median: the median
    leaf's. Leaves whose
    reference gradient is nought to rounding are left out of all but the
    loss (NULL_GRAD)."""
    med = statistics.median(ref.grads.values())
    leaves = [n for n, g in ref.grads.items() if g >= NULL_GRAD * med]
    g = _leaf_gaps(got.grads, ref.grads, leaves)
    u = _leaf_gaps(got.change, ref.change, leaves)
    return {
        "loss_gap": max(abs(a - b) / abs(b)
                        for a, b in zip(got.losses, ref.losses)),
        "grad_gap": max(g.values()),
        "grad_gap_median": statistics.median(g.values()),
        "update_gap": max(u.values()),
        "update_gap_median": statistics.median(u.values()),
        "null_leaves": float(len(ref.grads) - len(leaves)),
    }


def worst_leaves(got: Readings, ref: Readings, top: int = 5) -> dict:
    """The leaves with the widest gaps, for a look at what drives them."""
    med = statistics.median(ref.grads.values())
    leaves = [n for n, g in ref.grads.items() if g >= NULL_GRAD * med]
    out = {}
    for key, a, b in (("grad", got.grads, ref.grads),
                      ("change", got.change, ref.change)):
        gl = _leaf_gaps(a, b, leaves)
        out[key] = sorted(((round(v, 6), n) for n, v in gl.items()),
                          reverse=True)[:top]
    out["null"] = [n for n in ref.grads if n not in leaves]
    return out

