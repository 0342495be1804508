"""Step-1 gradient / trainable coverage audit (counterpart of
`dformer_tpu/train/audit.py`, whose `coverage_audit` this copies).

The reference warns on any parameter with a missing .grad after the first
backward of epoch 1 (utils/train.py:347-351). Here the train step returns
per-parameter flags (gradient != 0, optimizer update != 0, in
`named_parameters()` order) in the audited steps only, and the audit checks:

* gradient coverage (valid at any learning rate, including the warm-up's 0
  at step 0): a trainable weight with an exactly-zero gradient is cut off
  from the loss. Conv biases in front of a BatchNorm legitimately get zero
  gradients (the BatchNorm removes constant shifts), so zero-gradient
  biases are reported as info, not warnings.
* update coverage (needs a step whose learning rate is not 0): a frozen
  parameter must get no update, and a trainable parameter with a gradient
  must get one. If the audited step had rate 0 the audit reports
  incomplete and the Trainer audits the next step too.
"""

from typing import Sequence

import numpy as np


def param_paths(model) -> list:
    """Parameter paths (name split at the dots) in `named_parameters()`
    order, the order of the train step's flag vectors."""
    return [tuple(name.split(".")) for name, _ in model.named_parameters()]


def coverage_audit(paths: Sequence[tuple], grad_nz, upd_nz,
                   trainable_mask=None, logger=None,
                   verbose_grad: bool = True) -> dict:
    """Audit one early train step's flag vectors against the mask
    ({parameter name: trainable}, `optim.trainable_mask_from_matched`;
    None = every parameter trainable).

    Returns {"ok", "complete", "disconnected", "zero_grad_biases",
    "frozen_updated", "trainable_stuck", "per_module"}. complete=False means
    the step produced no updates at all (warmup lr=0) and the update checks
    must be retried on a later step; the grad checks are always final.
    """
    grad_nz = np.asarray(grad_nz, bool)
    upd_nz = np.asarray(upd_nz, bool)
    if trainable_mask is None:
        expected = np.ones(len(paths), bool)
    else:
        expected = np.asarray([trainable_mask[".".join(p)] for p in paths],
                              bool)
    assert len(paths) == len(grad_nz) == len(upd_nz) == len(expected)

    def _log(msg, warn=False):
        if logger is None:
            print(msg, flush=True)
        elif warn and hasattr(logger, "warning"):
            logger.warning(msg)
        else:
            logger.info(msg)

    disconnected, zero_grad_biases = [], []
    for p, g, e in zip(paths, grad_nz, expected):
        if e and not g:
            (zero_grad_biases if p[-1] == "bias" else disconnected).append(p)

    per_module = {}
    for p, g, u, e in zip(paths, grad_nz, upd_nz, expected):
        mod = per_module.setdefault(
            p[0], dict(trainable=0, frozen=0, grad=0, updated=0))
        mod["trainable" if e else "frozen"] += 1
        mod["grad"] += int(g)
        mod["updated"] += int(u)
    if verbose_grad:
        for mod, d in sorted(per_module.items()):
            _log(f"step-1 coverage: {mod}: {d['grad']} grads / "
                 f"{d['updated']} updated over {d['trainable']} trainable "
                 f"+ {d['frozen']} frozen leaves")
        for p in disconnected:
            _log("step-1 coverage: trainable parameter has exactly-zero gradient "
                 "(disconnected from the loss, or detached): "
                 + "/".join(p), warn=True)
        if zero_grad_biases:
            _log(f"step-1 coverage: {len(zero_grad_biases)} bias leaves "
                 "with exact-zero grad (conv bias before BatchNorm — "
                 "absorbed by construction): "
                 + ", ".join("/".join(p) for p in zero_grad_biases[:8])
                 + ("..." if len(zero_grad_biases) > 8 else ""))

    frozen_updated, trainable_stuck = [], []
    complete = bool(upd_nz.any())
    if complete:
        for p, g, u, e in zip(paths, grad_nz, upd_nz, expected):
            if not e and u:
                frozen_updated.append(p)
            elif e and g and not u:
                trainable_stuck.append(p)
        for p in frozen_updated:
            _log("step-1 coverage: FROZEN parameter received a nonzero update "
                 "(mask not applied?): " + "/".join(p), warn=True)
        for p in trainable_stuck:
            _log("step-1 coverage: trainable parameter with nonzero grad got a "
                 "ZERO update (left out of the optimizer — mislabeled mask?): "
                 + "/".join(p), warn=True)
        if not frozen_updated and not trainable_stuck and not disconnected:
            _log("step-1 coverage: complete — every trainable parameter receives "
                 "gradient and update, every frozen parameter is untouched")
    else:
        _log("step-1 coverage: step produced no updates (warmup lr=0 at "
             "iter 0, faithful to reference lr_policy.py:30) — update "
             "checks deferred to the next step")

    return dict(ok=not disconnected and not frozen_updated
                and not trainable_stuck,
                complete=complete, disconnected=disconnected,
                zero_grad_biases=zero_grad_biases,
                frozen_updated=frozen_updated,
                trainable_stuck=trainable_stuck, per_module=per_module)
