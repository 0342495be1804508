"""Training: optimizer steps of `entry.train_steps` on batches of `batch`
rows taken in turn from a pool of `pool` distinct batches on the device
(labels in 0..classes-1, `ignore_share` of the pixels at the background),
`steps_per_call` steps a call: the host waits for the card once a call,
as the train tool's loop waits only at its log lines (every tenth of an
epoch of 100 steps).

Set-up builds the trainer once (model, optimizer, schedule, generator),
copies the benchmark's weights in and takes its first `checked_steps`
steps through the same call the window makes, on rows that all differ.
What they leave is read then: each step's loss, each leaf's first
gradient as the optimizer got it (its first moment after step 1 over
1 - beta1) and each leaf's change after the checked steps. The reference
takes the same steps from the same weights, rows and seeded draws.
"""

import time

import torch

from h100_bench import inputs, program
from h100_bench.reference import train as ref_train
from h100_bench.reference.model import Precision
from h100_bench.weights import PROGRAM, derive, make_weights


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = traffic.get("compute_dtype", cfg["compute_dtype"])
        self.batch = traffic["batch"]
        self.per_item = traffic["steps_per_call"]  # steps an item takes
        self.gen_seed = derive(seed, PROGRAM)

    def batches(self, ks):
        B = self.batch
        return [(self.data["rgb"][k * B:(k + 1) * B],
                 self.data["modal"][k * B:(k + 1) * B],
                 self.data["gt"][k * B:(k + 1) * B]) for k in ks]

    def setup(self):
        from dformer_torch import entry

        (self.model, self.opt, self.sched, self.gen), self.build_s = \
            program.build(self.cfg, self.dtype, self.device, self.gen_seed,
                          train=True)
        weights = make_weights(self.cfg, self.seed, self.device)
        program.load(self.model, weights)
        self.data = inputs.pool(self.cfg, self.tr["pool"] * self.batch,
                                self.seed, self.device, labels=True,
                                ignore_share=self.tr["ignore_share"])
        t0 = time.perf_counter()
        names = {p: n for n, p in self.model.named_parameters()}
        losses, grads = [], None
        n = self.tr["checked_steps"]
        if n > self.tr["pool"]:
            raise ValueError("the checked steps need a batch of their own "
                             "each: pool < checked_steps")
        for k, batch in enumerate(self.batches(range(n))):
            losses += entry.train_steps(self.model, self.opt, self.sched,
                                        self.gen, [batch], first_step=k)
            if k == 0:
                grads = first_gradients(self.opt, names)
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(p - weights[n]))
                      for n, p in self.model.named_parameters()}
        self.readings = ref_train.Readings(losses, grads, change)
        del weights
        self.step = n
        self.warmup_s = time.perf_counter() - t0

    def item(self, record=True):
        """`steps_per_call` steps in one call; returns their images."""
        from dformer_torch import entry

        ks = [(self.step + i) % self.tr["pool"] for i in range(self.per_item)]
        entry.train_steps(self.model, self.opt, self.sched, self.gen,
                          self.batches(ks), first_step=self.step)
        self.step += self.per_item
        return self.batch * self.per_item

    def spans(self):
        return {}

    def finish(self):
        del self.model, self.opt
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, prec=None, rows=None):
        """The reference's readings of the checked steps (`rows` of each
        batch only, for the half-batch fault)."""
        W = make_weights(self.cfg, self.seed, self.device)
        batches = self.batches(range(self.tr["checked_steps"]))
        if rows is not None:
            batches = [tuple(t[:rows] for t in b) for b in batches]
        return ref_train.steps(self.cfg, W, batches, self.gen_seed,
                               prec or Precision("fp32"),
                               recompute=self.tr.get("recompute", True))

    def check(self, control=None):
        """The gaps between the program's readings (or, with `control`, the
        reference's at that precision) and the reference's."""
        ref = self.reference()
        got = self.reference(control) if control is not None \
            else self.readings
        return ref_train.gaps(got, ref)


def first_gradients(opt, names) -> dict:
    """Each leaf's gradient norm as the optimizer got it in its first
    step: the first moment over 1 - beta1."""
    out = {}
    for group in opt.param_groups:
        b1 = group["betas"][0]
        for p in group["params"]:
            m = opt.state[p]["exp_avg"]
            out[names[p]] = float(torch.linalg.vector_norm(m)) / (1.0 - b1)
    return out

