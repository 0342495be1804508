"""Evaluation: `Evaluator.evaluate_msf` over groups of `group` labelled
images (the Evaluator's groups) with the traffic's scales and flip, taken
in turn from a pool of `pool` distinct groups on the device.

Each group's confusion histogram is kept. The check takes
`checked_groups` of the window's groups, drawn from the seed, and compares
each histogram with the one the reference's multi-scale + flip
probabilities give: `hist_gap` is the largest number of pixels whose
counted label differs (half the sum of the absolute differences).
"""

import time

import numpy as np
import torch

from h100_bench import inputs, program
from h100_bench.reference.evaluate import msf_hist
from h100_bench.reference.model import Precision
from h100_bench.weights import PROGRAM, SAMPLE, derive, make_weights


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = traffic.get("compute_dtype", cfg["compute_dtype"])
        self.batch = traffic["group"]
        self.per_item = 1  # groups an item takes
        self.hists = []   # (pool index, hist) of each group of the window

    def setup(self):
        from dformer_torch.eval.evaluate import Evaluator

        self.model, self.build_s = program.build(
            self.cfg, self.dtype, self.device, derive(self.seed, PROGRAM))
        program.load(self.model, make_weights(self.cfg, self.seed,
                                              self.device))
        self.ev = Evaluator(self.model, program.program_config(self.cfg),
                            device=self.device)
        self.data = inputs.pool(self.cfg, self.tr["pool"] * self.batch,
                                self.seed, self.device, labels=True,
                                ignore_share=self.tr["ignore_share"])
        t0 = time.perf_counter()
        for _ in range(self.tr["warmup_groups"]):
            self.item(record=False)
        self.warmup_s = time.perf_counter() - t0

    def group(self, g):
        s = slice(g * self.batch, (g + 1) * self.batch)
        return {"rgb": self.data["rgb"][s], "modal_x": self.data["modal"][s],
                "gt": self.data["gt"][s]}

    def item(self, record=True):
        g = len(self.hists) % self.tr["pool"] if record else 0
        metrics = self.ev.evaluate_msf([self.group(g)], self.tr["scales"],
                                       flip=self.tr["flip"])
        if record:
            self.hists.append((g, metrics.hist.copy()))
        return self.batch

    def spans(self):
        return {}

    def finish(self):
        del self.ev, self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self, control=None):
        """{"hist_gap": the widest over the sampled groups}; with `control`
        (a Precision) the histograms are the reference's at that precision
        instead of the program's."""
        rng = np.random.default_rng(derive(self.seed, SAMPLE))
        k = min(self.tr["checked_groups"], len(self.hists))
        picks = rng.choice(len(self.hists), size=k, replace=False)
        W = make_weights(self.cfg, self.seed, self.device)
        worst = 0
        for i in sorted(int(p) for p in picks):
            g, got = self.hists[i]
            grp = self.group(g)
            args = (W, self.cfg, grp["rgb"], grp["modal_x"], grp["gt"],
                    self.tr["scales"], self.tr["flip"])
            ref = msf_hist(*args, Precision("fp32"))
            if control is not None:
                got = msf_hist(*args, control)
            worst = max(worst, int(np.abs(got - ref).sum()) // 2)
        return {"hist_gap": float(worst)}
