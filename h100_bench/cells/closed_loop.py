"""Serving in a closed loop: one caller, one request in flight.

A request is `batch` rows (image + depth map, or image + lidar scan) of a
pool of `pool` distinct batches held in page-locked host memory, taken in
turn. It copies its rows to the card, runs `entry.infer` and copies the
int32 labels back to the host; its latency runs from the start of the
upload to the labels on the host.

The labels of `checked_requests` requests of the window, a uniform sample
drawn from the seed (a reservoir, so that it is a sample of the requests
the window finished, however many that is), are kept for the check. At
every pixel of them the reference's logits give the gap by which the
served label's logit lies below the reference's best. `label_gap_tie` is
the sum of the gaps over the number of near ties: pixels whose reference
margin (best minus second logit) is under `TIE`. Rounding can only flip a
near tie, so the count of near ties, which random weights make differ
from seed to seed, cancels out of it. For a look: `label_gap_mean` (the
gaps' mean), `label_gap` (the widest), `label_mismatch` (the share of
pixels whose served label is not the reference's argmax), `near_ties`
(their share of the sample).
"""

import time

import numpy as np
import torch

from h100_bench import inputs, program
from h100_bench.reference.model import Precision, forward
from h100_bench.weights import PROGRAM, SAMPLE, derive, make_weights

REF_ROWS = 8  # rows the reference computes at a time
TIE = 1.0     # logits: a reference margin under this is a near tie


class Cell:
    def __init__(self, cfg, traffic, seed, device):
        self.cfg, self.tr, self.seed, self.device = cfg, traffic, seed, device
        self.dtype = traffic.get("compute_dtype", cfg["compute_dtype"])
        self.batch = traffic["batch"]
        self.per_item = 1      # requests an item takes
        self.rng = np.random.default_rng(derive(seed, SAMPLE))
        self.requests = 0      # served by the window
        self.kept = []         # (labels, pool index) of the sample

    def setup(self):
        cuda = torch.device(self.device).type == "cuda"
        self.model, self.build_s = program.build(
            self.cfg, self.dtype, self.device, derive(self.seed, PROGRAM))
        program.load(self.model, make_weights(self.cfg, self.seed,
                                              self.device))
        rows = self.tr["pool"] * self.batch
        made = inputs.pool(self.cfg, rows, self.seed, self.device,
                           coarse=self.tr.get("coarse"),
                           fine=self.tr.get("fine", 1.0))
        self.host = inputs.to_host(made, pinned=cuda)
        del made
        H, W = self.cfg["image_height"], self.cfg["image_width"]
        k = self.tr["checked_requests"]
        self.spare = [torch.empty((self.batch, H, W), dtype=torch.int32,
                                  pin_memory=cuda) for _ in range(k + 2)]
        t0 = time.perf_counter()
        for _ in range(self.tr["warmup_requests"]):
            self.item(record=False)
        self.warmup_s = time.perf_counter() - t0

    def rows(self, b):
        s = slice(b * self.batch, (b + 1) * self.batch)
        return self.host["rgb"][s], self.host["modal"][s]

    def serve(self, b, out):
        from dformer_torch import entry

        rgb, modal = self.rows(b)
        rgb = rgb.to(self.device, non_blocking=True)
        modal = modal.to(self.device, non_blocking=True)
        labels = entry.infer(self.model, rgb, modal)
        out.copy_(labels, non_blocking=True)
        if torch.device(self.device).type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def item(self, record=True):
        """One request; returns the images it served."""
        b = self.requests % self.tr["pool"] if record else 0
        slot = None
        if record:
            n, k = self.requests, self.tr["checked_requests"]
            j = n if n < k else int(self.rng.integers(0, n + 1))
            slot = j if j < k else None
            self.requests += 1
        out = self.spare[-1] if slot is not None else self.spare[0]
        self.serve(b, out)
        if slot is not None:
            self.spare.pop()
            if slot < len(self.kept):
                self.spare.append(self.kept[slot][0])
                self.kept[slot] = (out, b)
            else:
                self.kept.append((out, b))
        return self.batch

    def spans(self):
        return {"bench.encoder": self.model.encoder_backbone,
                "bench.decode_head": self.model.decode_head}

    def finish(self):
        del self.model
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----

    def check(self, control=None):
        """The numbers over every pixel of the sample; with `control` (a
        Precision) the labels are that precision's argmax of the reference
        instead of the served ones."""
        W = make_weights(self.cfg, self.seed, self.device)
        fp32 = Precision("fp32")
        worst, total, moved, ties, pixels = 0.0, 0.0, 0, 0, 0
        with torch.no_grad():
            for labels, b in self.kept:
                rgb, modal = self.rows(b)
                for r in range(0, self.batch, REF_ROWS):
                    s = slice(r, r + REF_ROWS)
                    x = rgb[s].to(self.device)
                    m = modal[s].to(self.device)
                    with fp32.scope():
                        ref = forward(W, self.cfg, x, m, fp32)
                    if control is not None:
                        with control.scope():
                            lab = forward(W, self.cfg, x, m,
                                          control).argmax(-1)
                    else:
                        lab = labels[s].to(self.device).long()
                    top2 = ref.topk(2, dim=-1).values
                    gap = top2[..., 0] - ref.gather(-1, lab[..., None])[..., 0]
                    worst = max(worst, float(gap.max()))
                    total += float(gap.double().sum())
                    moved += int((gap > 0).sum())
                    ties += int((top2[..., 0] - top2[..., 1] < TIE).sum())
                    pixels += gap.numel()
                    del ref, lab, gap, top2
        return {"label_gap_tie": total / max(ties, 1),
                "label_gap_mean": total / pixels, "label_gap": worst,
                "label_mismatch": moved / pixels, "near_ties": ties / pixels}
