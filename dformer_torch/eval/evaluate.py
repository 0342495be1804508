"""Evaluation: single-scale, multi-scale + flip (MSF) and sliding-window
inference with confusion-matrix metrics (counterpart of
`dformer_tpu/eval/evaluate.py`).

  * `evaluate`: one forward per batch, fp32 softmax, argmax into the hist.
  * `evaluate_msf`: per scale a resize to `ceil32(int(s*H)) x ceil32(int(s*W))`
    (align_corners=True), a forward, the logits resized back
    (align_corners=True) and their fp32 softmax summed; with flip, each
    scale also runs on the horizontally flipped inputs (flipped once per
    group, resized by the same resize) and the flipped probabilities are
    flipped back before they are summed.
  * sliding: the crop grid at stride `eval_stride_rate * crop`; all windows
    stacked window-major into the batch and run as one forward, summed in
    fp32 and divided by each pixel's visit count.

Inputs are NHWC batches (dicts of "rgb", "modal_x", "gt", optionally "hw"
and "fn") of numpy arrays or tensors; they are moved to `device` per group.
Everything runs under `torch.inference_mode()`.

Across devices: one process drives one device, so there is no mesh inside
a process (the JAX Evaluator's `mesh`). Under a process group each rank
evaluates its shard of the val split (`device_val_batches(shard=...)`) and
`Metrics.merge_across_processes` sums the hists.
"""

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dformer_torch.ops.metrics import Metrics, confusion_matrix
from dformer_torch.ops.resize import resize_bilinear


def ceil32(v: int) -> int:
    return int(-(-v // 32)) * 32


def slide_window_grid(h_img: int, w_img: int, crop, stride_rate: float):
    """Static list of (y1, x1) window origins."""
    h_crop, w_crop = crop
    h_stride = int(stride_rate * h_crop)
    w_stride = int(stride_rate * w_crop)
    h_grids = max(h_img - h_crop + h_stride - 1, 0) // h_stride + 1
    w_grids = max(w_img - w_crop + w_stride - 1, 0) // w_stride + 1
    origins = []
    for hi in range(h_grids):
        for wi in range(w_grids):
            y2 = min(hi * h_stride + h_crop, h_img)
            x2 = min(wi * w_stride + w_crop, w_img)
            origins.append((max(y2 - h_crop, 0), max(x2 - w_crop, 0)))
    return origins


def _host(v) -> np.ndarray:
    return v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


class Evaluator:
    """Drives a model over an iterable of batches.

    `forward(rgb, modal)` (default: the model's own forward) returns
    [B, H, W, num_classes] logits at input resolution. The model runs on
    `device`, the card unless the caller passes device="cpu"."""

    def __init__(self, model, cfg, sliding: bool = False,
                 forward: Optional[Callable] = None, device="cuda"):
        if torch.device(device).type == "cuda" \
                and not torch.cuda.is_available():
            raise RuntimeError("Evaluator: CUDA is not available; pass "
                               "device='cpu' to run on the CPU")
        self.model = model
        self.cfg = cfg
        self.sliding = sliding
        self.num_classes = cfg.num_classes
        self.background = cfg.background
        self.device = torch.device(device)
        self._forward_override = forward
        self.exported = False

    @classmethod
    def from_exported(cls, exported, cfg, device="cuda"):
        """Serve an artifact of `runtime/export.py` (a `torch.export`
        program, `load_exported`): its call replaces the model's forward,
        on fp32 inputs. The artifact holds one input H x W, so only
        single-scale `evaluate` runs: MSF and sliding windows need other
        shapes and raise. The program is moved, in place, to `device`
        (its weights, constants and the devices written into its graph):
        an artifact saved from one card serves on any other, as every
        rank of a torchrun evaluation does on its own."""
        from torch.export.passes import move_to_device_pass

        ev = cls(None, cfg, sliding=False, device=device)
        if ev.device.type == "cuda" and ev.device.index is None:
            ev.device = torch.device("cuda", torch.cuda.current_device())
        module = move_to_device_pass(exported, ev.device).module()

        def forward(rgb, modal):
            return module(rgb.float(), modal.float())

        ev._forward_override = forward
        ev.exported = True
        return ev

    def _single_scale_only(self, mode):
        if self.exported:
            raise ValueError(f"{mode} evaluation needs input shapes other "
                             "than the exported artifact's one H x W; "
                             "evaluate it at single scale")

    def _to_device(self, arr) -> torch.Tensor:
        return torch.as_tensor(arr).to(self.device)

    def _forward(self, rgb, modal):
        if self._forward_override is not None:
            return self._forward_override(rgb, modal)
        return self.model(rgb, modal)

    def _model_logits(self, rgb, modal):
        """Whole-image or sliding-window logits at input resolution."""
        if not self.sliding:
            return self._forward(rgb, modal)
        self._single_scale_only("sliding-window")
        return self._slide(rgb, modal)

    def _slide(self, rgb, modal):
        """Sliding-window logits: every window in one forward, fp32 sums
        divided by the visit count. Inputs smaller than the crop in either
        dimension are first resized to the crop (align_corners=True)."""
        crop = tuple(self.cfg.eval_crop_size)
        B, H, W, _ = rgb.shape
        if crop[0] > H or crop[1] > W:
            rgb = resize_bilinear(rgb, crop, align_corners=True)
            modal = resize_bilinear(modal, crop, align_corners=True)
            H, W = crop
        origins = slide_window_grid(H, W, crop, self.cfg.eval_stride_rate)
        if len(origins) == 1:
            return self._forward(rgb, modal)
        hc, wc = crop
        r_wins = torch.cat([rgb[:, y:y + hc, x:x + wc] for y, x in origins])
        m_wins = torch.cat([modal[:, y:y + hc, x:x + wc]
                            for y, x in origins])
        logits = self._forward(r_wins, m_wins)
        preds = torch.zeros((B, H, W, self.num_classes), dtype=torch.float32,
                            device=logits.device)
        count = torch.zeros((1, H, W, 1), dtype=torch.float32,
                            device=logits.device)
        for i, (y, x) in enumerate(origins):
            preds[:, y:y + hc, x:x + wc] += logits[i * B:(i + 1) * B].float()
            count[:, y:y + hc, x:x + wc] += 1.0
        return preds / count

    @torch.inference_mode()
    def single_probs(self, rgb, modal, hw):
        """fp32 class probabilities [B, *hw, C] of one whole-image or
        sliding-window pass. Sliding on inputs smaller than the crop returns
        crop-size logits, which are resized back to `hw`."""
        logits = self._model_logits(rgb, modal)
        if tuple(logits.shape[1:3]) != tuple(hw):
            logits = resize_bilinear(logits, hw, align_corners=True)
        return torch.softmax(logits.float(), dim=-1)

    def _scale_probs(self, rgb, modal, new_hw, out_hw):
        r = resize_bilinear(rgb, new_hw, align_corners=True)
        m = resize_bilinear(modal, new_hw, align_corners=True)
        logits = self._model_logits(r, m)
        logits = resize_bilinear(logits, out_hw, align_corners=True)
        return torch.softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def msf_probs(self, rgb, modal, hw, scales: Sequence[float], flip: bool):
        """The MSF accumulator: fp32 probabilities [B, *hw, C] summed over
        the scales (and their flipped passes); each pixel sums to
        len(scales) * (2 if flip else 1)."""
        self._single_scale_only("multi-scale")
        H, W = hw
        acc = torch.zeros((rgb.shape[0], H, W, self.num_classes),
                          dtype=torch.float32, device=rgb.device)
        if flip:  # once per group; reused by every scale's flip pass
            rgb_f, modal_f = torch.flip(rgb, dims=[2]), torch.flip(modal,
                                                                   dims=[2])
        for scale in scales:
            new_hw = (ceil32(int(scale * H)), ceil32(int(scale * W)))
            acc += self._scale_probs(rgb, modal, new_hw, (H, W))
            if flip:
                acc += torch.flip(self._scale_probs(rgb_f, modal_f, new_hw,
                                                    (H, W)), dims=[2])
        return acc

    def _true_extent_batches(self, batches):
        """Split variable-size canvas batches into true-extent groups.

        `Loader._collate` pads mixed-shape batches to a common canvas and
        records each sample's extent in batch["hw"]. Evaluating the canvas
        would let pad pixels into the receptive field and take the MSF
        geometry from the canvas, so each sample is cropped to its true
        (h, w) on the host and samples of one geometry are re-batched.

        Same-geometry samples are pooled across the whole stream and
        flushed in full groups of `cap`, the largest incoming batch, so a
        long mixed val set runs one (geometry, cap) shape per geometry. The tail of a geometry pads to `cap` if that geometry
        already flushed a full group, else to the next power of two; pads
        repeat the last sample with gt = background, so the hist is exact.
        The true sample count travels as batch["nb"]. Batches without "hw"
        pass through unchanged.
        """
        cap = None
        pending = {}  # (h, w) -> list of per-sample dicts
        flushed = set()  # geometries that emitted a full cap group

        def emit(items, bucket):
            nb = len(items)
            pad = bucket - nb
            sub = {"nb": nb}
            for k in items[0]:
                vals = [it[k] for it in items]
                v0 = vals[0]
                if isinstance(v0, np.ndarray) and v0.ndim >= 2:
                    if pad:
                        fill = (np.full_like(v0, self.background)
                                if k == "gt" else vals[-1])
                        vals = vals + [fill] * pad
                    sub[k] = np.stack(vals)
                elif isinstance(v0, np.ndarray):
                    # per-sample 1-D metadata rows: stacked unpadded,
                    # consumers index by [:nb]
                    sub[k] = np.stack(vals)
                else:
                    sub[k] = vals  # per-sample scalars/strings (e.g. fn)
            return sub

        for batch in batches:
            hw = batch.get("hw")
            if hw is None:
                yield batch
                continue
            hw = _host(hw)
            if cap is None or len(hw) > cap:
                cap = len(hw)
            for i, (h, w) in enumerate(hw):
                h, w = int(h), int(w)
                item = {}
                for k, v in batch.items():
                    if k == "hw":
                        continue
                    if hasattr(v, "ndim") and v.ndim >= 3:
                        item[k] = _host(v[i, :h, :w])
                    elif isinstance(v, (list, tuple)):
                        item[k] = v[i]
                    elif hasattr(v, "ndim") and v.ndim >= 1 \
                            and v.shape[0] == len(hw):
                        item[k] = _host(v[i])
                    else:
                        # batch-level scalar: replicated per sample so a
                        # cross-batch group cannot mix values
                        item[k] = v
                pend = pending.setdefault((h, w), [])
                pend.append(item)
                if len(pend) >= cap:
                    yield emit(pend[:cap], cap)
                    del pend[:cap]
                    flushed.add((h, w))
        for geom, pend in pending.items():
            if pend:
                bucket = cap if geom in flushed \
                    else 1 << (len(pend) - 1).bit_length()
                yield emit(pend, bucket)

    def _group(self, batch):
        """(rgb, modal, gt) of one group on the device, and its true count."""
        nb = batch.get("nb", batch["rgb"].shape[0])
        return (self._to_device(batch["rgb"]),
                self._to_device(batch["modal_x"]),
                self._to_device(batch["gt"]), nb)

    @torch.inference_mode()
    def evaluate(self, batches, save_hook: Optional[Callable] = None
                 ) -> Metrics:
        """Single-scale (or sliding-window) eval. save_hook(pred [nb,H,W]
        numpy, batch) sees each group's labels."""
        metrics = Metrics(self.num_classes, self.background)
        for batch in self._true_extent_batches(batches):
            rgb, modal, gt, nb = self._group(batch)
            probs = self.single_probs(rgb, modal, gt.shape[1:3])
            pred = torch.argmax(probs, dim=-1)
            metrics.update_hist(confusion_matrix(pred, gt, self.num_classes,
                                                 self.background))
            if save_hook is not None:
                save_hook(pred[:nb].cpu().numpy(), batch)
        return metrics

    @torch.inference_mode()
    def evaluate_msf(self, batches, scales: Sequence[float], flip: bool,
                     save_hook: Optional[Callable] = None) -> Metrics:
        """Multi-scale + flip eval."""
        metrics = Metrics(self.num_classes, self.background)
        for batch in self._true_extent_batches(batches):
            rgb, modal, gt, nb = self._group(batch)
            hw = gt.shape[1:3] if gt.ndim == 3 else gt.shape[:2]
            acc = self.msf_probs(rgb, modal, hw, scales, flip)
            pred = torch.argmax(acc, dim=-1)
            metrics.update_hist(confusion_matrix(pred, gt, self.num_classes,
                                                 self.background))
            if save_hook is not None:
                save_hook(pred[:nb].cpu().numpy(), batch)
        return metrics
