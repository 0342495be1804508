"""wandb logging for the FSS tool (counterpart of
`dformer_tpu/runtime/wandb.py`).

wandb is optional: `WandbHook` does nothing when the package is missing,
when its run cannot start, when `cfg.use_wandb` is off, or on a rank above
0, so the tool calls it unconditionally. The run goes to the project
`cfg.wandb_project`, by default "dformer-torch".
"""

from typing import Optional


class WandbHook:
    def __init__(self, cfg, rank: int = 0, logger=None):
        self._run = None
        if not cfg.get("use_wandb", False) or rank != 0:
            return
        try:
            import wandb

            self._run = wandb.init(
                project=cfg.get("wandb_project", "dformer-torch"),
                name=cfg.get("wandb_run_name"),
                config={k: v for k, v in dict(cfg).items()
                        if isinstance(v, (int, float, str, bool, list))})
        except Exception as e:  # package missing, or the run cannot start
            if logger:
                logger.info(f"wandb disabled: {e}")

    def log(self, metrics: dict, step: Optional[int] = None):
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_fss_eval(self, epoch: int, metrics):
        """An episodic evaluation's metrics (`ops.metrics.Metrics`): epoch,
        mIoU, mean Acc, mean F1, and each class's IoU, Acc and F1 as a
        scalar of its own (wandb would turn a list under one key into a
        string)."""
        if self._run is None:
            return
        ious, miou = metrics.compute_iou()
        acc, macc = metrics.compute_pixel_acc()
        f1, mf1 = metrics.compute_f1()
        payload = {"epoch": epoch, "mIoU": miou, "mean Acc": macc,
                   "mean F1": mf1}
        for c, (i, a, f) in enumerate(zip(ious, acc, f1)):
            payload[f"IoU_cls_{c}"] = float(i)
            payload[f"Acc_cls_{c}"] = float(a)
            payload[f"F1_cls_{c}"] = float(f)
        self.log(payload)

    def finish(self):
        if self._run is not None:
            self._run.finish()
