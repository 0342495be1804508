"""Train checkpoints with the reference's retention policy (counterpart of
`dformer_tpu/train/checkpoint.py`, which writes orbax directories; the
port restores those too, `utils/orbax.py`).

One torch file per checkpoint, `epoch-{E}_miou_{round(M, 2)}.pth`, holding
{"model": state_dict, "optimizer": state_dict, "step", "epoch", "frozen":
the frozen parameter names}, with `epoch-{E}_miou_{M}.meta.json` beside it.
The best `keep` by (mIoU, epoch) stay. The "model" entry is what
`utils.checkpoint.load_torch_checkpoint` reads, so the eval tool loads the
file as it is.

Under a process group rank 0 writes and prunes, and every rank waits for it
at a barrier; every rank restores from the same file.
"""

import json
import os
import os.path as osp
import re
from typing import Optional, Tuple

import torch

from dformer_torch.parallel import dist

_NAME_RE = re.compile(r"epoch-(\d+)_miou_([0-9.]+)\.pth$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 5, logger=None):
        self.dir = directory
        self.keep = keep
        self.logger = logger
        os.makedirs(directory, exist_ok=True)

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def _existing(self):
        """[(miou, epoch, file name)] sorted, worst first."""
        out = []
        for name in os.listdir(self.dir):
            m = _NAME_RE.match(name)
            if m:
                out.append((float(m.group(2)), int(m.group(1)), name))
        return sorted(out)

    def save(self, trainer, epoch: int, miou: float,
             extra: Optional[dict] = None) -> str:
        """Save the trainer's model, optimizer, step and frozen names as
        epoch `epoch` with val mIoU `miou`, then drop the worst files past
        `keep`. Returns the file's path. Under a process group only rank 0
        writes, and every rank returns once the file is there."""
        stem = f"epoch-{epoch}_miou_{round(miou, 2)}"
        path = osp.abspath(osp.join(self.dir, stem + ".pth"))
        if dist.rank() == 0:
            self._write(trainer, path, stem, epoch, miou, extra)
        if dist.active():
            torch.distributed.barrier()
        return path

    def _write(self, trainer, path, stem, epoch, miou, extra):
        write_checkpoint(trainer, epoch, path)
        with open(osp.join(self.dir, stem + ".meta.json"), "w") as f:
            json.dump(dict(epoch=epoch, miou=miou, **(extra or {})), f)
        self._log(f"saved checkpoint {stem}.pth")

        existing = self._existing()
        while len(existing) > self.keep:
            worst = existing.pop(0)[2]
            os.remove(osp.join(self.dir, worst))
            meta = osp.join(self.dir, worst[:-len(".pth")] + ".meta.json")
            if osp.exists(meta):
                os.remove(meta)
            self._log(f"removed worst checkpoint {worst}")

    def latest(self) -> Optional[Tuple[str, int]]:
        """(path, epoch) of the newest checkpoint by epoch, or None: a
        resume continues from the most recent epoch, not the best one."""
        existing = self._existing()
        if not existing:
            return None
        newest = max(existing, key=lambda t: t[1])
        return osp.join(self.dir, newest[2]), newest[1]

    def best(self) -> Optional[Tuple[str, int, float]]:
        """(path, epoch, miou) of the best checkpoint by metric, or None."""
        existing = self._existing()
        if not existing:
            return None
        miou, epoch, name = existing[-1]
        return osp.join(self.dir, name), epoch, miou

    def restore(self, trainer, path: str) -> int:
        """Load `path` into the trainer's model, optimizer and step; returns
        the epoch to continue with (the saved epoch + 1). A checkpoint whose
        frozen set differs from the trainer's is refused: the optimizer's
        state is indexed by the position of each parameter in its groups.
        A directory is read as the JAX trainer's orbax checkpoint
        (`utils/orbax.restore_trainer`)."""
        if osp.isdir(path):
            from dformer_torch.utils.orbax import restore_trainer

            epoch = restore_trainer(trainer, path)
            self._log(f"restored orbax checkpoint {path} (step "
                      f"{trainer.step}, resume at epoch {epoch})")
            return epoch
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
        if sorted(ckpt["frozen"]) != sorted(trainer.frozen):
            raise ValueError(
                f"checkpoint {path} froze {len(ckpt['frozen'])} parameters, "
                f"the model {len(trainer.frozen)}; the optimizer groups "
                "differ, so its state cannot be restored")
        trainer.model.load_state_dict(ckpt["model"], strict=True)
        trainer.optimizer.load_state_dict(ckpt["optimizer"])
        trainer.step = int(ckpt["step"])
        epoch = int(ckpt["epoch"])
        self._log(f"restored checkpoint {path} (step {trainer.step}, resume "
                  f"at epoch {epoch + 1})")
        return epoch + 1


def write_checkpoint(trainer, epoch: int, path: str) -> None:
    """The trainer's model, optimizer, step and frozen names as epoch
    `epoch` in the torch file `path` (through a temporary file)."""
    tmp = path + ".tmp"
    torch.save(dict(model=trainer.model.state_dict(),
                    optimizer=trainer.optimizer.state_dict(),
                    step=int(trainer.step), epoch=int(epoch),
                    frozen=list(trainer.frozen)), tmp)
    os.replace(tmp, path)


def state_difference(a, b) -> Optional[str]:
    """The first tensor in which two trainers' model or optimizer state
    differ (None when every one is equal): what `restore` must give back."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    if list(sa) != list(sb):
        return "model state names"
    for name, x in sa.items():
        if not torch.equal(x, sb[name]):
            return f"model {name}"
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if [g["params"] for g in sa["param_groups"]] != \
            [g["params"] for g in sb["param_groups"]]:
        return "optimizer groups"
    if list(sa["state"]) != list(sb["state"]):
        return "optimizer state indices"
    for k, st in sa["state"].items():
        if list(st) != list(sb["state"][k]):
            return f"optimizer state {k} names"
        for key, v in st.items():
            if not torch.equal(torch.as_tensor(v).cpu(),
                               torch.as_tensor(sb["state"][k][key]).cpu()):
                return f"optimizer state {k} {key}"
    return None
