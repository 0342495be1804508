"""Run set-up (counterpart of `dformer_tpu/runtime/engine.py`): seeding,
the timestamped run directories and the run's logger, on one process.

Distributed training (DDP over NCCL, SyncBatchNorm) is not ported yet: a
launcher's WORLD_SIZE > 1 raises.
"""

import logging
import os

import numpy as np
import torch

from dformer_torch.configs import finalize_run_dirs
from dformer_torch.runtime.logger import get_logger


class Engine:
    def __init__(self, cfg):
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world > 1:
            raise NotImplementedError(
                f"WORLD_SIZE={world}: distributed training is not ported yet "
                "(ROADMAP.md Queue 1, item 12: distributed training)")
        self.cfg = cfg
        finalize_run_dirs(cfg)
        self.logger = get_logger(cfg.log_dir, cfg.log_file)
        self.seed = int(cfg.get("seed", 8964))
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if exc_type is not None:
            self.logger.error(
                f"exit with exception {exc_type.__name__}: {exc_val}")
        for h in list(self.logger.handlers):
            if isinstance(h, logging.FileHandler):
                self.logger.removeHandler(h)
                h.close()
        return False
