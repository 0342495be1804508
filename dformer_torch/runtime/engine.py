"""Run set-up (counterpart of `dformer_tpu/runtime/engine.py`): the process
group, seeding, the timestamped run directories and the run's logger.

Under `torchrun` (RANK in the environment) the process joins the group
(`parallel.dist.group_from_env`: NCCL on the card, gloo on the CPU) for the
engine's `with` block, and leaves a group it started at the block's end;
rank 0 makes the run directories and every rank takes its names, so that
all write into one run. Without it, one process and no group.
"""

import contextlib
import logging
import os

import numpy as np
import torch
import torch.distributed

from dformer_torch.configs import finalize_run_dirs
from dformer_torch.parallel import dist
from dformer_torch.runtime.logger import get_logger

RUN_DIR_KEYS = ("log_dir", "tb_dir", "checkpoint_dir", "log_file",
                "val_log_file")


class Engine:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self._group = contextlib.ExitStack()
        self.distributed = self._group.enter_context(
            dist.group_from_env(device))
        self.rank, self.world_size = dist.rank(), dist.world()
        if self.rank == 0:
            finalize_run_dirs(cfg)
        if self.distributed:
            names = [{k: cfg.get(k) for k in RUN_DIR_KEYS}]
            torch.distributed.broadcast_object_list(names, src=0)
            cfg.update(names[0])
        self.logger = get_logger(cfg.log_dir, cfg.log_file, rank=self.rank)
        self.seed = int(cfg.get("seed", 8964))
        np.random.seed(self.seed)
        torch.manual_seed(self.seed)

    def data_shard(self):
        """(rank, world): this process's share of the train and val data
        (the loaders' `shard`)."""
        return self.rank, self.world_size

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
        self._group.close()
        return False


def single_process(tool: str) -> None:
    """Raise when a launcher asks `tool`, a one-process tool (the Trav
    k-fold runs, one process as in the JAX package), for more than one
    process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:
        raise NotImplementedError(
            f"{tool}: WORLD_SIZE={world}, but this tool runs as one process, "
            "as the JAX package's does; launch it without torchrun")
