"""Run logging (counterpart of `dformer_tpu/runtime/logger.py`): INFO to
stdout and to the run's log file on rank 0; on the other ranks WARNING and
above to stdout only."""

import logging
import os
import sys
from typing import Optional

_FORMAT = "%(asctime)s %(levelname)s %(message)s"


def get_logger(log_dir: Optional[str] = None, log_file: Optional[str] = None,
               rank: int = 0, name: str = "dformer_torch") -> logging.Logger:
    """The logger `name`, its handlers set anew for this run (a second run
    in the same process writes to its own log file)."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if rank == 0 else logging.WARNING)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter(_FORMAT, "%y%m%d %H:%M:%S")
    handlers = [logging.StreamHandler(sys.stdout)]
    if rank == 0 and log_dir and log_file:
        os.makedirs(log_dir, exist_ok=True)
        handlers.append(logging.FileHandler(log_file))
    for h in handlers:
        h.setFormatter(fmt)
        logger.addHandler(h)
    return logger
