"""TensorBoard scalars (the port's copy of `dformer_tpu/runtime/tb.py`):
a tensorboardX SummaryWriter into the run's tb_dir on rank 0, or nothing
on the other ranks and when tensorboardX is missing."""


class TBWriter:
    def __init__(self, logdir: str, rank: int = 0):
        self._w = None
        if rank != 0:
            return
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            return
        self._w = SummaryWriter(logdir)

    def scalar(self, tag: str, value, step: int):
        if self._w is not None:
            self._w.add_scalar(tag, float(value), int(step))

    def close(self):
        if self._w is not None:
            self._w.close()
