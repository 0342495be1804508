"""TensorBoard scalars (the port's copy of `dformer_tpu/runtime/tb.py`):
a tensorboardX SummaryWriter into the run's tb_dir, or nothing when
tensorboardX is missing."""


class TBWriter:
    def __init__(self, logdir: str):
        self._w = None
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
