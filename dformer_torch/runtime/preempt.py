"""Graceful preemption (the port's copy of
`dformer_tpu/runtime/preempt.py`).

Managed clusters deliver SIGTERM with a grace window before eviction. The
guard turns the first SIGTERM or SIGINT into a cooperative stop request:
the trainer finishes the step in flight, the train tool checkpoints the live
state and exits 0, and the next run resumes from it
(`CheckpointManager.latest` picks the newest epoch). A second SIGINT
restores Python's default KeyboardInterrupt, so an operator can still
hard-kill.
"""

import signal


class PreemptionGuard:
    """Installs handlers; `requested` flips True on the first signal."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT), logger=None):
        self._signals = tuple(signals)
        self._logger = logger
        self._requested = False
        self._prev = {}

    @property
    def requested(self) -> bool:
        return self._requested

    def install(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handle(self, signum, frame):
        self._requested = True
        msg = (f"received signal {signal.Signals(signum).name}: finishing "
               "the current step, checkpointing, then exiting cleanly "
               "(send SIGINT again to abort immediately)")
        if self._logger:
            self._logger.info(msg)
        else:
            print(msg, flush=True)
        if signum == signal.SIGINT and signal.SIGINT in self._prev:
            # second ctrl-C = operator override
            signal.signal(signal.SIGINT, self._prev.pop(signal.SIGINT))


class StopAfter:
    """A guard whose stop is requested from its n-th read on, for a
    preemption at a chosen point of a run: `Trainer.run_epoch` reads it
    before every step and the train tool once after each epoch."""

    def __init__(self, n: int):
        self.n, self.reads = n, 0

    @property
    def requested(self) -> bool:
        self.reads += 1
        return self.reads >= self.n
