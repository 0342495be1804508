"""The port's run-time hooks on the CPU: the logger's and the TensorBoard
writer's rank behaviour, and `WandbHook`'s payload against the JAX
`WandbHook`'s, both talking to the same stub `wandb` module (the package is
not installed). The engine's shared run directories under a process group
are checked in tests/test_torch_dist.py's worker."""

import logging
import sys
import types

import numpy as np
import pytest

from dformer_torch.config import AttrDict as TAttrDict
from dformer_torch.ops.metrics import Metrics as TMetrics
from dformer_torch.runtime import tb as t_tb
from dformer_torch.runtime.logger import get_logger
from dformer_torch.runtime.wandb import WandbHook as TWandbHook
from dformer_tpu.config import AttrDict as JAttrDict
from dformer_tpu.ops.metrics import Metrics as JMetrics
from dformer_tpu.runtime.wandb import WandbHook as JWandbHook


class WandbStub(types.ModuleType):
    """A `wandb` module that records what it is given."""

    def __init__(self):
        super().__init__("wandb")
        self.inits, self.logged, self.finished = [], [], False

    def init(self, **kwargs):
        self.inits.append(kwargs)
        return self

    def log(self, metrics, step=None):
        self.logged.append(dict(metrics))

    def finish(self):
        self.finished = True


@pytest.mark.parametrize("rank", [0, 1])
def test_logger_rank(tmp_path, rank):
    """Rank 0 logs INFO to stdout and the run's file; a rank above 0 logs
    WARNING and above to stdout only, and makes no file."""
    log_file = str(tmp_path / "run" / "log.log")
    log = get_logger(str(tmp_path / "run"), log_file, rank=rank,
                     name=f"dformer_torch_test_{rank}")
    log.info("info line")
    log.warning("warning line")
    files = [h for h in log.handlers if isinstance(h, logging.FileHandler)]
    assert log.level == (logging.INFO if rank == 0 else logging.WARNING)
    if rank == 0:
        files[0].flush()
        text = open(log_file).read()
        assert "info line" in text and "warning line" in text
    else:
        assert not files and not (tmp_path / "run").exists()
    for h in list(log.handlers):
        log.removeHandler(h)
        h.close()


def test_tb_writer_writes_on_rank_0_only(tmp_path, monkeypatch):
    """`TBWriter` opens a SummaryWriter on rank 0 only; the others write
    nothing (a stub tensorboardX records the calls)."""
    calls = []

    class Writer:
        def __init__(self, logdir):
            calls.append(("open", logdir))

        def add_scalar(self, tag, value, step):
            calls.append((tag, value, step))

        def close(self):
            calls.append(("close",))

    stub = types.ModuleType("tensorboardX")
    stub.SummaryWriter = Writer
    monkeypatch.setitem(sys.modules, "tensorboardX", stub)
    for rank in (1, 0):
        w = t_tb.TBWriter(str(tmp_path / f"tb{rank}"), rank=rank)
        w.scalar("train/loss", np.float32(0.5), 3)
        w.close()
    assert calls == [("open", str(tmp_path / "tb0")),
                     ("train/loss", 0.5, 3), ("close",)]


def test_wandb_hook_matches_jax(monkeypatch):
    """The same metrics through both hooks, each with its own stub `wandb`:
    the same init arguments (the config names the project: the hooks'
    defaults are their packages' names), the same payload (epoch, mIoU,
    mean Acc, mean F1, each class's IoU, Acc and F1; floats equal to
    1e-12), `finish` reaches the run; rank 1 and use_wandb off send
    nothing."""
    rng = np.random.RandomState(0)
    hist = rng.randint(0, 50, (3, 3)).astype(np.int64)
    sent = []
    for hook_cls, cfg_cls, metrics_cls in (
            (TWandbHook, TAttrDict, TMetrics),
            (JWandbHook, JAttrDict, JMetrics)):
        stub = WandbStub()
        monkeypatch.setitem(sys.modules, "wandb", stub)
        cfg = cfg_cls(use_wandb=True, wandb_project="dformer",
                      wandb_run_name="r", lr=1e-3, nepochs=2, tag="fss",
                      shape=(1, 2))
        m = metrics_cls(3, 255)
        m.hist = hist.copy()
        for off in (hook_cls(cfg, rank=1),
                    hook_cls(cfg_cls(use_wandb=False))):
            off.log_fss_eval(1, m)
            off.finish()
        assert not stub.inits and not stub.logged
        hook = hook_cls(cfg)
        hook.log_fss_eval(2, m)
        hook.finish()
        assert stub.finished
        sent.append((stub.inits, stub.logged))
    (t_inits, t_logged), (j_inits, j_logged) = sent
    assert t_inits == j_inits
    assert len(t_logged) == len(j_logged) == 1
    assert list(t_logged[0]) == list(j_logged[0])
    for key, value in j_logged[0].items():
        np.testing.assert_allclose(t_logged[0][key], value, rtol=1e-12,
                                   err_msg=key)


def test_wandb_hook_default_project(monkeypatch):
    """Without cfg.wandb_project the port's run goes to "dformer-torch"."""
    stub = WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    TWandbHook(TAttrDict(use_wandb=True)).finish()
    assert [i["project"] for i in stub.inits] == ["dformer-torch"]
    assert stub.finished
