"""The port's training loop and tool against the JAX package on the CPU, fp32, at
a depth-1 narrow model: SGDM and AdamW with a frozen mask against optax,
the coverage audit, the checkpoint manager's retention, resume and
preemption rescue, `Trainer.run_epoch` against the JAX `Trainer` on the
same uint8 batches and augmentation draws, the pretrained encoder load and
its frozen set, and `tools.train.run` end to end with the eval tool
reading its checkpoint."""

import glob
import os.path as osp
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dformer_torch import configs as t_configs
from dformer_torch import entry
from dformer_torch.data import augment as t_aug
from dformer_torch.eval import draw as t_draw
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.decoders import ham as t_ham
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import eval as t_eval_tool
from dformer_torch.tools import train as t_train_tool
from dformer_torch.train import loop as t_loop
from dformer_torch.train.audit import coverage_audit as t_coverage_audit
from dformer_torch.runtime.preempt import StopAfter
from dformer_torch.train.checkpoint import CheckpointManager as TCkpt
from dformer_torch.train.checkpoint import state_difference
from dformer_torch.train.optim import make_optimizer as t_make_optimizer
from dformer_torch.train.optim import make_schedule as t_make_schedule
from dformer_torch.train.optim import \
    trainable_mask_from_matched as t_trainable_mask
from dformer_torch.utils.checkpoint import load_checkpoint
from dformer_torch.utils.checkpoint import \
    load_pretrained_encoder as t_load_pretrained
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict as JAttrDict
from dformer_tpu.eval import draw as j_draw
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.decoders import ham as j_ham
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.train.audit import coverage_audit as j_coverage_audit
from dformer_tpu.train.checkpoint import CheckpointManager as JCkpt
from dformer_tpu.train.loop import TrainState, Trainer as JTrainer
from dformer_tpu.train.optim import make_optimizer as j_make_optimizer
from dformer_tpu.train.optim import \
    trainable_mask_from_matched as j_trainable_mask
from dformer_tpu.utils.convert import (convert_encoder_state,
                                       convert_model_state,
                                       load_into_variables, strip_prefixes)

from test_audit_and_hooks import _toy_setup
from test_torch_augment import _jax_draws
from test_torch_model import _random_variables
from test_torch_train import _flax_path, _IdentityDropout

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
B, HW, CLASSES = 2, (64, 96), 11


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The models here are tiny: one intra-op thread is as fast alone and
    does not oversubscribe the cores that other test processes share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def narrow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        yield


def _cfg(**over):
    """NYUDepthv2's config cut to the narrow model, 64x96, batch 2, two
    iterations per epoch, no warm-up, evaluation every epoch."""
    cfg = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.update(backbone="DFormer-Narrow1", image_height=HW[0],
               image_width=HW[1], num_classes=CLASSES, batch_size=B,
               niters_per_epoch=2, nepochs=2, warm_up_epoch=0,
               drop_path_rate=0.0, num_train_imgs=4, num_eval_imgs=2,
               checkpoint_start_epoch=0, lr=1e-3, pretrained_model=None)
    cfg.update(over)
    return cfg


def _trainer(cfg, **kw):
    model, opt, sched, mask = entry.build_training(cfg, None, "cpu", seed=0)
    return t_loop.Trainer(model, opt, sched, cfg, seed=cfg.seed,
                          trainable_mask=mask, **kw)


class _Batches:
    """A loader over fixed uint8 batches."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


class _LossRecorder:
    def __init__(self):
        self.iter_losses = []

    def scalar(self, tag, value, step):
        if tag == "train/loss_iter":
            self.iter_losses.append(float(value))


def _uint8_batches(rng, n, canvas=(80, 112)):
    return [dict(rgb=rng.randint(0, 256, (B, *canvas, 3)).astype(np.uint8),
                 gt=rng.randint(0, CLASSES, (B, *canvas)).astype(np.int32),
                 modal_x=rng.randint(0, 256, (B, *canvas, 3)).astype(np.uint8))
            for _ in range(n)]


# --- optimizer and audit ---------------------------------------------------

@pytest.mark.parametrize("kind", ["AdamW", "SGDM"])
def test_optimizer_with_frozen_mask_matches_optax(narrow, kind):
    """3 steps on the same gradients from the same numpy-drawn parameters:
    the JAX package's optimizer (optax, frozen leaves routed to
    set_to_zero) and the port's, with the stem and stage 0 of the encoder
    frozen. Each parameter within 1e-6 of its leaf's largest magnitude
    (AdamW: optax rounds its bias corrections in fp32, torch in fp64);
    frozen ones bit-unchanged."""
    cfg = _cfg(optimizer=kind, lr=1e-2, weight_decay=0.05, momentum=0.9,
               nepochs=3, niters_per_epoch=1)
    tmodel = t_build_model(cfg, device="cpu")
    rng = np.random.RandomState(4)
    with torch.no_grad():
        for p in tmodel.parameters():
            p.copy_(torch.from_numpy(
                0.2 * rng.randn(*p.shape).astype(np.float32)))
    names = [n for n, _ in tmodel.named_parameters()]
    frozen = [n for n in names if n.startswith(
        ("encoder_backbone.stages.0.", "encoder_backbone.downsample_layers.0.",
         "encoder_backbone.downsample_layers_e.0."))]
    tmask = t_trainable_mask(tmodel, frozen)
    assert sorted(n for n in names if not tmask[n]) == sorted(frozen)

    def to_jax(arrays):
        return convert_model_state(arrays)[0]

    params = to_jax({n: p.detach().numpy()
                     for n, p in tmodel.named_parameters()})
    jmask = j_trainable_mask(params, [
        _flax_path(n, p.detach().numpy()) for n, p in
        tmodel.named_parameters() if n in frozen])
    tx = j_make_optimizer(JAttrDict(cfg.copy()), params, jmask)
    opt_state = jax.jit(tx.init)(params)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    topt = t_make_optimizer(cfg, tmodel, tmask)
    sched = t_make_schedule(cfg)
    before = {n: p.detach().clone() for n, p in tmodel.named_parameters()}
    rng = np.random.RandomState(5)
    for k in range(3):
        grads = {n: rng.randn(*p.shape).astype(np.float32)
                 for n, p in tmodel.named_parameters()}
        params, opt_state = jax_step(to_jax(grads), opt_state, params)
        for group in topt.param_groups:
            group["lr"] = sched(k)
        for n, p in tmodel.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        topt.step()

    got = convert_model_state({n: p.detach().numpy()
                               for n, p in tmodel.named_parameters()})[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(want_leaves) == len(got_leaves) == len(names)
    for path, want in want_leaves:
        want = np.asarray(want)
        diff = np.abs(got_leaves[path] - want).max()
        assert diff <= 1e-6 * max(np.abs(want).max(), 1e-6), (path, diff)
    for n, p in tmodel.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == (n not in frozen), n


def _audit_cases():
    """The cases of tests/test_audit_and_hooks.py: (grad flags, update
    flags, mask tree or None) on the toy step's paths."""
    paths, gnz, unz, mask = _toy_setup()
    enc = paths.index(("encoder_backbone", "kernel"))
    bias = paths.index(("decode_head", "bias"))
    g_enc = gnz.copy()
    g_enc[enc] = True
    g_cut = gnz.copy()
    g_cut[enc] = False
    g_cut_bias = g_cut.copy()
    g_cut_bias[bias] = False
    all_train = {"decode_head": {"kernel": True, "bias": True},
                 "encoder_backbone": {"kernel": True}}
    head_frozen = {"decode_head": {"kernel": False, "bias": True},
                   "encoder_backbone": {"kernel": False}}
    return paths, {
        "correct": (gnz, unz, mask),
        "mislabeled_frozen": (g_enc, unz, all_train),
        "unexpectedly_updated": (gnz, unz, head_frozen),
        "disconnected": (g_cut, unz, None),
        "zero_grad_bias": (g_cut_bias, unz, None),
        "deferred_at_lr_0": (gnz, np.zeros_like(unz), mask)}


@pytest.mark.parametrize("case", ["correct", "mislabeled_frozen",
                                  "unexpectedly_updated", "disconnected",
                                  "zero_grad_bias", "deferred_at_lr_0"])
def test_coverage_audit_matches_jax(case):
    paths, cases = _audit_cases()
    gnz, unz, mask = cases[case]
    quiet = type("Quiet", (), {"info": lambda s, m: None,
                               "warning": lambda s, m: None})()
    want = j_coverage_audit(paths, gnz, unz, mask, logger=quiet)
    tmask = None if mask is None else {
        ".".join(str(k.key) for k in p): bool(v)
        for p, v in jax.tree_util.tree_flatten_with_path(mask)[0]}
    got = t_coverage_audit(paths, gnz, unz, tmask, logger=quiet)
    assert got == want


# --- checkpoints -------------------------------------------------------------

SAVES = [(1, 10.0), (2, 12.5), (3, 11.0), (4, 12.5), (5, 9.0), (6, 13.333),
         (7, 8.0)]


def test_checkpoint_retention_latest_best_match_jax(tmp_path):
    """7 saves into each manager, keep 5: the same files (the port's with a
    .pth suffix), the same newest and best."""
    params = {"w": jnp.ones((2, 2))}
    tx = optax.sgd(0.1)
    jstate = TrainState(step=jnp.asarray(0), params=params, batch_stats={},
                        opt_state=jax.jit(tx.init)(params))
    model = torch.nn.Linear(2, 2)
    tstate = type("State", (), dict(
        model=model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1),
        step=0, frozen=[]))()
    jm = JCkpt(str(tmp_path / "jax"), keep=5)
    tm = TCkpt(str(tmp_path / "port"), keep=5)
    for epoch, miou in SAVES:
        jm.save(jstate, epoch, miou)
        tm.save(tstate, epoch, miou)

    def files(d):
        return sorted(f.replace(".pth", "") for f in
                      map(osp.basename, glob.glob(str(tmp_path / d / "*"))))

    assert files("port") == files("jax")
    assert len([f for f in files("port") if "meta" not in f]) == 5
    (jpath, jepoch), (tpath, tepoch) = jm.latest(), tm.latest()
    assert tepoch == jepoch == 6 and tpath == jpath.replace("jax", "port") \
        + ".pth"
    (jpath, jepoch, jmiou), (tpath, tepoch, tmiou) = jm.best(), tm.best()
    assert (tepoch, tmiou) == (jepoch, jmiou) == (6, 13.33)


def test_resume_equals_straight_run(narrow, tmp_path):
    """4 steps straight, or 2 + save + restore into a fresh trainer + 2:
    the same losses, parameters, BatchNorm statistics, optimizer state and
    step, bit for bit (the augment draws follow (seed, epoch, iteration),
    the step's draws (seed, step))."""
    cfg = _cfg()
    batches = _Batches(_uint8_batches(np.random.RandomState(0), 2))
    rec_a, rec_b = _LossRecorder(), _LossRecorder()
    a = _trainer(cfg, tb=rec_a)
    for epoch in (1, 2):
        a.run_epoch(batches, epoch)

    b = _trainer(cfg, tb=rec_b)
    b.run_epoch(batches, 1)
    path = TCkpt(str(tmp_path)).save(b, 1, 5.0)
    c = _trainer(cfg, tb=rec_b)  # blank, as a new process would be
    assert TCkpt(str(tmp_path)).restore(c, path) == 2 and c.step == 2
    c.run_epoch(batches, 2)

    assert len(rec_a.iter_losses) == 4
    assert rec_a.iter_losses == rec_b.iter_losses
    assert a.step == c.step == 4
    assert state_difference(a, c) is None


# --- the train tool ------------------------------------------------------------

def _tool_args(*extra):
    return t_train_tool.parse_args(
        ["--config=local_configs.Test.Narrow", "--device=cpu",
         "--synthetic-data", "--no-mst", "--no-amp", "--val_batch_size=2",
         *extra])


@pytest.fixture(scope="module")
def tool_run(narrow, tmp_path_factory):
    """(config, result) of one `tools.train.run` on the CPU: 2 iterations,
    evaluation, an epoch-1 checkpoint."""
    cfg = _cfg(nepochs=1, log_dir_base=str(tmp_path_factory.mktemp("run")))
    return cfg, t_train_tool.run(cfg, _tool_args())


def test_train_tool_checkpoint_loads_in_the_eval_tool(narrow, tool_run,
                                                      monkeypatch, capsys):
    """`run` on the CPU: 2 iterations, evaluation, an epoch-1 checkpoint;
    the eval tool reads it and gets the train tool's mIoU."""
    cfg, out = tool_run
    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Test.Narrow",
                        lambda: _cfg())
    assert out["trainer"].step == 2 and np.isfinite(out["losses"][1])
    (path,) = glob.glob(osp.join(cfg.checkpoint_dir, "epoch-1_miou_*.pth"))
    assert path.endswith(f"epoch-1_miou_{round(out['best_miou'], 2)}.pth")
    capsys.readouterr()
    t_eval_tool.main(["--config=local_configs.Test.Narrow", "--device=cpu",
                      "--synthetic-data", "--no-mst", "--val_batch_size=2",
                      f"--continue_fpath={path}"])
    printed = capsys.readouterr().out
    miou = re.search(r"'mIoU': (?:np\.float64\()?([0-9.]+)", printed)
    assert miou and float(miou.group(1)) == out["best_miou"], printed
    # the file's weights are the trained model's
    fresh = load_checkpoint(t_build_model(cfg, device="cpu"), path)
    trained = out["trainer"].model.eval()
    x = torch.from_numpy(np.random.RandomState(3).randn(1, *HW, 3)
                         .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(fresh.eval()(x, x), trained(x, x))


def test_train_log_parses_as_jax_does(tool_run):
    """The report drawer's series of the train tool's log: the port's
    `parse_log_metrics` gives the JAX one's, the epoch's loss and mIoU."""
    cfg, out = tool_run
    losses, mious = t_draw.parse_log_metrics(cfg.log_file)
    assert (losses, mious) == j_draw.parse_log_metrics(cfg.log_file)
    assert [e for e, _ in losses] == [e for e, _ in mious] == [1]
    assert mious[0][1] == pytest.approx(out["best_miou"], abs=0.01)


def test_train_tool_rescue_checkpoint_resumes(narrow, tmp_path):
    """A preemption after the first step of epoch 1: the tool saves a rescue
    checkpoint at step 1 and stops; a second run resumes from it at epoch 2
    and ends at step 3 (as tests/test_preempt.py does for JAX)."""
    cfg = _cfg(log_dir_base=str(tmp_path / "a"))
    out = t_train_tool.run(cfg, _tool_args(), guard=StopAfter(2))
    assert out["trainer"].step == 1 and 1 not in out["eval_seconds"]
    path, epoch = out["checkpoints"].latest()
    assert epoch == 1 and osp.exists(path.replace(".pth", ".meta.json"))
    cfg = _cfg(log_dir_base=str(tmp_path / "b"))
    out = t_train_tool.run(cfg, _tool_args(f"--continue_fpath={path}"))
    assert out["trainer"].step == 3 and list(out["losses"]) == [2]


def test_train_tool_refuses_what_is_not_ported(narrow, tmp_path):
    cfg = _cfg(log_dir_base=str(tmp_path / "run"))
    # the native loader decodes files on disk: synthetic data has none
    with pytest.raises(ValueError, match="synthetic data has none"):
        t_train_tool.run(cfg, _tool_args("--native-loader"))


# --- the Trainer against JAX's -------------------------------------------------

def test_run_epoch_matches_jax_trainer(narrow, monkeypatch):
    """2 iterations of `Trainer.run_epoch` and of the JAX `Trainer` from the
    same numpy-drawn weights on the same uint8 batches, with the JAX
    Trainer's augmentation draws handed to the port, dropout off and the
    NMF bases pinned on both sides."""
    cfg = _cfg(optimizer="AdamW")
    jcfg = JAttrDict(cfg.copy())
    jmodel = j_build_model(jcfg, pallas="off")
    zeros = jnp.zeros((B, *HW, 3))
    variables = _random_variables(
        dict(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), zeros,
                            zeros)), seed=6)
    tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)

    rng = np.random.RandomState(7)
    bases = rng.rand(B, 512, 64).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    monkeypatch.setattr(j_ham, "Dropout", _IdentityDropout)
    monkeypatch.setattr(j_ham, "_uniform_bases",
                        lambda key, b, d, r: jnp.asarray(bases))
    monkeypatch.setattr(t_ham, "uniform_bases",
                        lambda *a, **k: torch.from_numpy(bases))
    tmodel.decode_head.dropout.rate = 0.0
    batches = _Batches(_uint8_batches(rng, 2))
    epoch, n_scales = 1, len(cfg.train_scale_array)
    draws = [_jax_draws(jax.random.fold_in(jax.random.PRNGKey(cfg.seed),
                                           epoch * 100003 + it), B, n_scales)
             for it in range(2)]
    monkeypatch.setattr(
        t_aug, "train_augment_draws",
        lambda b, n, gen: tuple(torch.from_numpy(np.array(d))
                                for d in draws.pop(0)))

    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = j_make_optimizer(jcfg, params)
    state = TrainState(
        step=jnp.asarray(0), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax.jit(tx.init)(params))
    want, got = _LossRecorder(), _LossRecorder()
    JTrainer(jmodel, state, tx, jcfg, tb=want, seed=cfg.seed).run_epoch(
        batches, epoch)
    trainer = t_loop.Trainer(tmodel, t_make_optimizer(cfg, tmodel),
                             t_make_schedule(cfg), cfg, seed=cfg.seed,
                             tb=got)
    mean = trainer.run_epoch(batches, epoch)
    assert not draws and trainer.step == 2 and trainer._audited
    assert len(got.iter_losses) == len(want.iter_losses) == 2
    for a, b in zip(got.iter_losses, want.iter_losses):
        assert abs(a - b) <= 1e-4 * abs(b), (got.iter_losses,
                                             want.iter_losses)
    assert mean == pytest.approx(np.mean(got.iter_losses))


# --- the pretrained encoder ------------------------------------------------------

def test_pretrained_load_and_frozen_set_match_jax(narrow, tmp_path):
    """A backbone file with "module." / "backbone." prefixes and keys the
    encoder lacks: the port's matched names and frozen set against the JAX
    package's convert_encoder_state + load_into_variables +
    trainable_mask_from_matched, mapped through the port's converter; the
    optimizer groups of that frozen set survive a save and restore, and a
    trainer with another frozen set is refused."""
    cfg = _cfg()
    torch.manual_seed(1)
    donor = t_build_model(cfg, device="cpu").encoder_backbone.state_dict()
    sd = {}
    for i, (k, v) in enumerate(donor.items()):
        if k.startswith("stages.3."):  # not in the file: stays trainable
            continue
        prefix = ("backbone.", "module.", "backbone.module.", "")[i % 4]
        sd[prefix + k] = v + 0.5
    sd["module.head.weight"] = torch.ones(10, 256)
    sd["norm.bias"] = torch.ones(256)
    path = str(tmp_path / "pretrained.pth")
    torch.save({"state_dict": sd}, path)

    cfg.pretrained_model = path
    model, opt, sched, mask = entry.build_training(cfg, None, "cpu", seed=0)
    matched = t_load_pretrained(t_build_model(cfg, device="cpu"), path)
    frozen = sorted(n for n, t in mask.items() if not t)
    assert frozen == matched and matched
    assert all(not n.startswith("encoder_backbone.stages.3.") for n in frozen)
    enc = model.encoder_backbone.state_dict()
    assert all(torch.equal(enc[k], donor[k] + 0.5)
               for k in donor if not k.startswith("stages.3."))

    jmodel = j_build_model(JAttrDict(cfg.copy()), pallas="off")
    zeros = jnp.zeros((1, *HW, 3))
    variables = jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), zeros, zeros))
    p, s = convert_encoder_state(strip_prefixes(
        {k: v.numpy() for k, v in sd.items()}))
    _, jmatched = load_into_variables(variables, {"encoder_backbone": p},
                                      {"encoder_backbone": s})
    jmask = j_trainable_mask(variables["params"], jmatched)
    frozen_tree = jax.tree.map(lambda t, v: v if not t else None, jmask,
                               variables["params"])
    jfrozen = sorted(from_jax_variables({"params": _prune(frozen_tree)}))
    jnames = sorted(from_jax_variables({"params": _prune(_subtree(
        variables["params"], jmatched))}))
    assert jnames == matched and jfrozen == frozen

    trainer = t_loop.Trainer(model, opt, sched, cfg, trainable_mask=mask)
    trainer.run_epoch(_Batches(_uint8_batches(np.random.RandomState(2), 1)), 1)
    ckpt = str(tmp_path / "ckpt")
    saved = TCkpt(ckpt).save(trainer, 1, 1.0)
    again = t_loop.Trainer(*entry.build_training(cfg, None, "cpu")[:3], cfg,
                           trainable_mask=mask)
    assert TCkpt(ckpt).restore(again, saved) == 2
    want, got = trainer.optimizer.state_dict(), again.optimizer.state_dict()
    assert [len(g["params"]) for g in got["param_groups"]] == \
        [len(g["params"]) for g in want["param_groups"]]
    for k, st in want["state"].items():
        for key, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(got["state"][k][key]))
    unfrozen = _trainer(_cfg())
    with pytest.raises(ValueError, match="froze"):
        TCkpt(ckpt).restore(unfrozen, saved)


def _subtree(tree, paths):
    """The leaves of `tree` at `paths`, as a nested dict."""
    out = {}
    for path in paths:
        node, src = out, tree
        for k in path[:-1]:
            node, src = node.setdefault(k, {}), src[k]
        node[path[-1]] = src[path[-1]]
    return out


def _prune(tree):
    """`tree` without its None leaves and empty dicts."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _prune(v) for k, v in tree.items() if v is not None}
    return {k: v for k, v in out.items() if not (isinstance(v, dict)
                                                  and not v)}
