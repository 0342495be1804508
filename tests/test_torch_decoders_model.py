"""The port's decode heads inside a whole model against the JAX package's
on the CPU, fp32, on the same numpy-drawn weights (the heads alone are in
tests/test_torch_decoders.py): on the narrow DFormer of
tests/test_torch_model.py, UPernet with its aux head (logits, two train
steps at aux_rate 0.4 and 0) and the FCN fallback; a Trav `meta_forward`
with MLPDecoder; a non-ham config through both tools."""

import glob
import re

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch import configs as t_configs
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models import builder as t_builder
from dformer_torch.models import decoders as t_dec
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import eval as t_eval_tool
from dformer_torch.tools import train as t_train_tool
from dformer_torch.train.loop import train_step
from dformer_torch.train.optim import make_optimizer as t_make_optimizer
from dformer_torch.train.optim import make_schedule as t_make_schedule
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models import builder as j_builder
from dformer_tpu.models import decoders as j_dec
from dformer_tpu.models.builder import EncoderDecoder as JEncoderDecoder
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.train.loop import TrainState, make_train_step
from dformer_tpu.train.optim import make_optimizer as j_make_optimizer
from dformer_tpu.utils.convert import convert_model_state, load_into_variables

from test_torch_decoders import B, CLASSES, _max_rel, no_jax_dropout  # noqa: F401
from test_torch_fss import SHORT_BASE
from test_torch_model import NARROW, _random_variables
from test_torch_trav import HW as TRAV_HW
from test_torch_trav import trav_cfg, trav_variables


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- the narrow model: UPernet with its aux head, the FCN fallback -----------

HW = (64, 96)


# the narrow DFormer with one block per stage, and UPernet's 512 channels cut
# to 64 in both builders
NARROW1 = dict(NARROW, depths=(1, 1, 1, 1))


@pytest.fixture(scope="module")
def narrow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow", NARROW1)
        mp.setattr(j_builder, "UPerHead", lambda channels, **kw:
                   j_dec.UPerHead(channels=64, **kw))
        mp.setattr(t_builder, "UPerHead", lambda dims, channels, **kw:
                   t_dec.UPerHead(dims, channels=64, **kw))
        yield


def _narrow_cfg(**over):
    # 10 steps in all, the first 2 of them warm-up: step 0 runs at rate 0
    # (as the recipe's first step does) and step 1 at 5e-4
    cfg = AttrDict(backbone="DFormer-Narrow", decoder="UPernet",
                   num_classes=CLASSES, decoder_embed_dim=64,
                   drop_path_rate=0.0, aux_rate=0.4, bn_eps=1e-3,
                   bn_momentum=0.1, optimizer="AdamW", lr=1e-3,
                   weight_decay=0.01, lr_power=0.9, nepochs=10,
                   niters_per_epoch=1, warm_up_epoch=2, background=255)
    cfg.update(over)
    return cfg


def _narrow_pair(cfg, seed):
    """JAX and port models of `cfg` on the same numpy-drawn weights. The
    JAX variables come from an init through `forward_with_aux`: one through
    `__call__`, as the JAX train tool's, leaves the aux head without
    parameters, and its train step then raises."""
    jmodel = j_build_model(cfg, pallas="off")
    zeros = jnp.zeros((B, *HW, 3))
    shapes = jax.eval_shape(
        lambda k: jmodel.init(k, zeros, zeros,
                              method=JEncoderDecoder.forward_with_aux),
        jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), seed=seed)
    tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    return jmodel, variables, tmodel


# the narrow model's batch in the UPernet checks: the main path's 8 images,
# so that the pyramid's scale-1 BatchNorm normalises 8 pooled values (over 2
# the fp32 gradients are ill-conditioned: JAX's and the port's first Adam
# moments differ by up to 4.7e-5 of a leaf's max there, 9.1e-6 at 8)
UPER_B = 8


class _TracedRate:
    """`aux_rate` for the JAX `make_train_step`, which reads it when the
    step is traced: truthy, and it multiplies as the traced `rate`, so that
    one compile serves every rate. At rate 0 the aux term adds 0 * CE: the
    loss and every gradient are those of a step that skips the term."""

    def __init__(self, rate):
        self.rate = rate

    def __bool__(self):
        return True

    def __mul__(self, other):
        return self.rate * other

    __rmul__ = __mul__


@pytest.fixture(scope="module")
def uper(narrow):
    cfg = _narrow_cfg()
    jmodel, variables, tmodel = _narrow_pair(cfg, seed=30)
    rng = np.random.RandomState(31)
    batches = []
    for _ in range(2):
        rgb = rng.randn(UPER_B, *HW, 3).astype(np.float32)
        modal = rng.randn(UPER_B, *HW, 3).astype(np.float32)
        gt = rng.randint(0, CLASSES, (UPER_B, *HW))
        gt = np.where(rng.rand(*gt.shape) < 0.05, 255, gt).astype(np.int64)
        batches.append((rgb, modal, gt))
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = j_make_optimizer(cfg, params)

    @jax.jit
    def jax_step(state, rgb, gt, modal, rate):
        step = make_train_step(jmodel, tx,
                               AttrDict(cfg, aux_rate=_TracedRate(rate)))
        return step(state, rgb, gt, modal, jax.random.PRNGKey(0))

    state0 = TrainState(
        step=jnp.asarray(0), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax.jit(tx.init)(params))
    return dict(cfg=cfg, jmodel=jmodel, variables=variables, tmodel=tmodel,
                batches=batches, jax_step=jax_step, state0=state0)


def test_upernet_logits_and_aux_match_forward_with_aux(uper):
    jmodel, variables, tmodel = uper["jmodel"], uper["variables"], \
        uper["tmodel"]
    rgb, modal, _ = uper["batches"][0]
    want, want_aux = jax.jit(lambda v, r, m: jmodel.apply(
        v, r, m, method=JEncoderDecoder.forward_with_aux))(
        variables, rgb, modal)
    assert set(n.split(".")[0] for n, _ in tmodel.named_parameters()) == \
        {"encoder_backbone", "decode_head", "aux_head"}
    with torch.no_grad():
        got, aux = tmodel.eval().forward_with_aux(torch.from_numpy(rgb),
                                                  torch.from_numpy(modal))
    assert got.shape == aux.shape == (UPER_B, *HW, CLASSES)
    assert _max_rel(got, want) <= 1e-4
    assert _max_rel(aux, want_aux) <= 1e-4


def _by_path(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def _adam_state(opt_state):
    """The `ScaleByAdamState` inside an optax state."""
    if isinstance(opt_state, optax.ScaleByAdamState):
        return opt_state
    if hasattr(opt_state, "inner_state"):
        return _adam_state(opt_state.inner_state)
    if isinstance(opt_state, (tuple, list)):
        for s in opt_state:
            found = _adam_state(s)
            if found is not None:
                return found
    return None


# Structurally null gradients (tests/test_torch_train.py's bound): biases
# whose constant shift a BatchNorm removes; rounding noise only.
NULL = 3e-7
# the first Adam moments, of each leaf's max (measured 9.1e-6)
MOMENT_REL = 1e-5


@pytest.mark.parametrize("aux_rate", [0.4, 0.0])
def test_upernet_train_steps_match_jax(uper, aux_rate):
    """Two steps of `train_step` against the JAX package's step (step 0 at
    rate 0, step 1 at 5e-4; one jitted JAX step serves both aux rates): the
    loss adds aux_rate times the aux head's cross entropy. At rate 0 the
    aux head still runs (its BatchNorm statistics move) and gets zero
    gradients, so AdamW only decays its kernels, in both frameworks alike.

    The first Adam moments (linear in the two steps' gradients) agree to
    MOMENT_REL of each leaf's max. Parameters: Adam divides each entry by
    its own root mean square, so a gradient difference e moves an entry by
    up to 2 * lr * e / sqrt(v_hat). Every entry agrees to 1e-3 of the
    rates' sum, as in tests/test_torch_train.py, plus what a difference of
    MOMENT_REL of its leaf's largest root mean square makes of it there
    (capped at Adam's walk); entries with a null gradient are held to the
    walk, as there."""
    cfg = _narrow_cfg(aux_rate=aux_rate)
    variables, batches = uper["variables"], uper["batches"]
    state, want_losses = uper["state0"], []
    for rgb, modal, gt in batches:
        state, loss = uper["jax_step"](state, rgb, gt, modal, aux_rate)
        want_losses.append(float(loss))

    tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    opt = t_make_optimizer(cfg, tmodel)
    sched = t_make_schedule(cfg)
    gen = torch.Generator().manual_seed(0)
    got_losses, lrs = [], []
    for k, (rgb, modal, gt) in enumerate(batches):
        loss = train_step(tmodel, opt, sched, k, torch.from_numpy(rgb),
                          torch.from_numpy(gt), torch.from_numpy(modal), gen,
                          aux_rate=cfg.aux_rate)
        got_losses.append(float(loss))
        lrs.append(opt.param_groups[0]["lr"])
        if k == 0:
            grad0 = {n: p.grad.numpy().copy()
                     for n, p in tmodel.named_parameters()}
    assert lrs == [0.0, pytest.approx(5e-4)]
    for a, b in zip(got_losses, want_losses):
        assert abs(a - b) <= 1e-4 * abs(b), (got_losses, want_losses)
    aux_moved = [np.abs(g).max() > 0 for n, g in grad0.items()
                 if n.startswith("aux_head.") and n.endswith("weight")]
    assert all(aux_moved) if aux_rate else not any(aux_moved)

    beta1, beta2 = opt.param_groups[0]["betas"]
    moments = {name: (opt.state[p]["exp_avg"].numpy(),
                      opt.state[p]["exp_avg_sq"].numpy() / (1 - beta2 ** 2))
               for name, p in tmodel.named_parameters()}
    zeros = jax.tree.map(np.zeros_like, variables)

    def flat(sd):
        return _by_path(load_into_variables(
            zeros, *convert_model_state(sd))[0]["params"])

    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    got_vars, matched = load_into_variables(zeros, *convert_model_state(sd))
    assert len(matched) == len(jax.tree.leaves(variables["params"]))
    flat_got, flat_grad0 = _by_path(got_vars["params"]), flat(grad0)
    flat_mu = flat({n: m for n, (m, _) in moments.items()})
    flat_vhat = flat({n: v for n, (_, v) in moments.items()})
    flat_init = _by_path(variables["params"])
    want_mu = _by_path(_adam_state(state.opt_state).mu)
    travelled, lr = sum(lrs), lrs[-1]
    n_null = n_all = 0
    for path, want in _by_path(state.params).items():
        want = np.asarray(want)
        name = jax.tree_util.keystr(path)
        null = np.abs(flat_grad0[path]) < NULL
        if aux_rate or path[0].key != "aux_head":  # unused at rate 0
            n_null, n_all = n_null + int(null.sum()), n_all + null.size
        if not null.all():
            mu = np.asarray(want_mu[path])
            assert np.abs(flat_mu[path] - mu).max() <= \
                MOMENT_REL * np.abs(mu).max(), name
        rms = np.sqrt(flat_vhat[path])
        sensitivity = np.minimum(
            2.4 * travelled, 2 * lr * MOMENT_REL * rms.max() / (rms + 1e-8))
        tol = 1e-3 * travelled + 1e-6 * np.abs(want).max() + sensitivity
        diff = np.abs(flat_got[path] - want)
        assert (diff[~null] <= tol[~null]).all(), (name, diff.max())
        assert diff[null].max(initial=0.0) <= 2.4 * travelled, name
        if path[0].key == "aux_head" and path[-1].key == "kernel":
            assert not np.array_equal(want, flat_init[path]), name
            if not aux_rate:  # decay only: p * (1 - lr * wd) per step
                decay = np.prod([1 - r * cfg.weight_decay for r in lrs])
                np.testing.assert_allclose(want, flat_init[path] * decay,
                                           rtol=1e-6, err_msg=name)
                np.testing.assert_allclose(flat_got[path], want, rtol=1e-6,
                                           err_msg=name)
    assert n_null < 0.02 * n_all  # the exemption stays an exception
    flat_stats = _by_path(got_vars["batch_stats"])
    init_stats = _by_path(variables["batch_stats"])
    for path, want in _by_path(state.batch_stats).items():
        # both steps' forwards ran on the initial parameters
        np.testing.assert_allclose(flat_stats[path], np.asarray(want),
                                   rtol=0, atol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))
        assert not np.array_equal(np.asarray(want), init_stats[path])


def test_unknown_decoder_falls_back_to_fcn(narrow):
    """Any other decoder name builds the FCN-32s fallback on the top stage
    (3x3, no aux head), with JAX's keys and logits."""
    cfg = _narrow_cfg(decoder="FCN-32s", aux_rate=0.0)
    jmodel, variables, tmodel = _narrow_pair(cfg, seed=40)
    assert isinstance(tmodel.decode_head, t_dec.FCNHead)
    assert tmodel.aux_head is None
    assert tuple(tmodel.decode_head.conv[0].weight.shape) == \
        (NARROW1["dims"][-1] // 4, NARROW1["dims"][-1], 3, 3)
    rgb = np.random.RandomState(41).randn(B, *HW, 3).astype(np.float32)
    want = jax.jit(jmodel.apply)(variables, rgb, rgb)
    with torch.no_grad():
        got = tmodel.eval()(torch.from_numpy(rgb), torch.from_numpy(rgb))
    assert _max_rel(got, want) <= 1e-4


# --- Trav with MLPDecoder; a non-ham config through the tools ----------------

def test_trav_meta_forward_with_mlp_decoder_matches_jax():
    """DFormerTrav-Base (stages 1-3 cut to one block, as in
    tests/test_torch_fss.py) + MLPDecoder: one B 1, S 1 episode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Base", SHORT_BASE)
        mp.setitem(T_VARIANTS, "DFormer-Base", SHORT_BASE)
        cfg = trav_cfg(decoder="MLPDecoder")
        rng = np.random.RandomState(50)
        ep = dict(s_rgb=rng.randn(1, 1, *TRAV_HW, 3).astype(np.float32),
                  s_depth=rng.randn(1, 1, 360).astype(np.float32),
                  s_mask=np.zeros((1, 1, *TRAV_HW), np.int32),
                  q_rgb=rng.randn(1, *TRAV_HW, 3).astype(np.float32),
                  q_depth=rng.randn(1, 360).astype(np.float32))
        ep["s_mask"][..., :TRAV_HW[1] // 2] = 1
        jmodel = j_build_model(cfg, pallas="off")
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                ep["q_rgb"], ep["q_depth"])
        variables = trav_variables(dict(shapes), seed=51)
        names = ("s_rgb", "s_depth", "s_mask", "q_rgb", "q_depth")
        want = jax.jit(lambda v, ep: jmodel.apply(
            v, *(ep[k] for k in names),
            method=JEncoderDecoder.meta_forward))(variables, ep)
        tmodel = t_build_model(cfg, device="cpu").eval()
        tmodel.load_state_dict(from_jax_variables(variables), strict=True)
        with torch.no_grad():
            got = tmodel.meta_forward(*(torch.from_numpy(ep[k])
                                        for k in names))
    assert isinstance(tmodel.decode_head, t_dec.MLPDecoderHead)
    assert got.shape == (1, *TRAV_HW, 2)
    assert _max_rel(got, want) <= 1e-4


def test_tools_train_and_evaluate_a_upernet_config(narrow, tmp_path,
                                                   monkeypatch, capsys):
    """A config whose `decoder` is UPernet with aux_rate 0.4, by its dotted
    name: the train tool takes its step, evaluates and saves; the file's
    keys are the reference's (the JAX converter maps every one), and the
    eval tool reads it back to the same mIoU."""
    def leaf():
        cfg = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
        cfg.update(backbone="DFormer-Narrow", decoder="UPernet",
                   aux_rate=0.4, image_height=HW[0], image_width=HW[1],
                   num_classes=CLASSES, batch_size=B, niters_per_epoch=1,
                   nepochs=1, warm_up_epoch=0, drop_path_rate=0.0,
                   num_train_imgs=2, num_eval_imgs=2,
                   checkpoint_start_epoch=0, pretrained_model=None,
                   log_dir_base=str(tmp_path / "run"))
        return cfg

    monkeypatch.setitem(t_configs.LEAVES, "local_configs.Test.UPernet", leaf)
    flags = ["--config=local_configs.Test.UPernet", "--device=cpu",
             "--synthetic-data", "--no-mst", "--val_batch_size=2"]
    t_train_tool.main(flags + ["--no-amp"])
    (path,) = glob.glob(str(tmp_path / "run*" / "checkpoint" /
                            "epoch-1_miou_*.pth"))
    sd = {k: v.numpy() for k, v in torch.load(path)["model"].items()}
    assert any(k.startswith("aux_head.conv.0.") for k in sd)
    assert "decode_head.fpn_bottleneck.0.weight" in sd
    params, stats = convert_model_state(sd)
    assert len(jax.tree.leaves(params)) + len(jax.tree.leaves(stats)) == \
        len(sd)
    capsys.readouterr()
    t_eval_tool.main(flags + [f"--continue_fpath={path}"])
    miou = re.search(r"'mIoU': (?:np\.float64\()?([0-9.]+)",
                     capsys.readouterr().out)
    assert miou and path.endswith(f"_miou_{round(float(miou.group(1)), 2)}"
                                  ".pth")
