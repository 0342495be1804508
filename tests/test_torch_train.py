"""The port's train path against the JAX package on the CPU, fp32, at a
narrow config: the masked cross entropy, the warm-up poly schedule,
BatchNorm in training mode, the train-mode NMF and its one-step gradient,
the AdamW decay grouping, and five whole train steps (losses, final
parameters, final BatchNorm statistics) from the same numpy-drawn weights
on the same batches."""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.decoders.ham import nmf2d as t_nmf2d
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.models.nn import BatchNorm as TBatchNorm
from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean as t_ce
from dformer_torch.ops.schedule import warmup_poly_lr as t_warmup_poly_lr
from dformer_torch.train.loop import train_step
from dformer_torch.train.optim import decay_mask as t_decay_mask
from dformer_torch.train.optim import make_optimizer as t_make_optimizer
from dformer_torch.train.optim import make_schedule as t_make_schedule
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.decoders import ham as j_ham
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.models.nn import BatchNorm as JBatchNorm
from dformer_tpu.ops.loss import softmax_cross_entropy_masked_mean as j_ce
from dformer_tpu.ops.schedule import warmup_poly_lr as j_warmup_poly_lr
from dformer_tpu.train.loop import TrainState, make_train_step
from dformer_tpu.train.optim import decay_mask as j_decay_mask
from dformer_tpu.train.optim import make_optimizer as j_make_optimizer
from dformer_tpu.utils.convert import convert_model_state, load_into_variables

from test_torch_model import NARROW, _random_variables

B, HW, CLASSES = 2, (64, 96), 11
N_STEPS = 5


def _cfg():
    # 10 steps in all, the first 2 of them warm-up
    return AttrDict(backbone="DFormer-Narrow", decoder="ham",
                    num_classes=CLASSES, decoder_embed_dim=64,
                    drop_path_rate=0.0, aux_rate=0.0, bn_eps=1e-3,
                    bn_momentum=0.1, optimizer="AdamW", lr=1e-3,
                    weight_decay=0.01, lr_power=0.9, nepochs=10,
                    niters_per_epoch=1, warm_up_epoch=2, background=255)


@pytest.mark.parametrize("ignored", [0.05, 1.0])
def test_masked_cross_entropy_matches_jax(ignored):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 9, 11, 7)).astype(np.float32)
    labels = rng.randint(0, 7, (2, 9, 11))
    labels = np.where(rng.rand(*labels.shape) < ignored, 255, labels)
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels), 255))
    got = float(t_ce(torch.from_numpy(logits), torch.from_numpy(labels), 255))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
    if ignored == 1.0:  # every pixel ignored: the count clamps to 1
        assert got == 0.0


@pytest.mark.parametrize("step", [0, 1, 3, 4, 5, 17, 39, 40, 55])
def test_warmup_poly_lr_matches_jax(step):
    # inside the warm-up (0-3), after it, at and past total_steps (40)
    want = float(j_warmup_poly_lr(step, 1e-3, 40, 4, 0.9))
    got = t_warmup_poly_lr(step, 1e-3, 40, 4, 0.9)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-5, abs=1e-10)
    if step >= 40:
        assert got == 0.0


def test_batchnorm_training_mode_matches_jax():
    rng = np.random.RandomState(1)
    C = 12
    xs = [(2.0 * rng.randn(3, 5, 7, C) + 1.5).astype(np.float32)
          for _ in range(2)]
    weight = (1 + 0.1 * rng.randn(C)).astype(np.float32)
    bias = (0.1 * rng.randn(C)).astype(np.float32)
    mean0 = (0.1 * rng.randn(C)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, C).astype(np.float32)

    jbn = JBatchNorm(eps=1e-3, momentum=0.1)
    variables = {"params": {"weight": weight, "bias": bias},
                 "batch_stats": {"mean": mean0, "var": var0}}
    tbn = TBatchNorm(C, eps=1e-3, momentum=0.1).train()
    tbn.load_state_dict({"weight": torch.from_numpy(weight),
                         "bias": torch.from_numpy(bias),
                         "running_mean": torch.from_numpy(mean0),
                         "running_var": torch.from_numpy(var0)})
    for x in xs:
        want, new = jbn.apply(variables, jnp.asarray(x),
                              use_running_average=False,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **new}
        got = tbn(torch.from_numpy(x))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    # after two calls: momentum 0.1 toward the batch mean and the UNBIASED
    # batch variance
    np.testing.assert_allclose(tbn.running_mean.numpy(),
                               np.asarray(variables["batch_stats"]["mean"]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(tbn.running_var.numpy(),
                               np.asarray(variables["batch_stats"]["var"]),
                               atol=1e-6, rtol=0)
    # eval mode reads the running statistics and leaves them alone
    before = tbn.running_var.clone()
    want = jbn.apply(variables, jnp.asarray(xs[0]))
    got = tbn.eval()(torch.from_numpy(xs[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    assert torch.equal(tbn.running_var, before)


def test_nmf2d_train_mode_value_and_gradient_match_jax():
    rng = np.random.RandomState(2)
    x = np.abs(rng.randn(2, 24, 16)).astype(np.float32)
    bases = rng.rand(2, 16, 8).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    cot = rng.randn(2, 24, 16).astype(np.float32)

    def jloss(x_):
        out = j_ham.nmf2d(x_, jnp.asarray(bases), train=True)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = t_nmf2d(tx, torch.from_numpy(bases), train=True)
    (tout * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5, rtol=1e-4)
    # 6 steps in training, 7 in eval: the two modes differ
    teval = t_nmf2d(torch.from_numpy(x), torch.from_numpy(bases))
    jeval = j_ham.nmf2d(jnp.asarray(x), jnp.asarray(bases))
    np.testing.assert_allclose(teval.numpy(), np.asarray(jeval), atol=1e-5,
                               rtol=1e-4)
    assert not np.allclose(teval.numpy(), tout.detach().numpy(), atol=1e-6)


class _IdentityDropout:
    """Stands in for the JAX head's Dropout: dropout off."""

    def __init__(self, rate, name=None):
        pass

    def __call__(self, x, deterministic=True):
        return x


@pytest.fixture(scope="module")
def pair():
    """JAX and port EncoderDecoder (narrow) on the same numpy-drawn
    weights, with the training config."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow", NARROW)
        mp.setitem(T_VARIANTS, "DFormer-Narrow", NARROW)
        cfg = _cfg()
        jmodel = j_build_model(cfg, pallas="off")
        zeros = jnp.zeros((B, *HW, 3))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), zeros,
                                zeros)
        variables = _random_variables(dict(shapes), seed=4)
        tmodel = t_build_model(cfg, device="cpu")
        tmodel.load_state_dict(from_jax_variables(variables), strict=True)
        yield dict(cfg=cfg, jmodel=jmodel, tmodel=tmodel, variables=variables)


def _flax_path(name, value):
    """The flax parameter path of one port state_dict key, through the JAX
    package's converter."""
    params, stats = convert_model_state({name: value})
    flat = jax.tree_util.tree_flatten_with_path({**params, **stats})[0]
    assert len(flat) == 1, name
    return tuple(k.key for k in flat[0][0])


def test_adamw_groups_match_jax_decay_mask(pair):
    tmodel, cfg = pair["tmodel"], pair["cfg"]
    jmask = j_decay_mask(pair["variables"]["params"])
    tmask = t_decay_mask(tmodel)
    names = [n for n, _ in tmodel.named_parameters()]
    assert set(tmask) == set(names)
    assert len(names) == len(jax.tree.leaves(jmask))
    for name, p in tmodel.named_parameters():
        node = jmask
        for key in _flax_path(name, p.detach().numpy()):
            node = node[key]
        assert tmask[name] == node, name
    # decayed: conv / linear weights only
    for name, decayed in tmask.items():
        if decayed:
            assert name.endswith(".weight") and "norm" not in name \
                and ".bn." not in name and "layer_scale" not in name, name
    opt = t_make_optimizer(cfg, tmodel)
    params = dict(tmodel.named_parameters())
    decay, no_decay = opt.param_groups
    assert decay["weight_decay"] == cfg.weight_decay
    assert no_decay["weight_decay"] == 0.0
    assert {id(p) for p in decay["params"]} == \
        {id(params[n]) for n in names if tmask[n]}
    assert {id(p) for p in no_decay["params"]} == \
        {id(params[n]) for n in names if not tmask[n]}
    assert decay["betas"] == (0.9, 0.999) and decay["eps"] == 1e-8


def test_train_steps_match_jax(pair, monkeypatch):
    """The slice as a whole: N_STEPS of `train_step` against the JAX
    package's jitted step. Dropout is off and the NMF bases are pinned on
    both sides (the two frameworks' random streams cannot be aligned);
    drop_path_rate is 0."""
    cfg, jmodel, tmodel = pair["cfg"], pair["jmodel"], pair["tmodel"]
    variables = pair["variables"]
    rng = np.random.RandomState(7)
    bases = rng.rand(B, 512, 64).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    monkeypatch.setattr(j_ham, "Dropout", _IdentityDropout)
    monkeypatch.setattr(j_ham, "_uniform_bases",
                        lambda key, b, d, r: jnp.asarray(bases))
    monkeypatch.setattr(tmodel.decode_head.dropout, "rate", 0.0)

    batches = []
    for _ in range(N_STEPS):
        rgb = rng.randn(B, *HW, 3).astype(np.float32)
        modal = rng.randn(B, *HW, 3).astype(np.float32)
        gt = rng.randint(0, CLASSES, (B, *HW))
        gt = np.where(rng.rand(*gt.shape) < 0.05, cfg.background, gt)
        batches.append((rgb, modal, gt.astype(np.int64)))

    # --- JAX
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = j_make_optimizer(cfg, params)
    state = TrainState(
        step=jnp.asarray(0), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax.jit(tx.init)(params))
    step_fn = make_train_step(jmodel, tx, cfg)
    key = jax.random.PRNGKey(0)
    want_losses = []
    for rgb, modal, gt in batches:
        state, loss = step_fn(state, jnp.asarray(rgb), jnp.asarray(gt),
                              jnp.asarray(modal), key)
        want_losses.append(float(loss))

    # --- the port
    opt = t_make_optimizer(cfg, tmodel)
    sched = t_make_schedule(cfg)
    gen = torch.Generator().manual_seed(0)
    got_losses, null_grad, lrs = [], [], []
    for k, (rgb, modal, gt) in enumerate(batches):
        loss = train_step(tmodel, opt, sched, k, torch.from_numpy(rgb),
                          torch.from_numpy(gt), torch.from_numpy(modal), gen,
                          bases=torch.from_numpy(bases))
        got_losses.append(float(loss))
        lrs.append(opt.param_groups[0]["lr"])
        if k == 0:
            grad0 = {n: p.grad.detach().numpy().copy()
                     for n, p in tmodel.named_parameters()}
    assert lrs[0] == 0.0 and lrs[1] == pytest.approx(5e-4)  # warm-up
    assert lrs[2] == pytest.approx(1e-3 * 0.8 ** 0.9)

    for k, (a, b) in enumerate(zip(got_losses, want_losses)):
        assert abs(a - b) <= 1e-4 * abs(b), (k, got_losses, want_losses)
    assert tmodel.training

    # Structurally-null gradients: Adam turns their rounding noise into
    # +-lr steps that no two frameworks share, so those entries are held
    # only to the length of that walk. Whole leaves of this kind are the
    # biases whose constant shift a BatchNorm's mean subtraction removes:
    # the stems' conv biases, and the fc2 bias of each stage's last block
    # (its output meets a BatchNorm next, in the downsample or the head).
    # Single entries: the key half of the kv bias (softmax ignores a shift
    # of all logits) and weights on dead inputs.
    NULL = 3e-7
    null_leaves = [n for n, g in grad0.items() if np.abs(g).max() < NULL]
    assert null_leaves
    last = {0: 0, 1: 0, 2: 0, 3: 1}  # last block of each NARROW stage
    for name in null_leaves:
        m = re.fullmatch(r"encoder_backbone\.stages\.(\d)\.(\d)\."
                         r"mlp(_e2)?\.fc2\.bias", name)
        assert (m and last[int(m.group(1))] == int(m.group(2))) or \
            re.fullmatch(r"encoder_backbone\.downsample_layers(_e)?\.0\."
                         r"[03]\.bias", name), name

    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}
    zeros = jax.tree.map(np.zeros_like, variables)
    got_vars, matched = load_into_variables(zeros, *convert_model_state(sd))
    assert len(matched) == len(jax.tree.leaves(variables["params"]))
    grad_vars, _ = load_into_variables(zeros, *convert_model_state(grad0))

    def by_path(tree):
        return dict(jax.tree_util.tree_flatten_with_path(tree)[0])

    flat_got, flat_init = by_path(got_vars["params"]), \
        by_path(variables["params"])
    flat_grad0 = by_path(grad_vars["params"])
    # Adam moves an entry by at most about the learning rate per step, so
    # the distance travelled is bounded by the sum of the rates. The two
    # runs agree to a thousandth of that; the Hamburger's leaves to 3e-2 of
    # it (their gradients pass through the NMF's ratio updates, which
    # amplify fp32 summation-order differences: measured 1e-2)
    travelled = sum(lrs)
    moved, n_null, n_all = 0.0, 0, 0
    for path, want in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        want = np.asarray(want)
        name = jax.tree_util.keystr(path)
        diff = np.abs(flat_got[path] - want)
        null = np.abs(flat_grad0[path]) < NULL
        n_null, n_all = n_null + int(null.sum()), n_all + null.size
        moved = max(moved, float(np.abs(want - flat_init[path]).max()))
        tol = (3e-2 if "hamburger" in name else 1e-3) * travelled \
            + 1e-6 * np.abs(want).max()
        assert diff[~null].max(initial=0.0) <= tol, (name, diff[~null].max())
        assert diff[null].max(initial=0.0) <= 2.4 * travelled, name
    assert n_null < 0.02 * n_all  # the exemption stays an exception
    assert moved > 0.5 * travelled  # the run is discriminative
    flat_stats = by_path(got_vars["batch_stats"])
    for path, want in jax.tree_util.tree_flatten_with_path(
            state.batch_stats)[0]:
        # the random walk of the null-gradient biases (above) shifts the
        # batch means of the BatchNorm right behind them and nothing else:
        # means to 3e-4 (measured 1.7e-4, the walk itself is up to 7e-3),
        # variances to 1e-5
        atol = 3e-4 if path[-1].key == "mean" else 1e-5
        np.testing.assert_allclose(flat_stats[path], np.asarray(want),
                                   rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))
