"""The JAX trainer's orbax checkpoint directories in the port, on the CPU,
fp32: the JAX `CheckpointManager` saves a narrow model + MLPDecoder after
one optax step (AdamW with the stem and stage 0 frozen, or SGDM); the port
reads the directory with tensorstore alone (`utils/orbax.py`) into a
trainer, whose logits equal JAX's and whose next step equals JAX's next
step; the converter's `.pth` restores to the same state. Without
tensorstore a directory raises, naming the converter."""

import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from dformer_torch import configs as t_configs
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.tools import convert_orbax
from dformer_torch.train.checkpoint import CheckpointManager as TCkpt
from dformer_torch.train.checkpoint import state_difference
from dformer_torch.train.optim import make_optimizer as t_make_optimizer
from dformer_torch.train.optim import make_schedule as t_make_schedule
from dformer_torch.train.optim import \
    trainable_mask_from_matched as t_trainable_mask
from dformer_torch.utils.checkpoint import load_torch_checkpoint
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict as JAttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.train.checkpoint import CheckpointManager as JCkpt
from dformer_tpu.train.loop import TrainState
from dformer_tpu.train.optim import make_optimizer as j_make_optimizer
from dformer_tpu.train.optim import \
    trainable_mask_from_matched as j_trainable_mask

from test_torch_model import _random_variables
from test_torch_train import _flax_path

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
B, HW, CLASSES = 2, (64, 96), 11
CFG = "local_configs.Test.OrbaxNarrow"
LOGITS_REL = 1e-5  # of max |JAX logits|
STEP_REL = 1e-6    # of each leaf's max |JAX value| (tests/test_torch_trainer.py)
FROZEN = ("encoder_backbone.stages.0.", "encoder_backbone.downsample_layers.0.",
          "encoder_backbone.downsample_layers_e.0.")


def _cfg(kind="AdamW"):
    cfg = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.update(backbone="DFormer-Narrow1", decoder="MLPDecoder",
               decoder_embed_dim=64, image_height=HW[0], image_width=HW[1],
               num_classes=CLASSES, optimizer=kind, lr=1e-2,
               weight_decay=0.05, momentum=0.9, nepochs=3,
               niters_per_epoch=1, warm_up_epoch=0, pretrained_model=None)
    return cfg


@pytest.fixture(scope="module")
def jax_model():
    """The JAX model on numpy-drawn weights, its jitted eval forward, and
    one numpy input."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(t_configs.LEAVES, CFG, _cfg)
        jmodel = j_build_model(JAttrDict(_cfg().copy()), pallas="off")
        rng = np.random.RandomState(1)
        rgb, modal = (rng.randn(B, *HW, 3).astype(np.float32)
                      for _ in range(2))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.asarray(rgb), jnp.asarray(modal))
        variables = _random_variables(dict(shapes), seed=2)
        forward = jax.jit(lambda v: jmodel.apply(
            v, jnp.asarray(rgb), jnp.asarray(modal),
            deterministic_bases=True))
        yield dict(variables=variables, forward=forward, rgb=rgb,
                   modal=modal)
    torch.set_num_threads(before)


def _close(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-6)
    assert err <= rel, f"{name}: {err:.3g} of max > {rel}"


def _trainer(cfg, frozen):
    model = t_build_model(cfg, device="cpu")
    mask = t_trainable_mask(model, frozen) if frozen else None
    return SimpleNamespace(model=model,
                           optimizer=t_make_optimizer(cfg, model, mask),
                           step=0, frozen=sorted(frozen))


@pytest.mark.parametrize("kind", ["AdamW", "SGDM"])
def test_orbax_checkpoint_restores_into_the_port(jax_model, tmp_path, kind):
    cfg = _cfg(kind)
    variables = jax_model["variables"]
    params = jax.tree.map(jnp.asarray, variables["params"])
    torch_params = from_jax_variables({"params": variables["params"]})
    frozen = [n for n in sorted(torch_params) if n.startswith(FROZEN)] \
        if kind == "AdamW" else []
    jmask = j_trainable_mask(params, [
        _flax_path(n, torch_params[n].numpy()) for n in frozen]) \
        if frozen else None
    tx = j_make_optimizer(JAttrDict(cfg.copy()), params, jmask)

    @jax.jit
    def jax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    rng = np.random.RandomState(5)
    grads = [jax.tree.map(lambda p: jnp.asarray(
        rng.randn(*p.shape).astype(np.float32)), params) for _ in range(2)]
    params, opt_state = jax_step(grads[0], jax.jit(tx.init)(params), params)
    state = TrainState(step=jnp.asarray(1), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=opt_state)
    path = JCkpt(str(tmp_path / "jax")).save(state, 1, 5.0)

    trainer = _trainer(cfg, frozen)
    assert TCkpt(str(tmp_path / "port")).restore(trainer, path) == 2
    assert trainer.step == 1
    want = jax_model["forward"]({"params": params,
                                 "batch_stats": variables["batch_stats"]})
    with torch.no_grad():
        got = trainer.model.eval()(torch.from_numpy(jax_model["rgb"]),
                                   torch.from_numpy(jax_model["modal"]))
    _close(got.numpy(), want, LOGITS_REL, "logits")

    # the converter's file restores to the same state
    out = str(tmp_path / "converted.pth")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(t_configs.LEAVES, CFG, lambda: _cfg(kind))
        convert_orbax.main([path, out, f"--config={CFG}"])
    again = _trainer(cfg, frozen)
    assert TCkpt(str(tmp_path / "port")).restore(again, out) == 2
    assert again.step == 1 and state_difference(trainer, again) is None

    # one more step on the same gradients
    params, _ = jax_step(grads[1], opt_state, params)
    tgrads = from_jax_variables({"params": grads[1]})
    for group in trainer.optimizer.param_groups:
        group["lr"] = t_make_schedule(cfg)(1)
    for n, p in trainer.model.named_parameters():
        p.grad = tgrads[n]
    trainer.optimizer.step()
    want = from_jax_variables({"params": params})
    for n, p in trainer.model.named_parameters():
        _close(p.detach().numpy(), want[n].numpy(), STEP_REL, n)


def test_orbax_directory_without_tensorstore_names_the_converter(
        tmp_path, monkeypatch):
    """Where tensorstore is not installed (the card machine), an orbax
    directory raises, naming the converter, in the eval path and in a
    trainer's restore; nothing falls back."""
    d = tmp_path / "epoch-3_miou_1.0"
    d.mkdir()
    (d / "_METADATA").write_text('{"tree_metadata": {}}')
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(RuntimeError, match="convert_orbax"):
        load_torch_checkpoint(str(d))
    with pytest.raises(RuntimeError, match="convert_orbax"):
        TCkpt(str(tmp_path / "port")).restore(
            SimpleNamespace(model=None, optimizer=None, step=0, frozen=[]),
            str(d))
