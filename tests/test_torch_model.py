"""The port's model against the JAX package on the same weights and inputs,
fp32 on the CPU, at a narrow config: the weight converter round trip, the
encoder per stage, the ham head, and the full-resolution logits.

Every parameter is drawn from a numpy seed (LayerScales around 1, BatchNorm
running variance positive): the fresh-init LayerScale of 1e-6 would hide
every attention and MLP branch from the outputs."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.decoders.ham import LightHamHead as TLightHamHead
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.builder import EncoderDecoder as JEncoderDecoder
from dformer_tpu.models.decoders.ham import LightHamHead as JLightHamHead
from dformer_tpu.models.decoders.ham import _uniform_bases
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.utils.convert import convert_model_state, load_into_variables

NARROW = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 2),
              num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
              mlp_ratios=(8, 8, 4, 4))
B, HW = 2, (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _random_variables(shapes, seed):
    """Fill a flax variable-shape tree with numpy draws."""
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            fan_in = int(np.prod(shape[:-1]))
            v = rng.randn(*shape) / np.sqrt(fan_in)
        elif name.startswith("layer_scale"):
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "weight":  # LayerNorm / BatchNorm affine
            v = 1.0 + 0.1 * rng.randn(*shape)
        elif name == "var":
            v = rng.uniform(0.5, 1.5, shape)
        elif name == "mean":
            v = 0.1 * rng.randn(*shape)
        else:  # bias
            v = 0.1 * rng.randn(*shape)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    """JAX and port EncoderDecoder on the same numpy-drawn weights, plus the
    JAX outputs (encoder stages and logits) for one numpy input."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow", NARROW)
        mp.setitem(T_VARIANTS, "DFormer-Narrow", NARROW)
        cfg = AttrDict(backbone="DFormer-Narrow", decoder="ham",
                       num_classes=11, decoder_embed_dim=64,
                       drop_path_rate=0.1, aux_rate=0.0, bn_eps=1e-3)
        jmodel = j_build_model(cfg, pallas="off")
        rng = np.random.RandomState(1)
        rgb = rng.randn(B, *HW, 3).astype(np.float32)
        modal = rng.randn(B, *HW, 3).astype(np.float32)
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.asarray(rgb), jnp.asarray(modal))
        variables = _random_variables(dict(shapes), seed=2)

        @jax.jit
        def run(v, rgb, modal):
            feats = jmodel.apply(v, rgb, modal, method=JEncoderDecoder.encode)
            logits = jmodel.apply(v, rgb, modal, deterministic_bases=True)
            return feats, logits

        feats, logits = run(variables, jnp.asarray(rgb), jnp.asarray(modal))
        tmodel = t_build_model(cfg, device="cpu").eval()
        tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    # the JAX model's deterministic NMF bases, passed to the port
    bases = np.array(_uniform_bases(jax.random.PRNGKey(0), B, 512, 64))
    return dict(variables=variables, tmodel=tmodel, rgb=rgb, modal=modal,
                feats=[np.asarray(f) for f in feats],
                logits=np.asarray(logits), bases=bases)


def test_from_jax_variables_round_trip(pair):
    variables = pair["variables"]
    sd = {k: v.numpy() for k, v in pair["tmodel"].state_dict().items()}
    params, stats = convert_model_state(sd)
    zeros = jax.tree.map(np.zeros_like, variables)
    back, matched = load_into_variables(zeros, params, stats)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    # every port key is a distinct JAX leaf, and every JAX leaf comes back
    assert len(sd) == len(leaves)
    assert len(matched) == len(jax.tree_util.tree_leaves(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, want in leaves:
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))


def test_encoder_stages_match_jax(pair):
    with torch.no_grad():
        got = pair["tmodel"].encode(torch.from_numpy(pair["rgb"]),
                                    torch.from_numpy(pair["modal"]))
    assert len(got) == 4
    for i, (g, w) in enumerate(zip(got, pair["feats"])):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=1e-3,
                                   err_msg=f"stage {i}")


# DFormer-Large's widths, heads, windows and MLP ratios, one block a stage
LARGE1 = dict(T_VARIANTS["DFormer-Large"], depths=(1, 1, 1, 1))


def test_encoder_stages_match_jax_at_large_widths():
    """The encoder at DFormer-Large's widths (96-576), one block per stage,
    64x96, on numpy-drawn weights: each stage against the JAX encoder's,
    to the tolerance of test_encoder_stages_match_jax."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Large1", LARGE1)
        mp.setitem(T_VARIANTS, "DFormer-Large1", LARGE1)
        cfg = AttrDict(backbone="DFormer-Large1", decoder="ham",
                       num_classes=11, decoder_embed_dim=64,
                       drop_path_rate=0.1, aux_rate=0.0, bn_eps=1e-3)
        jmodel = j_build_model(cfg, pallas="off")
        rng = np.random.RandomState(3)
        rgb, modal = (rng.randn(1, *HW, 3).astype(np.float32)
                      for _ in range(2))
        shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                                jnp.asarray(rgb), jnp.asarray(modal))
        variables = _random_variables(dict(shapes), seed=4)
        want = jax.jit(lambda v, r, m: jmodel.apply(
            v, r, m, method=JEncoderDecoder.encode))(
                variables, jnp.asarray(rgb), jnp.asarray(modal))
        tmodel = t_build_model(cfg, device="cpu").eval()
        tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = tmodel.encode(torch.from_numpy(rgb), torch.from_numpy(modal))
    assert [g.shape[-1] for g in got] == list(LARGE1["dims"])
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4,
                                   rtol=1e-3, err_msg=f"stage {i}")


def test_full_logits_match_jax(pair):
    with torch.no_grad():
        got = pair["tmodel"](torch.from_numpy(pair["rgb"]),
                             torch.from_numpy(pair["modal"]),
                             bases=torch.from_numpy(pair["bases"]))
    assert got.shape == (B, *HW, 11)
    # the gate of the ham-head parity test: fp32 NMF ratios amplify
    # summation-order differences of the encoder features
    np.testing.assert_allclose(got.numpy(), pair["logits"], atol=5e-4,
                               rtol=1e-2)


def test_ham_head_matches_jax():
    in_ch = (64, 128, 256)
    jhead = JLightHamHead(in_index=(1, 2, 3), channels=64, ham_channels=64,
                          num_classes=11)
    rng = np.random.RandomState(5)
    feats = [rng.randn(B, s, s, c).astype(np.float32)
             for s, c in zip((32, 16, 8, 4), (32,) + in_ch)]
    jfeats = [jnp.asarray(f) for f in feats]
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jfeats)
    variables = _random_variables(dict(shapes), seed=6)
    want = jax.jit(lambda v, f: jhead.apply(v, f, deterministic_bases=True))(
        variables, jfeats)
    bases = _uniform_bases(jax.random.PRNGKey(0), B, 64, 64)

    thead = TLightHamHead(in_channels=in_ch, channels=64, ham_channels=64,
                          num_classes=11).eval()
    thead.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = thead([torch.from_numpy(f) for f in feats],
                    bases=torch.from_numpy(np.asarray(bases)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4,
                               rtol=1e-2)


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, dformer_torch\n"
        "import dformer_torch.entry, dformer_torch.kernels.fused_mlp\n"
        "for m in pkgutil.walk_packages(dformer_torch.__path__, "
        "'dformer_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'dformer_tpu', 'local_configs', 'pandas',\n"
        "'sklearn'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          cwd=Path(__file__).resolve().parents[1],
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
