"""The port's fresh init against the JAX package's, leaf by leaf: the JAX
model's own `init` and the port's constructors, each leaf's spread
compared (std, and max|value| for the uniform draws) on every leaf of 1024
values or more, and every constant leaf (LayerNorm / BatchNorm affines and
statistics, LayerScales, deeplabv3+'s zero biases) equal.

DFormer-Small's widths with one block per stage (the JAX init compiles one
random draw per leaf: ~35 s at full depth), each decode head and the aux
head, and DFormerTrav-Base's lidar expansion (its body is a DFormer). The
JAX draws use the `rbg` generator while this module runs, which compiles
in half the time; only the spreads are compared, never the bits."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.builder import EncoderDecoder as JEncoderDecoder
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.models.trav import Attention1Dto2D as JAttention1Dto2D

SMALL1 = dict(J_VARIANTS["DFormer-Small"], depths=(1, 1, 1, 1))
SPREAD = (0.9, 1.1)   # port / JAX, std and max|value|
MIN_SIZE = 1024
# (decoder, aux_rate): every head the builder makes, and the aux head
HEADS = [("ham", 0.4), ("MLPDecoder", 0.0), ("UPernet", 0.0),
         ("deeplabv3+", 0.0), ("nl", 0.0), ("FCN-32s", 0.0)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are small, and 8 threads in each
    of the test run's worker processes oversubscribe the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def small1():
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "rbg")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Small1", SMALL1)
        mp.setitem(T_VARIANTS, "DFormer-Small1", SMALL1)
        yield
    jax.config.update("jax_default_prng_impl", before)


def _cfg(**over):
    cfg = AttrDict(backbone="DFormer-Small1", decoder="ham", num_classes=40,
                   decoder_embed_dim=512, drop_path_rate=0.1, aux_rate=0.0,
                   bn_eps=1e-3, bn_momentum=0.1)
    cfg.update(over)
    return cfg


def _check(port: dict, want: dict, where: str):
    """Every leaf of `want` (the JAX init in the port's names) against the
    port's; returns how many spreads were compared."""
    compared = 0
    for key, w in want.items():
        w = w.numpy()
        g = port[key].detach().numpy()
        assert g.shape == w.shape, (where, key)
        if w.size > 1 and w.std() == 0:
            assert np.array_equal(g, w), (where, key)
            continue
        if w.size < MIN_SIZE:
            continue
        ratios = [g.std() / w.std()]
        if not key.endswith(("query1", "query2")):  # the N(0, 1) queries
            ratios.append(np.abs(g).max() / np.abs(w).max())
        assert all(SPREAD[0] <= r <= SPREAD[1] for r in ratios), \
            (where, key, ratios)
        compared += 1
    return compared


def _sd(variables):
    return from_jax_variables(jax.tree.map(np.asarray, variables))


def test_encoder_init_matches_jax():
    jmodel = j_build_model(_cfg(), pallas="off")
    z = jnp.zeros((1, 32, 32, 3))
    variables = jax.jit(lambda k: jmodel.init(
        k, z, z, method=JEncoderDecoder.encode))(jax.random.PRNGKey(0))
    want = _sd(variables)
    torch.manual_seed(0)
    port = t_build_model(_cfg(), device="cpu").state_dict()
    assert {k for k in port if k.startswith("encoder_backbone.")} == \
        set(want)
    assert _check(port, want, "encoder") >= 40


@pytest.mark.parametrize("decoder, aux_rate", HEADS)
def test_head_init_matches_jax(decoder, aux_rate):
    cfg = _cfg(decoder=decoder, aux_rate=aux_rate)
    jmodel = j_build_model(cfg, pallas="off")
    dims = SMALL1["dims"]
    feats = [jnp.zeros((1, s, s, c)) for s, c in zip((16, 8, 4, 2), dims)]

    def init(key):
        params = jmodel.init(key, feats, (64, 64),
                             method=JEncoderDecoder.decode)
        if aux_rate or decoder in ("UPernet", "deeplabv3+", "nl"):
            aux = jmodel.init(key, feats[2],
                              method=lambda m, f: m.aux_head(f))
            params = {c: {**params[c], **aux[c]} for c in params}
        return params

    want = _sd(jax.jit(init)(jax.random.PRNGKey(1)))
    torch.manual_seed(1)
    port = t_build_model(cfg, device="cpu").state_dict()
    heads = {k for k in port if k.startswith(("decode_head.", "aux_head."))}
    assert heads == set(want)
    assert _check(port, want, decoder) >= 2


def test_trav_lidar_expansion_init_matches_jax():
    """The packed in-projections (xavier uniform), the N(0, 1) learned
    queries and the expansion's Linears of a DFormerTrav-Base at 64x96."""
    jm = JAttention1Dto2D(mid_len=96, output_len=64)
    variables = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 360))))(
        jax.random.PRNGKey(2))
    want = {f"encoder_backbone.attn_expand_e.{k}": v
            for k, v in _sd(variables).items()}
    cfg = _cfg(backbone="DFormerTrav-Base", num_classes=2,
               image_height=64, image_width=96)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(T_VARIANTS, "DFormer-Base",
                   dict(T_VARIANTS["DFormer-Base"], depths=(1, 1, 1, 1)))
        torch.manual_seed(2)
        port = t_build_model(cfg, device="cpu").state_dict()
    assert _check(port, want, "trav") >= 5
