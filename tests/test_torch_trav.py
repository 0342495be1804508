"""The port's Trav model against the JAX package on the CPU, fp32, on the
same numpy-drawn weights: the packed-in-projection MultiHeadAttention, the
lidar expansion (and its bf16 cast order), DFormerTrav-Base's encoder
stages and logits at 64x96 (stage 2 cut to two blocks), `meta_forward`
at B 1, S 1, the converter and
the pretrained load on the Trav tree, the decay mask, the builder's
heads and refusals and the Trav config through `entry.build_trav`."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch import configs as t_configs
from dformer_torch import entry
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.builder import EncoderDecoder as TEncoderDecoder
from dformer_torch.models import nn as t_nn
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.models.trav import Attention1Dto2D as TAttention1Dto2D
from dformer_torch.models.trav import MultiHeadAttention as TMHA
from dformer_torch.train.optim import decay_mask as t_decay_mask
from dformer_torch.utils.checkpoint import load_pretrained_encoder
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.builder import EncoderDecoder as JEncoderDecoder
from dformer_tpu.models.decoders.ham import _uniform_bases
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS
from dformer_tpu.models.trav import Attention1Dto2D as JAttention1Dto2D
from dformer_tpu.models.trav import MultiHeadAttention as JMHA
from dformer_tpu.train.optim import decay_mask as j_decay_mask
from dformer_tpu.utils.convert import (convert_encoder_state,
                                       convert_model_state,
                                       load_into_variables, strip_prefixes)

from test_torch_model import _random_variables

HW = (64, 96)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def trav_cfg(**over):
    cfg = AttrDict(
        backbone="DFormerTrav-Base", decoder="ham", num_classes=2,
        decoder_embed_dim=64, drop_path_rate=0.0, aux_rate=0.0, bn_eps=1e-3,
        bn_momentum=0.1, background=255, temperature=0.7, alpha=0.4,
        image_height=HW[0], image_width=HW[1])
    cfg.update(over)
    return cfg


def trav_variables(shapes, seed):
    """`_random_variables`, with the packed in-projections at the scale of
    a Linear kernel and the learned queries N(0, 1)."""
    variables = _random_variables(shapes, seed)
    rng = np.random.RandomState(seed + 1)

    def fill(path, leaf):
        name = path[-1].key
        if name == "in_proj_weight":
            return (rng.randn(*leaf.shape) / np.sqrt(leaf.shape[0])
                    ).astype(np.float32)
        if name in ("query1", "query2"):
            return rng.randn(*leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(fill, variables)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


# --- the attention modules --------------------------------------------------

def test_mha_matches_jax():
    E, nh = 32, 4
    rng = np.random.RandomState(0)
    q = rng.randn(2, 5, E).astype(np.float32)
    kv = rng.randn(2, 9, E).astype(np.float32)
    jm = JMHA(E, nh)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), q, kv, kv)
    variables = trav_variables(dict(shapes), seed=1)
    want = np.asarray(jax.jit(jm.apply)(variables, q, kv, kv))

    tm = TMHA(E, nh)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    assert tuple(tm.in_proj_weight.shape) == (3 * E, E)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv),
                 torch.from_numpy(kv))
        # a query of batch 1 is broadcast over the keys' batch
        one = np.broadcast_to(q[:1], q.shape)
        shared = tm(torch.from_numpy(q[:1]), torch.from_numpy(kv),
                    torch.from_numpy(kv))
    assert _max_rel(got, want) <= 1e-5
    want_one = np.asarray(jax.jit(jm.apply)(variables, one, kv, kv))
    assert _max_rel(shared, want_one) <= 1e-5


@pytest.fixture(scope="module")
def expansion():
    """The lidar expansion at 32x48 on both sides, same weights."""
    jm = JAttention1Dto2D(mid_len=48, output_len=32)
    rng = np.random.RandomState(2)
    scan = rng.rand(2, 360).astype(np.float32) * 5
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), scan)
    variables = trav_variables(dict(shapes), seed=3)
    tm = TAttention1Dto2D(mid_len=48, output_len=32)
    tm.load_state_dict(from_jax_variables(variables), strict=True)
    return dict(jm=jm, tm=tm, variables=variables, scan=scan)


def test_attention_1d_to_2d_matches_jax(expansion):
    jm, tm, variables, scan = (expansion[k] for k in
                               ("jm", "tm", "variables", "scan"))
    want = np.asarray(jax.jit(jm.apply)(variables, scan))
    with torch.no_grad():
        got = tm(torch.from_numpy(scan))
    assert got.shape == (2, 32, 48, 1) == want.shape
    assert _max_rel(got, want) <= 1e-5


# The port's bf16 expansion against the JAX module compiled to round every
# bf16 value (XLA's default keeps some bf16 intermediates in fp32): one
# bf16 step at the output's max. The port measured 0 here; the other cast
# orders below measured 1.17e-2 (fp32), 1.42e-2 (bf16 in-projection) and
# 2.27e-2 (bias added before the rounding), so they must miss it by 2x.
CAST_LIMIT = 2.0 ** -8


def test_attention_1d_to_2d_bf16_cast_order(expansion):
    """bf16 compute on the CPU: the port within 2e-2 of fp32 and of the
    JAX module in bf16, and within CAST_LIMIT of the JAX module without
    excess precision, a limit that three other cast orders miss: the whole
    expansion in fp32, bf16 in-projection weights, and Linears that add
    the bias before their one rounding."""
    jm, tm, variables, scan = (expansion[k] for k in
                               ("jm", "tm", "variables", "scan"))
    want32 = np.asarray(jax.jit(jm.apply)(variables, scan))
    jb = JAttention1Dto2D(mid_len=48, output_len=32, dtype=jnp.bfloat16)
    want16 = np.asarray(jax.jit(jb.apply)(variables, scan), np.float32)
    strict = jax.jit(jb.apply).lower(variables, scan).compile(
        compiler_options={"xla_allow_excess_precision": False})
    strict16 = np.asarray(strict(variables, scan), np.float32)

    def bf16_port(in_proj_dtype=torch.float32):
        tb = TAttention1Dto2D(mid_len=48, output_len=32, dtype=torch.bfloat16)
        tb.load_state_dict(tm.state_dict(), strict=True)
        for attn in (tb.attn1, tb.attn2):
            attn.in_proj_weight.data = attn.in_proj_weight.data.to(
                in_proj_dtype)
            attn.in_proj_bias.data = attn.in_proj_bias.data.to(in_proj_dtype)
        with torch.no_grad():
            out = tb(torch.from_numpy(scan))
        assert out.dtype == torch.bfloat16
        return out.float().numpy()

    got = bf16_port()
    assert _max_rel(got, want32) <= 2e-2
    assert _max_rel(got, want16) <= 2e-2
    assert _max_rel(got, strict16) <= CAST_LIMIT
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_nn.RoundedLinear, "forward", t_nn.Linear.forward)
        bias_first = bf16_port()
    others = dict(fp32=want32, bf16_in_proj=bf16_port(torch.bfloat16),
                  bias_before_rounding=bias_first)
    for name, out in others.items():
        assert _max_rel(out, strict16) > 2 * CAST_LIMIT, name


def test_attn2_attends_one_key(expansion):
    """attn2 has one key: its softmax is 1, the pseudo-depth is constant
    down each column, and query2 and the q/k thirds of attn2's
    in-projection get gradients of exactly 0, in both frameworks."""
    jm, tm, variables, scan = (expansion[k] for k in
                               ("jm", "tm", "variables", "scan"))
    out = tm(torch.from_numpy(scan))
    assert torch.equal(out, out[:, :1].expand_as(out))
    out.square().sum().backward()
    attn2 = tm.attn2
    assert torch.count_nonzero(tm.query2.grad) == 0
    assert torch.count_nonzero(attn2.in_proj_weight.grad[:128]) == 0
    assert torch.count_nonzero(attn2.in_proj_bias.grad[:128]) == 0
    assert torch.count_nonzero(attn2.in_proj_weight.grad[128:]) > 0
    assert torch.count_nonzero(tm.query1.grad) > 0

    def loss(params):
        y = jm.apply({"params": params}, scan)
        return jnp.sum(jnp.square(y))

    grads = jax.jit(jax.grad(loss))(variables["params"])
    assert not np.asarray(grads["query2"]).any()
    assert not np.asarray(grads["attn2"]["in_proj_weight"][:, :128]).any()
    assert np.asarray(grads["query1"]).any()


# --- DFormerTrav-Base + ham -------------------------------------------------

# DFormer-Base's widths with stage 2 cut from 12 blocks to 2: every stage
# still chains two blocks, and the JAX program of two encoder passes
# compiles in about a third of the full depth's time
SHORT_BASE = dict(J_VARIANTS["DFormer-Base"], depths=(2, 2, 2, 2))


@pytest.fixture(scope="module")
def pair():
    """JAX and port DFormerTrav-Base (stage 2 cut to SHORT_BASE) +
    LightHamHead (embed 64, 2 classes) on the same numpy-drawn weights, and
    the JAX outputs: meta_forward of a B 1, S 1 episode, and the encoder
    stages and logits of a B 2 request of the episode's two images
    (concatenated as meta_forward does, so that XLA compiles one encoder
    for both)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Base", SHORT_BASE)
        mp.setitem(T_VARIANTS, "DFormer-Base", SHORT_BASE)
        return _pair()


def _pair():
    cfg = trav_cfg()
    jmodel = j_build_model(cfg, pallas="off")
    rng = np.random.RandomState(4)
    ep = dict(s_rgb=rng.randn(1, 1, *HW, 3).astype(np.float32),
              s_depth=rng.randn(1, 1, 360).astype(np.float32),
              s_mask=np.zeros((1, 1, *HW), np.int32),
              q_rgb=rng.randn(1, *HW, 3).astype(np.float32),
              q_depth=rng.randn(1, 360).astype(np.float32))
    # foreground on the left half, an ignored band on top: on the 2x3
    # top-stage grid the resized mask is exactly 1, 0.5 and exactly 0
    ep["s_mask"][..., :HW[1] // 2] = 1
    ep["s_mask"][..., :8, :] = 255
    def request(ep):
        return (jnp.concatenate([ep["s_rgb"][0], ep["q_rgb"]]),
                jnp.concatenate([ep["s_depth"][0], ep["q_depth"]]))

    rgb, lidar = (np.array(a) for a in request(ep))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), rgb, lidar)
    variables = trav_variables(dict(shapes), seed=5)

    @jax.jit
    def run(v, ep):
        rgb, lidar = request(ep)
        # the logits as `__call__` composes them, on one encoder pass
        feats = jmodel.apply(v, rgb, lidar, method=JEncoderDecoder.encode)
        logits = jmodel.apply(v, feats, HW, method=JEncoderDecoder.decode)
        fused, inner = jmodel.apply(
            v, ep["s_rgb"], ep["s_depth"], ep["s_mask"], ep["q_rgb"],
            ep["q_depth"], return_episode=True,
            method=JEncoderDecoder.meta_forward)
        return feats, logits, fused, inner

    feats, logits, fused, inner = run(variables, ep)
    tmodel = t_build_model(cfg, device="cpu").eval()
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    bases = {b: torch.from_numpy(np.array(
        _uniform_bases(jax.random.PRNGKey(0), b, 512, 64))) for b in (1, 2)}
    return dict(cfg=cfg, variables=variables, tmodel=tmodel, rgb=rgb,
                lidar=lidar, ep=ep, bases=bases,
                feats=[np.asarray(f) for f in feats],
                logits=np.asarray(logits), fused=np.asarray(fused),
                inner={k: np.asarray(v) for k, v in inner.items()})


def test_trav_encoder_and_logits_match_jax(pair):
    tmodel = pair["tmodel"]
    rgb, lidar = torch.from_numpy(pair["rgb"]), torch.from_numpy(pair["lidar"])
    with torch.no_grad():
        feats = tmodel.encode(rgb, lidar)
        logits = tmodel(rgb, lidar, bases=pair["bases"][2])
    assert [tuple(f.shape) for f in feats] == \
        [f.shape for f in pair["feats"]]
    for i, (g, w) in enumerate(zip(feats, pair["feats"])):
        assert _max_rel(g, w) <= 1e-4, f"stage {i}"
    assert logits.shape == (2, *HW, 2)
    assert _max_rel(logits, pair["logits"]) <= 1e-4


def test_meta_forward_matches_jax(pair):
    tmodel, ep = pair["tmodel"], pair["ep"]
    with torch.no_grad():
        fused, inner = tmodel.meta_forward(
            *(torch.from_numpy(ep[k]) for k in
              ("s_rgb", "s_depth", "s_mask", "q_rgb", "q_depth")),
            bases=pair["bases"][1], return_episode=True)
    assert fused.shape == (1, *HW, 2)
    assert _max_rel(fused, pair["fused"]) <= 1e-4
    for k in ("q_top", "fg", "bg"):
        assert np.abs(pair["inner"][k]).max() > 0, k
        assert _max_rel(inner[k], pair["inner"][k]) <= 1e-4, k


def test_trav_state_dict_round_trips_through_the_jax_converter(pair):
    variables = pair["variables"]
    sd = {k: v.numpy() for k, v in pair["tmodel"].state_dict().items()}
    assert not any(".body." in k for k in sd)
    assert "encoder_backbone.attn_expand_e.attn1.in_proj_weight" in sd
    assert "encoder_backbone.stages.0.0.mlp.fc1.weight" in sd
    params, stats = convert_model_state(sd)
    zeros = jax.tree.map(np.zeros_like, variables)
    back, matched = load_into_variables(zeros, params, stats)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(sd) == len(leaves)
    assert len(matched) == len(jax.tree_util.tree_leaves(variables["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, want in leaves:
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))


def test_pretrained_load_fills_the_trav_encoder(pair, tmp_path):
    """A reference-layout encoder file written by the port (the body's keys
    flat beside attn_expand_e, under "backbone.") fills a fresh DFormerTrav
    encoder, and the JAX converter reads the same file into the same
    leaves."""
    enc = pair["tmodel"].encoder_backbone.state_dict()
    path = tmp_path / "trav_encoder.pth"
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in enc.items()}},
               path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(T_VARIANTS, "DFormer-Base", SHORT_BASE)
        fresh = t_build_model(pair["cfg"], device="cpu")
    matched = load_pretrained_encoder(fresh, str(path))
    names = {n for n, _ in fresh.encoder_backbone.named_parameters()}
    assert sorted(matched) == sorted(f"encoder_backbone.{n}" for n in names)
    for k, v in fresh.encoder_backbone.state_dict().items():
        assert torch.equal(v, enc[k]), k

    sd = strip_prefixes({k: v.numpy() for k, v in torch.load(
        path)["state_dict"].items()})
    p, s = convert_encoder_state(sd, trav=True)
    zeros = jax.tree.map(np.zeros_like, pair["variables"])
    back, jmatched = load_into_variables(
        zeros, {"encoder_backbone": p}, {"encoder_backbone": s})
    assert len(jmatched) == len(matched)
    want = dict(jax.tree_util.tree_leaves_with_path(
        pair["variables"]["params"]["encoder_backbone"]))
    got = dict(jax.tree_util.tree_leaves_with_path(
        back["params"]["encoder_backbone"]))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=str(k))


def test_decay_mask_matches_jax_on_the_trav_tree(pair):
    """The port's mask, carried through the JAX converter as constant
    tensors, equals the JAX mask leaf for leaf; the packed in-projections
    are decayed."""
    tmodel = pair["tmodel"]
    tmask = t_decay_mask(tmodel)
    params, _ = convert_model_state(
        {n: np.full(p.shape, float(tmask[n]), np.float32)
         for n, p in tmodel.named_parameters()})
    got = {path: bool(np.asarray(leaf).flat[0]) for path, leaf in
           jax.tree_util.tree_leaves_with_path(params)}
    want = dict(jax.tree_util.tree_leaves_with_path(
        j_decay_mask(pair["variables"]["params"])))
    assert got == want
    decayed = {n for n, d in tmask.items() if d}
    assert {"encoder_backbone.attn_expand_e.attn1.in_proj_weight",
            "encoder_backbone.attn_expand_e.attn2.in_proj_weight"} <= decayed
    assert not any("query" in n for n in decayed)


# --- builder and entry ------------------------------------------------------

@pytest.mark.parametrize("over", [dict(decoder="MLPDecoder"),
                                  dict(decoder="UPernet"),
                                  dict(aux_rate=0.4)])
def test_builder_refuses_what_is_not_ported(over):
    """Every decoder and the aux head are ported: the Trav config builds
    with them, the head the JAX builder would make, and no message names a
    ROADMAP item. What the builder refuses is a backbone it does not
    know."""
    cfg = trav_cfg(**over)
    model = t_build_model(cfg, device="cpu")
    want_aux = over.get("aux_rate", 0) != 0 or cfg.decoder == "UPernet"
    assert (model.aux_head is not None) == want_aux
    assert type(model.decode_head).__name__ == {
        "ham": "LightHamHead", "MLPDecoder": "MLPDecoderHead",
        "UPernet": "UPerHead"}[cfg.decoder]
    with pytest.raises(ValueError, match="unknown backbone"):
        TEncoderDecoder(backbone="DFormerTrav-Large")


def test_build_trav_serves_the_trav_config():
    """`local_configs.Trav.DFormer_Base` from the port's loader, cut to
    64x96: DFormerTrav-Base + ham with the config's fusion knobs, serving
    [B,360] scans; the card is the default device."""
    cfg = t_configs.load_config("local_configs.Trav.DFormer_Base")
    assert (cfg.backbone, cfg.decoder, cfg.num_classes) == \
        ("DFormerTrav-Base", "ham", 2)
    cfg.update(image_height=HW[0], image_width=HW[1])
    model = entry.build_trav(cfg, None, "cpu", seed=0)
    assert (model.temperature, model.alpha) == (1, 0.5)
    expand = model.encoder_backbone.attn_expand_e
    assert (expand.output_len, expand.mid_len) == HW
    rng = np.random.RandomState(6)
    labels = entry.infer(model, torch.from_numpy(
        rng.randn(2, *HW, 3).astype(np.float32)), torch.from_numpy(
        rng.randn(2, 360).astype(np.float32)))
    assert labels.shape == (2, *HW) and labels.dtype == torch.int32
    assert int(labels.min()) >= 0 and int(labels.max()) < 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry.build_trav(cfg)
