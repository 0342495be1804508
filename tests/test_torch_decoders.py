"""The port's decode heads against the JAX package's on the CPU, fp32 unless
stated, on the same numpy-drawn weights: FCN, MLPDecoder, UPernet,
deeplabv3+ and nl on a feature pyramid of dims (32, 64, 128, 256) at 16x24
down to 2x3 (key round trip, eval output, train-mode output, BatchNorm
statistics and gradients, the bf16 cast order), and the full-backprop NMF.
The heads inside a whole model are in tests/test_torch_decoders_model.py.

Dropout is off on both sides in training (JAX's random stream cannot be
replayed): the JAX heads' `Dropout` is replaced by the identity and the
port's rates are set to 0."""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

from dformer_torch.models import build_model as t_build_model
from dformer_torch.models import decoders as t_dec
from dformer_torch.models.decoders.ham import nmf2d as t_nmf2d
from dformer_torch.models import nn as t_nn
from dformer_torch.models.nn import Dropout as TDropout
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import decoders as j_dec
from dformer_tpu.models import nn as j_nn
from dformer_tpu.models.decoders import deeplabv3p as j_deeplab
from dformer_tpu.models.decoders import ham as j_ham
from dformer_tpu.models.decoders import mlp as j_mlp
from dformer_tpu.models.decoders import nl as j_nl
from dformer_tpu.utils.convert import convert_model_state, load_into_variables

from test_torch_model import _random_variables
from test_torch_train import _IdentityDropout

DIMS = (32, 64, 128, 256)
SIZES = ((16, 24), (8, 12), (4, 6), (2, 3))
B, CLASSES = 2, 11
EVAL_REL = 1e-5      # eval output, of max|JAX|
TRAIN_REL = 1e-4     # train output, statistics, gradients: of each leaf's max
BF16_REL = 2.0 ** -8  # bf16 output against JAX without excess precision
NULL_GRAD = 1e-5     # structurally null gradients, of the largest one

# name -> (JAX head, port head), each from the compute dtype
HEADS = {
    "fcn": (lambda dt: j_dec.FCNHead(num_classes=CLASSES, dtype=dt),
            lambda dt: t_dec.FCNHead(DIMS[-1], CLASSES, dtype=dt)),
    "MLPDecoder": (
        lambda dt: j_dec.MLPDecoderHead(num_classes=CLASSES, embed_dim=64,
                                        dtype=dt),
        lambda dt: t_dec.MLPDecoderHead(DIMS, CLASSES, embed_dim=64,
                                        dtype=dt)),
    "UPernet": (
        lambda dt: j_dec.UPerHead(num_classes=CLASSES, channels=64, dtype=dt),
        lambda dt: t_dec.UPerHead(DIMS, CLASSES, channels=64, dtype=dt)),
    "deeplabv3+": (
        lambda dt: j_dec.DeepLabV3Plus(num_classes=CLASSES, aspp_channels=64,
                                       dtype=dt),
        lambda dt: t_dec.DeepLabV3Plus(DIMS, CLASSES, aspp_channels=64,
                                       dtype=dt)),
    "nl": (lambda dt: j_dec.NLHead(num_classes=CLASSES, channels=64,
                                   dtype=dt),
           lambda dt: t_dec.NLHead(DIMS, channels=64, num_classes=CLASSES,
                                   dtype=dt)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def no_jax_dropout():
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_mlp, j_deeplab, j_nl, j_ham):
            mp.setattr(mod, "Dropout", _IdentityDropout)
        yield


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, TDropout):
            m.rate = 0.0
    return model


def _max_rel(got, want):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _head_sd(tree):
    """A head's flax variables (or gradient tree) -> the port head's
    state_dict names and layouts."""
    sd = from_jax_variables({c: {"decode_head": v} for c, v in tree.items()})
    return {k[len("decode_head."):]: v for k, v in sd.items()}


class _ConvBNInDtype(j_deeplab._ConvBN):
    """The JAX `_ConvBN` computing in its `dtype`, as the JAX `Conv` does:
    input and kernel cast to it, the product rounded, the bias added in it.
    (The JAX module casts neither, and `lax.conv_general_dilated` refuses
    a bf16 input against the fp32 kernel, so its head runs in fp32 only.)"""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        dt = self.dtype or x.dtype
        pad = (self.kernel // 2) * self.dilation
        y = jax.lax.conv_general_dilated(
            x.astype(dt), self.param_conv(x).astype(dt), (1, 1),
            [(pad, pad), (pad, pad)],
            rhs_dilation=(self.dilation, self.dilation),
            dimension_numbers=("NHWC", "HWIO", "NHWC"))
        if self.use_bias:
            y = y + self.param("bias", fnn.initializers.zeros,
                               (self.features,)).astype(dt)
        y = j_nn.BatchNorm(eps=self.bn_eps, momentum=self.bn_momentum,
                           name="bn")(y, use_running_average=not train)
        return jax.nn.relu(y)


@pytest.fixture(scope="module")
def jax_head():
    """name -> (feats, cotangent, variables, JAX results) of one head, made
    at the first call: the eval output, and in train mode the output, the
    new BatchNorm statistics and the gradient of sum(output * cotangent);
    one jit per head."""
    made = {}

    def get(name):
        if name in made:
            return made[name]
        jhead = HEADS[name][0](None)
        rng = np.random.RandomState(sorted(HEADS).index(name))
        feats = [rng.randn(B, h, w, c).astype(np.float32)
                 for (h, w), c in zip(SIZES, DIMS)]
        shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), feats)
        variables = _random_variables(dict(shapes), seed=10)
        out_shape = jax.eval_shape(jhead.apply, variables, feats).shape
        cot = rng.randn(*out_shape).astype(np.float32)

        @jax.jit
        def run(v, feats, cot):
            def loss(params):
                out, new = jhead.apply(
                    {"params": params, "batch_stats": v["batch_stats"]},
                    feats, train=True, mutable=["batch_stats"])
                return jnp.sum(out * cot), (out, new["batch_stats"])

            (_, (out, stats)), grads = jax.value_and_grad(
                loss, has_aux=True)(v["params"])
            return jhead.apply(v, feats), out, stats, grads

        made[name] = (feats, cot, variables,
                      jax.tree.map(np.asarray, run(variables, feats, cot)))
        return made[name]

    return get


def _port_head(name, variables, dtype=None):
    head = HEADS[name][1](dtype)
    head.load_state_dict(_head_sd(variables), strict=True)
    return _no_dropout(head)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_keys_round_trip_through_the_jax_converter(name, jax_head):
    _, _, variables, _ = jax_head(name)
    sd = {f"decode_head.{k}": v.numpy()
          for k, v in _port_head(name, variables).state_dict().items()}
    params, stats = convert_model_state(sd)
    wrapped = {c: {"decode_head": v} for c, v in variables.items()}
    zeros = jax.tree.map(np.zeros_like, wrapped)
    back, matched = load_into_variables(zeros, params, stats)
    leaves = jax.tree_util.tree_leaves_with_path(wrapped)
    assert len(sd) == len(leaves)
    assert len(matched) == len(jax.tree.leaves(wrapped["params"]))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, want in leaves:
        np.testing.assert_array_equal(got[path], want, err_msg=str(path))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_eval_output_matches_jax(name, jax_head):
    feats, _, variables, (want, *_) = jax_head(name)
    head = _port_head(name, variables).eval()
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats])
    assert got.shape == want.shape
    assert _max_rel(got, want) <= EVAL_REL


def _leaf_rel(got, want):
    want = np.asarray(want)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_train_mode_matches_jax(name, jax_head):
    """Batch statistics: the output, the running statistics after the
    step, and every parameter's gradient for one fixed cotangent. Conv
    biases in front of a train-mode BatchNorm have gradients of exactly 0
    in exact arithmetic (as have nl's g and phi biases: a shift of g's
    output or of every key passes the softmax unchanged, and the BatchNorm
    behind removes it); there both sides' rounding noise (measured up to
    1.2e-6) must stay below NULL_GRAD of the largest gradient."""
    feats, cot, variables, (_, want, stats, grads) = jax_head(name)
    head = _port_head(name, variables).train()
    out = head([torch.from_numpy(f) for f in feats])
    (out * torch.from_numpy(cot)).sum().backward()
    assert _max_rel(out, want) <= TRAIN_REL
    sd = head.state_dict()
    for key, value in _head_sd({"batch_stats": stats}).items():
        assert _leaf_rel(sd[key].numpy(), value) <= TRAIN_REL, key
    want_grads = _head_sd({"params": grads})
    top = max(np.abs(g.numpy()).max() for g in want_grads.values())
    null = 0
    for key, p in head.named_parameters():
        want_g = want_grads[key].numpy()
        if np.abs(want_g).max() < NULL_GRAD * top:
            assert key.endswith("bias"), key
            assert np.abs(p.grad.numpy()).max() < NULL_GRAD * top, key
            null += 1
        else:
            assert _leaf_rel(p.grad.numpy(), want_g) <= TRAIN_REL, key
    assert null < len(want_grads) // 2


def _bf16_ulp(x):
    """One bf16 ulp of each value (0 at 0)."""
    _, e = np.frexp(np.abs(x))
    return np.where(x == 0, 0.0, np.ldexp(1.0, e - 8))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_head_bf16_cast_order(name, jax_head, monkeypatch):
    """bf16 compute on fp32 parameters, eval mode, against the JAX head in
    bf16 compiled without excess precision (XLA's default keeps some bf16
    values in fp32): each value within BF16_REL of max|JAX|, or within one
    bf16 ulp of its own where that is more (fp32 summation order flips a
    rounding now and then: measured 1 ulp at 1.06 of a max of 1.56 for
    deeplabv3+). Every conv and Linear of the heads rounds its product to
    bf16 before adding the bias, as JAX's do; with the bias added before
    the one rounding (`F.conv2d`, `F.linear`) twice as many values or more
    differ from JAX's (measured 56-69% against 0-26%)."""
    if name == "deeplabv3+":
        monkeypatch.setattr(j_deeplab, "_ConvBN", _ConvBNInDtype)
    feats, _, variables, _ = jax_head(name)
    jhead = HEADS[name][0](jnp.bfloat16)
    f16 = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    strict = jax.jit(jhead.apply).lower(variables, f16).compile(
        compiler_options={"xla_allow_excess_precision": False})
    want = np.asarray(strict(variables, f16), np.float32)

    def port():
        head = _port_head(name, variables, torch.bfloat16).eval()
        with torch.no_grad():
            out = head([torch.from_numpy(f).to(torch.bfloat16)
                        for f in feats])
        assert out.dtype == torch.bfloat16
        return out.float().numpy()

    got = port()
    limit = np.maximum(BF16_REL * np.abs(want).max(), _bf16_ulp(want))
    assert (np.abs(got - want) <= limit).all(), _max_rel(got, want)
    with monkeypatch.context() as mp:
        mp.setattr(t_nn.RoundedConv2d, "forward", t_nn.Conv2d.forward)
        mp.setattr(t_nn.RoundedLinear, "forward", t_nn.Linear.forward)
        bias_first = port()
    assert (got != want).mean() < 0.5 * (bias_first != want).mean()


# --- the full-backprop NMF ---------------------------------------------------

def test_full_backprop_nmf_matches_jax():
    """`one_step_grad=False` differentiates all six updates: `nmf2d` and a
    ham head in train mode (bases pinned), value and gradients against
    JAX's; `build_model` reads `cfg.nmf_one_step_grad`."""
    rng = np.random.RandomState(20)
    x = np.abs(rng.randn(2, 24, 16)).astype(np.float32)
    bases = rng.rand(2, 16, 8).astype(np.float32)
    bases /= np.linalg.norm(bases, axis=1, keepdims=True)
    cot = rng.randn(2, 24, 16).astype(np.float32)

    def jloss(x_):
        out = j_ham.nmf2d(x_, jnp.asarray(bases), train=True,
                          one_step_grad=False)
        return jnp.sum(out * cot), out

    (_, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = t_nmf2d(tx, torch.from_numpy(bases), train=True,
                   one_step_grad=False)
    (tout * torch.from_numpy(cot)).sum().backward()
    assert _max_rel(tout, jout) <= TRAIN_REL
    assert _max_rel(tx.grad, jgrad) <= TRAIN_REL
    one_step = torch.from_numpy(x).requires_grad_()
    (t_nmf2d(one_step, torch.from_numpy(bases), train=True)
     * torch.from_numpy(cot)).sum().backward()
    assert _max_rel(one_step.grad, jgrad) > 1e-2  # the two modes differ

    # the ham head over the pyramid, train mode
    in_ch = DIMS[1:]
    jhead = j_dec.LightHamHead(channels=64, ham_channels=64,
                               num_classes=CLASSES, one_step_grad=False)
    feats = [rng.randn(B, h, w, c).astype(np.float32)
             for (h, w), c in zip(SIZES, DIMS)]
    shapes = jax.eval_shape(jhead.init, jax.random.PRNGKey(0), feats)
    variables = _random_variables(dict(shapes), seed=21)
    hb = rng.rand(B, 64, 64).astype(np.float32)
    hb /= np.linalg.norm(hb, axis=1, keepdims=True)
    hcot = rng.randn(B, *SIZES[1], CLASSES).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ham, "_uniform_bases", lambda key, b, d, r: hb)

        def loss(params):
            out, _ = jhead.apply(
                {"params": params, "batch_stats": variables["batch_stats"]},
                feats, train=True, mutable=["batch_stats"])
            return jnp.sum(out * hcot)

        grads = jax.jit(jax.grad(loss))(variables["params"])
    thead = t_dec.LightHamHead(in_ch, channels=64, ham_channels=64,
                               num_classes=CLASSES, one_step_grad=False)
    thead.load_state_dict(_head_sd(variables), strict=True)
    out = _no_dropout(thead).train()([torch.from_numpy(f) for f in feats],
                                     bases=torch.from_numpy(hb))
    (out * torch.from_numpy(hcot)).sum().backward()
    want_grads = _head_sd({"params": grads})
    top = max(np.abs(g.numpy()).max() for g in want_grads.values())
    for key, p in thead.named_parameters():
        want_g = want_grads[key].numpy()
        if np.abs(want_g).max() < NULL_GRAD * top:
            assert np.abs(p.grad.numpy()).max() < NULL_GRAD * top, key
        else:
            assert _leaf_rel(p.grad.numpy(), want_g) <= TRAIN_REL, key

    cfg = AttrDict(backbone="DFormer-Tiny", decoder="ham", num_classes=3,
                   nmf_one_step_grad=False)
    assert not t_build_model(cfg, device="cpu").decode_head.hamburger \
        .one_step_grad
    cfg.pop("nmf_one_step_grad")
    assert t_build_model(cfg, device="cpu").decode_head.hamburger \
        .one_step_grad
