"""The port's serving artifact on the CPU: the fused-MLP kernels as
`torch.library` ops (`opcheck`), `tools.export` of a narrow DFormer + ham
with a symbolic batch round-tripped through a `.pt2` file, its logits
against the eager model's, its graph's op nodes, `Evaluator.from_exported`
and `tools.eval --exported`, and an exported narrow model + MLPDecoder
against the JAX eval forward on the same numpy-drawn weights. fp32, one
torch thread; two exports of ~8 s each are most of the file's time."""

import copy
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dformer_torch import configs as t_configs
from dformer_torch import entry
from dformer_torch.data.loader import device_val_batches
from dformer_torch.eval.evaluate import Evaluator
from dformer_torch.kernels import fused_mlp as t_fm
from dformer_torch.models import build_model as t_build_model
from dformer_torch.models.encoder import VARIANTS as T_VARIANTS
from dformer_torch.models.encoder import MLPBlock
from dformer_torch.runtime.export import export_forward, load_exported
from dformer_torch.tools import eval as t_eval_tool
from dformer_torch.tools import export as t_export_tool
from dformer_torch.utils.convert import from_jax_variables
from dformer_tpu.config import AttrDict
from dformer_tpu.models import build_model as j_build_model
from dformer_tpu.models.encoder import VARIANTS as J_VARIANTS

from test_torch_model import _random_variables

NARROW1 = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 1),
               num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
               mlp_ratios=(8, 8, 4, 4))
HW, CLASSES = (64, 96), 11
CONFIG = "local_configs.test.DFormer_Narrow1"
JAX_LIMIT = 1e-4  # max |diff| / max |JAX logits|, as the decoder tests


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfg():
    """NYUDepthv2's config cut to the narrow model + ham at 64x96 and 3
    synthetic val images."""
    cfg = t_configs.load_config("local_configs.NYUDepthv2.DFormer_Tiny")
    cfg.update(backbone="DFormer-Narrow1", image_height=HW[0],
               image_width=HW[1], num_classes=CLASSES, num_eval_imgs=3)
    return cfg


@pytest.fixture(scope="module")
def narrow():
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(J_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(T_VARIANTS, "DFormer-Narrow1", NARROW1)
        mp.setitem(t_configs.LEAVES, CONFIG, _cfg)
        yield


@pytest.fixture(scope="module")
def artifact(narrow, tmp_path_factory):
    """(path of `tools.export`'s fp32 artifact with a symbolic batch, the
    program loaded from it, the eager model it was exported from)."""
    path = str(tmp_path_factory.mktemp("export") / "narrow.pt2")
    assert t_export_tool.main([f"--config={CONFIG}", "--device=cpu",
                               "--no-amp", f"--out={path}"]) == path
    model = entry.build_evaluator(_cfg(), None, "cpu")[0].model
    return path, load_exported(path), model


def _inputs(b, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, *HW, 3).astype(np.float32))
            for _ in range(2)]


def test_exported_logits_equal_the_eager_model(artifact):
    """The loaded artifact at B=1 and B=3 (a batch the export never saw):
    bit-equal to the eager model's logits (the same ops on the same
    weights; the ham head's seeded bases are the same rows)."""
    _, program, model = artifact
    module = program.module()
    for b in (1, 3):
        rgb, modal = _inputs(b, b)
        with torch.inference_mode():
            got, want = module(rgb, modal), model(rgb, modal)
        assert got.shape == (b, *HW, CLASSES)
        assert torch.equal(got, want), b


def test_graph_has_one_fused_mlp_node_per_mlp_call(artifact):
    """One `dformer_torch.fused_mlp` node per MLP block of the model (each
    runs once per forward) and no backward node."""
    _, program, model = artifact
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    blocks = sum(isinstance(m, MLPBlock) for m in model.modules())
    assert blocks == 7
    assert targets.count("dformer_torch.fused_mlp.default") == blocks
    assert not any("fused_mlp_backward" in t for t in targets)


def test_evaluator_from_exported_matches_the_live_evaluator(artifact):
    """`Evaluator.from_exported` gives the live Evaluator's hist over 3
    synthetic images in batches of 2; its multi-scale and sliding modes
    raise."""
    _, program, model = artifact
    cfg = _cfg()
    ev = Evaluator.from_exported(program, cfg, device="cpu")
    live = Evaluator(model, cfg, device="cpu")

    def batches():
        return device_val_batches(cfg, 2, "cpu", synthetic=True, n=3)

    want = live.evaluate(batches()).hist
    np.testing.assert_array_equal(ev.evaluate(batches()).hist, want)
    assert want.sum() == 3 * HW[0] * HW[1]
    with pytest.raises(ValueError, match="multi-scale"):
        ev.evaluate_msf(batches(), scales=[0.5, 1.0], flip=True)
    ev.sliding = True
    with pytest.raises(ValueError, match="sliding"):
        ev.evaluate(batches())


def test_evaluator_from_exported_moves_the_program_to_its_device(artifact):
    """The program runs on the Evaluator's device, not the one it was
    exported on (under torchrun a rank's card, where the artifact holds
    cuda:0): a copy of the CPU artifact served on the meta device keeps no
    CPU tensor (a CPU weight, constant or device literal meeting a meta
    input raises) and gives logits of the served shape there."""
    _, program, _ = artifact
    ev = Evaluator.from_exported(copy.deepcopy(program), _cfg(),
                                 device="meta")
    rgb, modal = (torch.zeros((2, *HW, 3), device="meta") for _ in range(2))
    out = ev._forward(rgb, modal)
    assert out.device.type == "meta" and out.shape == (2, *HW, CLASSES)


def test_eval_tool_serves_the_artifact(artifact, capsys, monkeypatch):
    """`tools.eval --exported`: the file's program (the one loaded above:
    a load takes ~4 s here) at single scale, MSF turned off with a note,
    the metrics line printed."""
    path, program, _ = artifact
    loaded = []
    monkeypatch.setattr(entry, "load_exported",
                        lambda p: loaded.append(p) or program)
    t_eval_tool.main([f"--config={CONFIG}", "--device=cpu",
                      "--synthetic-data", f"--exported={path}"])
    out = capsys.readouterr().out
    assert loaded == [path] and "MSF and sliding are off" in out
    miou = float(re.search(r"'mIoU': (?:np\.float64\()?([0-9.]+)",
                           out).group(1))
    assert 0 <= miou <= 100


def test_exported_mlp_decoder_matches_jax_eval_forward(narrow):
    """The narrow model + MLPDecoder (no NMF, so no bases to differ) on
    numpy-drawn JAX weights converted to the port: the program exported at
    B=2 against `model.apply(..., train=False)`, within JAX_LIMIT of max
    |logits|."""
    cfg = AttrDict(backbone="DFormer-Narrow1", decoder="MLPDecoder",
                   num_classes=CLASSES, decoder_embed_dim=64,
                   drop_path_rate=0.0, aux_rate=0.0, bn_eps=1e-3,
                   bn_momentum=0.1)
    jmodel = j_build_model(cfg, pallas="off")
    zeros = jnp.zeros((1, *HW, 3))
    shapes = jax.eval_shape(lambda k: jmodel.init(k, zeros, zeros),
                            jax.random.PRNGKey(0))
    variables = _random_variables(dict(shapes), seed=12)
    tmodel = t_build_model(cfg, device="cpu")
    tmodel.load_state_dict(from_jax_variables(variables), strict=True)
    module = export_forward(tmodel, HW, batch=2).module()
    rgb, modal = _inputs(2, 13)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(v, a, b,
                                                           train=False))(
        variables, rgb.numpy(), modal.numpy()))
    with torch.inference_mode():
        got = module(rgb, modal).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= JAX_LIMIT, err


@pytest.mark.parametrize("op", ["fused_mlp", "fused_mlp_backward"])
def test_kernel_ops_pass_opcheck(op):
    """`torch.library.opcheck` (schema, autograd registration, fake
    implementation against the CPU one, AOT dispatch with dynamic shapes)
    on each op at one small shape, fp32 on the CPU, with the fc weights
    passed as the transposed views `MLPBlock` passes."""
    rng = np.random.RandomState(3)
    B, H, W, C, Ch = 2, 5, 6, 16, 64

    def t(*shape, scale=1.0, grad=False):
        v = torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
        return v.requires_grad_(grad)

    grad = op == "fused_mlp"
    args = [t(B, H, W, C, grad=grad), 1 + t(C, scale=0.1).detach(),
            t(C, scale=0.1, grad=grad), t(Ch, C, scale=0.2, grad=grad).t(),
            t(Ch, scale=0.1, grad=grad), t(3, 3, Ch, scale=0.2, grad=grad),
            t(Ch, scale=0.1, grad=grad), t(C, Ch, scale=0.1, grad=grad).t(),
            t(C, scale=0.1, grad=grad)]
    args[1].requires_grad_(grad)
    if op == "fused_mlp_backward":
        args.append(t(B, H, W, C))
    result = torch.library.opcheck(getattr(t_fm, f"_{op}_op"),
                                   (*args, 1e-6))
    assert set(result.values()) == {"SUCCESS"}, result
