"""Which op makes the card's gradients vary from one run to the next.

    python -m dformer_torch.tools.grad_determinism [--runs 3]

1. Each decode head on a narrow DFormer (dims 32-256, one block per stage
   but two in the last; 64x96, batch 8, fp32, DropPath and dropout off,
   NMF bases pinned): one forward + backward `--runs` times on the card, by
   default, with `torch.backends.cudnn.deterministic`, and under
   `torch.use_deterministic_algorithms(True, warn_only=True)`. Per head and
   mode: the largest spread of a leaf's gradient between runs, as a share
   of the leaf's max (over the leaves above NULL_GRAD), how many leaves
   vary, and the ops the flag warns have no deterministic CUDA
   implementation.
2. Single ops of the model at its shapes (the bilinear resize, the
   adaptive pool, the masked cross entropy, layer norm, the depthwise
   conv, bmm), six runs each, by default and under the flag: the spread of
   the input gradients.
One JSON line per row. Sets CUBLAS_WORKSPACE_CONFIG (":4096:8") when it is
unset, as the flag asks of cuBLAS.
"""

import argparse
import json
import os
import warnings

import numpy as np
import torch
import torch.nn.functional as F

NARROW = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 2),
              num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
              mlp_ratios=(8, 8, 4, 4))
HEADS = (("ham", 0.0), ("MLPDecoder", 0.0), ("UPernet", 0.0),
         ("deeplabv3+", 0.0), ("nl", 0.0), ("ham", 0.4))
HW, BATCH, CLASSES = (64, 96), 8, 11
# a leaf whose gradient stays below this is structurally null (rounding
# noise, e.g. a bias a BatchNorm removes): its spread is counted, not scaled
NULL_GRAD = 3e-7


def _spread(runs):
    """(largest spread between runs of a leaf / its max over the leaves
    above NULL_GRAD, that leaf, leaves that vary at all) over {name:
    tensor} dicts of one shape."""
    worst, leaf, vary = 0.0, "", 0
    for name, first in runs[0].items():
        d = max((r[name] - first).abs().max().item() for r in runs[1:])
        vary += d > 0
        scale = first.abs().max().item()
        if scale > NULL_GRAD and d / scale > worst:
            worst, leaf = d / scale, name
    return worst, leaf, vary


def head_gradients(decoder, aux_rate, runs):
    from dformer_torch import entry
    from dformer_torch.models.nn import Dropout
    from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean

    rng = np.random.RandomState(31)
    rgb, depth = (torch.from_numpy(rng.randn(BATCH, *HW, 3)
                                   .astype(np.float32)).cuda()
                  for _ in range(2))
    gt = torch.from_numpy(rng.randint(0, CLASSES, (BATCH, *HW))).cuda()
    bases = torch.from_numpy(rng.rand(BATCH, 512, 64).astype(np.float32))
    bases = (bases / torch.linalg.norm(bases, dim=1, keepdim=True)).cuda()
    out = []
    for _ in range(runs):
        model = entry.build_trainer(
            "DFormer-Narrow", HW, CLASSES, torch.float32, "cuda", seed=0,
            decoder=decoder, aux_rate=aux_rate, drop_path_rate=0.0)[0]
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        logits, aux = model.forward_with_aux(rgb, depth, bases=bases)
        loss = softmax_cross_entropy_masked_mean(logits, gt)
        if model.aux_rate:
            loss = loss + model.aux_rate * \
                softmax_cross_entropy_masked_mean(aux, gt)
        loss.backward()
        out.append({n: p.grad.double().cpu()
                    for n, p in model.named_parameters()
                    if p.grad is not None})
    return out


def op_cases():
    """(name, input shapes, dtype, fn) of single ops at the model's
    shapes (NHWC, as the port calls them)."""
    from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean
    from dformer_torch.ops.pool import adaptive_avg_pool2d
    from dformer_torch.ops.resize import resize_bilinear

    labels = torch.from_numpy(np.random.RandomState(0).randint(
        0, CLASSES, (BATCH, *HW))).cuda()
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        cases += [
            ("resize_bilinear 16x24->64x96 C11", [(8, 16, 24, 11)], dt,
             lambda x: resize_bilinear(x, HW)),
            ("resize_bilinear 7x7->16x24 C64", [(8, 7, 7, 64)], dt,
             lambda x: resize_bilinear(x, (16, 24))),
            ("resize_bilinear 15x20->120x160 C512", [(8, 15, 20, 512)], dt,
             lambda x: resize_bilinear(x, (120, 160))),
            ("adaptive_avg_pool2d 16x24->7x7 C96", [(8, 16, 24, 96)], dt,
             lambda x: adaptive_avg_pool2d(x, (7, 7))),
            ("adaptive_avg_pool2d 120x160->7x7 C144", [(8, 120, 160, 144)],
             dt, lambda x: adaptive_avg_pool2d(x, (7, 7)))]
    f32 = torch.float32
    cases += [
        ("masked CE (log_softmax + gather)", [(8, *HW, CLASSES)], f32,
         lambda x: softmax_cross_entropy_masked_mean(x, labels)),
        ("layer_norm", [(8, 16, 24, 64), (64,), (64,)], f32,
         lambda x, w, b: F.layer_norm(x, (64,), w, b)),
        ("depthwise conv 7x7 NHWC", [(8, 64, 16, 24), (64, 1, 7, 7)], f32,
         lambda x, w: F.conv2d(x.contiguous(
             memory_format=torch.channels_last), w, padding=3, groups=64)),
        ("bmm", [(8, 384, 64), (8, 64, 49)], f32, torch.bmm)]
    return cases


def op_spread(shapes, dtype, fn, runs=6):
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = [torch.randn(s, generator=gen, device="cuda").to(dtype)
              for s in shapes]
    grads = []
    for _ in range(runs):
        xs = [t.clone().requires_grad_(True) for t in inputs]
        y = fn(*xs)
        w = torch.linspace(-1, 1, y.numel(), device="cuda").view(y.shape)
        (y * w.to(y.dtype)).sum().backward()
        grads.append({str(i): x.grad.double() for i, x in enumerate(xs)})
    return _spread(grads)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from dformer_torch.kernels import build
    from dformer_torch.models.encoder import VARIANTS

    if not torch.cuda.is_available():
        raise SystemExit("grad_determinism: CUDA is not available")
    build.build_all()
    VARIANTS.setdefault("DFormer-Narrow", NARROW)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def emit(rec):
        print(json.dumps(rec), flush=True)

    for mode in ("default", "cudnn_deterministic", "deterministic_flag"):
        torch.backends.cudnn.deterministic = mode == "cudnn_deterministic"
        torch.use_deterministic_algorithms(mode == "deterministic_flag",
                                           warn_only=True)
        for decoder, aux_rate in HEADS:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = head_gradients(decoder, aux_rate, args.runs)
            worst, leaf, vary = _spread(runs)
            emit({"part": "heads", "mode": mode, "decoder": decoder,
                  "aux_rate": aux_rate, "max_rel_between_runs": worst,
                  "leaf": leaf, "leaves_that_vary": vary,
                  "leaves": len(runs[0]), "warned_ops": sorted(
                      {str(w.message).split(" does not")[0][:100]
                       for w in caught
                       if "deterministic" in str(w.message)})})
    for flag in (False, True):
        torch.use_deterministic_algorithms(flag, warn_only=True)
        for name, shapes, dtype, fn in op_cases():
            worst, _, _ = op_spread(shapes, dtype, fn)
            emit({"part": "ops", "deterministic_flag": flag, "op": name,
                  "dtype": str(dtype).split(".")[-1],
                  "max_rel_between_runs": worst, "varies": worst > 0})
    torch.use_deterministic_algorithms(False)
    emit({"card": torch.cuda.get_device_name(0)})


if __name__ == "__main__":
    main()
