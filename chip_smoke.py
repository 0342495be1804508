#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`dformer_torch`) on one NVIDIA Hopper card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device      - nvidia-smi name and power limit, torch/CUDA versions, sm 9.0
  2. build       - nvcc builds every kernel under dformer_torch/kernels/csrc
  3. kernels     - each kernel (fused-MLP forward and backward) against its
                   plain PyTorch version at the shapes of the main path
                   (DFormer-L, 480x640, bs8, bf16) and at one fp32 shape;
                   kernel, plain and bound times, occupancy; both kernels
                   run twice (bit-equal); torch.matmul of the products as
                   a yardstick
  4. slice       - DFormer-Large + LightHamHead answers 3 bs8 480x640
                   requests through entry.infer; launch counts per forward;
                   ms per forward from 10 more forwards
  5. cpu_vs_card - one bs1 request on the card (bf16, kernel path) and on the
                   CPU (fp32, plain path), same weights
  6. train       - entry.build_trainer + entry.train_steps: 3 counted and 5
                   timed steps of DFormer-Large + LightHamHead at bs8 480x640
                   bf16; launch counts per step, gradients, parameters and
                   BatchNorm statistics checked
  7. train_cpu_vs_card - one forward + backward of a narrow model in fp32 on
                   the card (both kernels) and on the CPU (plain versions):
                   loss and every parameter's gradient
  8. eval        - entry.build_evaluator + Evaluator on synthetic val batches
                   of DFormer-Large + LightHamHead: single scale bf16 (16
                   images in batches of 4), MSF + flip bf16 (12) and fp32
                   (8), sliding window under the SUNRGBD config (4 images of
                   530x730 in batches of 2, 4 windows each); hists, metrics,
                   MSF accumulators and launch counts checked; ms per image,
                   whole and after the first group; the forward kernel
                   against its plain version and timed at every stage map of
                   both MSF + flip runs
  9. eval_cpu_vs_card - MSF + flip of a narrow fp32 model on the card
                   (kernel) and on the CPU (plain version): equal hists
 10. fit         - dformer_torch.tools.train.run on the NYUDepthv2
                   DFormer-Large config (bf16, bs8, 480x640, synthetic
                   data): 2 epochs of 4 iterations, MSF + flip fp32
                   evaluation of 4 images after epoch 1, a rescue checkpoint
                   after epoch 2 (a preemption requested there), then a
                   second run resumed from it for epoch 3; launches per
                   step, losses, steps, kept checkpoints, the restored state
                   and the file's logits in a fresh model checked; the
                   augmentation on the card against the CPU on one batch;
                   ms per step, augment ms, eval and checkpoint seconds,
                   checkpoint bytes, peak memory
 11. trav_kernels - both kernels at the 8 fused-MLP shapes of
                   DFormerTrav-Base at 480x640 in an FSS step's encoder
                   pass of 12 images (bf16): limits, bit-equal reruns,
                   times, bounds, torch.matmul yardsticks
 12. trav        - entry.build_trav on the Trav config (DFormerTrav-Base +
                   ham, bf16): bs2 requests of seed-made rgb and lidar, the
                   pseudo-depth constant down its columns, ms per forward;
                   then tools.train_trav.run on in-memory rows (one epoch
                   of 2 bs2 steps, pseudo-labels and their manifest for 4
                   images); launches counted
 13. fss         - tools.train_trav_fss.run on in-memory episodes (batch 2
                   x (5 + 1), 480x640, bf16): 2 epochs of 3 steps and 2
                   evaluation episodes each, a rescue checkpoint at the
                   start of epoch 3, then --class-episodes with the
                   contrastive term for one epoch; frozen parameters
                   unchanged, trainable ones updated (but query2), the
                   rescue file's logits in a fresh model, launches; ms per
                   FSS step and per eval episode, peak memory
 14. fss_cpu_vs_card - one FSS step at 64x96 on the CPU in float64 (the
                   reference, plain versions, its ReLU branches recorded)
                   and in fp32 on the card (both kernels, those branches
                   replayed): loss and gradients, and a card run with TF32
                   that the limit must refuse
 15. decoders    - DFormer-Large with each head of the JAX package
                   (MLPDecoder, UPernet, deeplabv3+, nl; ham with the FCN
                   aux head at aux_rate 0.4) at 480x640, bs8, bf16: 10
                   timed forwards through entry.infer, 3 + 5 timed steps
                   through entry.train_steps, peak memory, single-scale
                   evaluation of 4 images whose labels equal the served
                   forward's; 39 forward-kernel launches per forward, 39 +
                   39 per step
 16. decoders_cpu_vs_card - each head's narrow forward + backward at
                   bs8 against the float64 CPU, as in phase 14
 17. decoders_fit - tools.train.run on the NYUDepthv2 DFormer-Large config
                   with UPernet and aux_rate 0.4: 2 epochs of 3 steps, an
                   fp32 MSF + flip evaluation of 4 images, a rescue
                   checkpoint whose logits a fresh model reproduces
 18. convergence - tools.smoke_convergence.main at its defaults: 600
                   bf16 steps of DFormer-Tiny here and, side by side in a
                   second process, of DFormerTrav-Base (--trav), on the
                   learnable synthetic tasks; held-out
                   mIoU >= 60, losses finite and falling from the first 100
                   steps to the last 100, both kernels in every step
 19. tools       - the port's measurement tools, each at its defaults in
                   this process, each JSON line parsed and its numbers
                   finite and positive: dformer_torch.bench (whose labels
                   must equal entry.infer's on the same weights and
                   inputs), tools.latency, tools.benchmark,
                   tools.train_bench, tools.eval_bench (MSF + flip, and
                   --sliding); then trace_forward.trace for every head,
                   serving and training; launches counted
 20. ddp         - data-parallel training on the one card, each rank a
                   process started with torchrun's environment: world 1
                   over NCCL, 3 steps of DFormer-Large + ham (bf16, bs8)
                   bit-equal to the same steps with no process group, 39 +
                   39 launches and one gradient all-reduce per step; world
                   2 over gloo (2 x bs4 against 1 x bs8): a narrow fp32
                   model's every leaf within a limit, the Large losses'
                   differences; ms per step of each
 21. export      - DFormer-Large + ham (bf16) exported with a symbolic
                   batch into a temporary .pt2, loaded in a fresh process
                   and run at B=1 and B=8: labels equal to entry.infer's,
                   logits within a limit of the eager model's, 39
                   forward-kernel launches per call; artifact bytes,
                   export / load seconds, ms per bs8 forward
 22. trav_ddp    - Trav data-parallel training on the one card, as in
                   phase 20: world 1 over NCCL, 3 FSS steps (2 episodes of
                   5 shots + 1 query) and 3 supervised steps (batch 2) of
                   DFormerTrav-Base + ham (bf16) bit-equal to the same
                   steps with no process group, 39 + 39 launches and one
                   gradient all-reduce per step; world 2 over gloo: a
                   narrow fp32 model's every leaf within a limit of world
                   1's, the Base losses' differences; ms per step of each
 23. kfold       - tools.train_trav_kfold.run on the Trav config over 8
                   in-memory rows: 2 folds of one epoch of 2 bs2 steps,
                   each fold evaluated on its 4 rows; fold mIoUs finite,
                   launches counted, seconds per fold
 24. infer       - tools.eval --save_path (single scale) and tools.infer
                   (MSF + flip), bf16, on 4 synthetic NYUDepthv2 images of
                   DFormer-Large + ham: every PNG's labels equal the
                   Evaluator's, 39 forward-kernel launches per forward;
                   tools.infer_trav on 4 in-memory Trav rows: the PNGs'
                   labels equal entry.build_trav's argmax; ms per image
 25. rehearsal   - tools.sunrgbd_eval_rehearsal.run on the SUNRGBD
                   DFormer-Small config at 24 images of the sensor mix,
                   MSF + flip bf16, two passes: the hist exact, launches
                   per forward, img/s of the second pass, pad overhead
The native loader (dformer_torch/native/loader.cpp) has no phase: the card
machine has no libjpeg / libpng headers to build it (PERF.md section 7);
the CPU tests hold it against the Python loader and the JAX one. Nor have
the orbax reader and the report drawing: the card machine has no
tensorstore and no matplotlib; tests/test_torch_orbax.py and
tests/test_torch_reports.py hold them on the CPU.
Then the kernel summary line, and last {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; nothing is caught. Exits non-zero
before printing any result when CUDA is unavailable.
"""

import contextlib
import copy
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np

BATCH = 8
HW = (480, 640)
NUM_CLASSES = 40
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_FP32_FLOPS = 67e12    # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# Kernel vs plain version. fp32: the two differ by summation order only.
# bf16: the plain version rounds the hidden h to bf16 before the depthwise
# conv where the kernel keeps it in fp32, so the GELU inputs differ by up to
# one bf16 ulp (2^-8 relative) and the output by a few bf16 ulps of its own
# magnitude: the limit scales with max|plain output|.
FP32_LIMIT = 1e-4
BF16_LIMIT_REL = 2e-2
# Backward kernel vs plain backward, each of the nine outputs as
# max|diff| / max(max|plain|, 1e-3). bf16: the kernel keeps h1 and dhc in
# fp32 where the plain version rounds them to bf16; 3e-2 is the bound the JAX
# package holds its TPU kernel to against its plain backward. fp32: summation
# order only, per pixel for dx and over up to 153,600 pixels for the weight
# gradients.
BWD_BF16_LIMIT = 3e-2
BWD_FP32_LIMIT_DX = 1e-4
BWD_FP32_LIMIT_W = 1e-3
BWD_NAMES = ("dx", "dln_w", "dln_b", "dfc1_w", "dfc1_b", "dpos_w", "dpos_b",
             "dfc2_w", "dfc2_b")
# Card (bf16) vs CPU (fp32) logits on the same weights: bf16 rounding of the
# activations (2^-8 relative each time) compounds over the 38 blocks and the
# head; random-weight logits sit close together, so argmax can flip where two
# classes nearly tie.
CPU_VS_CARD_REL = 0.1
CPU_VS_CARD_AGREE = 0.9
# Card (fp32, both kernels) vs CPU (fp32, plain versions) on a narrow model:
# summation order only. The loss relative; each parameter's gradient against
# max|CPU gradient| of its leaf. Leaves whose CPU gradient is below
# TRAIN_NULL_GRAD everywhere are structurally null (biases whose constant shift
# a BatchNorm removes): rounding noise only, not compared.
TRAIN_LOSS_REL = 1e-4
TRAIN_GRAD_REL = 2e-3
TRAIN_NULL_GRAD = 3e-7
NARROW = dict(dims=(32, 64, 128, 256), depths=(1, 1, 1, 2),
              num_heads=(1, 2, 4, 8), windows=(0, 7, 7, 7),
              mlp_ratios=(8, 8, 4, 4))
# Evaluation: the MSF scales tools/eval.py takes for a config whose
# eval_scale_array is [1], the val batch size, and the limits: each pixel's
# MSF accumulator sums to 2 * len(scales) up to fp32 rounding of the
# softmax sums; card (fp32 kernel) vs CPU (plain) accumulators of the narrow
# model differ by summation order only.
EVAL_SCALES = [0.5, 0.75, 1.0, 1.25, 1.5]
EVAL_BATCH = 4
EVAL_ACC_SUM_LIMIT = 1e-3
EVAL_CPU_VS_CARD_ACC = 1e-4
# the fit phase: iterations per epoch and val images of the train tool's
# run; the card's bilinear resample against the CPU's (fp32, same order)
FIT_ITERS = 4
FIT_VAL_IMAGES = 4
AUGMENT_LIMIT = 1e-5
# the Trav phases: DFormerTrav-Base + ham from the Trav config at 480x640,
# bf16; FSS episodes of batch 2 x (5 shots + 1 query) = 12 images per
# encoder pass; the tool runs' epochs, episodes and pseudo-labelled images;
# the narrow FSS step, fp32 on the card against float64 on the CPU
TRAV_CONFIG = "local_configs.Trav.DFormer_Base"
TRAV_BATCH = 12
FSS_STEPS_PER_EPOCH = 3
FSS_EVAL_EPISODES = 2
TRAV_PSEUDO_IMAGES = 4
FSS_CPU_VS_CARD_REL = 1e-4
FSS_CPU_VS_CARD_GRAD = 1e-4
# ... but the lidar expansion's biases: small remainders (1e-3 to 7e-3 of
# the largest gradient) of sums over every pixel of the pseudo-depth, which
# fp32 on the CPU misses by up to 1.4e-4 of their max (an H100: 3.1e-5 and
# 4.7e-5 in two runs)
FSS_LIDAR_BIAS = r"encoder_backbone\.attn_expand_e\..*bias"
FSS_LIDAR_BIAS_GRAD = 3e-4


T0 = time.perf_counter()


def emit(obj):
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, reps=20, warmup=3, calls=5):
    """Median CUDA-event time of one call, after warm-up. Each sample times
    `calls` back-to-back calls and divides, so that the host's work before
    each launch overlaps the card's work on the one before, as it does in a
    forward, instead of being counted as card time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def mlp_shapes(variant="DFormer-Large"):
    """(name, H, W, C, Ch, launches per forward) of every fused-MLP call of
    the variant's encoder at 480x640: the main block mlp and the
    depth-stream mlp_e2 of each stage (the last block of stage 4 has no
    mlp_e2)."""
    from dformer_torch.models.encoder import VARIANTS

    spec = VARIANTS[variant]
    out = []
    for i in range(4):
        h, w = HW[0] // (4 * 2 ** i), HW[1] // (4 * 2 ** i)
        c, r, d = spec["dims"][i], spec["mlp_ratios"][i], spec["depths"][i]
        out.append((f"stage{i}.mlp", h, w, c, c * r, d))
        out.append((f"stage{i}.mlp_e2", h, w, c // 2, c // 2 * r,
                    d - (i == 3)))
    return out


def kernel_cases():
    """(name, B, H, W, C, Ch, launches on the main path, dtype): every
    fused-MLP shape of the main path in bf16, and one fp32 shape."""
    import torch

    cases = [(name, BATCH, h, w, c, ch, n, torch.bfloat16)
             for name, h, w, c, ch, n in mlp_shapes()]
    cases.append(("fp32_check", 2, 30, 40, 96, 768, 0, torch.float32))
    return cases


def variant_bwd_cases():
    """(name, B, H, W, C, Ch, 0, bf16): the backward kernel at each width
    that only DFormer-Tiny, -Small and -Base train with, at the first map
    (480x640, bs8) that gives it that width and hidden size. Not on the
    main path: checked, and outside its sums."""
    import torch

    return [(name, BATCH, HW[0] // s, HW[1] // s, c, ch, 0, torch.bfloat16)
            for name, s, c, ch in (
                ("tiny.stage0.mlp_e2", 4, 16, 128),
                ("tiny.stage0.mlp", 4, 32, 256),
                ("small.stage0.mlp", 4, 64, 512),
                ("small.stage1.mlp", 8, 128, 1024),
                ("small.stage2.mlp", 16, 256, 1024),
                ("small.stage3.mlp", 32, 512, 2048))]


def mlp_inputs(B, H, W, C, Ch, dtype, seed):
    """fused_mlp arguments. fc1_w and fc2_w are transposed views of weights
    in torch Linear layout, as MLPBlock passes them, so that a timed call
    launches the kernel and copies nothing."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    x = rnd(B, H, W, C).to(dtype)
    return (x, rnd(C, scale=0.1, shift=1.0), rnd(C, scale=0.1),
            rnd(Ch, C, scale=C ** -0.5).to(dtype).t(), rnd(Ch, scale=0.1),
            rnd(3, 3, Ch, scale=1 / 3).to(dtype), rnd(Ch, scale=0.1),
            rnd(C, Ch, scale=Ch ** -0.5).to(dtype).t(), rnd(C, scale=0.1))


def mlp_bound(B, H, W, C, Ch, itemsize):
    """(bound ms, 'bytes' or 'operations', flops, bytes) of one fused-MLP
    call: each input read once, each output written once."""
    n = B * H * W
    flops = 2 * n * C * Ch * 2 + 2 * 9 * n * Ch
    nbytes = 2 * n * C * itemsize + (2 * C * Ch + 9 * Ch) * itemsize \
        + (3 * C + 2 * Ch) * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def mlp_bwd_bound(B, H, W, C, Ch, itemsize):
    """The same for one fused-MLP backward call: five products and the
    depthwise taps three times over; x and g read, dx written, the weights
    read and their gradients written."""
    n = B * H * W
    flops = 5 * 2 * n * C * Ch + 27 * 2 * n * Ch
    weights = (2 * C * Ch + 9 * Ch) * itemsize
    nbytes = 3 * n * C * itemsize + 2 * weights + (2 * C + 2 * Ch) * 4 \
        + (3 * C + 2 * Ch) * 4
    peak = PEAK_BF16_FLOPS if itemsize == 2 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), t_ops, t_bytes


def grad_worst(got, want):
    """(largest max|got - want| / max|want| over the leaves, its leaf, the
    leaves skipped): leaves whose `want` stays below TRAIN_NULL_GRAD are
    structurally null, rounding noise, and not compared."""
    worst, worst_name, skipped = 0.0, "", []
    for name, w in want.items():
        scale = w.abs().max().item()
        if scale < TRAIN_NULL_GRAD:
            skipped.append(name)
            continue
        rel = (got[name] - w).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
    return worst, worst_name, skipped


class ReluBranches:
    """Pins every ReLU of one run to the branch (input > 0) that a reference
    run took. A pre-activation within rounding of 0 can take either branch
    in two evaluations; a flip moves its layer's weight gradient by one
    pixel's share, and a train-mode BatchNorm's backward, whose output is a
    small remainder, magnifies that (up to 7e-2 of a leaf's max between
    the card and the CPU at the narrow size). With the branches pinned, two
    runs differ by rounding only. In `record()` F.relu keeps each mask; in
    `replay()` it multiplies by them in call order."""

    def __init__(self):
        self.masks = []

    @contextlib.contextmanager
    def _relu(self, fn):
        import torch.nn.functional as F

        plain = F.relu
        F.relu = lambda x, inplace=False: fn(plain, x)
        try:
            yield
        finally:
            F.relu = plain

    def record(self):
        self.masks = []

        def relu(plain, x):
            self.masks.append((x > 0).cpu())
            return plain(x)
        return self._relu(relu)

    @contextlib.contextmanager
    def replay(self):
        masks = iter(self.masks)

        def relu(plain, x):
            mask = next(masks)
            check(mask.shape == x.shape, "ReLU branches: another graph")
            return x * mask.to(x.device, x.dtype)
        with self._relu(relu):
            yield
        check(next(masks, None) is None, "ReLU branches: masks left over")


def against_float64(model, step):
    """Runs `step(model copy, device, dtype) -> (loss, {leaf: gradient})`
    on the CPU in float64, the reference, recording its ReLU branches, then
    on the card in fp32 through the kernels and once more with TF32
    products (the control), both with those branches pinned. Returns the
    three results, the card run's (forward, backward) kernel launches and
    the number of ReLUs pinned."""
    import torch

    from dformer_torch.kernels.fused_mlp import fused_mlp

    branches = ReluBranches()
    with branches.record():
        ref = step(copy.deepcopy(model).to("cpu", torch.float64), "cpu",
                   torch.float64)
    fused_mlp.launches = fused_mlp.backward_launches = 0
    with branches.replay():
        card = step(copy.deepcopy(model).cuda(), "cuda", torch.float32)
    launches = (fused_mlp.launches, fused_mlp.backward_launches)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with branches.replay():
            control = step(copy.deepcopy(model).cuda(), "cuda",
                           torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return ref, card, control, launches, len(branches.masks)


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "sm": list(cap),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})
    check(cap == (9, 0), f"needs sm 9.0 (Hopper), got {cap}")
    # fp32 products (fp32 kernel check, plain versions, NMF) stay fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build():
    from dformer_torch.kernels import build

    t0 = time.perf_counter()
    seconds = build.build_all()
    emit({"phase": "build", "nvcc_seconds": seconds,
          "wall_seconds": time.perf_counter() - t0,
          "build_dir": str(build.BUILD_DIR)})


def phase_kernels(smi, cases=None, phase="kernels"):
    """Every fused-MLP shape of the main path in bf16, plus one fp32 shape
    (or the given `cases`): kernel vs plain version, a second run on the
    same inputs (bit-equal), times and bound, the kernel's plan and
    occupancy, and torch.matmul of its two products over the B*H*W pixels
    (no halo) as their yardstick. Returns the per-shape rows."""
    import torch

    from dformer_torch.kernels.fused_mlp import (card_forward_plan,
                                                 forward_occupancy, fused_mlp,
                                                 fused_mlp_reference)

    rows, misses = [], []
    for i, (name, B, H, W, C, Ch, n, dtype) in enumerate(
            cases or kernel_cases()):
        args = mlp_inputs(B, H, W, C, Ch, dtype, seed=i)
        got = fused_mlp(*args)
        check(torch.equal(got, fused_mlp(*args)),
              f"{name}: differs between two runs on the same inputs")
        got = got.float()
        want = fused_mlp_reference(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
        limit = FP32_LIMIT if dtype == torch.float32 else BF16_LIMIT_REL * scale
        bound, bound_by, t_ops, t_bytes = mlp_bound(
            B, H, W, C, Ch, torch.tensor([], dtype=dtype).element_size())
        plan = card_forward_plan(B, H, W, C, Ch, dtype)
        # the products' yardstick: y @ fc1_w and g @ fc2_w as one library
        # call each, on operands of the kernel's shapes and dtype
        y = torch.randn(B * H * W, C, device="cuda").to(dtype)
        g = torch.randn(B * H * W, Ch, device="cuda").to(dtype)
        products_library_ms = (
            time_ms(lambda: torch.matmul(y, args[3]), reps=10)
            + time_ms(lambda: torch.matmul(g, args[7]), reps=10))
        del y, g
        row = {"phase": phase, "kernel": "fused_mlp_fwd", "shape": name,
               "B": B, "H": H, "W": W, "C": C, "Ch": Ch,
               "dtype": str(dtype).replace("torch.", ""),
               "launches_per_forward": n, "max_abs_err": err,
               "limit": limit, "plain_max_abs": scale,
               "bit_equal_rerun": True,
               "plan": plan._asdict(),
               "occupancy": forward_occupancy(C, dtype, plan.tile_cols),
               "products_library_ms": products_library_ms,
               "ms": time_ms(lambda: fused_mlp(*args)),
               "plain_ms": time_ms(lambda: fused_mlp_reference(*args)),
               "bound_ms": bound, "bound_by": bound_by,
               "ops_ms": t_ops, "bytes_ms": t_bytes, "card": smi}
        emit(row)
        rows.append(row)
        if not err <= limit:
            misses.append(f"{name} {row['dtype']}: {err} > {limit}")
    check(not misses, "kernel disagrees with its plain version: "
          + "; ".join(misses))
    return rows


def phase_kernels_bwd(smi, cases, phase="kernels"):
    """The backward kernel at the given shapes (the main path's and the
    other variants' widths, `variant_bwd_cases`): all nine outputs against the
    plain backward, times and bound, and a second run on the same inputs
    (all nine outputs must be bit-equal). Each of the call's four launches
    timed by CUDA events, the blocks per SM of K1 and K3, and torch.matmul
    of the two weight-gradient products as K3's yardstick."""
    import torch

    from dformer_torch.kernels.fused_mlp import (
        backward_occupancy, backward_stage_ms, card_backward_plan,
        fused_mlp_backward, fused_mlp_backward_reference)

    rows, misses = [], []
    for i, (name, B, H, W, C, Ch, n, dtype) in enumerate(cases):
        args = mlp_inputs(B, H, W, C, Ch, dtype, seed=100 + i)
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        g = torch.randn(B, H, W, C, generator=gen, device="cuda").to(dtype)
        got = fused_mlp_backward(*args, g)
        again = fused_mlp_backward(*args, g)
        want = fused_mlp_backward_reference(*args, g)
        torch.cuda.synchronize()
        errs, limits, rerun, abs_err = {}, {}, {}, 0.0
        for out, a, a2, b in zip(BWD_NAMES, got, again, want):
            check(a.shape == b.shape and a.dtype == b.dtype,
                  f"{name} {out}: {a.dtype} {tuple(a.shape)} vs plain "
                  f"{b.dtype} {tuple(b.shape)}")
            check(bool(torch.isfinite(a).all()), f"{name} {out}: non-finite")
            check(torch.equal(a, a2),
                  f"{name} {out}: differs between two runs on the same "
                  f"inputs")
            scale = max(b.float().abs().max().item(), 1e-3)
            diff = (a.float() - b.float()).abs().max().item()
            abs_err = max(abs_err, diff)
            errs[out] = diff / scale
            rerun[out] = (a.float() - a2.float()).abs().max().item() / scale
            limits[out] = BWD_BF16_LIMIT if dtype == torch.bfloat16 else (
                BWD_FP32_LIMIT_DX if out == "dx" else BWD_FP32_LIMIT_W)
            if not errs[out] <= limits[out]:
                misses.append(f"{name} {out}: {errs[out]} > {limits[out]}")
        del got, again, want
        bound, bound_by, t_ops, t_bytes = mlp_bwd_bound(
            B, H, W, C, Ch, torch.tensor([], dtype=dtype).element_size())
        stages = [backward_stage_ms(*args, g) for _ in range(7)]
        stage_ms = [statistics.median(s[k] for s in stages) for k in range(4)]
        # K3's yardstick: the same two [Ch,N]x[N,C] products in one library
        # call each, on operands of the same shapes and dtype
        a_w = torch.randn(B * H * W, Ch, device="cuda").to(dtype)
        b_w = torch.randn(B * H * W, C, device="cuda").to(dtype)
        wgrad_library_ms = 2 * time_ms(lambda: torch.matmul(a_w.t(), b_w),
                                       reps=10, calls=3)
        del a_w, b_w
        occ = backward_occupancy(C, dtype)
        plan = card_backward_plan(B, H, W, C, Ch, dtype)
        row = {"phase": phase, "kernel": "fused_mlp_bwd", "shape": name,
               "B": B, "H": H, "W": W, "C": C, "Ch": Ch,
               "dtype": str(dtype).replace("torch.", ""),
               "launches_per_step": n, "max_rel_err": errs,
               "max_abs_err": abs_err, "limit": limits,
               "rerun_max_abs_diff": rerun, "bit_equal_rerun": True,
               "ms": time_ms(lambda: fused_mlp_backward(*args, g),
                             reps=10, calls=3),
               "stage_ms": dict(zip(("k1_hidden", "k2_ln", "k3_wgrad",
                                     "k4_reduce"), stage_ms)),
               "wgrad_library_ms": wgrad_library_ms,
               "occupancy": occ,
               "plan": plan._asdict(),
               "plain_ms": time_ms(
                   lambda: fused_mlp_backward_reference(*args, g),
                   reps=5, warmup=1, calls=2),
               "bound_ms": bound, "bound_by": bound_by,
               "ops_ms": t_ops, "bytes_ms": t_bytes, "card": smi}
        emit(row)
        rows.append(row)
    check(not misses, "backward kernel disagrees with its plain version: "
          + "; ".join(misses))
    return rows


def phase_slice(smi):
    """The main path: 3 requests through entry.infer. Returns (model,
    launches of the fused-MLP kernel in those requests)."""
    import torch

    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp

    model = entry.build("DFormer-Large", HW, NUM_CLASSES, torch.bfloat16,
                        "cuda", seed=0)
    rng = np.random.RandomState(0)
    requests = [(torch.from_numpy(rng.rand(BATCH, *HW, 3).astype(np.float32))
                 .cuda(),
                 torch.from_numpy(rng.rand(BATCH, *HW, 3).astype(np.float32))
                 .cuda()) for _ in range(3)]
    logits = []
    hook = model.register_forward_hook(lambda m, i, o: logits.append(o))
    entry.infer(model, *requests[0])  # warm-up: cuDNN and allocator
    torch.cuda.synchronize()
    logits.clear()

    fused_mlp.launches = 0
    times = []
    for rgb, depth in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        labels = entry.infer(model, rgb, depth)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        check(tuple(labels.shape) == (BATCH, *HW),
              f"labels shape {tuple(labels.shape)}")
        check(labels.dtype == torch.int32, f"labels dtype {labels.dtype}")
        check(0 <= labels.min().item() and labels.max().item() < NUM_CLASSES,
              "labels out of [0, num_classes)")
        out = logits.pop()
        check(tuple(out.shape) == (BATCH, *HW, NUM_CLASSES),
              f"logits shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite logits")
    launches = fused_mlp.launches
    hook.remove()
    per_forward = sum(n for *_, n in mlp_shapes())
    # steadier timing than 3 requests: 10 more forwards of the first request
    more = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entry.infer(model, *requests[0])
        torch.cuda.synchronize()
        more.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(more)
    emit({"phase": "slice", "model": "DFormer-Large+LightHamHead",
          "batch": BATCH, "hw": list(HW), "dtype": "bfloat16",
          "requests": len(requests), "ms_each_request": times,
          "ms_per_forward": ms, "ms_each_timed": more,
          "img_per_s": BATCH / ms * 1e3,
          "fused_mlp_launches": launches,
          "fused_mlp_launches_per_forward": launches / len(requests),
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})
    check(launches == per_forward * len(requests),
          f"fused_mlp launched {launches} times in {len(requests)} "
          f"forwards, expected {per_forward} per forward")
    return model, launches


def phase_cpu_vs_card(model, smi):
    import torch

    from dformer_torch import entry

    rng = np.random.RandomState(1)
    rgb = torch.from_numpy(rng.rand(1, *HW, 3).astype(np.float32))
    depth = torch.from_numpy(rng.rand(1, *HW, 3).astype(np.float32))
    with torch.inference_mode():
        card = model(rgb.cuda(), depth.cuda()).float().cpu()
        cpu_model = entry.build("DFormer-Large", HW, NUM_CLASSES,
                                torch.float32, "cpu", seed=0)
        ref = cpu_model(rgb, depth)
    check(bool(torch.isfinite(card).all()), "non-finite card logits")
    rel = ((card - ref).abs().max() / ref.abs().max()).item()
    agree = (card.argmax(-1) == ref.argmax(-1)).float().mean().item()
    emit({"phase": "cpu_vs_card", "batch": 1, "card_dtype": "bfloat16",
          "cpu_dtype": "float32", "max_abs_diff_rel": rel,
          "limit_rel": CPU_VS_CARD_REL, "argmax_agreement": agree,
          "limit_agreement": CPU_VS_CARD_AGREE, "card": smi})
    check(rel <= CPU_VS_CARD_REL and agree >= CPU_VS_CARD_AGREE,
          f"card vs CPU logits: rel {rel}, agreement {agree}")


def train_batch(rng, batch, hw, num_classes):
    """(rgb, modal_x, labels) on the card from numpy draws: labels in
    [0, num_classes) with about 5% set to the ignore index 255."""
    import torch

    rgb = rng.rand(batch, *hw, 3).astype(np.float32)
    depth = rng.rand(batch, *hw, 3).astype(np.float32)
    gt = rng.randint(0, num_classes, (batch, *hw))
    gt = np.where(rng.rand(*gt.shape) < 0.05, 255, gt).astype(np.int64)
    return tuple(torch.from_numpy(a).cuda() for a in (rgb, depth, gt))


def phase_train(smi):
    """The train path: 3 counted steps on 3 batches, then 5 timed steps,
    through entry.build_trainer and entry.train_steps. Returns the launches
    of (the forward kernel, the backward kernel) in the counted steps."""
    import torch

    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model, optimizer, schedule, gen = entry.build_trainer(
        "DFormer-Large", HW, NUM_CLASSES, torch.bfloat16, "cuda", seed=0)
    check(model.training, "build_trainer returned a model in eval mode")
    rng = np.random.RandomState(2)
    batches = [train_batch(rng, BATCH, HW, NUM_CLASSES) for _ in range(3)]
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: b.clone() for n, b in model.named_buffers()}
    per_step = sum(n for *_, n in mlp_shapes())

    fused_mlp.launches = fused_mlp.backward_launches = 0
    losses, lrs, nonzero_grad = [], [], {}
    for k, batch in enumerate(batches):
        losses += entry.train_steps(model, optimizer, schedule, gen, [batch],
                                    first_step=k)
        lrs.append(optimizer.param_groups[0]["lr"])
        check(np.isfinite(losses[-1]), f"step {k}: loss {losses[-1]}")
        check(fused_mlp.launches == per_step * (k + 1)
              and fused_mlp.backward_launches == per_step * (k + 1),
              f"after step {k}: {fused_mlp.launches} forward and "
              f"{fused_mlp.backward_launches} backward launches, expected "
              f"{per_step} of each per step")
        if k == 0:  # the gradients of the first backward are still there
            for name, p in model.named_parameters():
                check(p.grad is not None
                      and bool(torch.isfinite(p.grad).all()),
                      f"{name}: missing or non-finite gradient")
                nonzero_grad[name] = bool((p.grad != 0).any())
                if ".mlp." in name or ".mlp_e2." in name:
                    check(nonzero_grad[name], f"{name}: zero gradient")
    launches = (fused_mlp.launches, fused_mlp.backward_launches)

    times = []
    for k in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += entry.train_steps(model, optimizer, schedule, gen,
                                    [batches[k % 3]], first_step=3 + k)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    check(all(np.isfinite(v) for v in losses), f"losses {losses}")
    check(lrs[0] == 0.0 and lrs[1] > 0.0, f"warm-up learning rates {lrs}")
    # steps 1.. ran at lr > 0: every parameter that had a gradient moved
    stuck = [n for n, p in model.named_parameters()
             if nonzero_grad[n] and torch.equal(p.detach(), params0[n])]
    check(not stuck, f"parameters did not move: {stuck[:5]}")
    still = [n for n, b in model.named_buffers()
             if n.endswith(("running_mean", "running_var"))
             and torch.equal(b, stats0[n])]
    check(not still, f"BatchNorm statistics did not move: {still[:5]}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the trained model serves
    rgb, depth, _ = batches[0]
    labels = entry.infer(model.eval(), rgb, depth)
    check(tuple(labels.shape) == (BATCH, *HW) and labels.dtype == torch.int32
          and 0 <= labels.min().item()
          and labels.max().item() < NUM_CLASSES,
          "entry.infer on the trained model: bad labels")
    ms = statistics.median(times)
    emit({"phase": "train", "model": "DFormer-Large+LightHamHead",
          "batch": BATCH, "hw": list(HW), "dtype": "bfloat16",
          "counted_steps": len(batches), "timed_steps": len(times),
          "losses": losses, "lrs_counted": lrs, "ms_per_step": ms,
          "ms_each_timed": times, "img_per_s": BATCH / ms * 1e3,
          "fused_mlp_fwd_launches_per_step": launches[0] / len(batches),
          "fused_mlp_bwd_launches_per_step": launches[1] / len(batches),
          "parameters": len(params0),
          "parameters_with_zero_first_gradient":
              sorted(n for n, nz in nonzero_grad.items() if not nz),
          "peak_mem_gib": peak, "card": smi})
    return launches


def phase_train_cpu_vs_card(smi):
    """One forward + backward of a narrow model in fp32: the card through
    both kernels against the CPU through the plain versions, on the same
    weights, batch and NMF bases, with DropPath and dropout off."""
    import torch

    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.models.encoder import VARIANTS
    from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean

    VARIANTS.setdefault("DFormer-Narrow", NARROW)
    hw, batch, classes = (64, 96), 2, 11
    rng = np.random.RandomState(3)
    rgb, depth, gt = (t.cpu() for t in train_batch(rng, batch, hw, classes))
    bases = torch.from_numpy(rng.rand(batch, 512, 64).astype(np.float32))
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    out = {}
    fused_mlp.launches = fused_mlp.backward_launches = 0
    for device in ("cuda", "cpu"):
        model = entry.build_trainer("DFormer-Narrow", hw, classes,
                                    torch.float32, device, seed=0,
                                    drop_path_rate=0.0)[0]
        model.decode_head.dropout.rate = 0.0
        logits, _ = model.forward_with_aux(rgb.to(device), depth.to(device),
                                           bases=bases.to(device))
        loss = softmax_cross_entropy_masked_mean(logits, gt.to(device))
        loss.backward()
        out[device] = (loss.item(), {n: p.grad.cpu()
                                     for n, p in model.named_parameters()})
    n_mlp = sum(NARROW["depths"]) * 2 - 1
    check(fused_mlp.launches == n_mlp
          and fused_mlp.backward_launches == n_mlp,
          f"narrow model: {fused_mlp.launches} forward and "
          f"{fused_mlp.backward_launches} backward launches on the card, "
          f"expected {n_mlp} of each")
    (loss_card, grads_card), (loss_cpu, grads_cpu) = out["cuda"], out["cpu"]
    loss_rel = abs(loss_card - loss_cpu) / abs(loss_cpu)
    worst, worst_name, skipped = grad_worst(grads_card, grads_cpu)
    emit({"phase": "train_cpu_vs_card", "model": "DFormer-Narrow+LightHamHead",
          "batch": batch, "hw": list(hw), "dtype": "float32",
          "loss_card": loss_card, "loss_cpu": loss_cpu, "loss_rel": loss_rel,
          "limit_loss_rel": TRAIN_LOSS_REL, "max_grad_rel": worst,
          "max_grad_rel_leaf": worst_name, "limit_grad_rel": TRAIN_GRAD_REL,
          "leaves": len(grads_cpu), "null_gradient_leaves_skipped": skipped,
          "fused_mlp_launches_each_way": n_mlp, "card": smi})
    check(loss_rel <= TRAIN_LOSS_REL, f"card vs CPU loss: rel {loss_rel}")
    check(worst <= TRAIN_GRAD_REL,
          f"card vs CPU gradient of {worst_name}: rel {worst}")
    check(len(skipped) < len(grads_cpu) // 10,
          f"{len(skipped)} null-gradient leaves skipped")


def _eval_mode(smi, name, cfg, dtype, n, batch, scales=None,
               sliding=False):
    """One eval mode through entry.build_evaluator on n synthetic images
    in groups of `batch`: an untimed warm-up over one group, then the
    counted and timed run. Returns (row, Counter of the (B, H, W, C, Ch) the
    fused-MLP kernel saw in the timed run, groups in the timed run)."""
    import collections

    import torch

    from dformer_torch import entry
    from dformer_torch.data.loader import device_val_batches
    from dformer_torch.kernels.fused_mlp import card_forward_plan, fused_mlp
    from dformer_torch.models.encoder import MLPBlock

    def run(ev, batches):
        if scales is None:
            return ev.evaluate(batches, save_hook=hook)
        return ev.evaluate_msf(batches, scales, flip=cfg.eval_flip,
                               save_hook=hook)

    def hook(pred, batch):  # after each group, its labels on the host
        labelled.append((batch["gt"][:pred.shape[0]] != cfg.background)
                        .sum().item())
        ends.append(time.perf_counter())

    labelled, ends = [], []
    ev, _ = entry.build_evaluator(cfg, dtype, "cuda", seed=0, sliding=sliding)
    run(ev, device_val_batches(cfg, batch, "cuda", synthetic=True,
                               n=min(n, batch)))
    seen = collections.Counter()
    forwards = []
    handles = [m.register_forward_pre_hook(
        lambda m, a: seen.update([tuple(a[0].shape)[:4] + (m.fc1.weight
                                                           .shape[0],)]))
        for m in ev.model.modules() if isinstance(m, MLPBlock)]
    handles.append(ev.model.register_forward_hook(
        lambda m, a, o: forwards.append(o.shape[0])))
    acc_err = []
    if scales is not None:  # each group's accumulator, checked after the run
        msf_probs = ev.msf_probs

        def recording(*a, **k):
            acc = msf_probs(*a, **k)
            acc_err.append((acc.sum(-1) - 2 * len(scales)).abs().amax())
            return acc

        ev.msf_probs = recording
    batches = device_val_batches(cfg, batch, "cuda", synthetic=True, n=n)
    labelled.clear()
    torch.cuda.synchronize()
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    ends[:] = [t0]
    m = run(ev, batches)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = fused_mlp.launches
    for h in handles:
        h.remove()
    per_forward = sum(n_ for *_, n_ in mlp_shapes())
    hw = (cfg.image_height, cfg.image_width)
    groups = -(-n // batch)
    want_forwards = groups * (2 * len(scales) if scales else 1)
    (_, miou), (_, macc), (_, mf1) = (m.compute_iou(), m.compute_pixel_acc(),
                                      m.compute_f1())
    acc_err = max((e.item() for e in acc_err), default=None)
    dt = dtype or torch.float32
    group_ms = [(b - a) * 1e3 for a, b in zip(ends, ends[1:])]
    # the groups after the first: the loader's start-up (its threads and
    # the first group's data) stays in the first
    steady = n - min(n, batch)
    row = {"phase": "eval", "mode": name, "config": cfg.dataset_name,
           "backbone": cfg.backbone, "num_classes": cfg.num_classes,
           "dtype": str(dt).replace("torch.", ""), "images": n,
           "batch": batch, "hw": list(hw), "scales": scales,
           "flip": bool(scales and cfg.eval_flip), "sliding": sliding,
           "crop": list(cfg.eval_crop_size) if sliding else None,
           "forwards": len(forwards), "forward_batches": forwards,
           "fused_mlp_launches": launches,
           "fused_mlp_launches_per_forward": launches / max(len(forwards), 1),
           "hist_sum": int(m.hist.sum()), "labelled_pixels": sum(labelled),
           "mIoU": miou, "mAcc": macc, "mF1": mf1,
           "msf_acc_sum_max_err": acc_err,
           "ms": ms, "ms_per_image": ms / n, "img_per_s": n / ms * 1e3,
           "group_ms": group_ms, "first_group_ms": group_ms[0],
           "steady_images": steady,
           "steady_ms_per_image": sum(group_ms[1:]) / steady,
           "steady_img_per_s": steady / sum(group_ms[1:]) * 1e3,
           "kernel_shapes": [
               {"B": b, "H": h, "W": w, "C": c, "Ch": ch, "calls": k,
                "plan": card_forward_plan(b, h, w, c, ch, dt)._asdict()}
               for (b, h, w, c, ch), k in sorted(seen.items())],
           "card": smi}
    emit(row)
    check(len(group_ms) == groups,
          f"eval {name}: {len(group_ms)} groups, expected {groups}")
    check(len(forwards) == want_forwards,
          f"eval {name}: {len(forwards)} forwards, expected {want_forwards}")
    check(launches == per_forward * len(forwards),
          f"eval {name}: fused_mlp launched {launches} times in "
          f"{len(forwards)} forwards, expected {per_forward} per forward")
    check(row["hist_sum"] == row["labelled_pixels"] == n * hw[0] * hw[1],
          f"eval {name}: hist sums to {row['hist_sum']}, labelled pixels "
          f"{row['labelled_pixels']}")
    check(all(np.isfinite(v) for v in (miou, macc, mf1)),
          f"eval {name}: metrics {miou} {macc} {mf1}")
    if scales is not None:
        check(acc_err <= EVAL_ACC_SUM_LIMIT,
              f"eval {name}: MSF accumulator sums off by {acc_err}")
    del ev
    torch.cuda.empty_cache()
    return row, seen, groups


def _eval_kernel(smi, run, seen, groups, dtype):
    """The forward kernel at each stage map that an MSF + flip run gave it
    (`seen`: (B, H, W, C, Ch) -> calls in `groups` groups): against its
    plain version, bit-equal on rerun, timed, with its bound. Emits the
    shapes and their sum per group; returns the shapes that missed their
    limit."""
    import torch

    from dformer_torch.kernels.fused_mlp import fused_mlp, fused_mlp_reference

    itemsize = torch.tensor([], dtype=dtype).element_size()
    shapes, misses = [], []
    for i, ((B, H, W, C, Ch), calls) in enumerate(sorted(seen.items())):
        args = mlp_inputs(B, H, W, C, Ch, dtype, seed=300 + i)
        got = fused_mlp(*args)
        check(torch.equal(got, fused_mlp(*args)),
              f"eval shape {(B, H, W, C)} {dtype}: differs between two runs")
        check(bool(torch.isfinite(got).all()),
              f"eval shape {(B, H, W, C)} {dtype}: non-finite output")
        want = fused_mlp_reference(*args).float()
        err = (got.float() - want).abs().max().item()
        limit = FP32_LIMIT if dtype == torch.float32 else \
            BF16_LIMIT_REL * want.abs().max().item()
        bound, bound_by, t_ops, t_bytes = mlp_bound(B, H, W, C, Ch, itemsize)
        shape = {"B": B, "H": H, "W": W, "C": C, "Ch": Ch,
                 "calls_per_batch": calls / groups, "max_abs_err": err,
                 "limit": limit, "bit_equal_rerun": True,
                 "ms": time_ms(lambda: fused_mlp(*args), reps=10, calls=3),
                 "bound_ms": bound, "bound_by": bound_by, "ops_ms": t_ops,
                 "bytes_ms": t_bytes}
        shapes.append(shape)
        if not err <= limit:
            misses.append(f"{(B, H, W, C)} {dtype}: {err} > {limit}")
    per_batch = {k: sum(s[k] * s["calls_per_batch"] for s in shapes)
                 for k in ("ms", "ops_ms", "bytes_ms")}
    emit({"phase": "eval_kernel", "kernel": "fused_mlp_fwd", "run": run,
          "dtype": str(dtype).replace("torch.", ""), "batch": EVAL_BATCH,
          "shapes": shapes, "launches_per_batch":
              sum(s["calls_per_batch"] for s in shapes),
          "ms_per_batch": per_batch["ms"],
          "bound_ms_per_batch": max(per_batch["ops_ms"],
                                    per_batch["bytes_ms"]),
          "bound_by": "operations" if per_batch["ops_ms"]
          >= per_batch["bytes_ms"] else "bytes",
          "max_abs_err": max(s["max_abs_err"] for s in shapes),
          "card": smi})
    return misses


def phase_eval(smi):
    """The eval path at full width (DFormer-Large + LightHamHead, weights
    from seed 0, synthetic val data) in four modes, then the forward kernel
    at every stage map of the bf16 and of the fp32 MSF + flip run. Every
    mode runs two groups or more, so that the groups after the first give
    a steady-state time. Returns the mode rows."""
    import torch

    from dformer_torch.configs import load_config

    nyu = load_config("local_configs.NYUDepthv2.DFormer_Large")
    sun = load_config("local_configs.SUNRGBD.DFormer_Large")
    sun.image_height, sun.image_width = 530, 730  # crop stays 480x480
    rows, misses = [], []
    for name, cfg, dtype, n, batch, scales, sliding in (
            ("single_bf16", nyu, torch.bfloat16, 16, EVAL_BATCH, None, False),
            ("msf_flip_bf16", nyu, torch.bfloat16, 12, EVAL_BATCH,
             EVAL_SCALES, False),
            ("msf_flip_fp32", nyu, None, 8, EVAL_BATCH, EVAL_SCALES, False),
            # 2 images of 4 windows each per forward
            ("sliding_bf16", sun, torch.bfloat16, 4, 2, None, True)):
        row, seen, groups = _eval_mode(smi, name, cfg, dtype, n, batch,
                                       scales, sliding)
        rows.append(row)
        if scales is not None:
            misses += _eval_kernel(smi, name, seen, groups,
                                   dtype or torch.float32)
    check(not misses, "kernel disagrees with its plain version at eval "
          "shapes: " + "; ".join(misses))
    return rows


def phase_eval_cpu_vs_card(smi):
    """MSF + flip (scales 0.5 and 1) of a narrow fp32 model over 2 images
    of 64x96 through `entry.msf_group`, on the card through the kernel and
    on the CPU through the plain version, same weights: equal hists,
    accumulators within EVAL_CPU_VS_CARD_ACC."""
    import torch

    from dformer_torch import entry
    from dformer_torch.models.encoder import VARIANTS

    VARIANTS.setdefault("DFormer-Narrow", NARROW)
    hw, scales, classes = (64, 96), [0.5, 1.0], 11
    rng = np.random.RandomState(4)
    rgb, modal = (torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32))
                  for _ in range(2))
    gt = torch.from_numpy(rng.randint(0, classes, (2, *hw)))
    (hist_card, acc_card, n_card), (hist_cpu, acc_cpu, _) = (
        entry.msf_group("DFormer-Narrow", classes, rgb, modal, gt, scales,
                        True, device) for device in ("cuda", "cpu"))
    diff = (acc_card - acc_cpu).abs().max().item()
    top2 = acc_cpu.topk(2, dim=-1).values
    near_ties = int(((top2[..., 0] - top2[..., 1]) < 2 * diff).sum())
    n_mlp = sum(NARROW["depths"]) * 2 - 1
    emit({"phase": "eval_cpu_vs_card", "model": "DFormer-Narrow+LightHamHead",
          "images": 2, "hw": list(hw), "dtype": "float32", "scales": scales,
          "flip": True, "hist_equal": bool(np.array_equal(hist_card,
                                                          hist_cpu)),
          "hist_sum": int(hist_card.sum()), "acc_max_abs_diff": diff,
          "limit_acc": EVAL_CPU_VS_CARD_ACC,
          "pixels_within_2x_diff_of_a_tie": near_ties,
          "fused_mlp_launches_card": n_card, "card": smi})
    check(n_card == 2 * len(scales) * n_mlp,
          f"narrow eval: {n_card} launches on the card, expected "
          f"{2 * len(scales) * n_mlp}")
    check(diff <= EVAL_CPU_VS_CARD_ACC,
          f"narrow eval: accumulators differ by {diff}")
    check(np.array_equal(hist_card, hist_cpu),
          "narrow eval: card and CPU hists differ")


def step_gaps_ms(trainer):
    """ms between successive log lines of one epoch: with fewer than 20
    iterations an epoch, the Trainer logs, and waits for the card, after
    every step, so each gap is one step (the loader's wait included)."""
    return [(t - t_prev) * 1e3 for (e, _, t_prev), (e2, _, t)
            in zip(trainer.log_times, trainer.log_times[1:]) if e == e2]


def fit_config(root, nepochs):
    from dformer_torch.configs import load_config

    cfg = load_config("local_configs.NYUDepthv2.DFormer_Large")
    cfg.update(niters_per_epoch=FIT_ITERS, nepochs=nepochs,
               checkpoint_start_epoch=0, num_eval_imgs=FIT_VAL_IMAGES,
               log_dir_base=f"{root}/run_to_{nepochs}")
    return cfg


def phase_fit(smi):
    """The train tool at full width: `tools.train.run` on the NYUDepthv2
    DFormer-Large config (bf16 compute, bs8, 480x640, synthetic data),
    epochs of FIT_ITERS iterations, fp32 MSF + flip evaluation of
    FIT_VAL_IMAGES images, then a resume from the epoch-2 rescue checkpoint
    for epoch 3. Returns the kernel launches of the first run."""
    import tempfile

    import torch

    from dformer_torch import entry
    from dformer_torch.data.augment import (apply_train_augment,
                                            train_augment_draws)
    from dformer_torch.data.loader import train_batches
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import train as train_tool
    from dformer_torch.runtime.preempt import StopAfter
    from dformer_torch.train.checkpoint import (CheckpointManager,
                                                state_difference)
    from dformer_torch.train.loop import Trainer
    from dformer_torch.utils.checkpoint import load_checkpoint

    per_step = sum(n for *_, n in mlp_shapes())
    # one MSF + flip group of FIT_VAL_IMAGES images: 5 scales x 2 flips
    per_eval = 10 * per_step
    flags = ["--config=local_configs.NYUDepthv2.DFormer_Large",
             "--synthetic-data", f"--val_batch_size={FIT_VAL_IMAGES}"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as root:
        # run 1: epochs 1-2, a preemption requested after epoch 2 (the
        # Trainer reads the guard before each step, the tool after each
        # epoch: read 2 * (FIT_ITERS + 1) is the one after epoch 2)
        cfg = fit_config(root, 2)
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        first = train_tool.run(cfg, train_tool.parse_args(flags),
                               guard=StopAfter(2 * (FIT_ITERS + 1)))
        first_s = time.perf_counter() - t0
        launches = (fused_mlp.launches, fused_mlp.backward_launches)
        a = first.pop("trainer")
        gaps = step_gaps_ms(a)
        steps = 2 * FIT_ITERS
        check(a.step == steps, f"run 1 ended at step {a.step}, not {steps}")
        check(launches == (steps * per_step + per_eval, steps * per_step),
              f"run 1: {launches} forward and backward launches, expected "
              f"{per_step} of each per step and {per_eval} forward in the "
              "epoch-1 evaluation")
        check(all(np.isfinite(v) for v in first["losses"].values()),
              f"run 1 losses {first['losses']}")
        check(sorted(first["eval_seconds"]) == [1],
              f"run 1 evaluated after epochs {sorted(first['eval_seconds'])}")
        m1 = first["best_miou"]
        kept = sorted(n for *_, n in first["checkpoints"]._existing())
        # epoch 1 saves when its mIoU beats 0; the rescue at epoch 2 saves
        # under the best mIoU so far
        want = sorted(({f"epoch-1_miou_{round(m1, 2)}.pth"} if m1 > 0
                       else set()) | {f"epoch-2_miou_{round(m1, 2)}.pth"})
        check(kept == want, f"run 1 kept {kept}, expected {want}")
        rescue, epoch = first["checkpoints"].latest()
        check(epoch == 2, f"latest checkpoint is epoch {epoch}")

        # save and restore timed on their own; the restored state equal
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed = CheckpointManager(f"{root}/timed").save(a, 2, m1)
        save_s = time.perf_counter() - t0
        ckpt_bytes = os.path.getsize(timed)
        b = Trainer(*entry.build_training(cfg, torch.bfloat16, "cuda",
                                          cfg.seed)[:3], cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        next_epoch = CheckpointManager(f"{root}/timed").restore(b, timed)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        check(next_epoch == 3 and b.step == steps,
              f"restore: epoch {next_epoch}, step {b.step}")
        differs = state_difference(a, b)
        check(differs is None, f"restored state differs: {differs}")
        del b

        # the rescue file in a fresh serving model gives the same logits
        rng = np.random.RandomState(9)
        rgb, depth, _ = train_batch(rng, 2, HW, NUM_CLASSES)
        fresh = load_checkpoint(entry.build("DFormer-Large", HW, NUM_CLASSES,
                                            torch.bfloat16, "cuda"), rescue)
        with torch.inference_mode():
            logits_file = fresh(rgb, depth)
            logits_trained = a.model.eval()(rgb, depth)
        logits_diff = (logits_file.float() - logits_trained.float()).abs() \
            .max().item()
        check(torch.equal(logits_file, logits_trained),
              f"logits of the checkpoint differ by {logits_diff}")
        del fresh, logits_file, logits_trained

        # the augmentation on the card against the CPU, same draws
        batch = next(iter(train_batches(cfg, synthetic=True)))
        draws = train_augment_draws(BATCH, len(cfg.train_scale_array),
                                    torch.Generator().manual_seed(5))
        stats = [torch.as_tensor(np.asarray(v), dtype=torch.float32)
                 for v in (cfg.norm_mean, cfg.norm_std, [0.48] * 3,
                           [0.28] * 3)]

        def augment(device):
            return apply_train_augment(
                *(torch.from_numpy(batch[k]).to(device)
                  for k in ("rgb", "gt", "modal_x")),
                *(d.to(device) for d in draws), HW, cfg.train_scale_array,
                *(v.to(device) for v in stats))

        card, cpu = augment("cuda"), augment("cpu")
        check(torch.equal(card[1].cpu(), cpu[1]),
              "augment: card and CPU labels differ")
        aug_err = max((x.cpu() - y).abs().max().item()
                      for x, y in ((card[0], cpu[0]), (card[2], cpu[2])))
        check(aug_err <= AUGMENT_LIMIT,
              f"augment: card and CPU images differ by {aug_err}")
        on_card = {k: torch.from_numpy(batch[k]).cuda()
                   for k in ("rgb", "gt", "modal_x")}
        args_card = ([on_card[k] for k in ("rgb", "gt", "modal_x")]
                     + [d.cuda() for d in draws] + [HW]
                     + [torch.tensor(cfg.train_scale_array, device="cuda")]
                     + [v.cuda() for v in stats])
        augment_ms = time_ms(lambda: apply_train_augment(*args_card),
                             reps=10, calls=3)
        del card, cpu, on_card, args_card
        del a

        # run 2: resume from the rescue checkpoint for epoch 3
        cfg = fit_config(root, 3)
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        second = train_tool.run(cfg, train_tool.parse_args(
            flags + [f"--continue_fpath={rescue}"]))
        second_s = time.perf_counter() - t0
        launches2 = (fused_mlp.launches, fused_mlp.backward_launches)
        c = second.pop("trainer")
        gaps += step_gaps_ms(c)
        steps2 = c.step
        check(c.step == steps + FIT_ITERS,
              f"run 2 ended at step {c.step}, not {steps + FIT_ITERS}")
        check(launches2 == (FIT_ITERS * per_step + per_eval,
                            FIT_ITERS * per_step),
              f"run 2: {launches2} forward and backward launches")
        check(list(second["losses"]) == [3]
              and np.isfinite(second["losses"][3]),
              f"run 2 losses {second['losses']}")
        m3 = second["best_miou"]
        kept2 = sorted(n for *_, n in second["checkpoints"]._existing())
        want2 = [f"epoch-3_miou_{round(m3, 2)}.pth"] if m3 > 0 else []
        check(kept2 == want2, f"run 2 kept {kept2}, expected {want2}")
        del c
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "fit", "model": "DFormer-Large+LightHamHead",
          "config": "local_configs.NYUDepthv2.DFormer_Large", "batch": BATCH,
          "hw": list(HW), "dtype": "bfloat16", "eval_dtype": "float32",
          "iterations_per_epoch": FIT_ITERS, "val_images": FIT_VAL_IMAGES,
          "losses": {**first["losses"], **second["losses"]},
          "miou": {1: m1, 3: m3}, "steps": [steps, steps2],
          "kept_run1": kept, "kept_run2": kept2,
          "fused_mlp_launches_run1": launches,
          "fused_mlp_launches_run2": launches2,
          "fwd_launches_per_step": per_step, "bwd_launches_per_step": per_step,
          "ms_per_step": statistics.median(gaps), "ms_each_step": gaps,
          # whole epochs on the host's clock over their steps: the loader's
          # start, a wait for the card at every step's log line and, in the
          # first epoch of each run, the coverage audit included
          "ms_per_step_by_epoch": {
              e: s * 1e3 / FIT_ITERS for e, s in
              {**first["epoch_seconds"], **second["epoch_seconds"]}.items()},
          "augment_ms": augment_ms, "augment_max_abs_err": aug_err,
          "augment_labels_equal": True,
          "epoch_seconds": {**first["epoch_seconds"],
                            **second["epoch_seconds"]},
          "eval_seconds": {**first["eval_seconds"], **second["eval_seconds"]},
          "checkpoint_bytes": ckpt_bytes, "save_s": save_s,
          "restore_s": restore_s, "logits_equal": True,
          "run1_s": first_s, "run2_s": second_s, "peak_mem_gib": peak,
          "card": smi})
    return launches


def trav_cases():
    """(name, B, H, W, C, Ch, launches per encoder pass, bf16): every
    fused-MLP shape of DFormerTrav-Base at 480x640 in an FSS step's encoder
    pass of TRAV_BATCH images."""
    import torch

    return [(f"trav.{name}", TRAV_BATCH, h, w, c, ch, n, torch.bfloat16)
            for name, h, w, c, ch, n in mlp_shapes("DFormer-Base")]


def phase_trav_kernels(smi):
    """Both kernels at the Trav path's 8 shapes (B 12, bf16) against their
    plain versions, bit-equal on rerun, with times, bounds and yardsticks.
    Returns (forward rows, backward rows)."""
    cases = trav_cases()
    return (phase_kernels(smi, cases, "trav_kernels"),
            phase_kernels_bwd(smi, cases, "trav_kernels"))


class MemoryTrav:
    """Trav rows made in memory from a seed, in the item layout of
    `data.trav.TravRGBDLabeledDataset`: uint8 BGR image, a 360-beam scan of
    ranges in metres, labels 0/1 below and above a horizon row (none when
    `labelled` is False), and the paths the pseudo-label manifest names."""

    def __init__(self, n, hw, seed, labelled=True):
        self.n, self.hw, self.seed, self.labelled = n, hw, seed, labelled

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 1000003 + i)
        item = dict(rgb=rng.randint(0, 256, self.hw + (3,), np.uint8),
                    laser=(rng.rand(360) * 8).astype(np.float32),
                    rgb_path=f"memory/images/{self.seed}_{i}.png",
                    depth_path=f"memory/scans/{self.seed}_{i}.pkl",
                    n=self.n)
        if self.labelled:
            item["gt"] = _horizon_labels(rng, self.hw)
        return item


def _horizon_labels(rng, hw):
    """1 (traversable) below a random horizon row, 0 above, a few pixels
    255 (ignored)."""
    gt = (np.arange(hw[0])[:, None] >= rng.randint(hw[0] // 4, hw[0]))
    gt = np.broadcast_to(gt, hw).astype(np.int32)
    return np.where(rng.rand(*hw) < 0.01, 255, gt).astype(np.int32)


class MemoryEpisodes:
    """Episodes made in memory, in the item layout of
    `data.trav.FewShotTravDatasetBinary` (`class_grouped`: of
    `FewShotTravRGBDDataset`, one class per item), drawn from
    `RandomState(seed * 1000003 + index)` after `set_epoch(seed)`."""

    def __init__(self, n, hw, shots, class_grouped=False, queries=1):
        self.n, self.hw, self.shots = n, hw, shots
        self.class_grouped, self.queries = class_grouped, queries
        self.seed = 0

    def __len__(self):
        return self.n

    def set_epoch(self, seed):
        self.seed = seed

    def __getitem__(self, index):
        rng = np.random.RandomState(self.seed * 1000003 + index)
        n = self.shots + self.queries

        def draw(k):
            return (rng.randint(0, 256, (k,) + self.hw + (3,), np.uint8),
                    np.stack([_horizon_labels(rng, self.hw)
                              for _ in range(k)]),
                    (rng.rand(k, 360) * 8).astype(np.float32))

        img, gt, scan = draw(n)
        S = self.shots
        if self.class_grouped:
            return dict(s_imgs=img[:S], s_masks=gt[:S], s_depths=scan[:S],
                        q_imgs=img[S:], q_masks=gt[S:], q_depths=scan[S:],
                        cls=index % 2)
        return dict(s_img=img[:S], s_gt=gt[:S], s_depth=scan[:S],
                    q_img=img[S], q_gt=gt[S], q_depth=scan[S],
                    fn=f"memory/episode_{index}")


def trav_cfg(root, name):
    from dformer_torch.configs import load_config

    cfg = load_config(TRAV_CONFIG)
    cfg.update(log_dir_base=f"{root}/{name}", save_dir=f"{root}/pseudo")
    return cfg


def phase_trav(smi):
    """The Trav serving and semi-supervised paths: `entry.build_trav` on
    the Trav config (DFormerTrav-Base + ham, 480x640, bf16), bs2 requests
    of seed-made rgb and lidar through `entry.infer`, the pseudo-depth
    constant down its columns; then `tools.train_trav.run` on in-memory
    rows: one epoch of 2 bs2 steps, pseudo-labels and the manifest for
    TRAV_PSEUDO_IMAGES images. Returns the forward and backward launches
    {requests, train_trav}."""
    import csv
    import tempfile

    import torch

    from dformer_torch import entry
    from dformer_torch.configs import TRAV_LIDAR_MEAN, TRAV_LIDAR_STD
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import train_trav

    per_pass = sum(n for *_, n in mlp_shapes("DFormer-Base"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as root:
        cfg = trav_cfg(root, "serve")
        hw = (cfg.image_height, cfg.image_width)
        model = entry.build_trav(cfg, torch.bfloat16, "cuda", seed=0)
        rng = np.random.RandomState(20)
        requests = [
            (torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32)).cuda(),
             torch.from_numpy(((rng.rand(2, 360) * 8 - TRAV_LIDAR_MEAN)
                               / TRAV_LIDAR_STD).astype(np.float32)).cuda())
            for _ in range(3)]
        entry.infer(model, *requests[0])  # warm-up
        torch.cuda.synchronize()
        fused_mlp.launches = 0
        for rgb, lidar in requests:
            labels = entry.infer(model, rgb, lidar)
            check(tuple(labels.shape) == (2, *hw)
                  and 0 <= labels.min().item() and labels.max().item() < 2,
                  f"trav labels {tuple(labels.shape)}")
        torch.cuda.synchronize()
        fwd_requests = fused_mlp.launches
        check(fwd_requests == per_pass * len(requests),
              f"trav: {fwd_requests} forward launches in {len(requests)} "
              f"requests, expected {per_pass} per forward")
        with torch.inference_mode():
            logits = model(*requests[0])
            depth = model.encoder_backbone.attn_expand_e(requests[0][1])
        check(bool(torch.isfinite(logits).all()), "trav: non-finite logits")
        check(tuple(depth.shape) == (2, *hw, 1)
              and torch.equal(depth, depth[:, :1].expand_as(depth)),
              "trav: pseudo-depth not constant down its columns")
        times = []
        for _ in range(10):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.infer(model, *requests[0])
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        peak_serve = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, logits, depth

        # the semi-supervised tool: supervised epoch, then pseudo-labels
        cfg = trav_cfg(root, "train_trav")
        datasets = (MemoryTrav(4, hw, seed=21),
                    MemoryTrav(TRAV_PSEUDO_IMAGES, hw, seed=22,
                               labelled=False))
        torch.cuda.reset_peak_memory_stats()
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        out = train_trav.run(cfg, train_trav.parse_args(["--epochs=1"]),
                             datasets=datasets)
        run_s = time.perf_counter() - t0
        tool = (fused_mlp.launches, fused_mlp.backward_launches)
        steps = 4 // cfg.batch_size
        check(out["step"] == steps and np.isfinite(out["losses"][1]),
              f"train_trav: step {out['step']}, losses {out['losses']}")
        check(tool == ((steps + TRAV_PSEUDO_IMAGES) * per_pass,
                       steps * per_pass),
              f"train_trav: {tool} forward and backward launches")
        with open(out["csv_path"], newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == TRAV_PSEUDO_IMAGES
              and list(rows[0]) == ["image", "depth", "label"],
              f"train_trav: manifest {rows[:1]}")
        for row in rows:
            mask = np.load(row["label"])
            check(mask.dtype == np.uint8 and mask.shape == hw
                  and set(np.unique(mask)) <= {0, 1},
                  f"train_trav: mask {row['label']}")
        peak_tool = torch.cuda.max_memory_allocated() / 2 ** 30
        epoch_s, label_s = out["epoch_seconds"][1], out["label_seconds"]
        del out
    emit({"phase": "trav", "model": "DFormerTrav-Base+LightHamHead",
          "config": TRAV_CONFIG, "batch": 2, "hw": list(hw),
          "dtype": "bfloat16", "ms_per_forward": statistics.median(times),
          "ms_each_timed": times,
          "fused_mlp_launches_per_forward": fwd_requests / len(requests),
          "pseudo_depth_constant_down_columns": True,
          "peak_mem_gib_serving": peak_serve,
          "train_trav_steps": steps, "train_trav_batch": cfg.batch_size,
          "train_trav_epoch_s": epoch_s,
          "train_trav_ms_per_step": epoch_s * 1e3 / steps,
          "pseudo_label_s": label_s, "train_trav_run_s": run_s,
          "train_trav_launches": {"forward": tool[0], "backward": tool[1]},
          "pseudo_label_images": TRAV_PSEUDO_IMAGES,
          "peak_mem_gib_train_trav": peak_tool, "card": smi})
    return {"requests": (fwd_requests, 0), "train_trav": tool}


def phase_fss(smi):
    """The few-shot path: `tools.train_trav_fss.run` on the Trav config
    (480x640, bf16, batch 2 x (5 + 1)) over in-memory episodes: 2 epochs
    of FSS_STEPS_PER_EPOCH steps, FSS_EVAL_EPISODES evaluation episodes
    after each, a preemption requested at the start of epoch 3 (the rescue
    checkpoint holds the trained state); then --class-episodes with the
    contrastive term for one epoch; then the step and the evaluation
    episode timed through `entry.fss_steps` and `fss_evaluate`. Checks
    losses, launches, the frozen and the trained parameters, the kept
    checkpoints and the rescue file's logits in a fresh model. Returns the
    forward and backward launches {binary, class_episodes}."""
    import tempfile

    import torch

    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.runtime.preempt import StopAfter
    from dformer_torch.tools import train_trav_fss
    from dformer_torch.train.fss import FSSTrainer, fss_evaluate
    from dformer_torch.train.loop import coverage_flags
    from dformer_torch.utils.checkpoint import load_checkpoint

    per_pass = sum(n for *_, n in mlp_shapes("DFormer-Base"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as root:
        cfg = trav_cfg(root, "fss")
        hw, B, S = (cfg.image_height, cfg.image_width), cfg.batch_size, \
            cfg.shots
        check(B * (S + 1) == TRAV_BATCH, f"episode batch {B} x ({S} + 1)")
        cfg.update(epochs=3, eval_iterations=FSS_EVAL_EPISODES)
        datasets = (MemoryEpisodes(B * FSS_STEPS_PER_EPOCH, hw, S),
                    MemoryEpisodes(FSS_EVAL_EPISODES, hw, S))
        init = entry.build_fss_training(cfg, torch.bfloat16, "cuda",
                                        cfg.seed)[0]
        params0 = {n: p.detach().clone() for n, p in init.named_parameters()}
        del init
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        # guard reads: the start of epochs 1, 2 and 3; stop at the third
        out = train_trav_fss.run(cfg, train_trav_fss.parse_args([]),
                                 datasets=datasets, guard=StopAfter(3))
        run_s = time.perf_counter() - t0
        binary = (fused_mlp.launches, fused_mlp.backward_launches)
        trainer = out["trainer"]
        steps = 2 * FSS_STEPS_PER_EPOCH
        check(trainer.step == steps, f"fss: step {trainer.step}")
        check(binary == ((steps + 2 * FSS_EVAL_EPISODES) * per_pass,
                         steps * per_pass),
              f"fss: {binary} forward and backward launches, expected "
              f"{per_pass} of each per step and {per_pass} per episode")
        check(sorted(out["losses"]) == [1, 2]
              and all(np.isfinite(v) for v in out["losses"].values()),
              f"fss: losses {out['losses']}")
        # frozen: bit-unchanged; trainable: an update in the optimizer's
        # state (its first moment; at the warm-up's rates and the
        # depth stream's small gradients many updates round away in fp32),
        # all but query2, whose gradient is exactly 0
        frozen = set(trainer.frozen)
        _, updated = coverage_flags(trainer.model, trainer.optimizer)
        moved, stuck = [], []
        for (name, p), upd in zip(trainer.model.named_parameters(), updated):
            same = torch.equal(p.detach(), params0[name])
            if name in frozen:
                check(same and not upd, f"fss: frozen {name} changed")
                continue
            if not upd:
                stuck.append(name)
            if not same:
                moved.append(name)
        check(stuck == ["encoder_backbone.attn_expand_e.query2"],
              f"fss: trainable parameters with no update: {stuck}")
        ckpt = out["checkpoints"]
        rescue, epoch = ckpt.latest()
        kept = sorted(n for *_, n in ckpt._existing())
        check(epoch == 2 and f"epoch-2_miou_{round(out['best_miou'], 2)}.pth"
              in kept, f"fss: kept {kept}")
        rng = np.random.RandomState(23)
        rgb = torch.from_numpy(rng.randn(2, *hw, 3).astype(np.float32)).cuda()
        lidar = torch.from_numpy(rng.randn(2, 360).astype(np.float32)).cuda()
        fresh = load_checkpoint(entry.build_trav(cfg, torch.bfloat16), rescue)
        with torch.inference_mode():
            logits_equal = torch.equal(fresh(rgb, lidar),
                                       trainer.model.eval()(rgb, lidar))
        check(logits_equal, "fss: the rescue checkpoint's logits differ")
        binary_out = {k: out[k] for k in ("losses", "miou", "epoch_seconds",
                                          "eval_seconds")}
        del fresh, trainer, out, params0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30

        # class-grouped episodes with the contrastive term, one epoch
        cfg = trav_cfg(root, "fss_class")
        cfg.update(epochs=1, eval_iterations=FSS_EVAL_EPISODES)
        fused_mlp.launches = fused_mlp.backward_launches = 0
        out = train_trav_fss.run(
            cfg, train_trav_fss.parse_args(
                ["--class-episodes", "--contrastive-weight=0.1"]),
            datasets=(MemoryEpisodes(2, hw, S, class_grouped=True),
                      datasets[1]))
        grouped = (fused_mlp.launches, fused_mlp.backward_launches)
        check(out["trainer"].step == 1
              and np.isfinite(out["losses"][1])
              and np.isfinite(out["contrastive"][1]),
              f"fss class episodes: losses {out['losses']}, contrastive "
              f"{out['contrastive']}")
        check(grouped == ((1 + FSS_EVAL_EPISODES) * per_pass, per_pass),
              f"fss class episodes: {grouped} launches")
        class_out = {k: out[k] for k in ("losses", "contrastive", "miou")}
        del out

        # one step and one evaluation episode, timed
        model, opt, sched, mask = entry.build_fss_training(
            cfg, torch.bfloat16, "cuda", cfg.seed)
        ft = FSSTrainer(model, opt, sched, cfg, mask, seed=cfg.seed)
        ep = ft.prepare(epoch_batches(datasets[0], B)[0], 1, 0)
        args = [ep[k] for k in ("s_img", "s_depth", "s_gt", "q_img",
                                "q_depth", "q_gt")]
        gen = torch.Generator(device="cuda").manual_seed(0)
        entry.fss_steps(model, opt, sched, gen, [args])  # warm-up
        step_ms = []
        for k in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            entry.fss_steps(model, opt, sched, gen, [args], first_step=1 + k)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        val = [ft.prepare(b) for b in epoch_batches(datasets[1], 1)]
        fss_evaluate(model, val[:1], cfg)  # warm-up
        eval_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = fss_evaluate(model, val, cfg)
            torch.cuda.synchronize()
            eval_ms.append((time.perf_counter() - t0) * 1e3 / len(val))
        check(int(m.hist.sum()) > 0, "fss: empty evaluation hist")
        del model, opt, ft, ep, args, val
    emit({"phase": "fss", "model": "DFormerTrav-Base+LightHamHead",
          "config": TRAV_CONFIG, "episodes_per_step": B, "shots": S,
          "images_per_step": TRAV_BATCH, "hw": list(hw), "dtype": "bfloat16",
          "steps": steps, "binary": binary_out,
          "ms_per_step": statistics.median(step_ms), "ms_each_step": step_ms,
          "ms_per_eval_episode": statistics.median(eval_ms),
          "ms_each_eval_episode": eval_ms, "run_s": run_s,
          "launches_binary": {"forward": binary[0], "backward": binary[1]},
          "launches_class_episodes": {"forward": grouped[0],
                                      "backward": grouped[1]},
          "fwd_launches_per_step": per_pass,
          "bwd_launches_per_step": per_pass,
          "frozen": len(frozen), "trainable_updated": len(updated)
          - len(frozen) - len(stuck), "trainable_not_updated": stuck,
          "trainable_changed_in_fp32": len(moved), "kept": kept,
          "rescue_logits_equal": True,
          "class_episodes": class_out, "peak_mem_gib": peak, "card": smi})
    return {"binary": binary, "class_episodes": grouped}


def epoch_batches(dataset, batch):
    """The collated batches of one epoch of `dataset`, through the port's
    loader."""
    from dformer_torch.data.loader import Loader

    return list(Loader(dataset, batch, drop_last=True))


def phase_fss_cpu_vs_card(smi):
    """One FSS step of DFormerTrav-Base + ham at 64x96 (B 1, S 1, the
    contrastive term on, LayerScales 1), same weights, episode and NMF
    bases, DropPath and dropout off, through `against_float64`: the card's
    fp32 loss within FSS_CPU_VS_CARD_REL relative of the float64 CPU's,
    every trainable gradient within FSS_CPU_VS_CARD_GRAD of its leaf's max
    (the FSS_LIDAR_BIAS leaves within FSS_LIDAR_BIAS_GRAD; leaves whose
    reference gradient is below TRAIN_NULL_GRAD everywhere are rounding
    noise, not compared), and the TF32 control outside the first limit."""
    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.train.fss import fss_train_step
    from dformer_torch.train.optim import make_optimizer

    cfg = load_config(TRAV_CONFIG)
    cfg.update(image_height=64, image_width=96, drop_path_rate=0.0,
               pretrained_model=None, warm_up_epoch=0)
    hw = (64, 96)
    rng = np.random.RandomState(24)
    episode = [torch.from_numpy(a) for a in (
        rng.randn(1, 1, *hw, 3).astype(np.float32),
        np.stack([[_horizon_labels(rng, hw)]]).astype(np.int64),
        rng.randn(1, 1, 360).astype(np.float32),
        rng.randn(1, *hw, 3).astype(np.float32),
        _horizon_labels(rng, hw)[None].astype(np.int64),
        rng.randn(1, 360).astype(np.float32))]
    bases = torch.from_numpy(rng.rand(1, 512, 64).astype(np.float32))
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    model, _, sched, mask = entry.build_fss_training(cfg, None, "cpu",
                                                     seed=0)
    model.decode_head.dropout.rate = 0.0
    with torch.no_grad():  # LayerScales 1: every branch in the gradients
        for name, p in model.named_parameters():
            if "layer_scale" in name:
                p.fill_(1.0)

    def step(m, device, dtype):
        loss, con = fss_train_step(
            m, make_optimizer(cfg, m, mask), sched, 0,
            *(t.to(device, dtype) if t.is_floating_point() else t.to(device)
              for t in episode),
            torch.Generator(device=device).manual_seed(0),
            bases=bases.to(device, dtype), contrastive_weight=0.1)
        return (loss.item(), con.item()), {
            n: p.grad.double().cpu() for n, p in m.named_parameters()
            if mask[n]}

    ref, card, control, launches, relus = against_float64(model, step)
    per_pass = sum(n for *_, n in mlp_shapes("DFormer-Base"))
    check(launches == (per_pass, per_pass),
          f"fss cpu vs card: {launches} forward and backward launches on "
          "the card")
    ((loss_ref, con_ref), g_ref), ((loss, con), g) = ref, card
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    lidar = {n for n in g_ref if re.fullmatch(FSS_LIDAR_BIAS, n)}
    check(lidar, "fss cpu vs card: no lidar-expansion bias")
    rest = {n: w for n, w in g_ref.items() if n not in lidar}
    worst, worst_name, skipped = grad_worst(g, rest)
    worst_lidar, lidar_name, _ = grad_worst(g, {n: g_ref[n] for n in lidar})
    control_worst, control_name, _ = grad_worst(control[1], rest)
    emit({"phase": "fss_cpu_vs_card",
          "model": "DFormerTrav-Base+LightHamHead", "episodes": 1,
          "shots": 1, "hw": list(hw), "reference": "cpu float64",
          "loss_card": loss, "loss_ref": loss_ref, "loss_rel": loss_rel,
          "contrastive_card": con, "contrastive_ref": con_ref,
          "max_grad_rel": worst, "max_grad_rel_leaf": worst_name,
          "max_grad_rel_lidar_biases": worst_lidar,
          "max_grad_rel_lidar_leaf": lidar_name,
          "tf32_control_max_grad_rel": control_worst,
          "tf32_control_leaf": control_name, "relus_pinned": relus,
          "limit_rel": FSS_CPU_VS_CARD_REL,
          "limit_grad_rel": FSS_CPU_VS_CARD_GRAD,
          "limit_grad_rel_lidar_biases": FSS_LIDAR_BIAS_GRAD,
          "lidar_biases": sorted(lidar),
          "trainable_leaves": len(g_ref),
          "null_gradient_leaves_skipped": skipped,
          "fused_mlp_launches_each_way": per_pass, "card": smi})
    check(loss_rel <= FSS_CPU_VS_CARD_REL, f"fss card loss: {loss_rel}")
    check(worst <= FSS_CPU_VS_CARD_GRAD,
          f"fss card gradient of {worst_name}: rel {worst}")
    check(worst_lidar <= FSS_LIDAR_BIAS_GRAD,
          f"fss card gradient of {lidar_name}: rel {worst_lidar}")
    check(control_worst > FSS_CPU_VS_CARD_GRAD,
          f"fss: the TF32 control passed ({control_worst})")
    check(len(skipped) < len(g_ref) // 10,
          f"{len(skipped)} null-gradient leaves skipped")

# the decoder phases: every head of the JAX package on DFormer-Large at
# 480x640, bs8, bf16 (ham with the FCN aux head at aux_rate 0.4; UPernet,
# deeplabv3+ and nl always carry it); forwards timed, steps counted and
# timed, images evaluated; each head's narrow step at the main path's batch
# (UPernet's pyramid and deeplabv3+'s image pool then normalise 8 pooled
# values), fp32 on the card against float64 on the CPU through
# `against_float64` (an H100 read 6.5e-6 to 2.3e-5 of a leaf's max there
# over three runs, TF32 5e-3 to 7.5e-3); the train tool on the UPernet
# config
DECODERS = (("MLPDecoder", 0.0), ("UPernet", 0.0), ("deeplabv3+", 0.0),
            ("nl", 0.0), ("ham", 0.4))
DECODER_FORWARDS = 10
DECODER_WARM_STEPS, DECODER_TIMED_STEPS = 3, 5
DECODER_EVAL_IMAGES = 4
DECODER_CPU_VS_CARD_BATCH = 8
DECODER_CPU_VS_CARD_LOSS = 1e-6
DECODER_CPU_VS_CARD_GRAD = 5e-5
DECODERS_FIT_ITERS = 3


def phase_decoders(smi):
    """Each head of DECODERS on DFormer-Large (weights from seed 0): a
    warm-up request, then DECODER_FORWARDS timed forwards through
    entry.infer (finite logits of the right shape, 39 forward-kernel
    launches each); entry.build_trainer + entry.train_steps for
    DECODER_WARM_STEPS steps, then DECODER_TIMED_STEPS timed ones (finite
    losses, 39 + 39 launches each); single-scale evaluation of
    DECODER_EVAL_IMAGES synthetic images through entry.build_evaluator,
    whose labels must equal entry.infer's on the same batch. Returns
    {head: (forward launches per forward, forward and backward launches
    per step)}."""
    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.data.loader import device_val_batches
    from dformer_torch.kernels.fused_mlp import fused_mlp

    per_pass = sum(n for *_, n in mlp_shapes())
    rng = np.random.RandomState(30)
    rgb, depth, _ = train_batch(rng, BATCH, HW, NUM_CLASSES)
    batches = [train_batch(rng, BATCH, HW, NUM_CLASSES) for _ in range(2)]
    out = {}
    for decoder, aux_rate in DECODERS:
        name = decoder + (f"+aux{aux_rate}" if aux_rate else "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = entry.build("DFormer-Large", HW, NUM_CLASSES, torch.bfloat16,
                            "cuda", seed=0, decoder=decoder,
                            aux_rate=aux_rate)
        logits = []
        hook = model.register_forward_hook(lambda m, i, o: logits.append(o))
        entry.infer(model, rgb, depth)
        torch.cuda.synchronize()
        fused_mlp.launches = 0
        times = []
        for _ in range(DECODER_FORWARDS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            labels = entry.infer(model, rgb, depth)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd_launches = fused_mlp.launches
        hook.remove()
        out_logits = logits[-1]
        check(tuple(out_logits.shape) == (BATCH, *HW, NUM_CLASSES)
              and bool(torch.isfinite(out_logits).all()),
              f"{name}: logits {tuple(out_logits.shape)} or not finite")
        check(tuple(labels.shape) == (BATCH, *HW)
              and 0 <= labels.min().item()
              and labels.max().item() < NUM_CLASSES,
              f"{name}: bad labels")
        check(fwd_launches == per_pass * DECODER_FORWARDS,
              f"{name}: {fwd_launches} forward launches in "
              f"{DECODER_FORWARDS} forwards, expected {per_pass} each")
        serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, logits, out_logits
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        model, optimizer, schedule, gen = entry.build_trainer(
            "DFormer-Large", HW, NUM_CLASSES, torch.bfloat16, "cuda", seed=0,
            decoder=decoder, aux_rate=aux_rate)
        check((model.aux_head is not None)
              == (aux_rate != 0 or decoder != "MLPDecoder"),
              f"{name}: aux head {model.aux_head is not None}")
        fused_mlp.launches = fused_mlp.backward_launches = 0
        losses = entry.train_steps(model, optimizer, schedule, gen,
                                   [batches[k % 2] for k in
                                    range(DECODER_WARM_STEPS)])
        steps = DECODER_WARM_STEPS
        step_launches = (fused_mlp.launches, fused_mlp.backward_launches)
        check(step_launches == (per_pass * steps, per_pass * steps),
              f"{name}: {step_launches} forward and backward launches in "
              f"{steps} steps, expected {per_pass} + {per_pass} each")
        step_times = []
        for k in range(DECODER_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses += entry.train_steps(model, optimizer, schedule, gen,
                                        [batches[k % 2]],
                                        first_step=steps + k)
            torch.cuda.synchronize()
            step_times.append((time.perf_counter() - t0) * 1e3)
        check(all(np.isfinite(v) for v in losses), f"{name}: losses {losses}")
        train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        del model, optimizer
        torch.cuda.empty_cache()

        cfg = load_config("local_configs.NYUDepthv2.DFormer_Large")
        cfg.update(decoder=decoder, aux_rate=aux_rate)
        ev, _ = entry.build_evaluator(cfg, torch.bfloat16, "cuda", seed=0)
        differ = []

        def same_labels(pred, batch):
            served = entry.infer(ev.model, batch["rgb"], batch["modal_x"])
            differ.append(int((served[:pred.shape[0]].cpu().numpy()
                               != pred).sum()))

        fused_mlp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = ev.evaluate(device_val_batches(cfg, DECODER_EVAL_IMAGES, "cuda",
                                           synthetic=True,
                                           n=DECODER_EVAL_IMAGES),
                        save_hook=same_labels)
        torch.cuda.synchronize()
        eval_s = time.perf_counter() - t0
        check(m.hist.sum() == DECODER_EVAL_IMAGES * HW[0] * HW[1]
              and np.isfinite(m.compute_iou()[1]),
              f"{name}: eval hist {m.hist.sum()}")
        check(differ == [0], f"{name}: eval labels differ from the served "
              f"forward's at {differ} pixels")
        check(fused_mlp.launches == 2 * per_pass,
              f"{name}: {fused_mlp.launches} launches in the eval group and "
              "its served forward")
        del ev
        torch.cuda.empty_cache()
        ms, step_ms = statistics.median(times), statistics.median(step_times)
        emit({"phase": "decoders", "model": f"DFormer-Large+{name}",
              "decoder": decoder, "aux_rate": aux_rate, "batch": BATCH,
              "hw": list(HW), "dtype": "bfloat16",
              "ms_per_forward": ms, "ms_each_forward": times,
              "img_per_s": BATCH / ms * 1e3,
              "fused_mlp_launches_per_forward": fwd_launches
              / DECODER_FORWARDS,
              "ms_per_step": step_ms, "ms_each_step": step_times,
              "losses": losses,
              "fused_mlp_launches_per_step": [n / steps
                                              for n in step_launches],
              "peak_mem_gib_serve": serve_peak,
              "peak_mem_gib_train": train_peak,
              "eval_images": DECODER_EVAL_IMAGES, "eval_s": eval_s,
              "eval_mIoU": m.compute_iou()[1],
              "eval_labels_equal_served": True, "card": smi})
        out[name] = (fwd_launches / DECODER_FORWARDS,
                     [n / steps for n in step_launches])
    return out


def phase_decoders_cpu_vs_card(smi):
    """For each head of DECODERS, one narrow forward + backward at batch
    DECODER_CPU_VS_CARD_BATCH (the train step's loss, the aux term
    included; same weights, batch and NMF bases; DropPath and dropout off)
    through `against_float64`: the card's fp32 loss within
    DECODER_CPU_VS_CARD_LOSS relative of the float64 CPU's, every gradient
    within DECODER_CPU_VS_CARD_GRAD of its leaf's max (leaves whose
    reference gradient stays below TRAIN_NULL_GRAD are rounding noise, not
    compared), and the TF32 control outside that limit."""
    import torch

    from dformer_torch import entry
    from dformer_torch.models.encoder import VARIANTS
    from dformer_torch.models.nn import Dropout
    from dformer_torch.ops.loss import softmax_cross_entropy_masked_mean

    VARIANTS.setdefault("DFormer-Narrow", NARROW)
    hw, batch, classes = (64, 96), DECODER_CPU_VS_CARD_BATCH, 11
    n_mlp = sum(NARROW["depths"]) * 2 - 1
    rng = np.random.RandomState(31)
    rgb, depth, gt = (t.cpu() for t in train_batch(rng, batch, hw, classes))
    bases = torch.from_numpy(rng.rand(batch, 512, 64).astype(np.float32))
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)

    def step(model, device, dtype):
        logits, aux = model.forward_with_aux(
            rgb.to(device, dtype), depth.to(device, dtype),
            bases=bases.to(device, dtype))
        loss = softmax_cross_entropy_masked_mean(logits, gt.to(device))
        if model.aux_rate:
            loss = loss + model.aux_rate * softmax_cross_entropy_masked_mean(
                aux, gt.to(device))
        loss.backward()
        return loss.item(), {n: p.grad.double().cpu()
                             for n, p in model.named_parameters()
                             if p.grad is not None}

    misses = []
    for decoder, aux_rate in DECODERS:
        model = entry.build_trainer(
            "DFormer-Narrow", hw, classes, torch.float32, "cpu", seed=0,
            decoder=decoder, aux_rate=aux_rate, drop_path_rate=0.0)[0]
        for m in model.modules():
            if isinstance(m, Dropout):
                m.rate = 0.0
        (loss_ref, g_ref), (loss, g), control, launches, relus = \
            against_float64(model, step)
        loss_rel = abs(loss - loss_ref) / abs(loss_ref)
        worst, worst_name, skipped = grad_worst(g, g_ref)
        control_worst, control_name, _ = grad_worst(control[1], g_ref)
        emit({"phase": "decoders_cpu_vs_card", "decoder": decoder,
              "aux_rate": aux_rate, "model": "DFormer-Narrow",
              "batch": batch, "hw": list(hw), "reference": "cpu float64",
              "loss_card": loss, "loss_ref": loss_ref, "loss_rel": loss_rel,
              "limit_loss_rel": DECODER_CPU_VS_CARD_LOSS,
              "max_grad_rel": worst, "max_grad_rel_leaf": worst_name,
              "limit_grad_rel": DECODER_CPU_VS_CARD_GRAD,
              "tf32_control_max_grad_rel": control_worst,
              "tf32_control_leaf": control_name, "relus_pinned": relus,
              "leaves": len(g_ref), "null_gradient_leaves_skipped": skipped,
              "fused_mlp_launches_card": launches, "card": smi})
        check(launches == (n_mlp, n_mlp),
              f"{decoder} cpu vs card: {launches} launches on the card")
        check(len(skipped) < len(g_ref) // 5,
              f"{decoder}: {len(skipped)} null-gradient leaves skipped")
        if loss_rel > DECODER_CPU_VS_CARD_LOSS \
                or worst > DECODER_CPU_VS_CARD_GRAD:
            misses.append(f"{decoder}: loss {loss_rel}, gradient of "
                          f"{worst_name} {worst}")
        if control_worst <= DECODER_CPU_VS_CARD_GRAD:
            misses.append(f"{decoder}: the TF32 control passed "
                          f"({control_worst})")
    check(not misses, "decoders against the float64 CPU: "
          + "; ".join(misses))


def phase_decoders_fit(smi):
    """`tools.train.run` on the NYUDepthv2 DFormer-Large config with
    decoder UPernet and aux_rate 0.4 (bf16, bs8, 480x640, synthetic data):
    2 epochs of DECODERS_FIT_ITERS iterations, an fp32 MSF + flip
    evaluation of FIT_VAL_IMAGES images after epoch 1, and a rescue
    checkpoint after epoch 2 (a preemption requested there, as in `fit`);
    that file, loaded into a fresh `entry.build` model of the same head,
    gives the trained model's logits. Returns the run's (forward, backward)
    launches."""
    import tempfile

    import torch

    from dformer_torch import entry
    from dformer_torch.configs import load_config
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.runtime.preempt import StopAfter
    from dformer_torch.tools import train as train_tool
    from dformer_torch.utils.checkpoint import load_checkpoint

    per_pass = sum(n for *_, n in mlp_shapes())
    steps = 2 * DECODERS_FIT_ITERS
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as root:
        cfg = load_config("local_configs.NYUDepthv2.DFormer_Large")
        cfg.update(decoder="UPernet", aux_rate=0.4,
                   niters_per_epoch=DECODERS_FIT_ITERS, nepochs=2,
                   checkpoint_start_epoch=0, num_eval_imgs=FIT_VAL_IMAGES,
                   log_dir_base=f"{root}/upernet")
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        run = train_tool.run(cfg, train_tool.parse_args(
            ["--config=local_configs.NYUDepthv2.DFormer_Large",
             "--synthetic-data", f"--val_batch_size={FIT_VAL_IMAGES}"]),
            guard=StopAfter(2 * (DECODERS_FIT_ITERS + 1)))
        run_s = time.perf_counter() - t0
        launches = (fused_mlp.launches, fused_mlp.backward_launches)
        trainer = run.pop("trainer")
        evals = sorted(run["eval_seconds"])
        # one MSF + flip group: 5 scales x 2 flips
        want = (steps * per_pass + 10 * per_pass, steps * per_pass)
        check(trainer.step == steps, f"UPernet fit ended at step "
              f"{trainer.step}, not {steps}")
        check(trainer.model.aux_head is not None, "UPernet fit: no aux head")
        check(launches == want, f"UPernet fit: {launches} forward and "
              f"backward launches, expected {want}")
        check(all(np.isfinite(v) for v in run["losses"].values())
              and evals == [1], f"UPernet fit losses {run['losses']}, "
              f"evaluated after epochs {evals}")
        kept = sorted(p for *_, p in run["checkpoints"]._existing())
        rescue, epoch = run["checkpoints"].latest()
        check(epoch == 2, f"UPernet fit kept {kept}")
        rgb, depth, _ = train_batch(np.random.RandomState(32), 2, HW,
                                    NUM_CLASSES)
        fresh = load_checkpoint(entry.build(
            "DFormer-Large", HW, NUM_CLASSES, torch.bfloat16, "cuda",
            decoder="UPernet", aux_rate=0.4), rescue)
        with torch.inference_mode():
            logits_file = fresh(rgb, depth)
            logits_trained = trainer.model.eval()(rgb, depth)
        check(torch.equal(logits_file, logits_trained),
              "UPernet checkpoint logits differ by "
              f"{(logits_file.float() - logits_trained.float()).abs().max()}")
        gaps = step_gaps_ms(trainer)
        del trainer, fresh
    emit({"phase": "decoders_fit", "model": "DFormer-Large+UPernet+aux0.4",
          "config": "local_configs.NYUDepthv2.DFormer_Large",
          "decoder": "UPernet", "aux_rate": 0.4, "batch": BATCH,
          "hw": list(HW), "dtype": "bfloat16", "eval_dtype": "float32",
          "iterations_per_epoch": DECODERS_FIT_ITERS,
          "val_images": FIT_VAL_IMAGES, "losses": run["losses"],
          "evaluated_epochs": evals, "kept": kept,
          "fused_mlp_launches": launches,
          "ms_per_step": statistics.median(gaps), "ms_each_step": gaps,
          "epoch_seconds": run["epoch_seconds"],
          "eval_seconds": run["eval_seconds"], "run_s": run_s,
          "checkpoint_logits_equal": True,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "card": smi})
    return launches


CONVERGENCE_MIN_MIOU = 60.0
CONVERGENCE_WINDOW = 100  # steps averaged at each end of the loss curve


# Trav's smoke in its own process, beside Tiny's in this one: each 600-step
# run is host-bound (one Python thread launching small kernels) and the card
# has room for both
TRAV_SMOKE = ("import json; from dformer_torch.kernels.fused_mlp import "
              "fused_mlp; from dformer_torch.tools import smoke_convergence "
              "as s; r = s.main(['--trav']); r['totals'] = "
              "[fused_mlp.launches, fused_mlp.backward_launches]; "
              "print(json.dumps(r))")


def phase_convergence(smi):
    """`tools.smoke_convergence.main` at its defaults (600 steps, bf16,
    min mIoU 60) for DFormer-Tiny here and, at the same time, for
    DFormerTrav-Base (--trav) in a second process (TRAV_SMOKE), whose
    kernel counts start at 0: the tool raises below the mIoU; here also
    every step's forward and backward launches (one per fused MLP of the
    encoder each way), finite losses, and the mean loss of the last
    CONVERGENCE_WINDOW steps below that of the first. Returns {task: the
    run's (forward, backward) launches}."""
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import smoke_convergence

    child = subprocess.Popen(
        [sys.executable, "-c", TRAV_SMOKE], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        fused_mlp.launches = fused_mlp.backward_launches = 0
        runs = {"tiny": smoke_convergence.main([])}
        runs["tiny"]["totals"] = [fused_mlp.launches,
                                  fused_mlp.backward_launches]
        text, _ = child.communicate(timeout=900)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    print(text, end="", flush=True)
    check(child.returncode == 0, f"convergence trav: exit {child.returncode}")
    runs["trav"] = json.loads(text.strip().splitlines()[-1])

    out = {}
    for task, variant in (("tiny", "DFormer-Tiny"), ("trav", "DFormer-Base")):
        r = runs[task]
        per_pass = sum(n for *_, n in mlp_shapes(variant))
        out[task] = tuple(r["totals"])
        losses = r["losses"]
        first = statistics.mean(losses[:CONVERGENCE_WINDOW])
        last = statistics.mean(losses[-CONVERGENCE_WINDOW:])
        bad_steps = [i for i, n in enumerate(r["launches"])
                     if tuple(n) != (per_pass, per_pass)]
        emit({"phase": "convergence", "task": task,
              "steps": len(losses), "held_out_miou": r["miou"],
              "per_class_iou": r["ious"], "limit_miou": CONVERGENCE_MIN_MIOU,
              "mean_loss_first_100": first, "mean_loss_last_100": last,
              "final_loss": losses[-1], "seconds": r["seconds"],
              "ms_per_step": r["ms_per_step"],
              "launches_per_step": list(r["launches"][0]),
              "launches": list(out[task]), "card": smi})
        check(all(np.isfinite(losses)), f"convergence {task}: loss not "
              "finite")
        check(last < first, f"convergence {task}: loss {first} -> {last}")
        check(r["miou"] >= CONVERGENCE_MIN_MIOU,
              f"convergence {task}: mIoU {r['miou']}")
        check(not bad_steps, f"convergence {task}: steps {bad_steps[:5]} "
              f"did not launch {per_pass} + {per_pass} kernels")
    return out


def run_tool(main, argv, keys):
    """Call a tool's `main(argv)` in this process, echo what it prints, and
    return (its JSON records, main's result); every record's `keys` must be
    finite and positive."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    text = buf.getvalue()
    print(text, end="", flush=True)
    records = [json.loads(line) for line in text.splitlines()
               if line.startswith("{")]
    check(records, f"{main.__module__}: no JSON line")
    for rec in records:
        check_positive(rec, keys, main.__module__)
    return records, result


def check_positive(record, keys, who):
    for key in keys:
        v = record.get(key)
        check(isinstance(v, (int, float)) and np.isfinite(v) and v > 0,
              f"{who}: {key} = {v!r}")


# traced runs per head in the tools phase: fewer than the tool's defaults
# (10 forwards, 3 steps), to keep the script within its time
TRACE_REPS = {"forward": 5, "train": 2}


def phase_tools(smi):
    """Each measurement tool of the port at its defaults (`run_tool`); the
    bench's labels against `entry.infer` of a model built apart from the
    same seed on the same inputs; the forward kernel's launches in the
    bench, latency and train_bench runs exact; then
    `trace_forward.trace` of every head, serving and training. Returns
    {tool: (forward, backward) launches}."""
    import torch

    from dformer_torch import bench, entry, trace_forward
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import (benchmark, eval_bench, latency,
                                     train_bench)

    per_pass = sum(n for *_, n in mlp_shapes())
    launches = {}

    seconds = {}

    def counted(name, fn):
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        launches[name] = (fused_mlp.launches, fused_mlp.backward_launches)
        return result

    records, labels = counted("bench", lambda: run_tool(
        bench.main, [], ("value", "vs_baseline", "forward_ms")))
    check(len(records) == 2, f"bench: {len(records)} records")
    check_positive(records[1], ("train_step_ms_bs8",
                                "train_imgs_per_sec_per_chip"), "bench")
    model = entry.build("DFormer-Large", HW, NUM_CLASSES, torch.bfloat16,
                        "cuda", seed=0)
    rgb, modal = bench.inputs(np.random.RandomState(0), BATCH, HW, "cuda")
    same = bool(torch.equal(entry.infer(model, rgb, modal), labels))
    del model
    emit({"phase": "tools", "tool": "bench", "record": records[1],
          "labels_equal_entry_infer": same, "launches": launches["bench"],
          "card": smi})
    check(same, "bench: labels differ from entry.infer's")
    check(launches["bench"] == (per_pass * 46, per_pass * 23),
          f"bench: {launches['bench']} launches, expected "
          f"{per_pass} x (23 forwards + 23 steps) and {per_pass} x 23")

    counted("latency", lambda: run_tool(latency.main, [],
                                        ("avg_ms", "p50_ms", "p90_ms")))
    check(launches["latency"] == (per_pass * 120, 0),
          f"latency: {launches['latency']} launches")
    counted("benchmark", lambda: run_tool(benchmark.main, [],
                                          ("params", "flops")))
    check(launches["benchmark"] == (0, 0), "benchmark: counted on the "
          "card, not on the CPU's plain path")
    counted("train_bench", lambda: run_tool(
        train_bench.main, [], ("step_ms", "img_per_s", "epoch_seconds")))
    check(launches["train_bench"] == (per_pass * 23, per_pass * 23),
          f"train_bench: {launches['train_bench']} launches")
    for mode, argv in (("eval_bench_msf_flip", []),
                       ("eval_bench_sliding", ["--sliding"])):
        counted(mode, lambda: run_tool(
            eval_bench.main, argv, ("ms_per_image", "img_per_s")))
        check(launches[mode][0] > 0 and launches[mode][1] == 0,
              f"{mode}: {launches[mode]} launches")

    traces = {}
    for decoder in trace_forward.DECODERS:
        for mode in ("forward", "train"):
            torch.cuda.empty_cache()
            rec = counted(f"trace_{decoder}_{mode}",
                          lambda: trace_forward.trace(
                              mode, decoder, reps=TRACE_REPS[mode]))
            what = "step" if mode == "train" else "forward"
            rec = {k: v for k, v in rec.items() if k != "top"} | {
                "top": rec["top"][:8]}
            emit({"phase": "tools", "tool": "trace_forward", "mode": mode,
                  **rec})
            kernel_ms = rec[f"device_kernel_ms_per_{what}"]
            check(np.isfinite(kernel_ms) and kernel_ms > 0
                  and rec[f"fused_mlp_ms_per_{what}"] > 0,
                  f"trace {decoder} {mode}: {kernel_ms} ms of kernels")
            traces[f"{decoder}_{mode}"] = kernel_ms
    emit({"phase": "tools", "device_kernel_ms": traces,
          "launches": launches, "seconds": seconds, "card": smi})
    return launches


# the data-parallel phase: steps counted and compared, then timed; the
# world-2 run's narrow fp32 state against world 1's, each leaf as max |diff|
# over max(max |world 1|, DDP_STATE_FLOOR) (a leaf that stays near 0 holds
# rounding noise: tests/test_torch_dist.py); the exported artifact's logits
# against the eager model's, as max |diff| / max |eager|
DDP_STEPS = 3
DDP_TIMED = 3
DDP_NARROW_HW = (64, 96)
DDP_STATE_REL = 1e-5
DDP_STATE_FLOOR = 0.1
EXPORT_LOGITS_REL = 1e-2
WORKER_TIMEOUT_S = 600


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(call, world, env=None):
    """Start `world` processes of `python -c call` from the repository root
    with torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) on one card; wait for all, echo their output, fail unless
    each exits 0, and return rank 0's last JSON line."""
    port = str(_free_port())
    procs = []
    try:
        for rank in range(world):
            penv = dict(os.environ, RANK=str(rank), LOCAL_RANK="0",
                        WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                        **(env or {}))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", call], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True, env=penv,
                cwd=os.path.dirname(os.path.abspath(__file__))))
        outs = [p.communicate(timeout=WORKER_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        print(text[-4000:], end="", flush=True)
        check(p.returncode == 0, f"worker rank {rank} of {world}: exit "
              f"{p.returncode}")
    lines = [ln for ln in outs[0].splitlines() if ln.startswith("{")]
    check(lines, "worker rank 0 printed no JSON line")
    return json.loads(lines[-1])


def _ddp_steps(backbone, hw, batch, dtype):
    """entry.build_trainer(backbone, seed 0) and DDP_STEPS counted steps
    through entry.train_steps on this rank's rows of seeded global batches
    of `batch`, under deterministic algorithms (the bilinear resize's
    backward otherwise sums with atomics); then DDP_TIMED steps without
    them, each timed by CUDA events. Returns {"losses", "state" (on the
    card), "launches" per counted step, "ms_each_timed", "grad_syncs" of
    the counted steps}."""
    import torch

    from dformer_torch import entry
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.parallel import dist

    model, optimizer, schedule, gen = entry.build_trainer(
        backbone, hw, NUM_CLASSES, dtype, "cuda", seed=0)
    rng = np.random.RandomState(5)
    batches = [tuple(dist.rank_rows(t)
                     for t in train_batch(rng, batch, hw, NUM_CLASSES))
               for _ in range(DDP_STEPS)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    losses, launches, syncs = [], [], dist.grad_syncs
    for k, b in enumerate(batches):
        f0, b0 = fused_mlp.launches, fused_mlp.backward_launches
        losses += entry.train_steps(model, optimizer, schedule, gen, [b],
                                    first_step=k)
        launches.append([fused_mlp.launches - f0,
                         fused_mlp.backward_launches - b0])
    syncs = dist.grad_syncs - syncs
    state = {n: t.detach().clone() for n, t in model.state_dict().items()}
    torch.use_deterministic_algorithms(False)
    if dist.world() > 1:
        dist.check_replicas_equal(list(model.parameters()))
    times = []
    for k in range(DDP_TIMED):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        entry.train_steps(model, optimizer, schedule, gen,
                          [batches[k % DDP_STEPS]],
                          first_step=DDP_STEPS + k)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    # the gradient all-reduce alone, on the last step's gradients (at
    # world 2 each call doubles them; nothing reads them afterwards): of
    # the optimizer's parameters, as the step syncs them (here every
    # parameter), and of those left when a pretrained encoder is frozen
    # (the tool's mask: everything outside encoder_backbone)
    sync_ms = sync_frozen_ms = None
    if dist.active():
        trained = [p for g in optimizer.param_groups for p in g["params"]]
        unfrozen = [p for n, p in model.named_parameters()
                    if not n.startswith("encoder_backbone.")]
        sync_ms = time_ms(lambda: dist.sync_grads(trained), reps=10,
                          warmup=2, calls=1)
        sync_frozen_ms = time_ms(lambda: dist.sync_grads(unfrozen), reps=10,
                                 warmup=2, calls=1)
    del model, optimizer
    torch.cuda.empty_cache()
    return dict(losses=losses, state=state, launches=launches,
                ms_each_timed=times, grad_syncs=syncs, sync_ms=sync_ms,
                sync_frozen_ms=sync_frozen_ms)


def ddp_worker(mode, out_dir):
    """One rank of phase_ddp, in a process of its own. "nccl" (world 1):
    DFormer-Large + ham bf16 at bs8 with no process group, the narrow fp32
    model likewise (its state saved for the gloo run), then the group from
    torchrun's environment (NCCL) and the Large steps again: losses and
    every parameter and buffer against the run without the group. "gloo"
    (world 2 on the one card): the narrow fp32 and the Large bf16 steps on
    each rank's half of the same global batches of 8; rank 0 saves the
    narrow state. Prints one JSON line."""
    import torch
    import torch.distributed

    from dformer_torch.models.encoder import VARIANTS
    from dformer_torch.parallel import dist

    VARIANTS.setdefault("DFormer-Narrow", NARROW)
    large = ("DFormer-Large", HW, BATCH, torch.bfloat16)
    narrow = ("DFormer-Narrow", DDP_NARROW_HW, BATCH, torch.float32)
    out = {"mode": mode}
    if mode == "nccl":
        alone = _ddp_steps(*large)
        ref = _ddp_steps(*narrow)
        torch.save({k: v.cpu() for k, v in ref["state"].items()},
                   os.path.join(out_dir, "narrow_world1.pt"))
        out["narrow_world1_losses"] = ref["losses"]
        check(dist.init_from_env("cuda"), "no process group from the "
              "environment")
        check(torch.distributed.get_backend() == "nccl",
              f"backend {torch.distributed.get_backend()}")
        grouped = _ddp_steps(*large)
        unequal = [n for n, v in alone["state"].items()
                   if not torch.equal(v, grouped["state"][n])]
        diff = max((alone["state"][n].float()
                    - grouped["state"][n].float()).abs().max().item()
                   for n in unequal) if unequal else 0.0
        out.update(
            world=dist.world(), backend="nccl",
            losses_no_group=alone["losses"], losses_group=grouped["losses"],
            launches_per_step=grouped["launches"],
            launches_per_step_no_group=alone["launches"],
            grad_syncs=grouped["grad_syncs"],
            grad_syncs_no_group=alone["grad_syncs"],
            leaves=len(alone["state"]), unequal_leaves=unequal[:10],
            max_abs_diff=diff,
            ms_each_timed_no_group=alone["ms_each_timed"],
            ms_each_timed_group=grouped["ms_each_timed"],
            sync_grads_ms=grouped["sync_ms"],
            sync_grads_frozen_encoder_ms=grouped["sync_frozen_ms"])
    else:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("gloo", init_method="env://")
        mine = _ddp_steps(*narrow)
        if dist.rank() == 0:
            torch.save({k: v.cpu() for k, v in mine["state"].items()},
                       os.path.join(out_dir, "narrow_world2.pt"))
        big = _ddp_steps(*large)
        out.update(world=dist.world(), backend="gloo",
                   narrow_losses=mine["losses"], losses=big["losses"],
                   launches_per_step=big["launches"],
                   grad_syncs=big["grad_syncs"],
                   ms_each_timed=big["ms_each_timed"],
                   sync_grads_ms=big["sync_ms"],
                   sync_grads_frozen_encoder_ms=big["sync_frozen_ms"])
    print(json.dumps(out), flush=True)
    if dist.active():
        torch.distributed.destroy_process_group()


def phase_ddp(smi):
    """Data-parallel training on the one card. World 1 over NCCL (a process
    started as torchrun starts one): 3 steps of DFormer-Large + ham (bf16,
    bs8, 480x640, weights from seed 0) equal bit for bit the same steps
    with no process group, with 39 + 39 kernel launches and one gradient
    all-reduce per step. World 2 over gloo on the card (NCCL refuses two
    ranks on one device), 2 x bs4 against world 1 x bs8: a narrow fp32
    model's every leaf within DDP_STATE_REL, and the Large bf16 losses'
    differences printed. Returns {run: (forward, backward) launches}."""
    import shutil
    import tempfile

    import torch

    per_step = sum(n for *_, n in mlp_shapes())
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    tmp = tempfile.mkdtemp(prefix="dformer_ddp_")
    try:
        t0 = time.perf_counter()
        one = run_workers(f"import chip_smoke as c; c.ddp_worker('nccl', "
                          f"{tmp!r})", 1, env)
        t1 = time.perf_counter()
        two = run_workers(f"import chip_smoke as c; c.ddp_worker('gloo', "
                          f"{tmp!r})", 2, env)
        t2 = time.perf_counter()
        ref = torch.load(os.path.join(tmp, "narrow_world1.pt"))
        got = torch.load(os.path.join(tmp, "narrow_world2.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst, worst_name = 0.0, None
    for name, want in ref.items():
        if not want.dtype.is_floating_point:
            check(torch.equal(got[name], want), f"gloo narrow {name}")
            continue
        scale = max(want.abs().max().item(), DDP_STATE_FLOOR)
        err = (got[name] - want).abs().max().item() / scale
        if err > worst:
            worst, worst_name = err, name
    loss_diff = [abs(a - b) for a, b in zip(two["losses"],
                                            one["losses_no_group"])]
    emit({"phase": "ddp", "model": "DFormer-Large+LightHamHead",
          "batch": BATCH, "hw": list(HW), "dtype": "bfloat16",
          "steps": DDP_STEPS,
          "nccl_world1": {k: one[k] for k in (
              "world", "losses_group", "losses_no_group", "leaves",
              "unequal_leaves", "max_abs_diff", "launches_per_step",
              "grad_syncs", "grad_syncs_no_group")},
          "nccl_world1_ms_per_step": statistics.median(
              one["ms_each_timed_group"]),
          "no_group_ms_per_step": statistics.median(
              one["ms_each_timed_no_group"]),
          "nccl_world1_ms_each_timed": one["ms_each_timed_group"],
          "no_group_ms_each_timed": one["ms_each_timed_no_group"],
          "nccl_world1_sync_grads_ms": one["sync_grads_ms"],
          "nccl_world1_sync_grads_frozen_encoder_ms":
              one["sync_grads_frozen_encoder_ms"],
          "gloo_world2": {"losses": two["losses"],
                          "loss_abs_diff_vs_world1": loss_diff,
                          "launches_per_step_per_rank":
                              two["launches_per_step"],
                          "grad_syncs": two["grad_syncs"],
                          "ms_per_step": statistics.median(
                              two["ms_each_timed"]),
                          "ms_each_timed": two["ms_each_timed"],
                          "sync_grads_ms": two["sync_grads_ms"],
                          "sync_grads_frozen_encoder_ms":
                              two["sync_grads_frozen_encoder_ms"]},
          "gloo_narrow_fp32": {"batch": BATCH, "hw": list(DDP_NARROW_HW),
                               "losses_world2": two["narrow_losses"],
                               "losses_world1": one["narrow_world1_losses"],
                               "max_state_rel": worst,
                               "max_state_rel_leaf": worst_name,
                               "limit_state_rel": DDP_STATE_REL,
                               "state_floor": DDP_STATE_FLOOR},
          "seconds_nccl": t1 - t0, "seconds_gloo": t2 - t1, "card": smi})
    check(one["world"] == 1 and two["world"] == 2, "world sizes")
    check(not one["unequal_leaves"], f"NCCL world 1 against no group: "
          f"{one['unequal_leaves']} differ by up to {one['max_abs_diff']}")
    check(one["losses_group"] == one["losses_no_group"],
          f"NCCL world 1 losses {one['losses_group']} against "
          f"{one['losses_no_group']}")
    check(one["grad_syncs"] == DDP_STEPS
          and one["grad_syncs_no_group"] == 0 and
          two["grad_syncs"] == DDP_STEPS,
          f"gradient syncs: {one['grad_syncs']} (NCCL), "
          f"{one['grad_syncs_no_group']} (no group), {two['grad_syncs']} "
          f"(gloo) in {DDP_STEPS} steps")
    for name, rows in (("nccl", one["launches_per_step"]),
                       ("no group", one["launches_per_step_no_group"]),
                       ("gloo", two["launches_per_step"])):
        check(all(r == [per_step, per_step] for r in rows),
              f"{name}: launches per step {rows}, expected {per_step} + "
              f"{per_step}")
    check(worst <= DDP_STATE_REL, f"gloo world 2 narrow fp32 state: "
          f"{worst_name} {worst} > {DDP_STATE_REL}")
    check(all(np.isfinite(two["losses"])), f"gloo losses {two['losses']}")
    def total(rows):
        return [sum(r[0] for r in rows), sum(r[1] for r in rows)]

    return {"nccl_world1": total(one["launches_per_step"]),
            "no_group": total(one["launches_per_step_no_group"]),
            "gloo_world2_rank0": total(two["launches_per_step"])}


def export_worker(path, tmp):
    """The fresh process of phase_export: load the artifact (no model
    code) and serve it as the eval tool does (`Evaluator.from_exported`,
    which moves the program to the process's card), run it at B=1 and
    B=BATCH on the saved inputs counting the forward kernel's launches per
    call, save the logits, time a bs8 forward. Prints one JSON line."""
    import torch

    from dformer_torch.configs import load_config
    from dformer_torch.eval.evaluate import Evaluator
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.runtime.export import load_exported

    t0 = time.perf_counter()
    cfg = load_config("local_configs.NYUDepthv2.DFormer_Large")
    module = Evaluator.from_exported(load_exported(path), cfg,
                                     device="cuda")._forward
    load_s = time.perf_counter() - t0
    inputs = torch.load(os.path.join(tmp, "inputs.pt"))
    rgb, depth = inputs["rgb"].cuda(), inputs["depth"].cuda()
    launches = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            fused_mlp.launches = 0
            logits = module(rgb[:b], depth[:b])
            torch.cuda.synchronize()
            launches[b] = fused_mlp.launches
            torch.save(logits.cpu(), os.path.join(tmp, f"logits_{b}.pt"))
        ms = time_ms(lambda: module(rgb, depth), reps=10, warmup=3, calls=1)
    print(json.dumps({"load_s": load_s, "launches_per_call": launches,
                      "ms_per_forward": ms}), flush=True)


def phase_export(smi):
    """The serving artifact: DFormer-Large + ham (bf16, 480x640, weights
    from seed 0) exported with a symbolic batch into a temporary directory,
    loaded in a fresh process that runs it at B=1 and B=8: its labels equal
    entry.infer's on the same inputs, its logits within EXPORT_LOGITS_REL
    of the eager model's, and 39 forward-kernel launches per call (the
    kernel op, not the plain version, is in the program). Returns
    {B: launches per call}."""
    import shutil
    import tempfile

    import torch

    from dformer_torch import entry
    from dformer_torch.runtime.export import export_forward, save_exported

    per_forward = sum(n for *_, n in mlp_shapes())
    model = entry.build("DFormer-Large", HW, NUM_CLASSES, torch.bfloat16,
                        "cuda", seed=0)
    rng = np.random.RandomState(7)
    rgb, depth = (torch.from_numpy(rng.rand(BATCH, *HW, 3).astype(
        np.float32)).cuda() for _ in range(2))
    tmp = tempfile.mkdtemp(prefix="dformer_export_")
    try:
        path = os.path.join(tmp, "dformer_large_ham.pt2")
        t0 = time.perf_counter()
        program = export_forward(model, HW)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        save_exported(program, path)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        torch.save({"rgb": rgb.cpu(), "depth": depth.cpu()},
                   os.path.join(tmp, "inputs.pt"))
        want, labels = {}, {}
        module = program.module()
        with torch.inference_mode():
            for b in (1, BATCH):
                want[b] = model(rgb[:b], depth[:b]).cpu()
                labels[b] = entry.infer(model, rgb[:b], depth[:b]).cpu()
            # eager and the program in this process, in turns
            turns = [(name, time_ms(lambda: fn(rgb, depth), reps=10,
                                    warmup=3, calls=1))
                     for name, fn in (("eager", model), ("exported", module),
                                      ("exported", module),
                                      ("eager", model))]
        del model, module, program
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        child = run_workers(f"import chip_smoke as c; c.export_worker("
                            f"{path!r}, {tmp!r})", 1)
        child_s = time.perf_counter() - t0
        got = {b: torch.load(os.path.join(tmp, f"logits_{b}.pt"))
               for b in (1, BATCH)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = {}
    for b in (1, BATCH):
        check(tuple(got[b].shape) == (b, *HW, NUM_CLASSES),
              f"exported logits at B={b}: {tuple(got[b].shape)}")
        rel = ((got[b].float() - want[b].float()).abs().max()
               / want[b].float().abs().max()).item()
        same = torch.equal(got[b].argmax(-1).to(torch.int32), labels[b])
        rows[b] = {"logits_rel": rel, "bit_equal": torch.equal(got[b],
                                                                want[b]),
                   "labels_equal": same,
                   "launches": child["launches_per_call"][str(b)]}
    emit({"phase": "export", "model": "DFormer-Large+LightHamHead",
          "hw": list(HW), "dtype": "bfloat16", "batch": "symbolic 1..64",
          "artifact_bytes": nbytes, "export_s": export_s, "save_s": save_s,
          "load_s": child["load_s"], "child_process_s": child_s,
          "ms_per_forward_bs8": child["ms_per_forward"],
          "ms_per_forward_bs8_in_turns": turns, "by_batch": rows,
          "limit_logits_rel": EXPORT_LOGITS_REL, "card": smi})
    for b, row in rows.items():
        check(row["labels_equal"], f"exported labels at B={b} differ from "
              "entry.infer's")
        check(row["logits_rel"] <= EXPORT_LOGITS_REL,
              f"exported logits at B={b}: rel {row['logits_rel']}")
        check(row["launches"] == per_forward, f"B={b}: {row['launches']} "
              f"forward-kernel launches per call, expected {per_forward}")
    return {b: row["launches"] for b, row in rows.items()}


# the Trav data-parallel phase: FSS and supervised steps counted, compared
# bit for bit at NCCL world 1, then timed; the gloo world-2 narrow fp32
# state against world 1's as in the ddp phase. The k-fold, prediction-saving
# and rehearsal phases: their sizes.
TRAV_DDP_STEPS = 3
TRAV_DDP_TIMED = 3
# the untrained DFormerTrav-Base of `_trav_ddp_steps`, by (hw, dtype, body)
_TRAV_MODELS = {}
KFOLD_ROWS = 8
INFER_IMAGES = 4
REHEARSAL_IMAGES = 24


def _trav_ddp_steps(hw, dtype, narrow=False):
    """TRAV_DDP_STEPS FSS steps (`FSSTrainer`, global batch of the Trav
    config's 2 episodes of 5 shots + 1 query) then as many supervised
    steps (`train.loop.train_step` through `TravPrep`, global batch 2) of
    DFormerTrav-Base + ham from seed-made weights (`narrow`: the body cut
    to the narrow widths), on this rank's rows of seeded global batches,
    under deterministic algorithms; then TRAV_DDP_TIMED more of each,
    timed by CUDA events. Returns {"fss" / "sup": {"losses", "state" (on
    the card), "launches" per counted step, "ms_each_timed"},
    "grad_syncs" of the counted steps}."""
    import torch

    from dformer_torch import entry
    from dformer_torch.config import AttrDict
    from dformer_torch.configs import load_config
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.models.encoder import VARIANTS
    from dformer_torch.parallel import dist
    from dformer_torch.train.fss import (FSSTrainer, TravPrep,
                                         fss_trainable_mask)
    from dformer_torch.train.loop import train_step
    from dformer_torch.train.optim import make_optimizer, make_schedule

    base = VARIANTS["DFormer-Base"]
    if narrow:
        VARIANTS["DFormer-Base"] = {k: v for k, v in NARROW.items()}
    try:
        cfg = load_config(TRAV_CONFIG)
        cfg.update(image_height=hw[0], image_width=hw[1])
        B, n = cfg.batch_size, TRAV_DDP_STEPS + TRAV_DDP_TIMED

        def mine(batches):  # this rank's rows of each global batch
            return [{k: dist.rank_rows(v) for k, v in b.items()
                     if isinstance(v, np.ndarray)} for b in batches]

        episodes = mine(epoch_batches(MemoryEpisodes(B * n, hw, cfg.shots),
                                      B))
        rows = mine(epoch_batches(MemoryTrav(B * n, hw, seed=31), B))
        # the FSS and the supervised recipe draw the same model from the
        # seed (no pretrained file): drawn once per (size, body), copied
        key = (hw, dtype, narrow)
        if key not in _TRAV_MODELS:
            _TRAV_MODELS[key] = entry.build_training(
                AttrDict(cfg, pretrained_model=None), dtype, "cuda",
                cfg.seed)[0]
    finally:
        VARIANTS["DFormer-Base"] = base
    model = copy.deepcopy(_TRAV_MODELS[key])
    mask = fss_trainable_mask(model)
    fss = FSSTrainer(model, make_optimizer(cfg, model, mask),
                     make_schedule(cfg), cfg, mask, seed=cfg.seed)
    sup_model = copy.deepcopy(_TRAV_MODELS[key])
    sup = (sup_model, make_optimizer(cfg, sup_model), make_schedule(cfg))
    prep = TravPrep(cfg, cfg.seed, torch.device("cuda"))

    def fss_step(k):
        return fss.train_step(fss.prepare(episodes[k], 1, k))

    def sup_step(k):
        b = rows[k]
        (flips,) = prep.mirror_draws(1, k, len(b["rgb"]))
        rgb, laser, gt = prep(b["rgb"], b["laser"], b["gt"], flips)
        return train_step(sup[0], sup[1], sup[2], k, rgb, gt, laser,
                          prep.step_generator(k),
                          ignore_index=cfg.background)

    out, syncs = {}, dist.grad_syncs
    for name, step, m in (("fss", fss_step, model), ("sup", sup_step,
                                                     sup[0])):
        torch.use_deterministic_algorithms(True, warn_only=True)
        losses, launches = [], []
        for k in range(TRAV_DDP_STEPS):
            f0, b0 = fused_mlp.launches, fused_mlp.backward_launches
            losses.append(float(step(k)))
            launches.append([fused_mlp.launches - f0,
                             fused_mlp.backward_launches - b0])
        state = {n_: t.detach().clone() for n_, t in m.state_dict().items()}
        torch.use_deterministic_algorithms(False)
        times = []
        for k in range(TRAV_DDP_STEPS, n):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step(k)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = dict(losses=losses, state=state, launches=launches,
                         ms_each_timed=times)
    out["grad_syncs"] = dist.grad_syncs - syncs
    del model, fss, sup, sup_model
    torch.cuda.empty_cache()
    return out


def trav_ddp_worker(mode, out_dir):
    """One rank of phase_trav_ddp. "nccl" (world 1): the Base bf16 steps
    with no process group, the narrow fp32 steps (their states saved for
    the gloo run), then the group from torchrun's environment and the Base
    steps again, against the run without it. "gloo" (world 2 on the one
    card): the narrow fp32 and the Base bf16 steps on each rank's half of
    the global batches; rank 0 saves the narrow states. Prints one JSON
    line."""
    import torch
    import torch.distributed

    from dformer_torch.parallel import dist

    base = (HW, torch.bfloat16)
    narrow = (DDP_NARROW_HW, torch.float32, True)
    out = {"mode": mode}
    if mode == "nccl":
        alone = _trav_ddp_steps(*base)
        ref = _trav_ddp_steps(*narrow)
        torch.save({k: {n: v.cpu() for n, v in ref[k]["state"].items()}
                    for k in ("fss", "sup")},
                   os.path.join(out_dir, "trav_narrow_world1.pt"))
        out["narrow_world1_losses"] = {k: ref[k]["losses"]
                                       for k in ("fss", "sup")}
        check(dist.init_from_env("cuda"), "no process group from the "
              "environment")
        grouped = _trav_ddp_steps(*base)
        for k in ("fss", "sup"):
            unequal = [n for n, v in alone[k]["state"].items()
                       if not torch.equal(v, grouped[k]["state"][n])]
            out[k] = dict(
                losses_no_group=alone[k]["losses"],
                losses_group=grouped[k]["losses"],
                launches_per_step=grouped[k]["launches"],
                launches_per_step_no_group=alone[k]["launches"],
                leaves=len(alone[k]["state"]), unequal_leaves=unequal[:10],
                ms_each_timed_no_group=alone[k]["ms_each_timed"],
                ms_each_timed_group=grouped[k]["ms_each_timed"])
        out.update(world=dist.world(), grad_syncs=grouped["grad_syncs"],
                   grad_syncs_no_group=alone["grad_syncs"])
    else:
        torch.cuda.set_device(0)
        torch.distributed.init_process_group("gloo", init_method="env://")
        mine = _trav_ddp_steps(*narrow)
        if dist.rank() == 0:
            torch.save({k: {n: v.cpu() for n, v in mine[k]["state"].items()}
                        for k in ("fss", "sup")},
                       os.path.join(out_dir, "trav_narrow_world2.pt"))
        big = _trav_ddp_steps(*base)
        out.update(world=dist.world(), grad_syncs=big["grad_syncs"],
                   narrow_losses={k: mine[k]["losses"]
                                  for k in ("fss", "sup")},
                   **{k: dict(losses=big[k]["losses"],
                              launches_per_step=big[k]["launches"],
                              ms_each_timed=big[k]["ms_each_timed"])
                      for k in ("fss", "sup")})
    print(json.dumps(out), flush=True)
    if dist.active():
        torch.distributed.destroy_process_group()


def phase_trav_ddp(smi):
    """Trav data-parallel training on the one card. World 1 over NCCL:
    TRAV_DDP_STEPS FSS steps and as many supervised steps of
    DFormerTrav-Base + ham at the Trav config's widths and batch (bf16,
    480x640) equal bit for bit the same steps with no process group, with
    39 + 39 launches and one gradient all-reduce per step. World 2 over
    gloo on the card (one episode and one row per rank): a narrow fp32
    model's every leaf within DDP_STATE_REL of world 1's, the Base losses'
    differences printed. ms per step of each. Returns {run: (forward,
    backward) launches of the counted steps}."""
    import shutil
    import tempfile

    import torch

    per_step = sum(n for *_, n in mlp_shapes("DFormer-Base"))
    env = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8"}
    tmp = tempfile.mkdtemp(prefix="dformer_trav_ddp_")
    try:
        t0 = time.perf_counter()
        one = run_workers(f"import chip_smoke as c; c.trav_ddp_worker("
                          f"'nccl', {tmp!r})", 1, env)
        t1 = time.perf_counter()
        two = run_workers(f"import chip_smoke as c; c.trav_ddp_worker("
                          f"'gloo', {tmp!r})", 2, env)
        t2 = time.perf_counter()
        ref = torch.load(os.path.join(tmp, "trav_narrow_world1.pt"))
        got = torch.load(os.path.join(tmp, "trav_narrow_world2.pt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst = {}
    for k in ("fss", "sup"):
        worst[k] = (0.0, None)
        for name, want in ref[k].items():
            if not want.dtype.is_floating_point:
                check(torch.equal(got[k][name], want),
                      f"trav gloo narrow {k} {name}")
                continue
            scale = max(want.abs().max().item(), DDP_STATE_FLOOR)
            err = (got[k][name] - want).abs().max().item() / scale
            if err > worst[k][0]:
                worst[k] = (err, name)
    record = {"phase": "trav_ddp", "model": "DFormerTrav-Base+LightHamHead",
              "config": TRAV_CONFIG, "hw": list(HW), "dtype": "bfloat16",
              "fss_episodes": 2, "supervised_batch": 2,
              "steps": TRAV_DDP_STEPS, "world": one["world"],
              "grad_syncs": one["grad_syncs"],
              "grad_syncs_no_group": one["grad_syncs_no_group"],
              "gloo_grad_syncs": two["grad_syncs"],
              "seconds_nccl": t1 - t0, "seconds_gloo": t2 - t1, "card": smi}
    for k in ("fss", "sup"):
        o, w = one[k], two[k]
        record[k] = {
            "nccl_world1": {x: o[x] for x in (
                "losses_group", "losses_no_group", "leaves",
                "unequal_leaves", "launches_per_step")},
            "nccl_world1_ms_per_step": statistics.median(
                o["ms_each_timed_group"]),
            "no_group_ms_per_step": statistics.median(
                o["ms_each_timed_no_group"]),
            "nccl_world1_ms_each_timed": o["ms_each_timed_group"],
            "no_group_ms_each_timed": o["ms_each_timed_no_group"],
            "gloo_world2": {
                "losses": w["losses"],
                "loss_abs_diff_vs_world1": [
                    abs(a - b) for a, b in zip(w["losses"],
                                               o["losses_no_group"])],
                "launches_per_step_per_rank": w["launches_per_step"],
                "ms_per_step": statistics.median(w["ms_each_timed"]),
                "ms_each_timed": w["ms_each_timed"]},
            "gloo_narrow_fp32": {
                "hw": list(DDP_NARROW_HW),
                "losses_world2": two["narrow_losses"][k],
                "losses_world1": one["narrow_world1_losses"][k],
                "max_state_rel": worst[k][0],
                "max_state_rel_leaf": worst[k][1],
                "limit_state_rel": DDP_STATE_REL,
                "state_floor": DDP_STATE_FLOOR}}
    emit(record)
    check(one["world"] == 1 and two["world"] == 2, "trav_ddp world sizes")
    # one per step: counted and timed, FSS and supervised
    want_syncs = 2 * (TRAV_DDP_STEPS + TRAV_DDP_TIMED)
    check(one["grad_syncs"] == two["grad_syncs"] == want_syncs
          and one["grad_syncs_no_group"] == 0,
          f"trav_ddp gradient syncs: {one['grad_syncs']} (NCCL), "
          f"{two['grad_syncs']} (gloo), {one['grad_syncs_no_group']} (no "
          f"group); expected {want_syncs}")
    launches = {}
    for k in ("fss", "sup"):
        o = one[k]
        check(not o["unequal_leaves"], f"trav_ddp {k}: NCCL world 1 "
              f"against no group: {o['unequal_leaves']} differ")
        check(o["losses_group"] == o["losses_no_group"],
              f"trav_ddp {k}: NCCL world 1 losses {o['losses_group']} "
              f"against {o['losses_no_group']}")
        for name, rows in (("nccl", o["launches_per_step"]),
                           ("no group", o["launches_per_step_no_group"]),
                           ("gloo", two[k]["launches_per_step"])):
            check(all(r == [per_step, per_step] for r in rows),
                  f"trav_ddp {k} {name}: launches per step {rows}, "
                  f"expected {per_step} + {per_step}")
        check(worst[k][0] <= DDP_STATE_REL, f"trav_ddp {k}: gloo world 2 "
              f"narrow fp32 state {worst[k][1]} {worst[k][0]} > "
              f"{DDP_STATE_REL}")
        check(all(np.isfinite(two[k]["losses"])),
              f"trav_ddp {k}: gloo losses {two[k]['losses']}")
        for run, rows in (("nccl_world1", o["launches_per_step"]),
                          ("gloo_world2_rank0",
                           two[k]["launches_per_step"])):
            launches[f"{k}_{run}"] = [sum(r[0] for r in rows),
                                      sum(r[1] for r in rows)]
    return launches


def phase_kfold(smi):
    """The Trav k-fold tool: `tools.train_trav_kfold.run` on the Trav
    config (DFormerTrav-Base + ham, 480x640, bf16, batch 2) over
    KFOLD_ROWS in-memory rows, 2 folds of one epoch (2 steps each), each
    fold evaluated on its 4 rows. Returns the (forward, backward)
    launches of the run."""
    import tempfile

    import torch

    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import train_trav_kfold

    per_pass = sum(n for *_, n in mlp_shapes("DFormer-Base"))
    folds = 2
    with tempfile.TemporaryDirectory() as root:
        cfg = trav_cfg(root, "kfold")
        hw, B = (cfg.image_height, cfg.image_width), cfg.batch_size
        fused_mlp.launches = fused_mlp.backward_launches = 0
        t0 = time.perf_counter()
        out = train_trav_kfold.run(cfg, train_trav_kfold.parse_args(
            [f"--folds={folds}", "--epochs=1"]),
            rows=MemoryTrav(KFOLD_ROWS, hw, seed=24))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    launches = (fused_mlp.launches, fused_mlp.backward_launches)
    val = KFOLD_ROWS // folds
    steps = (KFOLD_ROWS - val) // B
    emit({"phase": "kfold", "model": "DFormerTrav-Base+LightHamHead",
          "config": TRAV_CONFIG, "rows": KFOLD_ROWS, "folds": folds,
          "epochs": 1, "batch": B, "steps_per_fold": steps,
          "val_images_per_fold": val, "hw": list(hw), "dtype": "bfloat16",
          "fold_mious": out["fold_mious"], "mean_miou": out["mean_miou"],
          "losses": out["losses"], "fold_seconds": out["fold_seconds"],
          "s_per_fold": statistics.median(out["fold_seconds"].values()),
          "run_s": run_s,
          "launches": {"forward": launches[0], "backward": launches[1]},
          "card": smi})
    check(len(out["fold_mious"]) == folds
          and all(np.isfinite(m) for m in out["fold_mious"]),
          f"kfold: fold mIoUs {out['fold_mious']}")
    check(all(np.isfinite(out["losses"][f][1]) for f in range(folds)),
          f"kfold: losses {out['losses']}")
    check(launches == (folds * (steps + val) * per_pass,
                       folds * steps * per_pass),
          f"kfold: {launches} forward and backward launches, expected "
          f"{per_pass} per step and per forward")
    return launches


def phase_infer(smi):
    """Prediction saving: `tools.eval --save_path` at single scale and
    `tools.infer` (MSF + flip), bf16, on INFER_IMAGES synthetic NYUDepthv2
    images of DFormer-Large + ham (seed-0 weights) in one group: every
    PNG's labels equal the Evaluator's on the same model and images, the
    hists too, 39 forward-kernel launches per forward; then
    `tools.infer_trav` on INFER_IMAGES in-memory Trav rows: each PNG's
    labels equal `entry.build_trav`'s argmax. Returns {run: forward
    launches}."""
    import tempfile

    import torch

    from dformer_torch import configs, entry
    from dformer_torch.eval.visualize import (labels_from_png, palette_for,
                                              pred_png_name)
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import eval as eval_tool
    from dformer_torch.tools import infer, infer_trav
    from dformer_torch.train.fss import TravPrep

    leaf = "local_configs.NYUDepthv2.DFormer_Large"
    cut = f"{leaf}:{INFER_IMAGES}"

    def cut_cfg():
        cfg = configs.load_config(leaf)
        cfg.num_eval_imgs = INFER_IMAGES
        return cfg

    configs.LEAVES[cut] = cut_cfg
    per_forward = sum(n for *_, n in mlp_shapes())
    flags = [f"--config={cut}", "--synthetic-data", "--amp",
             f"--val_batch_size={INFER_IMAGES}"]
    runs, launches = {}, {}
    with tempfile.TemporaryDirectory() as root:
        for mode, tool, argv, forwards in (
                ("single", eval_tool, ["--no-mst"], 1),
                ("msf_flip", infer, [], 2 * len(eval_tool.MSF_SCALES))):
            save = os.path.join(root, mode)
            torch.cuda.synchronize()
            fused_mlp.launches = 0
            t0 = time.perf_counter()
            m = tool.main(flags + argv + [f"--save_path={save}"])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches[mode] = fused_mlp.launches
            # the Evaluator's labels on the same model and images
            cfg = cut_cfg()
            ev, batches = entry.build_evaluator(
                cfg, torch.bfloat16, "cuda", synthetic=True,
                val_batch_size=INFER_IMAGES)
            seen = {}

            def hook(preds, batch):
                seen.update(zip(batch["fn"], preds))

            t0 = time.perf_counter()
            if mode == "single":
                ref = ev.evaluate(batches, save_hook=hook)
            else:
                ref = ev.evaluate_msf(batches, eval_tool.MSF_SCALES,
                                      flip=cfg.eval_flip, save_hook=hook)
            torch.cuda.synchronize()
            eval_s = time.perf_counter() - t0
            palette = palette_for(cfg)
            differ = sum(int((labels_from_png(os.path.join(
                save, pred_png_name(fn)), palette) != pred).sum())
                for fn, pred in seen.items())
            runs[mode] = {"seconds": seconds,
                          "ms_per_image_with_saving": seconds * 1e3
                          / INFER_IMAGES,
                          "evaluator_ms_per_image": eval_s * 1e3
                          / INFER_IMAGES,
                          "pngs": len(seen), "pixels_differing": differ,
                          "hist_equal": bool(np.array_equal(m.hist,
                                                            ref.hist)),
                          "fused_mlp_launches": launches[mode]}
            check(len(seen) == INFER_IMAGES and differ == 0
                  and runs[mode]["hist_equal"],
                  f"infer {mode}: {runs[mode]}")
            check(launches[mode] == forwards * per_forward,
                  f"infer {mode}: {launches[mode]} launches, expected "
                  f"{forwards * per_forward}")
            del ev

        # Trav predictions over in-memory rows
        cfg = trav_cfg(root, "infer_trav")
        hw = (cfg.image_height, cfg.image_width)
        rows = MemoryTrav(INFER_IMAGES, hw, seed=25, labelled=False)
        per_pass = sum(n for *_, n in mlp_shapes("DFormer-Base"))
        fused_mlp.launches = 0
        out = infer_trav.run(cfg, infer_trav.parse_args(
            [f"--save_path={root}/trav"]), dataset=rows)
        launches["infer_trav"] = fused_mlp.launches
        model = entry.build_trav(cfg, torch.bfloat16, "cuda", 0)
        prep = TravPrep(cfg, 0, torch.device("cuda"))
        palette = palette_for(cfg)
        differ = 0
        with torch.inference_mode():
            for path, i in zip(out["paths"], range(INFER_IMAGES)):
                item = rows[i]
                rgb, laser = prep(item["rgb"][None], item["laser"][None])
                want = torch.argmax(model(rgb, laser), dim=-1)[0]
                differ += int((labels_from_png(path, palette)
                               != want.cpu().numpy()).sum())
        runs["infer_trav"] = {"seconds": out["seconds"],
                              "ms_per_image_with_saving": out["seconds"]
                              * 1e3 / INFER_IMAGES,
                              "pngs": len(out["paths"]),
                              "pixels_differing": differ,
                              "fused_mlp_launches": launches["infer_trav"]}
        del model, out
    del configs.LEAVES[cut]
    emit({"phase": "infer", "model": "DFormer-Large+LightHamHead",
          "trav_model": "DFormerTrav-Base+LightHamHead",
          "images": INFER_IMAGES, "hw": list(HW), "dtype": "bfloat16",
          "runs": runs, "card": smi})
    check(runs["infer_trav"]["pngs"] == INFER_IMAGES and differ == 0,
          f"infer_trav: {runs['infer_trav']}")
    check(launches["infer_trav"] == INFER_IMAGES * per_pass,
          f"infer_trav: {launches['infer_trav']} launches, expected "
          f"{INFER_IMAGES * per_pass}")
    return launches


def phase_rehearsal(smi):
    """`tools.sunrgbd_eval_rehearsal.run` on the SUNRGBD DFormer-Small
    config (bf16, seed-0 weights) at REHEARSAL_IMAGES images of the sensor
    mix in loader batches of 4, MSF + flip, two passes: the hist exact
    (checked by the tool), the forward kernel at DFormer-Small's launches
    per forward, the img/s of the second pass and the pad overhead.
    Returns the forward launches."""
    from dformer_torch.configs import load_config
    from dformer_torch.kernels.fused_mlp import fused_mlp
    from dformer_torch.tools import sunrgbd_eval_rehearsal as rehearsal

    config = "local_configs.SUNRGBD.DFormer_Small"
    args = rehearsal.parse_args([f"--config={config}",
                                 f"--images={REHEARSAL_IMAGES}"])
    per_forward = sum(n for *_, n in mlp_shapes("DFormer-Small"))
    fused_mlp.launches = 0
    t0 = time.perf_counter()
    rec = rehearsal.run(load_config(config), args)
    seconds = time.perf_counter() - t0
    launches = fused_mlp.launches
    forwards = 2 * sum(rec["groups"].values()) * 2 * len(args.scales)
    emit({"phase": "rehearsal", **rec, "fused_mlp_launches": launches,
          "forwards": forwards, "seconds": seconds, "card": smi})
    check(rec["hist_exact"] and np.isfinite(rec["steady_img_per_s"]),
          f"rehearsal: {rec}")
    check(launches == forwards * per_forward,
          f"rehearsal: {launches} launches in {forwards} forwards, expected "
          f"{per_forward} per forward")
    return launches



def kernel_summary(rows, rows_bwd, launches, train_launches, eval_rows,
                   fit_launches, trav_rows, trav_launches, fss_launches,
                   decoder_launches, decoders_fit_launches, convergence_launches,
                   tool_launches, ddp_launches, export_launches,
                   trav_ddp_launches, kfold_launches, infer_launches,
                   rehearsal_launches):
    """One entry per kernel: times per forward or per train step (each
    shape's time times its launches, summed over the main-path shapes).
    `launches` are those of the serving path's run for the forward kernel
    (its launches in the train steps, in each timed eval run, in the train
    tool's first run and on the Trav paths beside them) and of the train
    path's counted steps for the backward kernel (its launches in the train
    tool's first run and on the Trav paths beside them); a
    backward call is four CUDA launches (K1-K4), whose times per step are
    listed, with torch.matmul of K3's two products beside K3; beside the
    forward, torch.matmul of its two products. The `trav_*` keys are the
    same sums over the 8 shapes of an FSS step's encoder pass (B 12). The
    `*_decoders*` keys are the launches of the decoder phases: per forward
    and per step for each head, and in the UPernet train tool's run;
    `launches_in_convergence` and `launches_in_tools` those of the
    convergence and tools phases; `launches_in_ddp` the counted steps of
    each run of the ddp phase (rank 0's for world 2) and
    `launches_per_call_in_export` the exported program's per call, by
    batch; `launches_in_trav_ddp` the counted FSS and supervised steps of
    each run of the trav_ddp phase (rank 0's for world 2),
    `launches_in_kfold` the k-fold tool's run, `launches_in_infer` each
    prediction-saving run and `launches_in_rehearsal` the rehearsal's two
    passes."""
    from dformer_torch.kernels.fused_mlp import (REPLACES, REPLACES_BWD,
                                                 SOURCE, SOURCE_BWD)

    def total(rows, per, key, sub=None):
        return sum((r[key] if sub is None else r[key][sub]) * r[per]
                   for r in rows if r[per])

    def entry_of(name, source, replaces, rows, per, n_launches, extra):
        main = [r for r in rows if r[per]]
        ops, nbytes = total(rows, per, "ops_ms"), total(rows, per, "bytes_ms")
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launches,
                "max_abs_err": max(r["max_abs_err"] for r in main),
                "ms": total(rows, per, "ms"),
                "plain_ms": total(rows, per, "plain_ms"),
                "bound_ms": max(ops, nbytes),
                "bound_by": "operations" if ops >= nbytes else "bytes",
                "library_ms": None, **extra}

    def trav(rows, per, yardstick):
        ops, nbytes = total(rows, per, "ops_ms"), total(rows, per, "bytes_ms")
        return {"trav_ms_per_fss_step": total(rows, per, "ms"),
                "trav_plain_ms_per_fss_step": total(rows, per, "plain_ms"),
                "trav_bound_ms_per_fss_step": max(ops, nbytes),
                "trav_bound_by": "operations" if ops >= nbytes else "bytes",
                "trav_yardstick_ms_per_fss_step": total(rows, per, yardstick),
                "trav_max_abs_err": max(r["max_abs_err"] for r in rows),
                "trav_launches_per_fss_step": sum(r[per] for r in rows)}

    per = "launches_per_step"
    stages = {k: total(rows_bwd, per, "stage_ms", k)
              for k in rows_bwd[0]["stage_ms"]}
    return {"kernels": [
        entry_of("fused_mlp_fwd", SOURCE, REPLACES, rows,
                 "launches_per_forward", launches,
                 {"launches_in_train_steps": train_launches[0],
                  "launches_in_fit": fit_launches[0],
                  "launches_in_eval": {r["mode"]: r["fused_mlp_launches"]
                                       for r in eval_rows},
                  "launches_in_trav": {k: v[0]
                                       for k, v in trav_launches.items()},
                  "launches_in_fss": {k: v[0]
                                      for k, v in fss_launches.items()},
                  "launches_per_forward_in_decoders": {
                      k: v[0] for k, v in decoder_launches.items()},
                  "launches_per_step_in_decoders": {
                      k: v[1][0] for k, v in decoder_launches.items()},
                  "launches_in_decoders_fit": decoders_fit_launches[0],
                  "launches_in_convergence": {
                      k: v[0] for k, v in convergence_launches.items()},
                  "launches_in_tools": {k: v[0]
                                        for k, v in tool_launches.items()},
                  "launches_in_ddp": {k: v[0]
                                      for k, v in ddp_launches.items()},
                  "launches_per_call_in_export": export_launches,
                  "launches_in_trav_ddp": {
                      k: v[0] for k, v in trav_ddp_launches.items()},
                  "launches_in_kfold": kfold_launches[0],
                  "launches_in_infer": infer_launches,
                  "launches_in_rehearsal": rehearsal_launches,
                  "products_library_ms": total(rows, "launches_per_forward",
                                               "products_library_ms"),
                  **trav(trav_rows[0], "launches_per_forward",
                         "products_library_ms")}),
        entry_of("fused_mlp_bwd", SOURCE_BWD, REPLACES_BWD, rows_bwd, per,
                 train_launches[1],
                 {"launches_in_fit": fit_launches[1],
                  "launches_in_trav": {k: v[1]
                                       for k, v in trav_launches.items()},
                  "launches_in_fss": {k: v[1]
                                      for k, v in fss_launches.items()},
                  "launches_per_step_in_decoders": {
                      k: v[1][1] for k, v in decoder_launches.items()},
                  "launches_in_decoders_fit": decoders_fit_launches[1],
                  "launches_in_convergence": {
                      k: v[1] for k, v in convergence_launches.items()},
                  "launches_in_tools": {k: v[1]
                                        for k, v in tool_launches.items()},
                  "launches_in_ddp": {k: v[1]
                                      for k, v in ddp_launches.items()},
                  "launches_in_trav_ddp": {
                      k: v[1] for k, v in trav_ddp_launches.items()},
                  "launches_in_kfold": kfold_launches[1],
                  "stage_ms": stages,
                  "wgrad_library_ms": total(rows_bwd, per,
                                            "wgrad_library_ms"),
                  **trav(trav_rows[1], per, "wgrad_library_ms")})]}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    import dformer_torch  # noqa: F401 - fail before any output without it

    smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)
    rows_bwd = phase_kernels_bwd(smi, kernel_cases() + variant_bwd_cases())
    model, launches = phase_slice(smi)
    phase_cpu_vs_card(model, smi)
    del model
    train_launches = phase_train(smi)
    phase_train_cpu_vs_card(smi)
    eval_rows = phase_eval(smi)
    phase_eval_cpu_vs_card(smi)
    fit_launches = phase_fit(smi)
    trav_rows = phase_trav_kernels(smi)
    trav_launches = phase_trav(smi)
    fss_launches = phase_fss(smi)
    phase_fss_cpu_vs_card(smi)
    decoder_launches = phase_decoders(smi)
    phase_decoders_cpu_vs_card(smi)
    decoders_fit_launches = phase_decoders_fit(smi)
    convergence_launches = phase_convergence(smi)
    tool_launches = phase_tools(smi)
    ddp_launches = phase_ddp(smi)
    export_launches = phase_export(smi)
    trav_ddp_launches = phase_trav_ddp(smi)
    kfold_launches = phase_kfold(smi)
    infer_launches = phase_infer(smi)
    rehearsal_launches = phase_rehearsal(smi)
    emit(kernel_summary(rows, rows_bwd, launches, train_launches, eval_rows,
                        fit_launches, trav_rows, trav_launches, fss_launches,
                        decoder_launches, decoders_fit_launches,
                        convergence_launches, tool_launches, ddp_launches,
                        export_launches, trav_ddp_launches, kfold_launches,
                        infer_launches, rehearsal_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
