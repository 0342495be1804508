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
Then the kernel summary line, and last {"ok": true, "device": {...}}.
Any failure raises and exits non-zero; nothing is caught. Exits non-zero
before printing any result when CUDA is unavailable.
"""

import json
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


def emit(obj):
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


def mlp_shapes():
    """(name, H, W, C, Ch, launches per forward) of every fused-MLP call of
    DFormer-Large at 480x640: the main block mlp and the depth-stream mlp_e2
    of each stage (the last block of stage 4 has no mlp_e2)."""
    from dformer_torch.models.encoder import VARIANTS

    spec = VARIANTS["DFormer-Large"]
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


def phase_kernels(smi):
    """Every fused-MLP shape of the main path in bf16, plus one fp32 shape:
    kernel vs plain version, a second run on the same inputs (bit-equal),
    times and bound, the kernel's plan and occupancy, and torch.matmul of
    its two products over the B*H*W pixels (no halo) as their yardstick.
    Returns the per-shape rows."""
    import torch

    from dformer_torch.kernels.fused_mlp import (card_forward_plan,
                                                 forward_occupancy, fused_mlp,
                                                 fused_mlp_reference)

    rows, misses = [], []
    for i, (name, B, H, W, C, Ch, n, dtype) in enumerate(kernel_cases()):
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
        row = {"phase": "kernels", "kernel": "fused_mlp_fwd", "shape": name,
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


def phase_kernels_bwd(smi):
    """The backward kernel at the same shapes: all nine outputs against the
    plain backward, times and bound, and a second run on the same inputs
    (all nine outputs must be bit-equal). Each of the call's four launches
    timed by CUDA events, the blocks per SM of K1 and K3, and torch.matmul
    of the two weight-gradient products as K3's yardstick."""
    import torch

    from dformer_torch.kernels.fused_mlp import (
        backward_occupancy, backward_stage_ms, card_backward_plan,
        fused_mlp_backward, fused_mlp_backward_reference)

    rows, misses = [], []
    for i, (name, B, H, W, C, Ch, n, dtype) in enumerate(kernel_cases()):
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
        row = {"phase": "kernels", "kernel": "fused_mlp_bwd", "shape": name,
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
    worst, worst_name, skipped = 0.0, "", []
    for name, want in grads_cpu.items():
        scale = want.abs().max().item()
        if scale < TRAIN_NULL_GRAD:
            skipped.append(name)
            continue
        rel = (grads_card[name] - want).abs().max().item() / scale
        if rel > worst:
            worst, worst_name = rel, name
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


def kernel_summary(rows, rows_bwd, launches, train_launches):
    """One entry per kernel: times per forward or per train step (each
    shape's time times its launches, summed over the main-path shapes).
    `launches` are those of the serving path's run for the forward kernel
    and of the train path's counted steps for the backward kernel; a
    backward call is four CUDA launches (K1-K4), whose times per step are
    listed, with torch.matmul of K3's two products beside K3; beside the
    forward, torch.matmul of its two products."""
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

    per = "launches_per_step"
    stages = {k: total(rows_bwd, per, "stage_ms", k)
              for k in rows_bwd[0]["stage_ms"]}
    return {"kernels": [
        entry_of("fused_mlp_fwd", SOURCE, REPLACES, rows,
                 "launches_per_forward", launches,
                 {"launches_in_train_steps": train_launches[0],
                  "products_library_ms": total(rows, "launches_per_forward",
                                               "products_library_ms")}),
        entry_of("fused_mlp_bwd", SOURCE_BWD, REPLACES_BWD, rows_bwd, per,
                 train_launches[1],
                 {"stage_ms": stages,
                  "wgrad_library_ms": total(rows_bwd, per,
                                            "wgrad_library_ms")})]}


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    import dformer_torch  # noqa: F401 - fail before any output without it

    smi = phase_device()
    phase_build()
    rows = phase_kernels(smi)
    rows_bwd = phase_kernels_bwd(smi)
    model, launches = phase_slice(smi)
    phase_cpu_vs_card(model, smi)
    del model
    train_launches = phase_train(smi)
    phase_train_cpu_vs_card(smi)
    emit(kernel_summary(rows, rows_bwd, launches, train_launches))
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
