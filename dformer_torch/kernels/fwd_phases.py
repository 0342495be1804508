"""Where the fused-MLP forward kernel spends its time, by phase, in bf16 and
in fp32.

Builds csrc/fused_mlp_fwd.cu with -DDFORMER_FWD_PHASES, in which every warp
of the main kernel adds the clock64 cycles it spends in each phase (staging:
issuing the copies of the halo tile and weights; fc1; dwconv + GELU; fc2;
barrier and copy waits; output) to a counter of the launch, and runs the
forward at DFormer-Large's stage-0 and stage-2 `mlp` shapes (bs8, 480x640).
The LayerNorm launch before the kernel is not counted. Prints one JSON line
per dtype and shape with each phase's share of the warps' cycles. The
counters cost a few instructions per phase, so the instrumented kernel runs
a little slower than the plain build, which is the one the port uses.

    python -m dformer_torch.kernels.fwd_phases
"""

import ctypes
import json

import torch

from dformer_torch.kernels import build
from dformer_torch.kernels import fused_mlp as fm

PHASES = ("staging", "fc1", "dwconv_gelu", "fc2", "waits", "output")
SHAPES = (("stage0.mlp", 8, 120, 160, 96, 768),
          ("stage2.mlp", 8, 30, 40, 288, 1152))
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}


def _inputs(B, H, W, C, Ch, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale + shift

    return (rnd(B, H, W, C).to(dtype), rnd(C, scale=0.1, shift=1.0),
            rnd(C, scale=0.1), rnd(Ch, C, scale=C ** -0.5).to(dtype).t(),
            rnd(Ch, scale=0.1), rnd(3, 3, Ch, scale=1 / 3).to(dtype),
            rnd(Ch, scale=0.1), rnd(C, Ch, scale=Ch ** -0.5).to(dtype).t(),
            rnd(C, scale=0.1))


def main(calls=5):
    if not torch.cuda.is_available():
        raise SystemExit("fwd_phases: needs a CUDA card")
    lib = build.library("fused_mlp_fwd", ("DFORMER_FWD_PHASES",))
    read = lib.dformer_fused_mlp_fwd_phases
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    plain, fm._bound = fm._kernel(), fm.bind_forward(lib)
    clk = (ctypes.c_ulonglong * len(PHASES))()
    try:
        for name, dtype in DTYPES.items():
            for i, (shape, B, H, W, C, Ch) in enumerate(SHAPES):
                args = _inputs(B, H, W, C, Ch, dtype, seed=i)
                plan = fm.card_forward_plan(B, H, W, C, Ch, dtype)
                fm.fused_mlp(*args)  # warm-up
                if read(clk) != 0:
                    raise RuntimeError("fwd_phases: reading the counters "
                                       "failed")
                for _ in range(calls):
                    fm.fused_mlp(*args)
                if read(clk) != 0:
                    raise RuntimeError("fwd_phases: reading the counters "
                                       "failed")
                total = sum(clk)
                print(json.dumps({
                    "phase": "fwd_phases", "dtype": name, "shape": shape,
                    "B": B, "H": H, "W": W, "C": C, "Ch": Ch, "calls": calls,
                    "plan": plan._asdict(),
                    "occupancy": fm.forward_occupancy(C, dtype,
                                                      plan.tile_cols),
                    "warp_cycles_per_call": total / calls,
                    "share": {p: c / total for p, c in zip(PHASES, clk)}}),
                    flush=True)
    finally:
        fm._bound = plain


if __name__ == "__main__":
    main()
