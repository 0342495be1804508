"""Fused DFormer MLP block: CUDA kernel wrappers and plain versions, forward
and backward.

    y   = LayerNorm(x)                      # fp32 stats, eps 1e-6
    h   = y @ fc1_w + fc1_b                 # [., C] -> [., Ch], fp32 accumulate
    h   = dwconv3x3(h, pos_w) + pos_b + h   # zero padding outside the image
    out = gelu(h) @ fc2_w + fc2_b           # fp32 accumulate

The plain versions and the fp32 kernels take the exact-erf GELU; the bf16
forward kernel takes the TPU kernel's clamped polynomial erf (within 7.7e-4
of it, under bf16 rounding).

`fused_mlp` is `FusedMLP.apply`, a `torch.autograd.Function`. For a CUDA
tensor (bf16 or fp32) its forward launches `csrc/fused_mlp_fwd.cu` and its
backward `csrc/fused_mlp_bwd.cu`, and either raises if it cannot; for a CPU
tensor they run `fused_mlp_reference` and `fused_mlp_backward_reference`.
The kernels replace the TPU kernels `_kernel` and `_bwd_kernel` of
`dformer_tpu/kernels/fused_mlp.py`; the source notes say what bounds them on
the card and how they are laid out. Only x and the eight parameters are
saved for the backward, which recomputes the hidden tensors.

One forward call is the kernel's launch, after one that writes
LayerNorm(x) in bf16 (bf16 only) and before one that adds the hidden
splits' fp32 partial sums in a fixed order when the plan `forward_plan`
splits the hidden chunks of a tile over blocks (small maps);
`fused_mlp.launches` counts calls.

Rounding points differ by design: the kernels keep the hidden tensors (h,
and in the backward dh) in fp32 and round only the matmul operands to the
I/O dtype (as the TPU kernels do), while the plain versions hold the hidden
tensors in the I/O dtype (as the JAX references do). In fp32 the two agree
to summation order.

One backward call is four CUDA launches (K1-K4 in the source note), cut
into blocks by the plan `backward_plan` computes here; the wrapper
allocates the scratch the plan sizes. Blocks write partial sums to slots of
their own and the last launch adds them in a fixed order, with no atomics,
so all nine gradients are bit-for-bit reproducible from run to run.
`fused_mlp.backward_launches` counts calls, not launches.
"""

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

SOURCE = "dformer_torch/kernels/csrc/fused_mlp_fwd.cu"
REPLACES = "dformer_tpu/kernels/fused_mlp.py:76"
SOURCE_BWD = "dformer_torch/kernels/csrc/fused_mlp_bwd.cu"
REPLACES_BWD = "dformer_tpu/kernels/fused_mlp.py:272"
MAX_C = 576

_bound = None
_bound_bwd = None


def _kernel():
    """The ctypes entry points of the built forward library (built on first
    use)."""
    global _bound
    if _bound is None:
        from dformer_torch.kernels.build import library

        _bound = bind_forward(library("fused_mlp_fwd"))
    return _bound


def bind_forward(lib):
    """The ctypes entry points of a forward library (`_kernel` binds the
    plain build; `kernels/fwd_phases.py` an instrumented one)."""
    fn = lib.dformer_fused_mlp_fwd
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 5
                   + [ctypes.c_float] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.dformer_fused_mlp_fwd_occupancy
    occ.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    err = lib.dformer_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, occ, err


def _kernel_bwd():
    """The ctypes entry points of the built backward library."""
    global _bound_bwd
    if _bound_bwd is None:
        from dformer_torch.kernels.build import library

        lib = library("fused_mlp_bwd")
        fn = lib.dformer_fused_mlp_bwd
        fn.argtypes = ([ctypes.c_void_p] * 27 + [ctypes.c_int] * 5
                       + [ctypes.c_float] + [ctypes.c_int] * 7
                       + [ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        occ = lib.dformer_fused_mlp_bwd_occupancy
        occ.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p]
        occ.restype = ctypes.c_int
        err = lib.dformer_cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _bound_bwd = (fn, occ, err)
    return _bound_bwd


class BackwardPlan(NamedTuple):
    """How one backward call is cut into blocks (see `backward_plan`).

    K1 (bwd_hidden) takes TH x 8 pixel tiles, `tile_rows` x TILE_W, over a
    grid of tiles_h x tiles_w per image, and splits the Ch / 32 hidden chunks
    of a tile over `nsplit` blocks of `chunks_per_split` chunks (the last
    may hold fewer). K2 (bwd_ln) takes `ln_pixels` consecutive pixels per
    block, `ln_blocks` blocks. K3 (bwd_wgrad) cuts the N = B*H*W pixels into
    `slices` slices of `slice_len` (a multiple of WGRAD_K; the last is
    ragged)."""
    tile_rows: int
    tiles_h: int
    tiles_w: int
    chunks_per_split: int
    nsplit: int
    ln_pixels: int
    ln_blocks: int
    slice_len: int
    slices: int


TILE_W = 8
HIDDEN_CHUNK = 32
WGRAD_TILE = (256, 96)   # K3 output tile: hidden rows x channels
WGRAD_K = 32             # K3 pixels per stage
K1_PROLOGUE_CHUNKS = 2   # a K1 block's halo staging and LayerNorm cost
                         # about two hidden chunks (measured on the card)
FWD_PROLOGUE_CHUNKS = 1  # a forward block's staging of its halo tile and
                         # first weights, taken as one chunk (not measured)
LN_BLOCKS_PER_SM = 4
K3_BLOCKS_PER_SM = 2
K3_MIN_SLICE = 512


def _cdiv(a, b):
    return -(-a // b)


def _chunks_per_split(tiles, nchunks, slots, prologue):
    """Hidden chunks per block of a kernel that walks a tile's hidden chunks
    after a prologue costing `prologue` chunks. Of the counts that give at
    least `slots` blocks (every SM busy; all counts if none does), the one
    that minimises the modelled time: rounds of `slots` concurrent blocks,
    each costing its chunks and its prologue; on a tie, the fewer blocks."""
    def cost(cps):
        return (_cdiv(tiles * _cdiv(nchunks, cps), slots)
                * (prologue + cps))
    fill = [c for c in range(nchunks, 0, -1)
            if tiles * _cdiv(nchunks, c) >= slots]
    return min(fill or range(nchunks, 0, -1), key=cost)


def backward_plan(B, H, W, C, Ch, tile_rows, k1_blocks_per_sm,
                  sms) -> BackwardPlan:
    """The launch plan of one backward call at this shape, for K1 at
    `tile_rows` rows per tile and `k1_blocks_per_sm`, on a card of `sms`
    SMs (`card_backward_plan` takes all three from the built kernel and the
    card). Small maps split K1's hidden chunks over blocks
    (`_chunks_per_split`); K2 takes 8 to 64 pixels per block, for about
    LN_BLOCKS_PER_SM blocks per SM; K3 takes enough pixel slices for about
    K3_BLOCKS_PER_SM blocks per SM, each slice at least K3_MIN_SLICE
    pixels."""
    tiles_h, tiles_w = _cdiv(H, tile_rows), _cdiv(W, TILE_W)
    nchunks = Ch // HIDDEN_CHUNK
    cps = _chunks_per_split(B * tiles_h * tiles_w, nchunks,
                            sms * k1_blocks_per_sm, K1_PROLOGUE_CHUNKS)
    N = B * H * W
    ln_pixels = min(max(N // (LN_BLOCKS_PER_SM * sms) // 8 * 8, 8), 64)
    out_tiles = 2 * _cdiv(Ch, WGRAD_TILE[0]) * _cdiv(C, WGRAD_TILE[1])
    slices = min(max(_cdiv(K3_BLOCKS_PER_SM * sms, out_tiles), 1),
                 max(N // K3_MIN_SLICE, 1))
    slice_len = _cdiv(_cdiv(N, slices), WGRAD_K) * WGRAD_K
    return BackwardPlan(tile_rows, tiles_h, tiles_w, cps, _cdiv(nchunks, cps),
                        ln_pixels, _cdiv(N, ln_pixels), slice_len,
                        _cdiv(N, slice_len))


class ForwardPlan(NamedTuple):
    """How one forward call is cut into blocks (see `forward_plan`): pixel
    tiles of `tile_rows` x `tile_cols` over a grid of tiles_h x tiles_w per
    image; the ceil(Ch / chunk) hidden chunks of a tile split over `nsplit`
    blocks of `chunks_per_split` chunks (the last may hold fewer). With
    nsplit above 1 each block writes an fp32 partial sum of fc2, and a
    second launch adds them in split order."""
    tile_rows: int
    tile_cols: int
    tiles_h: int
    tiles_w: int
    chunk: int
    chunks_per_split: int
    nsplit: int


def forward_tile_cols(W, widest):
    """The forward's tile width for a map W pixels wide, of 8 and the
    widest the kernel has at this C: the fewer halo columns computed per
    tile row, ceil(W / cols) * (cols + 2); on a tie, the wider."""
    return min(sorted({8, widest}, reverse=True),
               key=lambda cols: _cdiv(W, cols) * (cols + 2))


def forward_plan(B, H, W, C, Ch, tile_rows, tile_cols, chunk, blocks_per_sm,
                 sms) -> ForwardPlan:
    """The launch plan of one forward call at this shape, for the kernel's
    `tile_rows` x `tile_cols` tiles and hidden `chunk` at `blocks_per_sm`,
    on a card of `sms` SMs (`card_forward_plan` takes them from the built
    kernel and the card). Small maps split the hidden chunks over blocks
    (`_chunks_per_split`, each block's prologue the halo LayerNorm)."""
    tiles_h, tiles_w = _cdiv(H, tile_rows), _cdiv(W, tile_cols)
    nchunks = _cdiv(Ch, chunk)
    cps = _chunks_per_split(B * tiles_h * tiles_w, nchunks,
                            sms * blocks_per_sm, FWD_PROLOGUE_CHUNKS)
    return ForwardPlan(tile_rows, tile_cols, tiles_h, tiles_w, chunk, cps,
                       _cdiv(nchunks, cps))


FWD_OCCUPANCY_KEYS = ("tile_rows", "tile_cols", "chunk", "threads",
                      "smem_bytes", "blocks_per_sm", "registers",
                      "local_bytes")


def forward_occupancy(C, dtype, tile_cols=0, device="cuda"):
    """{tile_rows, tile_cols, chunk, threads, smem_bytes, blocks_per_sm,
    registers, local_bytes} of the forward kernel csrc/fused_mlp_fwd.cu runs
    at this width and dtype with tiles `tile_cols` wide (0: the widest it
    has): its tile, hidden channels per chunk, block size and dynamic shared
    memory, and what the card reports for it (resident blocks per SM,
    registers and spill bytes per thread)."""
    _, occ, err = _kernel()
    out = (ctypes.c_int * len(FWD_OCCUPANCY_KEYS))()
    with torch.cuda.device(device):
        rc = occ(C, int(dtype == torch.bfloat16), tile_cols, out)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd occupancy query failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return dict(zip(FWD_OCCUPANCY_KEYS, out))


@functools.lru_cache(maxsize=256)
def card_forward_plan(B, H, W, C, Ch, dtype, device="cuda") -> ForwardPlan:
    """`forward_plan` with the tile width from `forward_tile_cols`, the tile
    height, chunk and blocks per SM of the built kernel at that width, and
    the SM count of the card; computed once per shape, dtype and device."""
    widest = forward_occupancy(C, dtype, 0, device)["tile_cols"]
    occ = forward_occupancy(C, dtype, forward_tile_cols(W, widest), device)
    if occ["blocks_per_sm"] < 1:
        raise RuntimeError(f"fused_mlp_fwd: the kernel does not fit an SM at "
                           f"C={C}, {dtype}: {occ}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return forward_plan(B, H, W, C, Ch, occ["tile_rows"], occ["tile_cols"],
                        occ["chunk"], occ["blocks_per_sm"], sms)


def backward_occupancy(C, dtype, device="cuda"):
    """{tile_rows, k1_blocks_per_sm, k3_blocks_per_sm, k1_smem_bytes,
    k1_fc1_buffers} of the backward at this width and dtype: K1's tile
    height as csrc/fused_mlp_bwd.cu chooses it, and what the card reports
    for the kernels built for it."""
    _, occ, err = _kernel_bwd()
    out = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = occ(C, int(dtype == torch.bfloat16), out)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_bwd occupancy query failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    return dict(zip(("tile_rows", "k1_blocks_per_sm", "k3_blocks_per_sm",
                     "k1_smem_bytes", "k1_fc1_buffers"), out))


@functools.lru_cache(maxsize=256)
def card_backward_plan(B, H, W, C, Ch, dtype, device="cuda") -> BackwardPlan:
    """`backward_plan` with K1's tile height and blocks per SM from the
    built kernel and the SM count of the card; computed once per shape,
    dtype and device, so that a call's host work is one lookup."""
    occ = backward_occupancy(C, dtype, device)
    if occ["k1_blocks_per_sm"] < 1:
        raise RuntimeError(f"fused_mlp_bwd: K1 does not fit an SM at C={C}, "
                           f"{dtype}: {occ}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return backward_plan(B, H, W, C, Ch, occ["tile_rows"],
                         occ["k1_blocks_per_sm"], sms)


def fused_mlp_reference(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                        fc2_b, eps: float = 1e-6):
    """Plain PyTorch version (follows the JAX `fused_mlp_reference`).

    x [B,H,W,C]; fc1_w [C,Ch]; pos_w [3,3,Ch]; fc2_w [Ch,C]; the matmuls
    take their operands in x's dtype and accumulate in fp32."""
    dt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps) * ln_w.float() + ln_b.float()
    h = y.to(dt).float() @ fc1_w.to(dt).float() + fc1_b.float()
    ch = h.shape[-1]
    kernel = pos_w.to(dt).permute(2, 0, 1).unsqueeze(1)  # [Ch, 1, 3, 3]
    conv = F.conv2d(h.to(dt).permute(0, 3, 1, 2), kernel, None, 1, 1, 1, ch)
    h = conv.permute(0, 2, 3, 1).float() + pos_b.float() + h
    g = F.gelu(h)
    out = g.to(dt).float() @ fc2_w.to(dt).float() + fc2_b.float()
    return out.to(dt)


def fused_mlp_backward_reference(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b,
                                 fc2_w, fc2_b, g, eps: float = 1e-6):
    """Plain PyTorch backward (follows the JAX `_bwd_xla`): the cotangent g
    of the output -> gradients of the nine tensor arguments, in their
    dtypes.

    The forward is recomputed from x. The hidden tensors h1 and dhc are held
    in x's dtype, every product accumulates in fp32, and the LayerNorm
    backward runs in fp32."""
    cd = x.dtype
    C, Ch = fc1_w.shape
    H, W = x.shape[1:3]
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y0 = (xf - mean) * rstd
    y = (y0 * ln_w.float() + ln_b.float()).to(cd)
    w1, w2 = fc1_w.to(cd).float(), fc2_w.to(cd).float()
    h1 = (y.float() @ w1 + fc1_b.float()).to(cd)

    def dwconv(t, taps):  # NHWC depthwise 3x3, zero padding, in cd
        kernel = taps.permute(2, 0, 1).unsqueeze(1)  # [Ch, 1, 3, 3]
        out = F.conv2d(t.permute(0, 3, 1, 2), kernel, None, 1, 1, 1, Ch)
        return out.permute(0, 2, 3, 1)

    pw = pos_w.to(cd)
    hc = (dwconv(h1, pw) + pos_b.to(cd) + h1).float()
    inner = 0.5 * (1.0 + torch.erf(hc * 0.7071067811865476))
    gact = (hc * inner).to(cd)
    gp = inner + hc * (torch.exp(-0.5 * hc * hc) * 0.3989422804014327)

    gout = g.to(cd)
    go2d = gout.reshape(-1, C).float()
    dfc2_w = (gact.reshape(-1, Ch).float().t() @ go2d).to(fc2_w.dtype)
    dfc2_b = go2d.sum(0).to(fc2_b.dtype)
    dhc = ((gout.float() @ w2.t()) * gp).to(cd)

    # depthwise conv gradients: the input's is the correlation with the
    # flipped taps; the taps' are nine shifted products summed in fp32
    dconv_h1 = dwconv(dhc, pw.flip(0, 1))
    h1_pad = F.pad(h1, (0, 0, 1, 1, 1, 1))
    dpos_w = torch.stack([
        (dhc.float() * h1_pad[:, k:k + H, l:l + W].float()).sum((0, 1, 2))
        for k in range(3) for l in range(3)]).reshape(3, 3, Ch)
    dpos_b = dhc.float().sum((0, 1, 2)).to(pos_b.dtype)
    dh1 = (dhc + dconv_h1).reshape(-1, Ch).float()  # + the residual branch
    dfc1_w = (y.reshape(-1, C).float().t() @ dh1).to(fc1_w.dtype)
    dfc1_b = dh1.sum(0).to(fc1_b.dtype)

    dy = (dh1 @ w1.t()).reshape(x.shape)
    dln_w = (dy * y0).sum((0, 1, 2)).to(ln_w.dtype)
    dln_b = dy.sum((0, 1, 2)).to(ln_b.dtype)
    dyn = dy * ln_w.float()
    dx = rstd * (dyn - dyn.mean(-1, keepdim=True)
                 - y0 * (dyn * y0).mean(-1, keepdim=True))
    return (dx.to(cd), dln_w, dln_b, dfc1_w, dfc1_b, dpos_w.to(pos_w.dtype),
            dpos_b, dfc2_w, dfc2_b)


def _check(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b):
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"fused_mlp: x must be bf16 or fp32, got {x.dtype}")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"fused_mlp: x must be a non-empty [B,H,W,C] tensor, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_mlp: x must be contiguous NHWC")
    C = x.shape[-1]
    Ch = fc1_w.shape[-1]
    want = {"ln_w": (ln_w, (C,), torch.float32),
            "ln_b": (ln_b, (C,), torch.float32),
            "fc1_w": (fc1_w, (C, Ch), x.dtype),
            "fc1_b": (fc1_b, (Ch,), torch.float32),
            "pos_w": (pos_w, (3, 3, Ch), x.dtype),
            "pos_b": (pos_b, (Ch,), torch.float32),
            "fc2_w": (fc2_w, (Ch, C), x.dtype),
            "fc2_b": (fc2_b, (C,), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"fused_mlp: {name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"fused_mlp: {name} must be on {x.device}")
        if name not in ("fc1_w", "fc2_w") and not t.is_contiguous():
            raise ValueError(f"fused_mlp: {name} must be contiguous")
    c_mult = 16 if x.dtype == torch.bfloat16 else 4
    if C % c_mult or C > MAX_C or Ch % 32:
        raise ValueError(f"fused_mlp kernel takes C % {c_mult} == 0, "
                         f"C <= {MAX_C} and Ch % 32 == 0; got C={C}, Ch={Ch}")


def _forward_cuda(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b,
                  eps):
    _check(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b)
    fn, _, err = _kernel()
    B, H, W, C = x.shape
    Ch = fc1_w.shape[1]
    plan = card_forward_plan(B, H, W, C, Ch, x.dtype, x.device)
    w1 = fc1_w.t().contiguous()  # [Ch, C]
    w2 = fc2_w.t().contiguous()  # [C, Ch]
    out = torch.empty_like(x)
    # small maps split the hidden channels over blocks: fp32 partial sums
    partial = (torch.empty((plan.nsplit, B, H, W, C), dtype=torch.float32,
                           device=x.device) if plan.nsplit > 1 else None)
    # bf16: LayerNorm(x), written by a launch of its own before the kernel
    y = torch.empty_like(x) if x.dtype == torch.bfloat16 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), ln_w.data_ptr(), ln_b.data_ptr(),
                w1.data_ptr(), fc1_b.data_ptr(), pos_w.data_ptr(),
                pos_b.data_ptr(), w2.data_ptr(), fc2_b.data_ptr(),
                out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if y is None else y.data_ptr(),
                B, H, W, C, Ch, eps, plan.tile_rows, plan.tile_cols,
                plan.chunks_per_split, plan.nsplit,
                int(x.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_fwd launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    fused_mlp.launches += 1
    return out


def _backward_cuda(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b,
                   g, eps, times=None):
    _check(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"fused_mlp backward: g must be {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    if not g.is_contiguous():
        raise ValueError("fused_mlp backward: g must be contiguous NHWC")
    fn, _, err = _kernel_bwd()
    B, H, W, C = x.shape
    Ch = fc1_w.shape[1]
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    plan = card_backward_plan(B, H, W, C, Ch, dt, x.device)
    N = B * H * W
    # only the weight layouts this dtype's K1 reads (csrc/fused_mlp_bwd.cu):
    # both read fc1 as [Ch, C] (a view of the Linear weight); bf16 also fc2
    # as [Ch, C], fp32 also fc1 as [C, Ch] and fc2 as [C, Ch] (a view)
    w1 = fc1_w.t().contiguous()
    w1t, w2 = (None, None) if bf16 else (fc1_w.contiguous(),
                                         fc2_w.t().contiguous())
    w2t = fc2_w.contiguous() if bf16 else None

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=x.device)

    dx = torch.empty_like(x)
    dln_w, dln_b, dfc2_b = empty(C), empty(C), empty(C)
    dfc1_b, dpos_b = empty(Ch), empty(Ch)
    dw1, dw2 = empty(Ch, C, dtype=dt), empty(Ch, C, dtype=dt)
    dpos_w = empty(3, 3, Ch, dtype=dt)
    # scratch, every element written by the launches before it is read
    y = empty(N, C, dtype=dt)
    gact, dh1c = empty(N, Ch, dtype=dt), empty(N, Ch, dtype=dt)
    dy_part = empty(plan.nsplit, N, C)
    hid_part = empty(B * plan.tiles_h * plan.tiles_w, 11, Ch)
    ln_part = empty(plan.ln_blocks, 3, C)
    w_part = empty(2, plan.slices, Ch, C)
    ptrs = [x, g, ln_w, ln_b, w1, w1t, fc1_b, pos_w, pos_b, w2, w2t, dx,
            dln_w, dln_b, dw1, dfc1_b, dpos_w, dpos_b, dw2, dfc2_b, y, gact,
            dh1c, dy_part, hid_part, ln_part, w_part]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*(None if t is None else t.data_ptr() for t in ptrs), B, H,
                W, C, Ch, eps, plan.tile_rows, plan.chunks_per_split,
                plan.nsplit, plan.ln_pixels, plan.slice_len, plan.slices,
                int(bf16), stream, times)
    if rc != 0:
        raise RuntimeError(f"fused_mlp_bwd launch failed: "
                           f"{err(rc).decode()} (cudaError {rc})")
    fused_mlp.backward_launches += 1
    return (dx, dln_w, dln_b, dw1.t(), dfc1_b, dpos_w, dpos_b, dw2, dfc2_b)


def backward_stage_ms(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                      fc2_b, g, eps: float = 1e-6):
    """One backward call on the card with each of its four launches (K1
    bwd_hidden, K2 bwd_ln, K3 bwd_wgrad, K4 bwd_reduce) timed by CUDA
    events; waits for the call. Returns the four times in ms.

    The events are recorded on the stream between the launches, inside the
    C entry point, so the four times are on the same clock as a call's
    CUDA-event time and need no profiler session; a torch.profiler trace
    gives the same split by kernel name (`trace_forward --train`) but adds
    its own overhead to the calls it records."""
    times = (ctypes.c_float * 4)()
    _backward_cuda(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b,
                   g, eps, times)
    return list(times)


def fused_mlp_backward(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                       fc2_b, g, eps: float = 1e-6):
    """Backward of the fused MLP block: the cotangent g [B,H,W,C] (x's dtype,
    contiguous) -> the gradients of the nine tensor arguments, in their
    shapes and dtypes. On a CUDA tensor: the hand-written kernel, counted in
    `fused_mlp.backward_launches`, or an exception. On a CPU tensor: the
    plain version."""
    if x.device.type == "cpu":
        return fused_mlp_backward_reference(x, ln_w, ln_b, fc1_w, fc1_b,
                                            pos_w, pos_b, fc2_w, fc2_b, g,
                                            eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp: unsupported device {x.device}")
    return _backward_cuda(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                          fc2_b, g, eps)


class FusedMLP(torch.autograd.Function):
    """The fused MLP block with its hand-written backward. On a CUDA tensor
    both directions launch their kernel (counted in `fused_mlp.launches` and
    `fused_mlp.backward_launches`) or raise; on a CPU tensor they run the
    plain versions."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b,
                eps=1e-6):
        ctx.eps = eps
        ctx.save_for_backward(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b,
                              fc2_w, fc2_b)
        if x.device.type == "cpu":
            return fused_mlp_reference(x, ln_w, ln_b, fc1_w, fc1_b, pos_w,
                                       pos_b, fc2_w, fc2_b, eps)
        if x.device.type != "cuda":
            raise ValueError(f"fused_mlp: unsupported device {x.device}")
        return _forward_cuda(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b,
                             fc2_w, fc2_b, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return (*fused_mlp_backward(*ctx.saved_tensors, g.contiguous(),
                                    ctx.eps), None)


def fused_mlp(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w, fc2_b,
              eps: float = 1e-6):
    """Fused MLP block, differentiable in its nine tensor arguments.

    x [B,H,W,C] in bf16 or fp32; fc1_w [C,Ch], pos_w [3,3,Ch], fc2_w [Ch,C]
    in x's dtype; ln_w, ln_b, fc1_b, pos_b, fc2_b in fp32. fc1_w and fc2_w
    may be transposed views: the kernels read them in torch Linear layout
    ([Ch,C] and [C,Ch]), so the transposed view of a Linear weight is passed
    without a copy."""
    return FusedMLP.apply(x, ln_w, ln_b, fc1_w, fc1_b, pos_w, pos_b, fc2_w,
                          fc2_b, eps)


fused_mlp.launches = 0
fused_mlp.backward_launches = 0
