"""Plain PyTorch reference of DFormer / DFormerTrav with the LightHamHead.

Written from the published description (DFormer, ICLR 2024; HamNet's
light head; the Trav lidar expansion) in float32, NHWC, as functions of a
weight dict keyed by the published state-dict names. It imports nothing of
the program under test. A configuration file of `h100_bench/configs/`
gives every size.

Products go through a `Precision`: float32 with TF32 off (the reference
itself), TF32, bf16 operands, or fp8 (e4m3 operands with a per-tensor
scale, e5m2 gradients); TF32 and fp8 serve as the controls of the
correctness check, bf16 as a witness of what bf16 compute alone gives.
Statistics, softmaxes and the NMF stay in float32 in every mode, as the
configurations state.

Departures from the published code, each kept because the configuration
runs that way: the NMF bases of a forward in eval mode are the rows of one
uniform draw from a generator seeded 0 (`seeded_bases`), LayerScales are
weights like any other (drawn, not 1e-6), and in training every random
draw (DropPath, NMF bases, dropout) comes from one generator handed in, in
the order the forward meets them (`plan_draws`).
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

ENC = "encoder_backbone"
HEAD = "decode_head"
LIDAR = "encoder_backbone.attn_expand_e"


class _Fp8(torch.autograd.Function):
    """e4m3 rounding of a value (per-tensor scale), e5m2 of its gradient."""

    @staticmethod
    def forward(ctx, t):
        return fp8_round(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2, 57344.0)


def fp8_round(t, dtype, largest):
    scale = t.detach().abs().amax().float().clamp(min=1e-30) / largest
    return ((t / scale).to(dtype).to(t.dtype)) * scale


class _Bf16(torch.autograd.Function):
    """bf16 rounding of a value and of its gradient."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """How the products are computed: "fp32" (TF32 off), "tf32", "bf16"
    (operands rounded to bf16, float32 sums: a witness of what bf16
    compute alone gives) or "fp8"."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    @contextlib.contextmanager
    def scope(self):
        """TF32 on for "tf32", off otherwise, restored on exit."""
        saved = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32)
        on = self.mode == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = saved

    def q(self, t):
        if self.mode == "fp8":
            return _Fp8.apply(t)
        return _Bf16.apply(t) if self.mode == "bf16" else t

    def linear(self, x, w, b=None):
        return F.linear(self.q(x), self.q(w), b)

    def conv(self, x, w, b=None, stride=1, padding=0, groups=1):
        """NHWC in, NHWC out."""
        y = F.conv2d(self.q(x).permute(0, 3, 1, 2), self.q(w), b, stride,
                     padding, 1, groups)
        return y.permute(0, 2, 3, 1)

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))


def gelu(x):
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def layer_norm(W, p, x, eps):
    return F.layer_norm(x, (x.shape[-1],), W[f"{p}.weight"], W[f"{p}.bias"],
                        eps)


class Moments(dict):
    """Passed as `train`: an eval-mode forward in which the BatchNorms
    named in `layers` use their batch's moments and record them here."""

    def __init__(self, layers):
        super().__init__()
        self.layers = set(layers)

    def __bool__(self):
        return False


def batch_norm(W, p, x, eps, train):
    """Over N, H, W of an NHWC tensor; the batch's biased moments in
    training, the running ones in eval."""
    if isinstance(train, Moments) and p in train.layers:
        mean = x.mean((0, 1, 2))
        var = (x - mean).square().mean((0, 1, 2))
        train[p] = (mean, var)
    elif train:
        mean = x.mean((0, 1, 2))
        var = (x - mean).square().mean((0, 1, 2))
    else:
        mean, var = W[f"{p}.running_mean"], W[f"{p}.running_var"]
    return (x - mean) * (W[f"{p}.weight"] * torch.rsqrt(var + eps)) \
        + W[f"{p}.bias"]


def resize(x, size, align_corners=False):
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1)


def lin(W, p, x, prec, bias=True):
    return prec.linear(x, W[f"{p}.weight"], W[f"{p}.bias"] if bias else None)


def conv(W, p, x, prec, stride=1, padding=0, groups=1, bias=True):
    return prec.conv(x, W[f"{p}.weight"], W[f"{p}.bias"] if bias else None,
                     stride, padding, groups)


def drop_rates(cfg):
    """Stochastic-depth rate of each block, in order."""
    return [float(r) for r in np.linspace(0.0, cfg["drop_path_rate"],
                                          sum(cfg["depths"]))]


def blocks(cfg):
    """(stage, index, rate, window, drops depth) of every block in order."""
    rates, out, k = drop_rates(cfg), [], 0
    for i, depth in enumerate(cfg["depths"]):
        for j in range(depth):
            out.append((i, j, rates[k], cfg["windows"][i],
                        i == 3 and j == depth - 1))
            k += 1
    return out


# ---- the encoder ----

def mlp(W, p, x, prec, eps):
    """LN -> fc1 -> 3x3 depthwise positional conv (+ residual) -> GELU ->
    fc2."""
    y = layer_norm(W, f"{p}.norm", x, eps)
    h = lin(W, f"{p}.fc1", y, prec)
    h = conv(W, f"{p}.pos", h, prec, padding=1, groups=h.shape[-1]) + h
    return lin(W, f"{p}.fc2", gelu(h), prec)


def attention(W, p, x, x_e, heads, window, drops_depth, prec, eps):
    """Local enhancement, depth gating and (window != 0) the global-aware
    attention over a window x window pooling of [x, x_e]."""
    B, H, Wd, C = x.shape
    hd = C // heads // 2
    x = layer_norm(W, f"{p}.norm", x, eps)
    x_e = layer_norm(W, f"{p}.norm_e", x_e, eps)
    q = lin(W, f"{p}.q", x, prec)
    cut = lin(W, f"{p}.q_cut", x, prec)
    t = gelu(lin(W, f"{p}.l", x, prec))
    a = lin(W, f"{p}.a", conv(W, f"{p}.conv", t, prec, padding=3, groups=C),
            prec)
    parts = [q * a]
    if window:
        kv = lin(W, f"{p}.kv", t, prec).reshape(B, H * Wd, 2 * heads, hd)
        k, v = kv[:, :, :heads], kv[:, :, heads:]
        pooled = F.adaptive_avg_pool2d(
            torch.cat([x, x_e], -1).permute(0, 3, 1, 2), (window, window))
        m = lin(W, f"{p}.short_cut_linear", pooled.permute(0, 2, 3, 1), prec)
        m = m.reshape(B, window * window, heads, hd)
        logits = torch.einsum("bqnd,bknd->bnqk", m * hd ** -0.5, k)
        attn = torch.softmax(logits, -1)
        gaa = prec.matmul(attn, v.permute(0, 2, 1, 3))  # [B, n, q, d]
        gaa = gaa.permute(0, 2, 1, 3).reshape(B, window, window, C // 2)
        parts.append(resize(gaa, (H, Wd)))
    e = lin(W, f"{p}.e_fore", x_e, prec)
    e = conv(W, f"{p}.e_conv", e, prec, padding=3, groups=C // 2)
    e = lin(W, f"{p}.e_back", e, prec)
    parts.append(cut * e)
    cat = torch.cat(parts, -1)
    out = lin(W, f"{p}.proj", cat, prec)
    if drops_depth:
        return out, e
    return out, lin(W, f"{p}.proj_e", cat, prec)


def block(W, p, x, x_e, heads, window, drops_depth, prec, eps, masks=None):
    """One encoder block. masks: None (no stochastic depth) or (keep,
    [bool [B,1,1,1] per residual branch, in order])."""

    def drop(t, i):
        if masks is None:
            return t
        keep, ms = masks
        return torch.where(ms[i], t / keep, torch.zeros_like(t))

    a_x, a_e = attention(W, f"{p}.attn", x, x_e, heads, window, drops_depth,
                         prec, eps)
    x = x + drop(W[f"{p}.layer_scale_1"] * a_x, 0)
    x = x + drop(W[f"{p}.layer_scale_2"] * mlp(W, f"{p}.mlp", x, prec, eps), 1)
    if drops_depth:
        return x, a_e
    x_e = x_e + drop(W[f"{p}.layer_scale_1_e"] * a_e, 2)
    x_e = x_e + drop(W[f"{p}.layer_scale_2_e"]
                     * mlp(W, f"{p}.mlp_e2", x_e, prec, eps), 3)
    return x, x_e


def stem(W, p, x, prec, train, eps):
    x = conv(W, f"{p}.0", x, prec, stride=2, padding=1)
    x = gelu(batch_norm(W, f"{p}.1", x, eps, train))
    x = conv(W, f"{p}.3", x, prec, stride=2, padding=1)
    return batch_norm(W, f"{p}.4", x, eps, train)


def downsample(W, p, x, prec, train, eps):
    x = batch_norm(W, f"{p}.0", x, eps, train)
    return conv(W, f"{p}.1", x, prec, stride=2, padding=1)


def encoder(W, cfg, rgb, x_e, prec, train=False, masks=None,
            run_block=None):
    """Four stages; returns the RGB feature maps at strides 4, 8, 16, 32.
    x_e: [B, H, W, >=1], first channel used. masks: per block, as `block`
    takes them (None for a block without stochastic depth).
    run_block(fn, *tensors) may wrap each block (recomputation)."""
    eps_bn, eps = cfg["bn_eps_encoder"], cfg["ln_eps"]
    x_e = x_e[..., :1]
    outs, k = [], 0
    for i in range(4):
        if i == 0:
            x = stem(W, f"{ENC}.downsample_layers.0", rgb, prec, train, eps_bn)
            x_e = stem(W, f"{ENC}.downsample_layers_e.0", x_e, prec, train,
                       eps_bn)
        else:
            x = downsample(W, f"{ENC}.downsample_layers.{i}", x, prec, train,
                           eps_bn)
            x_e = downsample(W, f"{ENC}.downsample_layers_e.{i}", x_e, prec,
                             train, eps_bn)
        for j in range(cfg["depths"][i]):
            window = cfg["windows"][i]
            drops_depth = i == 3 and j == cfg["depths"][i] - 1
            m = masks[k] if masks is not None else None

            def fn(a, b, i=i, j=j, window=window, drops_depth=drops_depth,
                   m=m):
                return block(W, f"{ENC}.stages.{i}.{j}", a, b,
                             cfg["num_heads"][i], window, drops_depth, prec,
                             eps, m)
            x, x_e = run_block(fn, x, x_e) if run_block else fn(x, x_e)
            k += 1
        outs.append(x)
    return outs


# ---- the Trav lidar expansion ----

def mha(W, p, query, key, value, heads, prec):
    """Multi-head attention with a packed in-projection (float32, as the
    configuration computes it) and an out-projection; a query of batch 1 is
    broadcast over the key's batch."""
    w, b = W[f"{p}.in_proj_weight"], W[f"{p}.in_proj_bias"]
    E = w.shape[1]
    hd = E // heads
    q = F.linear(query, w[:E], b[:E])
    k = F.linear(key, w[E:2 * E], b[E:2 * E])
    v = F.linear(value, w[2 * E:], b[2 * E:])
    Bq, Lq, _ = q.shape
    B, Lk, _ = k.shape
    q = q.reshape(Bq, Lq, heads, hd).transpose(1, 2)
    k = k.reshape(B, Lk, heads, hd).transpose(1, 2)
    v = v.reshape(B, Lk, heads, hd).transpose(1, 2)
    attn = torch.softmax(torch.matmul(q / math.sqrt(hd), k.transpose(-1, -2)),
                         -1)
    out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Lq, E)
    return lin(W, f"{p}.out_proj", out, prec)


def lidar_expand(W, cfg, scan, prec):
    """[B, beams] scan -> [B, H, W, 1] pseudo-depth: beams -> W columns,
    then one token per column -> H rows."""
    lid = cfg["lidar"]
    B = scan.shape[0]
    H, Wd = cfg["image_height"], cfg["image_width"]
    x = lin(W, f"{LIDAR}.input_proj", scan.reshape(B, lid["beams"], 1), prec)
    x = mha(W, f"{LIDAR}.attn1", W[f"{LIDAR}.query1"][None], x, x,
            lid["heads"], prec)
    x = x.reshape(B * Wd, 1, lid["embed_dim"])
    x = mha(W, f"{LIDAR}.attn2", W[f"{LIDAR}.query2"][None], x, x,
            lid["heads"], prec)
    x = lin(W, f"{LIDAR}.output_proj", x, prec)[..., 0]
    return x.reshape(B, Wd, H).transpose(1, 2)[..., None]


# ---- the light Hamburger head ----

def seeded_bases(b, d, r, device, rows=64):
    """The eval-mode NMF bases of the configuration: the first b rows of
    one uniform [max(b, rows), d, r] draw from a CPU generator seeded 0,
    L2-normalised over d."""
    gen = torch.Generator().manual_seed(0)
    bases = torch.rand((max(b, rows), d, r), generator=gen)
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    return bases[:b].to(device)


def nmf(x, bases, train):
    """Multiplicative-update NMF: 7 steps in eval, 6 in training with the
    one-step gradient (the iterations on x detached, only the last
    coefficient update differentiated). x [B, N, D] >= 0, bases [B, D, R];
    returns the reconstruction [B, N, D]."""
    eps = 1e-6

    def coef_step(x_, bases_, coef):
        num = torch.bmm(x_, bases_)
        den = torch.bmm(coef, torch.bmm(bases_.transpose(1, 2), bases_))
        return coef * num / (den + eps)

    with torch.set_grad_enabled(torch.is_grad_enabled() and not train):
        x_it = x.detach() if train else x
        coef = torch.softmax(torch.bmm(x_it, bases), -1)
        for _ in range(6 if train else 7):
            coef = coef_step(x_it, bases, coef)
            num = torch.bmm(x_it.transpose(1, 2), coef)
            den = torch.bmm(bases, torch.bmm(coef.transpose(1, 2), coef))
            bases = bases * num / (den + eps)
    coef = coef_step(x, bases, coef)
    return torch.bmm(coef, bases.transpose(1, 2))


def ham_head(W, cfg, feats, prec, train=False, bases=None, dropout=None):
    """Stages 2-4 at stride 8 -> squeeze -> Hamburger -> align -> (dropout)
    -> classifier. dropout: None or a bool keep mask of the align output."""
    eps = cfg["bn_eps_decoder"]
    p = HEAD
    size = feats[1].shape[1:3]
    x = torch.cat([resize(f, size) for f in feats[1:]], -1)
    x = F.relu(batch_norm(W, f"{p}.squeeze.bn",
                          conv(W, f"{p}.squeeze.conv", x, prec, bias=False),
                          eps, train))
    B, h, w, D = x.shape
    if bases is None:
        bases = seeded_bases(B, D, cfg["md_r"], x.device)
    enjoy = F.relu(conv(W, f"{p}.hamburger.ham_in", x, prec))
    enjoy = nmf(enjoy.reshape(B, h * w, D), bases, train).reshape(B, h, w, D)
    enjoy = batch_norm(W, f"{p}.hamburger.ham_out.bn",
                       conv(W, f"{p}.hamburger.ham_out.conv", enjoy, prec,
                            bias=False), eps, train)
    x = F.relu(x + enjoy)
    x = F.relu(batch_norm(W, f"{p}.align.bn",
                          conv(W, f"{p}.align.conv", x, prec, bias=False),
                          eps, train))
    if dropout is not None:
        keep = 1.0 - cfg["dropout_ratio"]
        x = torch.where(dropout, x / keep, torch.zeros_like(x))
    return conv(W, f"{p}.conv_seg", x, prec)


def forward(W, cfg, rgb, modal, prec=None, train=False, draws=None,
            run_block=None):
    """Logits [B, H, W, classes] at the input's size. modal: the depth map
    [B, H, W, C] or, for a lidar configuration, the scan [B, beams].
    draws: `plan_draws`' random numbers of a training forward."""
    prec = prec or Precision()
    x_e = lidar_expand(W, cfg, modal, prec) if "lidar" in cfg else modal
    masks = draws["masks"] if draws else None
    feats = encoder(W, cfg, rgb, x_e, prec, train, masks, run_block)
    out = ham_head(W, cfg, feats, prec, train,
                   draws["bases"] if draws else None,
                   draws["dropout"] if draws else None)
    return resize(out, rgb.shape[1:3])


def plan_draws(cfg, batch, hw, generator):
    """Every random number of one training forward, drawn from `generator`
    in the order the forward meets them: each block's stochastic-depth
    keeps (one uniform [B,1,1,1] per residual branch, none for a rate of
    0), the NMF bases (uniform [B, D, R], L2-normalised over D), then the
    head's dropout (uniform over the align output)."""
    dev = generator.device
    masks = []
    for _, _, rate, _, drops_depth in blocks(cfg):
        if rate == 0.0:
            masks.append(None)
            continue
        keep = 1.0 - rate
        ms = [torch.rand((batch, 1, 1, 1), generator=generator, device=dev)
              < keep for _ in range(2 if drops_depth else 4)]
        masks.append((keep, ms))
    D, R = cfg["ham_channels"], cfg["md_r"]
    bases = torch.rand((batch, D, R), generator=generator, device=dev)
    bases = bases / torch.linalg.norm(bases, dim=1, keepdim=True)
    h, w = -(-hw[0] // 8), -(-hw[1] // 8)
    dropout = torch.rand((batch, h, w, cfg["decoder_embed_dim"]),
                         generator=generator, device=dev) \
        < 1.0 - cfg["dropout_ratio"]
    return dict(masks=masks, bases=bases, dropout=dropout)


def parameter_shapes(cfg):
    """{name: shape} of every weight and BatchNorm statistic, in a fixed
    order: the published state-dict layout of the configuration."""
    shapes = {}

    def add(p, *shape):
        shapes[p] = tuple(shape)

    def linear(p, i, o, bias=True):
        add(f"{p}.weight", o, i)
        if bias:
            add(f"{p}.bias", o)

    def conv2d(p, i, o, k, groups=1, bias=True):
        add(f"{p}.weight", o, i // groups, k, k)
        if bias:
            add(f"{p}.bias", o)

    def norm(p, c, bn=False):
        add(f"{p}.weight", c)
        add(f"{p}.bias", c)
        if bn:
            add(f"{p}.running_mean", c)
            add(f"{p}.running_var", c)

    def mlp_(p, c, ratio):
        norm(f"{p}.norm", c)
        linear(f"{p}.fc1", c, c * ratio)
        conv2d(f"{p}.pos", c * ratio, c * ratio, 3, groups=c * ratio)
        linear(f"{p}.fc2", c * ratio, c)

    dims = cfg["dims"]
    for e, scale in (("", 1), ("_e", 2)):
        d0 = dims[0] // scale
        conv2d(f"{ENC}.downsample_layers{e}.0.0", 3 if e == "" else 1,
               d0 // 2, 3)
        norm(f"{ENC}.downsample_layers{e}.0.1", d0 // 2, bn=True)
        conv2d(f"{ENC}.downsample_layers{e}.0.3", d0 // 2, d0, 3)
        norm(f"{ENC}.downsample_layers{e}.0.4", d0, bn=True)
        for i in range(1, 4):
            norm(f"{ENC}.downsample_layers{e}.{i}.0", dims[i - 1] // scale,
                 bn=True)
            conv2d(f"{ENC}.downsample_layers{e}.{i}.1", dims[i - 1] // scale,
                   dims[i] // scale, 3)
    for i, j, _, window, drops_depth in blocks(cfg):
        C, p = dims[i], f"{ENC}.stages.{i}.{j}"
        add(f"{p}.layer_scale_1", C)
        add(f"{p}.layer_scale_2", C)
        if not drops_depth:
            add(f"{p}.layer_scale_1_e", C // 2)
            add(f"{p}.layer_scale_2_e", C // 2)
        a = f"{p}.attn"
        norm(f"{a}.norm", C)
        norm(f"{a}.norm_e", C // 2)
        linear(f"{a}.q", C, C)
        linear(f"{a}.q_cut", C, C // 2)
        linear(f"{a}.l", C, C)
        conv2d(f"{a}.conv", C, C, 7, groups=C)
        linear(f"{a}.a", C, C)
        linear(f"{a}.e_fore", C // 2, C // 2)
        conv2d(f"{a}.e_conv", C // 2, C // 2, 7, groups=C // 2)
        linear(f"{a}.e_back", C // 2, C // 2)
        cat = 2 * C if window else C // 2 * 3
        linear(f"{a}.proj", cat, C)
        if not drops_depth:
            linear(f"{a}.proj_e", cat, C // 2)
        if window:
            linear(f"{a}.short_cut_linear", C // 2 * 3, C // 2)
            linear(f"{a}.kv", C, C)
        mlp_(f"{p}.mlp", C, cfg["mlp_ratios"][i])
        if not drops_depth:
            mlp_(f"{p}.mlp_e2", C // 2, cfg["mlp_ratios"][i])
    if "lidar" in cfg:
        lid, E = cfg["lidar"], cfg["lidar"]["embed_dim"]
        add(f"{LIDAR}.query1", cfg["image_width"], E)
        add(f"{LIDAR}.query2", cfg["image_height"], E)
        linear(f"{LIDAR}.input_proj", 1, E)
        for k in ("attn1", "attn2"):
            add(f"{LIDAR}.{k}.in_proj_weight", 3 * E, E)
            add(f"{LIDAR}.{k}.in_proj_bias", 3 * E)
            linear(f"{LIDAR}.{k}.out_proj", E, E)
        linear(f"{LIDAR}.output_proj", E, 1)
    D, C = cfg["ham_channels"], cfg["decoder_embed_dim"]
    conv2d(f"{HEAD}.squeeze.conv", sum(dims[1:]), D, 1, bias=False)
    norm(f"{HEAD}.squeeze.bn", D, bn=True)
    conv2d(f"{HEAD}.hamburger.ham_in", D, D, 1)
    conv2d(f"{HEAD}.hamburger.ham_out.conv", D, D, 1, bias=False)
    norm(f"{HEAD}.hamburger.ham_out.bn", D, bn=True)
    conv2d(f"{HEAD}.align.conv", D, C, 1, bias=False)
    norm(f"{HEAD}.align.bn", C, bn=True)
    conv2d(f"{HEAD}.conv_seg", C, cfg["num_classes"], 1)
    return shapes


def is_statistic(name):
    return name.endswith(("running_mean", "running_var"))
