"""Plain PyTorch forward passes of the benchmarked model families.

This is the benchmark's own yardstick: it imports nothing of the program.
It follows the published architectures as the configurations name them
(EfficientNet B0/B4 with the skip-concat depth decoder, ResNet-50 with the
ReDWeb feature-fusion decoder), NCHW, float32 unless a :class:`Ctx` asks
for a lower precision, with no kernels, caches or fused paths.

One function per family runs the forward against a :class:`Ctx`, which
decides what a parameter is and how a convolution runs:

* spec mode (``Ctx(None)``): the forward runs on the ``meta`` device and
  records every parameter (name, shape, kind), every conv -> BN pair and
  every convolution's shape, from which the benchmark makes weights and
  counts operations;
* train mode: BatchNorm normalises with the batch's statistics (biased
  variance, two passes), drop-path draws one uniform a sample from
  ``ctx.gen`` in block order (no drop-path without a generator);
* inference: BatchNorm with running statistics;
* quantized inference (``quant="calib"`` or ``"int"``): every conv that
  has a BatchNorm is a quantization site, BN folded into it; weights
  symmetric per output channel, activations symmetric per tensor,
  ``bits`` wide; dense sites multiply integers exactly (float64), a
  depthwise site keeps float activations.

Parameter names are those of the state dicts the configurations' models
have, so one set of weights loads into the program by name.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CAFFE_MEAN_BGR = (103.939, 116.779, 123.68)


class Ctx:
    """How one forward runs (see the module docstring)."""

    def __init__(self, params: Optional[Dict[str, torch.Tensor]] = None, *, spec_device="meta",
                 train: bool = False,
                 gen: Optional[torch.Generator] = None, quant: Optional[str] = None,
                 bits: int = 8, scales: Optional[Dict[str, torch.Tensor]] = None,
                 lowp: Optional[str] = None, batch_sum=None, record_stats: bool = False,
                 rows: Tuple[int, int] = (0, 1), remat: bool = False):
        self.params = params
        self.spec_device = spec_device
        self.train, self.gen = train, gen
        self.quant, self.bits = quant, bits
        self.scales = scales or {}  # site -> activation amax (int mode)
        self.amax: Dict[str, torch.Tensor] = {}  # calib mode: site -> max |input|
        # None | "fp8": every convolution reads e4m3-rounded inputs and
        # weights and its output is rounded to e4m3 (the program's are bf16)
        self.lowp = lowp
        # train mode over several processes: all-reduce of per-channel sums
        self.batch_sum = batch_sum
        # train mode: {BN name: (batch mean, biased batch variance)} when asked
        self.stats: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = (
            {} if record_stats else None)
        # (this process's data index, the data-axis size): batch draws are
        # made at the global batch's shape and these rows kept
        self.rows = rows
        # recompute each encoder block in the backward pass (memory only:
        # the same values)
        self.remat = remat
        self.spec: List[Tuple[str, Tuple[int, ...], str, int]] = []  # name, shape, kind, fan_in
        self.pairs: Dict[str, Tuple[str, float]] = {}  # conv -> (bn, eps)
        self.convs: List[dict] = []  # spec mode: one record a convolution
        self.folded: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    @property
    def spec_mode(self) -> bool:
        return self.params is None

    def uniform(self, n: int, device) -> torch.Tensor:
        """``n`` uniforms for this process's rows of a global batch draw."""
        index, count = self.rows
        full = torch.rand((n * count,), generator=self.gen, device=device)
        return full.narrow(0, index * n, n) if count > 1 else full

    def p(self, name: str, shape, kind: str, fan_in: int = 0) -> torch.Tensor:
        if self.spec_mode:
            self.spec.append((name, tuple(shape), kind, fan_in))
            return torch.empty(shape, device=self.spec_device)
        return self.params[name]


def _same(size: int, k: int, stride: int) -> Tuple[int, int]:
    """TF SAME pads (before, after) of one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale (the control's
    precision for a bfloat16 configuration); the gradient passes the
    rounding unchanged, as a float8 convolution's backward reads its saved
    float8 operands."""
    s = t.detach().abs().amax().clamp(min=1e-12) / 448.0
    q = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (q - t).detach()


def _qmax(bits: int) -> float:
    return float(2 ** (bits - 1) - 1)


def conv(ctx: Ctx, x: torch.Tensor, name: str, cin: int, cout: int, k: int, stride: int = 1,
         groups: int = 1, bias: bool = True, padding: Optional[int] = None,
         site: bool = False, encoder: bool = False) -> torch.Tensor:
    """Convolution ``name`` of NCHW ``x``: TF SAME padding, or ``padding``
    on every side. ``site``: a quantization site (the conv has a BN)."""
    fan_in = (cin // groups) * k * k
    w = ctx.p(f"{name}.weight", (cout, cin // groups, k, k), "conv", fan_in)
    b = ctx.p(f"{name}.bias", (cout,), "bias") if bias else None
    h, wd = x.shape[2], x.shape[3]
    if padding is None:
        (pt, pb), (pl, pr) = _same(h, k, stride), _same(wd, k, stride)
    else:
        pt = pb = pl = pr = padding
    if ctx.spec_mode:
        ho, wo = (h + pt + pb - k) // stride + 1, (wd + pl + pr - k) // stride + 1
        ctx.convs.append({"name": name, "n": x.shape[0], "cin": cin, "cout": cout, "k": k,
                          "stride": stride, "groups": groups, "h": h, "w": wd, "ho": ho,
                          "wo": wo, "site": site, "encoder": encoder})
    xp = F.pad(x, (pl, pr, pt, pb)) if (pt or pb or pl or pr) else x
    if site and ctx.quant and not ctx.spec_mode:
        return _quant_conv(ctx, xp, name, stride, groups)
    lowp = ctx.lowp == "fp8" and not ctx.spec_mode
    if lowp:
        xp, w = _fp8(xp), _fp8(w)
    y = F.conv2d(xp, w, None, stride, 0, 1, groups)
    y = y if b is None else y + b.reshape(1, -1, 1, 1)
    return _fp8(y) if lowp else y


def _quant_conv(ctx: Ctx, xp: torch.Tensor, name: str, stride: int, groups: int):
    """A quantization site on padded ``xp`` (zero-point 0: the zero pad is
    exact in the integer domain). The weight and bias are the folded ones."""
    w, b = ctx.folded[name]
    q = _qmax(ctx.bits)
    w_scale = w.abs().amax(dim=(1, 2, 3)).clamp(min=1e-12) / q
    kq = torch.clamp(torch.round(w / w_scale.reshape(-1, 1, 1, 1)), -q, q)
    wdq = kq * w_scale.reshape(-1, 1, 1, 1)
    if ctx.quant == "calib":
        a = xp.detach().abs().amax()
        ctx.amax[name] = a if name not in ctx.amax else torch.maximum(ctx.amax[name], a)
        return F.conv2d(xp, wdq, None, stride, 0, 1, groups) + b.reshape(1, -1, 1, 1)
    if groups > 1:  # depthwise: integer weights, float activations
        return F.conv2d(xp, wdq, None, stride, 0, 1, groups) + b.reshape(1, -1, 1, 1)
    a_scale = ctx.scales[name].clamp(min=1e-12) / q
    xq = torch.clamp(torch.round(xp / a_scale), -q, q)
    acc = F.conv2d(xq.double(), kq.double(), None, stride, 0, 1, 1).float()
    return acc * (w_scale * a_scale).reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)


def batch_norm(ctx: Ctx, x: torch.Tensor, name: str, ch: int, eps: float) -> torch.Tensor:
    g = ctx.p(f"{name}.weight", (ch,), "bn_weight")
    beta = ctx.p(f"{name}.bias", (ch,), "bn_bias")
    rm = ctx.p(f"{name}.running_mean", (ch,), "bn_mean")
    rv = ctx.p(f"{name}.running_var", (ch,), "bn_var")
    if ctx.spec_mode:
        return x
    if ctx.train:
        if ctx.batch_sum is None:
            mean = x.mean(dim=(0, 2, 3))
            y = x - mean.reshape(1, -1, 1, 1)
            var = torch.square(y).mean(dim=(0, 2, 3))
        else:  # the global batch over processes
            n = x.shape[0] * x.shape[2] * x.shape[3]
            sums = ctx.batch_sum(torch.cat([x.sum(dim=(0, 2, 3)),
                                            x.new_full((1,), float(n))]))
            mean = sums[:ch] / sums[ch]
            y = x - mean.reshape(1, -1, 1, 1)
            var = ctx.batch_sum(torch.square(y).sum(dim=(0, 2, 3))) / sums[ch]
        if ctx.stats is not None:
            ctx.stats[name] = (mean.detach(), var.detach())
    else:
        y, var = x - rm.reshape(1, -1, 1, 1), rv
    mul = torch.rsqrt(var + eps) * g
    return y * mul.reshape(1, -1, 1, 1) + beta.reshape(1, -1, 1, 1)


def conv_bn(ctx: Ctx, x, conv_name: str, bn_name: str, cin: int, cout: int, k: int,
            stride: int = 1, groups: int = 1, bias: bool = True, eps: float = 1e-3,
            padding: Optional[int] = None, encoder: bool = False):
    """``bn(conv(x))``, or the folded site under ``ctx.quant``."""
    if ctx.spec_mode:
        ctx.pairs[conv_name] = (bn_name, eps)
    y = conv(ctx, x, conv_name, cin, cout, k, stride, groups, bias, padding, site=True,
             encoder=encoder)
    if ctx.quant and not ctx.spec_mode:
        return y
    return batch_norm(ctx, y, bn_name, cout, eps)


def swish(x):
    return x * torch.sigmoid(x)


def up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


# --------------------------------------------------------------- EfficientNet
_STAGES = ((1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
           (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3))
EFFNET_SCALING = {"b0": (1.0, 1.0), "b4": (1.4, 1.8)}
TAP_STAGES = (3, 4, 6)


def round_filters(filters: int, width: float, divisor: int = 8) -> int:
    filters *= width
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def _blocks(variant: str):
    """(name, in, out, expand, kernel, stride, drop rate, stage) of every MBConv."""
    width, depth = EFFNET_SCALING[variant]
    reps = [int(math.ceil(depth * r)) for (_, _, r, _, _) in _STAGES]
    total = sum(reps)
    out, cin, j = [], round_filters(32, width), 0
    for s, ((e, c, _, st, k), n) in enumerate(zip(_STAGES, reps), start=1):
        cout = round_filters(c, width)
        for i in range(n):
            out.append((f"stage{s}_block{i}", cin, cout, e, k, st if i == 0 else 1,
                        0.2 * j / total, s))
            cin, j = cout, j + 1
    return out, round_filters(32, width), round_filters(1280, width)


def _mbconv(ctx: Ctx, x, n: str, cin: int, cout: int, exp: int, k: int, st: int, keep_draw):
    inputs, ce = x, cin * exp
    tap = None
    if exp != 1:
        x = swish(conv_bn(ctx, x, n + "expand_conv", n + "expand_bn", cin, ce, 1, bias=False,
                          encoder=True))
        tap = x
    x = swish(conv_bn(ctx, x, n + "dw_conv", n + "dw_bn", ce, ce, k, st, groups=ce, bias=False,
                      encoder=True))
    rc = max(1, int(cin * 0.25))
    se = x.mean(dim=(2, 3), keepdim=True)
    se = swish(conv(ctx, se, n + "se.reduce", ce, rc, 1, encoder=True))
    se = conv(ctx, se, n + "se.expand", rc, ce, 1, encoder=True)
    x = x * torch.sigmoid(se)
    x = conv_bn(ctx, x, n + "project_conv", n + "project_bn", ce, cout, 1, bias=False,
                encoder=True)
    if st == 1 and cin == cout:
        if keep_draw is not None:
            draw, keep = keep_draw
            x = torch.where((draw < keep).reshape(-1, 1, 1, 1), x / keep,
                            torch.zeros((), dtype=x.dtype, device=x.device))
        x = x + inputs
    return x, tap


def effnet_encoder(ctx: Ctx, x: torch.Tensor, variant: str):
    blocks, stem, top = _blocks(variant)
    e = "encoder."
    x = swish(conv_bn(ctx, x, e + "stem_conv", e + "stem_bn", 3, stem, 3, 2, bias=False,
                      encoder=True))
    # drop-path: one uniform a sample for each residual block, in block order
    draws = {}
    if ctx.train and ctx.gen is not None and not ctx.spec_mode:
        for name, cin, cout, _, _, st, drop, _ in blocks:
            if st == 1 and cin == cout and drop > 0:
                draws[name] = (ctx.uniform(x.shape[0], x.device), 1.0 - drop)
    taps = {}
    for name, cin, cout, exp, k, st, drop, stage in blocks:
        args = (e + name + ".", cin, cout, exp, k, st, draws.get(name))
        if ctx.remat and ctx.train and not ctx.spec_mode:
            x, tap = torch.utils.checkpoint.checkpoint(
                lambda x, a=args: _mbconv(ctx, x, *a), x, use_reentrant=False)
        else:
            x, tap = _mbconv(ctx, x, *args)
        if name.endswith("_block0") and stage in TAP_STAGES:
            taps[f"expand_{stage}"] = tap
    x = swish(conv_bn(ctx, x, e + "top_conv", e + "top_bn", blocks[-1][2], top, 1, bias=False,
                      encoder=True))
    return x, taps


def skip_concat_decoder(ctx: Ctx, top: torch.Tensor, taps, head_ch: int = 32):
    d = "decoder."
    c6, c4, c3 = (taps[f"expand_{s}"].shape[1] for s in (6, 4, 3))
    ins = (top.shape[1], 2 * c6, 2 * c4, 2 * c3, head_ch)
    outs = (c6, c4, c3, head_ch, head_ch)

    def cbr(x, i):
        return torch.relu(conv_bn(ctx, x, f"{d}conv{i}", f"{d}bn{i}", ins[i], outs[i], 3))

    x = top
    for i, tap in enumerate(("expand_6", "expand_4", "expand_3")):
        x = torch.cat([up2(cbr(x, i)), taps[tap]], dim=1)
    x = cbr(up2(cbr(x, 3)), 4)
    return conv(ctx, up2(x), d + "head", head_ch, 1, 3)


# ---------------------------------------------------------------- ResNet-50
RESNET_EPS = 1.001e-5
FILTERS = (64, 128, 256, 512)
STAGE_BLOCKS = (3, 4, 6, 3)


def resnet50_encoder(ctx: Ctx, x: torch.Tensor):
    e = "encoder."
    x = torch.relu(conv_bn(ctx, x, e + "stem_conv", e + "stem_bn", 3, 64, 7, 2, eps=RESNET_EPS,
                           padding=3, encoder=True))
    x = F.max_pool2d(x, 3, 2, padding=1)
    taps, cin = {}, 64
    for si, blocks in enumerate(STAGE_BLOCKS):
        stage, f = si + 2, FILTERS[si]
        for i in range(blocks):
            n = f"{e}stage{stage}_block{i}."
            st = 2 if (i == 0 and si > 0) else 1

            def cb(x, c, ci, co, k, s=1):
                return conv_bn(ctx, x, n + c, n + c.replace("conv", "bn"), ci, co, k, s,
                               eps=RESNET_EPS, encoder=True)

            short = cb(x, "proj_conv", cin, 4 * f, 1, st) if i == 0 else x
            y = torch.relu(cb(x, "conv1", cin, f, 1, st))
            y = torch.relu(cb(y, "conv2", f, f, 3))
            x = torch.relu(cb(y, "conv3", f, 4 * f, 1) + short)
            cin = 4 * f
            if stage == 4 and i == 2:
                taps["c4_mid"] = x
        if stage in (2, 3):
            taps[f"c{stage}"] = x
    return x, taps


def _bottleneck_pair(ctx: Ctx, x, n: str, ch: int):
    for u in range(2):
        def cb(x, j, ci, co, k):
            return conv_bn(ctx, x, f"{n}u{u}_conv{j}", f"{n}u{u}_bn{j}", ci, co, k, bias=False)

        y = torch.relu(cb(x, 0, ch, ch // 4, 1))
        y = torch.relu(cb(y, 1, ch // 4, ch // 4, 3))
        x = torch.relu(cb(y, 2, ch // 4, ch, 1) + x)
    return x


def redweb_decoder(ctx: Ctx, c5: torch.Tensor, taps):
    d = "decoder."
    x, up_ch = up2(c5), c5.shape[1]
    for i, (tap, ch) in enumerate(zip(("c4_mid", "c3", "c2"), (256, 128, 64))):
        n = f"{d}fusion{i}."
        lat = taps[tap]
        left = conv_bn(ctx, lat, n + "lateral_conv", n + "lateral_bn", lat.shape[1], ch, 3,
                       bias=False)
        left = _bottleneck_pair(ctx, left, n + "lateral_block.", ch)
        x = left + conv_bn(ctx, x, n + "up_conv", n + "up_bn", up_ch, ch, 3, bias=False)
        x = up2(_bottleneck_pair(ctx, x, n + "fuse_block.", ch))
        up_ch = ch
    o = d + "output."
    x = torch.relu(conv_bn(ctx, x, o + "conv0", o + "bn0", up_ch, 64, 3))
    x = conv(ctx, x, o + "conv1", 64, 1, 3)
    return conv(ctx, up2(x), o + "conv2", 1, 1, 1)


# ---------------------------------------------------------------- the models
FAMILIES = {
    "ff_effnet": ("effnet", "b0"),
    "ff_effnet_b4": ("effnet", "b4"),
    "ff_redweb": ("redweb", None),
}


def normalize(images_nhwc: torch.Tensor, family: str) -> torch.Tensor:
    """[0, 1] NHWC images -> the backbone's normalised NCHW input."""
    x = images_nhwc.to(torch.float32)
    if family == "effnet":
        x = (x - x.new_tensor(IMAGENET_MEAN)) / x.new_tensor(IMAGENET_STD)
    else:
        x = x.flip(-1) * 255.0 - x.new_tensor(CAFFE_MEAN_BGR)
    return x.permute(0, 3, 1, 2)


def forward(ctx: Ctx, model: str, images_nhwc: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) [0, 1] images -> (B, H, W) depth maps."""
    family, variant = FAMILIES[model]
    x = normalize(images_nhwc, family)
    if family == "effnet":
        top, taps = effnet_encoder(ctx, x, variant)
        out = skip_concat_decoder(ctx, top, taps)
    else:
        c5, taps = resnet50_encoder(ctx, x)
        out = redweb_decoder(ctx, c5, taps)
    return out[:, 0]


def spec(model: str, batch: int, size: int, device="meta") -> Ctx:
    """The model's parameters, conv -> BN pairs and convolutions at (batch,
    size, size) images, from one forward on ``device``: the meta device by
    default; a small one on the CPU is quicker where only the parameters
    are wanted (the meta device's first convolution loads a good deal)."""
    ctx = Ctx(None, spec_device=device)
    forward(ctx, model, torch.zeros((batch, size, size, 3), device=device))
    return ctx


def fold(params: Dict[str, torch.Tensor], pairs) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """{conv: (weight, bias)} with each BN's affine and running statistics
    folded in: ``s = gamma / sqrt(var + eps)``, ``w s``, ``(b - mean) s + beta``."""
    out = {}
    for c, (bn, eps) in pairs.items():
        s = params[f"{bn}.weight"] / torch.sqrt(params[f"{bn}.running_var"] + eps)
        b = params.get(f"{c}.bias")
        b = torch.zeros_like(s) if b is None else b
        out[c] = (params[f"{c}.weight"] * s.reshape(-1, 1, 1, 1),
                  (b - params[f"{bn}.running_mean"]) * s + params[f"{bn}.bias"])
    return out


def residual_closers(model: str):
    """The BatchNorms that close a residual branch (their output is added
    to the shortcut): EfficientNet's ``project_bn`` of the blocks that keep
    their shape, ResNet-50's ``bn3``, ReDWeb's ``u0_bn2`` / ``u1_bn2``."""
    family, variant = FAMILIES[model]
    if family == "effnet":
        return {f"encoder.{name}.project_bn" for name, cin, cout, _, _, st, _, _ in
                _blocks(variant)[0] if st == 1 and cin == cout}
    names = {n.rsplit(".", 1)[0] for n, *_ in spec(model, 1, 64, device="cpu").spec}
    return {n for n in names if n.endswith((".bn3", ".u0_bn2", ".u1_bn2"))}


def frozen(name: str, kind: str, freeze_encoder: bool) -> bool:
    """The configurations' freeze rule: with a frozen encoder only its
    BatchNorm affine parameters train; running statistics never do."""
    if kind in ("bn_mean", "bn_var"):
        return True
    return freeze_encoder and name.startswith("encoder.") and kind in ("conv", "bias")
