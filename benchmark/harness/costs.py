"""Operations and bytes from shapes: the yardstick of the ``mfu.*`` and
``*_roofline.*`` metrics. They count the work the algorithm needs, whatever
runs it, from the reference's convolution records (reference/nets.py spec
mode); nothing here looks inside the program's kernels.

Peaks (one NVIDIA H100 SXM, NVIDIA's data sheet, dense, at 700 W): 989
TFLOP/s bf16, 1,979 TOP/s int8, 67 TFLOP/s float32 outside the tensor
cores, 3.35 TB/s of HBM."""

from __future__ import annotations

import math
from typing import Dict, List

from benchmark.reference import nets

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12
HBM_BYTES_PER_S = 3.35e12


def convs(model: str, batch: int, size: int) -> List[dict]:
    """The reference's convolution records at (batch, size, size) images.
    At a multiple of 64 every level's size is the 64-pixel forward's times
    size / 64 (SAME and the stem's pad keep ceil(h / stride); its top is 2
    pixels, so a 1-pixel record is a squeeze-excite's pooled input and
    keeps its size): a small forward on the CPU serves. Otherwise one on
    the meta device."""
    if size % 64:
        return nets.spec(model, batch, size).convs
    m = size // 64
    out = []
    for c in nets.spec(model, 1, 64, device="cpu").convs:
        c = dict(c, n=batch)
        if c["h"] > 1:
            for k in ("h", "w", "ho", "wo"):
                c[k] *= m
        out.append(c)
    return out


def conv_ops(c: dict) -> float:
    """2 multiply-adds' operations of one convolution's forward."""
    return 2.0 * c["n"] * c["ho"] * c["wo"] * c["cout"] * (c["cin"] // c["groups"]) * c["k"] ** 2


def train_ops(model: str, batch: int, size: int, freeze_encoder: bool) -> float:
    """Operations of one train step's convolutions on ``batch`` images:
    the forward, the input gradient of every conv but the first (whose
    input is the image), and the weight gradient of every trainable conv.
    Recomputation is not counted."""
    total = 0.0
    for i, c in enumerate(convs(model, batch, size)):
        f = conv_ops(c)
        total += f
        if i > 0:
            total += f
        if not nets.frozen(c["name"] + ".weight", "conv", freeze_encoder):
            total += f
    return total


def serve_least_s(model: str, batch: int, size: int) -> float:
    """Least device seconds of one int8 forward of ``batch`` images:
    dense quantization sites at the int8 peak, every other convolution at
    the bf16 peak."""
    s = 0.0
    for c in convs(model, batch, size):
        dense_int8 = c["site"] and c["groups"] == 1
        s += conv_ops(c) / (PEAK_INT8 if dense_int8 else PEAK_BF16)
    return s


def k4_sites(model: str, batch: int, size: int) -> List[dict]:
    """The dense int8 sites of one forward: M, K, N and the input's size."""
    out = []
    for c in convs(model, batch, size):
        if c["site"] and c["groups"] == 1:
            out.append({"m": c["n"] * c["ho"] * c["wo"], "k": c["k"] ** 2 * c["cin"],
                        "n": c["cout"], "in": c["n"] * c["h"] * c["w"] * c["cin"],
                        "window": c["k"] > 1 or c["stride"] > 1})
    return out


def k4_least_s(model: str, batch: int, size: int) -> float:
    """Least device seconds of K4 over one forward's dense sites: each site
    max(bytes / HBM, ops / int8 peak), its int8 input read once (in place),
    the weight, scales and bias read once, the bf16 output written once."""
    s = 0.0
    for t in k4_sites(model, batch, size):
        m, k, n = t["m"], t["k"], t["n"]
        nbytes = (min(t["in"], m * k) if t["window"] else m * k) + k * n + 8 * n + 4 + 2 * m * n
        s += max(nbytes / HBM_BYTES_PER_S, 2.0 * m * k * n / PEAK_INT8)
    return s


def k1_least_s(lists: int, k: int) -> float:
    """Least device seconds of the fused K1 forward and backward over
    ``lists`` ranking lists of ``k`` pixels (f32): forward reads the
    rankings and the gathered scores and writes lse and the sorted indices;
    backward reads them again and scatters the gradient; a comparison sort
    and ~12 f32 operations an element forward, ~14 backward. The zero fill
    of the gradient map is not K1's."""
    fwd_b, fwd_o = 20 * lists * k + 4 * lists + 4, lists * k * (math.log2(max(k, 2)) + 12)
    bwd_b, bwd_o = 16 * lists * k + 4, 14 * lists * k
    return sum(max(b / HBM_BYTES_PER_S, o / PEAK_F32) for b, o in ((fwd_b, fwd_o),
                                                                    (bwd_b, bwd_o)))


def summary(model: str, batch: int, size: int, freeze_encoder: bool, rpi: int,
            k: int, world: int = 1) -> Dict[str, float]:
    """A train step's operations over the global ``batch``, and K1's least
    time a step on one of ``world`` ranks (its ``batch // world`` rows)."""
    return {"train_ops_per_step": train_ops(model, batch, size, freeze_encoder),
            "k1_least_s_per_step": k1_least_s(batch // world * rpi, k)}
