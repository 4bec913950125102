#!/usr/bin/env python3
"""Drive pldepth_torch on one CUDA card and check it.

    python3 chip_smoke.py [--out PATH]

Phases (any failure exits non-zero):
  1. build the CUDA kernels from pldepth_torch/csrc with nvcc (sm_90a);
     log ptxas's registers, shared memory and spills per kernel and the
     tensor-core instructions (HMMA / HGMMA) in K2's and K3's SASS
     (cuobjdump), failing if a bf16 expand or project kernel holds none
     or a K1 kernel uses a stack frame or spills;
     print the card's name and power limit;
  2. K2 (fused MBConv) against its plain PyTorch version at the 16 shapes
     the ff_effnet (EfficientNet-B0) encoder gives it at 448^2, batch 2,
     bf16 and f32, seeded inputs, randomised BN statistics, TF32 off;
  3. the serving slice: seeded ff_effnet weights saved and reloaded in the
     JAX package's npz layout, then serve.pipeline.run_pipeline over 4
     batches of 8 seeded 448^2 images with Trainer.jit_predict(fused=True);
     32 finite (448, 448) depth maps, 16 K2 launches per forward,
     predict_fused vs predict, and the f32 model vs the TF golden at 96^2;
  4. times: served images/s through the pipeline; ms per batch of
     predict_fused and predict (CUDA events); K2 per block shape as device
     time (profiler windows) beside its plain version, the cuDNN
     composition of the predict_bnfold graph's block and its bound (bytes,
     tensor flops at the bf16 peak, CUDA-core flops at the f32 peak; also
     with g written and read back); a torch.profiler kernel breakdown of
     predict_fused and the device's idle share;
  5. K1: the sorted ListMLE NLL (forward and backward) against its plain
     PyTorch version in f32 at K in {3, 5, 25, 128, 500} x N in {1, 257,
     3200}, at every (N, K) the training phases give it (read from their
     configs), and on a list whose scores spread by more than 87; the fused
     ranking loss (gather, label sort, NLL, mean; the gradient map) against
     ranking_loss_plain at the same (N, K), K = 1 and 12800 lists of K 10 on
     448^2 maps, clean (ties, collisions, ragged N) and with faults (NaN
     labels, out-of-range and negative indices, the spread > 87 list);
  6. the training slice: configs/ff_effnet_448.json at batch 32 (448^2,
     K=5, RPI=100, info_score, frozen encoder, bf16) on a seeded synthetic
     448^2 set through Trainer.fit, 20 steps with validation: finite
     losses, fused K1 forward launches == steps + val batches and backward
     launches == steps, frozen encoder convs bitwise unchanged, every BN's
     affine and running statistics moved, and the fixed-rankings loss of a
     batch trained on repeatedly falls;
  7. training times: ms per train step (CUDA events, rounds alternating
     the fused K1 loss with the plain one), train images/s through fit,
     peak device memory, the device idle share of a 3-step profiler window
     with the top kernels; K1 at (N, K) in K1_TIME_SHAPES: the sorted and
     the fused kernels as device time and per call with the host, beside
     the plain versions, the unfused chain, the bounds and an empty kernel's
     launch; the thread / warp layout sweep over K; the loss path of one
     step alone (pl_ranking_loss and its gradient at ff_effnet batch 32
     and ff_redweb batch 4): device time, launches and host time against
     the unfused chain, gated to the fused forward, one fill and the fused
     backward;
  8. K4 (the int8 tensor-core matmul and its window read in place) and the
     int8 serving path: K4 against its plain PyTorch version at the 38 dense
     int8 sites of ff_effnet at 448^2, batch 8, each through the entry point
     the graph takes (a window site from a seeded NHWC int8 input against
     im2col + the plain product): f32 out bit-equal without an activation
     (rtol = atol = 1e-5 with swish), bf16 out within one bf16 ulp; extras
     with swish / relu and ragged M, N, K, and ragged windows (odd H and W,
     Cin 3 / 24 / 40, 3x3 stride 2, 7x7 stride 2 pad 3, 1x1 stride 2); then
     seeded synth_weight weights with randomised BN statistics, calibrated
     on the first batch of 8 seeded 448^2 images, serve 4 batches through
     run_pipeline with Trainer.jit_predict("quant"): 32 finite maps, 38 K4
     launches per forward of which 6 window reads, no im2col_same call on
     the card's route, predict_quant vs predict_bnfold (rel < 0.15,
     pearson > 0.98), predict_bnfold vs predict (bf16 rel <= 3e-2; f32 at
     96^2 rel <= 2e-5), and the K4 route vs the plain route of
     predict_quant (rel <= 1e-2);
  9. serving times of the four modes: served images/s in "quant" mode
     through the pipeline, ms per batch of predict_quant, predict_bnfold,
     predict and predict_fused (alternating rounds), the calibration time,
     a profiler breakdown of predict_quant with the device's idle share,
     and K4 per site shape beside its plain version, the bound of the work
     in place (and with the input im2col'd), and the library yardstick
     im2col + torch._int_mm + a torch epilogue with the im2col's share,
     totals per forward (K4 must beat the yardstick's total);
 10. K3 (the banded MBConv) at the four B0 stage-2/3 blocks at 448^2, batch
     8, whole blocks: against its plain version (the band algorithm) and
     against K2 on the same inputs (bf16 bit-equal), bf16 and f32, at the
     default band and a smaller divisor, one launch per call; the path run
     (the four blocks, counts from 0); then per block K3's device time per
     pass beside the plain passes' and the bound, and per call beside K2's
     (profiler windows that hold every kernel);
 11. ff_redweb training: configs/ff_redweb_448.json (448^2, batch 4, K=5,
     RPI=100, thresholded sampling, SGDR, frozen encoder, bf16) through
     Trainer.fit on a seeded synthetic set with phase 6's gates; ms per
     step at batch 4 and 32 with peak memory, idle share and top kernels;
 12. ff_redweb serving: seeded synth_weight weights with randomised BN
     statistics, 4 batches of 8 at 448^2 through run_pipeline in the
     default mode (bn_fold): 32 finite maps; predict_bnfold and predict in
     bf16 each against the f32 graph (rel <= 3e-2, at two seeds of BN
     statistics; their distance and a wrong-eps fold's recorded),
     predict_bnfold vs predict in f32 at 96^2 (rel <= 2e-5, and a wrong-eps
     fold must fail it); the f32 model against the TF
     golden at 96^2 (infer rel < 5e-5, train rel < 5e-4); --quantize int8:
     K4 against its plain version at every ff_redweb site shape, 4 int8
     batches through run_pipeline with 96 K4 launches per forward (42
     window reads, no im2col_same call), the K4 route vs the plain route
     (rel <= 1e-2), quant vs bn_fold recorded; ms per batch of
     predict_bnfold, predict and predict_quant, served images/s, the idle
     shares of predict_bnfold and predict_quant, and K4 per site shape as
     in phase 9.
The line before the last is the {"kernels": [...]} record; the last is
{"ok": true, "device": {...}}. ``--out`` also writes every number as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
# dense bf16 tensor / f32 non-tensor / dense int8 tensor
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}
BATCH_CHECK, BATCH_SERVE, SIZE = 2, 8, 448
# max|d| / max|ref|; bf16 measured at most 2.9e-3 over the 16 B0 shapes
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# K1 vs its plain version, f32: the same recurrences in another order; the
# rounding of a sum of K terms grows with K (measured at most 8.1e-6 of
# max|ref| at K=500, 1.1e-6 at K<=25); max|d| <= K1_ATOL + K1_RTOL * max|ref|
K1_RTOL, K1_ATOL = 3e-5, 1e-5
K1_SHAPES = [(n, k) for k in (3, 5, 25, 128, 500) for n in (1, 257, 3200)]
# K1 timed at the main path's (ff_effnet batch 32, ff_redweb batch 4, RPI
# 100, K 5), at 12800 lists of K 10, and at K 500
K1_TIME_SHAPES = [(3200, 5), (400, 5), (12800, 10), (3200, 500)]
K1_MAIN = "3200x5"  # the kernels line's K1 rows: ff_effnet's train step at batch 32
LOSS_PATHS = (("ff_effnet", 32), ("ff_redweb", 4))  # (model, batch) at 448^2, RPI 100, K 5
EFFNET_CONFIG, REDWEB_CONFIG = "ff_effnet_448.json", "ff_redweb_448.json"
BATCH_TRAIN, N_TRAIN, N_VAL, EPOCHS = 32, 64, 32, 10  # 2 steps + 1 val batch per epoch
K4_TOL = 1e-5  # f32 out: rtol = atol (tests/test_quantize.py:135)
K4_SITES = 38  # dense int8 sites of one ff_effnet forward
K4_SITES_REDWEB = 96  # of one ff_redweb forward: 53 encoder, 43 decoder
# of which read a window in place (k > 1 or stride 2): ff_effnet's stem and
# five decoder 3x3s; ff_redweb's 7x7 stem, 35 3x3s and 6 downsampling 1x1s
K4_WINDOWS, K4_WINDOWS_REDWEB = 6, 42
SPIN_KERNELS = 8  # opening each profiler window (kernel_window)
K3_BLOCKS = ("stage2_block0", "stage2_block1", "stage3_block0", "stage3_block1")
# K4 with an activation, and ragged M (not a multiple of 64), N (not of 16)
# and K (not of 4 or of 64): (M, K, N, act)
K4_EXTRA = [(6272, 480, 112, "swish"), (25088, 240, 40, "relu"), (997, 27, 5, None),
            (1000, 250, 37, "swish"), (129, 70, 70, "relu"), (65, 4, 33, None)]
# ragged window reads: (batch, H, W, Cin, Cout, window, stride, padding, act);
# odd and even sizes at stride 2, Cin 3 / 24 / 40, the 7x7 pad-3 stem, 1x1
# stride 2, odd Cout
K4_CONV_EXTRA = [(2, 57, 43, 3, 16, 3, 2, None, "swish"), (2, 56, 44, 3, 32, 3, 2, None, None),
                 (2, 56, 44, 24, 40, 3, 2, None, "relu"), (2, 33, 31, 40, 24, 3, 1, None, "swish"),
                 (2, 33, 31, 64, 48, 1, 2, None, None), (2, 34, 32, 64, 48, 1, 2, None, "relu"),
                 (2, 45, 51, 3, 64, 7, 2, 3, "relu"), (2, 44, 52, 3, 64, 7, 2, 3, None),
                 (3, 15, 17, 128, 37, 7, 2, 3, None), (1, 5, 5, 16, 8, 3, 1, None, None)]


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``reps`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_name(mangled: str) -> str:
    """``expand_dw_bf16_kernel<5, 1>`` from its mangled name: the
    length-prefixed names of ``_ZN...`` read in turn up to the one ending in
    ``_kernel``, then its template arguments."""
    pos = 3 if mangled.startswith("_ZN") else 0
    while pos < len(mangled):
        m = re.match(r"\d+", mangled[pos:])
        if not m:
            break
        start = pos + m.end()
        ident = mangled[start:start + int(m.group())]
        pos = start + len(ident)
        if ident.endswith("_kernel"):
            rest = mangled[pos:]
            k = re.match(r"I((?:Li\d+E)+)", rest)
            arg = (", ".join(re.findall(r"Li(\d+)E", k.group(1))) if k
                   else "bf16" if rest.startswith("I13__nv_bfloat16")
                   else "f32" if rest.startswith("If") else "")
            return ident + (f"<{arg}>" if arg else "")
    return mangled[:60]


def compiled_code(reports):
    """Phase 1: what nvcc made of the kernels: ptxas's registers, shared
    memory and spills per kernel (of the libraries compiled now), and for
    K2 and K3 the tensor-core instructions (HMMA / HGMMA) in each kernel's
    SASS, from cuobjdump where the toolkit has it. Fails if a bf16 expand or
    project kernel of K2 or K3 holds none."""
    import shutil

    from pldepth_torch.ops import _build

    rec = {"ptxas": {}, "sass": {}}
    for lib, rep in reports.items():
        fn = None
        for line in rep.splitlines():
            if "Compiling entry function" in line:
                fn = kernel_name(line.split("'")[1])
            elif fn and ("registers" in line or "spill" in line):
                text = line.replace("ptxas info    :", "").strip()
                rec["ptxas"].setdefault(f"{lib}:{fn}", []).append(text)
                log(f"ptxas {lib} {fn}: {text}")
    # K1 keeps its lists in registers and shared memory: no stack, no spill
    local = [f"{key}: {text}" for key, lines in rec["ptxas"].items() if key.startswith("listmle:")
             for text in lines if re.search(r"[1-9]\d* bytes (stack frame|spill)", text)]
    if local:
        fail(f"K1 kernels use local memory: {local}")
    tool =os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    tool = tool if os.path.exists(tool) else shutil.which("cuobjdump")
    if tool is None:
        log("SASS: cuobjdump not found; tensor-core instructions not checked")
        return rec
    for lib in ("fused_mbconv", "banded_mbconv"):
        out = subprocess.run([tool, "--dump-sass", str(_build.library_path(lib))],
                             capture_output=True, text=True, timeout=120).stdout
        fn = None
        for line in out.splitlines():
            if "Function :" in line:
                fn = kernel_name(line.split("Function :")[1].strip())
                rec["sass"][f"{lib}:{fn}"] = {"HMMA": 0, "HGMMA": 0}
            elif fn is not None:
                for op in ("HGMMA", "HMMA"):
                    if f" {op}." in line or f" {op} " in line:
                        rec["sass"][f"{lib}:{fn}"][op] += 1
                        break
    for key, ops in rec["sass"].items():
        log(f"SASS {key}: HMMA {ops['HMMA']}, HGMMA {ops['HGMMA']}")
        if "bf16" in key and ("expand" in key or "project" in key) and not sum(ops.values()):
            fail(f"{key}: no tensor-core instruction in its SASS")
    return rec


def randomise_bn(module, seed: int) -> None:
    """Seeded BN statistics and affine, so the fold matters."""
    import numpy as np
    import torch

    from pldepth_torch.models.layers import BatchNorm

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, BatchNorm):
                n = m.weight.numel()
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.2, n).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32)))
                m.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.2, n).astype(np.float32)))
                m.running_var.copy_(torch.from_numpy(np.exp(rng.normal(0, 0.2, n)).astype(np.float32)))


def block_cost(plan, batch: int, dtype: str):
    """What the block must move and do: (bytes, tensor flops, CUDA-core
    flops, g bytes). Bytes: read x, the weights and the affine vectors
    once, write y once. Tensor flops: the expand and the project products.
    CUDA-core flops: the depthwise, the SE pool and the SE MLP, which have
    no tensor-core form here. g bytes: the depthwise output once, which a
    design that writes g and reads it back moves twice more."""
    p = plan.params
    es = 2 if dtype == "bfloat16" else 4
    h, w = plan.in_hw
    cin = p.we.shape[0] if p.we is not None else p.dw.shape[-1]
    ce, cse, cout = p.dw.shape[-1], p.se_w1.shape[-1], p.wp.shape[-1]
    ho, wo = -(-h // plan.stride), -(-w // plan.stride)
    mats = sum(t.numel() for t in (p.we, p.dw, p.se_w1, p.se_w2, p.wp) if t is not None)
    vecs = sum(t.numel() for t in (p.e_scale, p.e_shift, p.d_scale, p.d_shift,
                                   p.se_b1, p.se_b2, p.p_scale, p.p_shift) if t is not None)
    nbytes = es * (batch * h * w * cin + batch * ho * wo * cout + mats) + 4 * vecs
    tensor = 2 * batch * ((h * w * cin * ce if p.we is not None else 0) + ho * wo * ce * cout)
    cuda = 2 * batch * (ho * wo * ce * plan.kernel ** 2 + ho * wo * ce + 2 * ce * cse)
    return nbytes, tensor, cuda, es * batch * ho * wo * ce


def swish_sfu_ms(plan, batch: int) -> float:
    """The swishes of the block (the expand's at the input size, the
    depthwise's at the output size) on the special-function units: an exp2
    and a reciprocal each, at an eighth of the f32 FMA rate (sm_90 retires
    16 such results a clock an SM against 128 FMAs). Not a term of the
    bound, which counts flops; logged beside it."""
    p = plan.params
    h, w = plan.in_hw
    ho, wo = -(-h // plan.stride), -(-w // plan.stride)
    ce = p.dw.shape[-1]
    n = batch * ce * ((h * w if p.we is not None else 0) + ho * wo)
    return 2 * n / (PEAK_FLOPS["float32"] / 2 / 8) * 1e3


def mbconv_bound(nbytes: float, tensor: float, cuda: float):
    """(bound ms, what bounds it, {term: ms}): the larger of the bytes at
    the memory rate, the tensor flops at the bf16 tensor-core peak and the
    CUDA-core flops at the f32 peak."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
             "tensor": tensor / PEAK_FLOPS["bfloat16"] * 1e3,
             "cuda_core": cuda / PEAK_FLOPS["float32"] * 1e3}
    by = max(terms, key=terms.get)
    return terms[by], ("bytes" if by == "bytes" else "operations"), terms


def block_inputs(calls, plans, batch: int, dtype, seed: int):
    """Seeded inputs of K2 at each block's shape (a tap block's K2 input is
    its expand activation, Ce channels)."""
    import numpy as np
    import torch

    out = []
    for i, ((_, p, _), plan) in enumerate(zip(calls, plans)):
        c = p.dw.shape[-1] if p.we is None else p.we.shape[0]
        x = np.random.default_rng(seed + i).normal(size=(batch, *plan.in_hw, c))
        out.append(torch.from_numpy(x.astype(np.float32)).to("cuda", dtype))
    return out


def k2_calls(plans):
    """K2's (params, kwargs) per block, in the form the encoder launches it."""
    calls = []
    for plan in plans:
        p = plan.params
        if plan.tap is not None:  # tap block: K2 runs the tail on the tap
            p = p._replace(we=None, e_scale=None, e_shift=None)
        calls.append((plan.name, p, dict(kernel=plan.kernel, stride=plan.stride,
                                          residual=plan.residual and plan.tap is None)))
    return calls


def composition(blk, tap: bool):
    """The cuDNN and torch-op composition of the call K2 makes for one
    block: the predict_bnfold graph's block module (BN folded into biased
    convs; a tap block from its depthwise on, as K2 runs it)."""
    from pldepth_torch.models.layers import swish

    if tap:
        return lambda h: blk.project_conv(blk.se(swish(blk.dw_conv(h))))
    return lambda x: blk(x)[0]


def k2_times(trainer, state, smi: str, reps: int = 10):
    """Phase 4: per B0 block at 448^2, batch 8, bf16, as device time
    (profiler kernel durations over windows whose launch counts are
    checked, device_ms): K2 (its three launches), its plain version and the
    cuDNN composition of the predict_bnfold graph's block; K2 per call with
    the host launching back to back (CUDA events); the bound of the work
    (mbconv_bound: bytes, tensor flops at the bf16 peak, CUDA-core flops at
    the f32 peak), the bound of K2's design (g written and read back), the
    bound reckoned with every flop at the tensor peak (the earlier
    reckoning) and the swishes' time on the special-function units."""
    import torch

    from pldepth_torch.ops import fused_mbconv as k2

    plans = trainer._plan(state.model, (SIZE, SIZE))
    calls = k2_calls(plans)
    xs = block_inputs(calls, plans, BATCH_SERVE, torch.bfloat16, seed=200)
    folded = trainer._folded_model(state.model).encoder
    rows = []
    keys = ("ms", "plain_ms", "composition_ms", "call_ms", "bound_ms", "design_bound_ms",
            "old_bound_ms", "bytes_ms", "tensor_ms", "cuda_core_ms", "sfu_ms")
    tot = dict.fromkeys(keys, 0.0)
    for plan, (name, p, kw), x in zip(plans, calls, xs):
        fn = lambda: k2.fused_mbconv_infer(x, p, **kw)  # noqa: E731
        comp = composition(getattr(folded, name), plan.tap is not None)
        with torch.inference_mode():
            y = fn().float()
            rel = float((comp(x).float() - y).abs().max() / y.abs().max())
            comp_ms = device_ms(lambda: comp(x), reps, f"cuDNN composition {name}")
        nbytes, tensor, cuda, gbytes = block_cost(plan._replace(params=p), BATCH_SERVE,
                                                  "bfloat16")
        bound, by, terms = mbconv_bound(nbytes, tensor, cuda)
        row = {"block": name, "x": list(x.shape), "kernel": kw["kernel"], "stride": kw["stride"],
               "ms": device_ms(fn, reps, f"K2 {name}", per_call=3),
               "plain_ms": device_ms(lambda: k2.mbconv_infer_plain(x, p, **kw), reps,
                                     f"K2 plain {name}"),
               "composition_ms": comp_ms, "composition_rel": rel,
               "call_ms": cuda_ms(fn, reps=reps),
               "bytes": nbytes, "tensor_flops": tensor, "cuda_flops": cuda, "g_bytes": gbytes,
               "bound_ms": bound, "bound_by": by, "bytes_ms": terms["bytes"],
               "tensor_ms": terms["tensor"], "cuda_core_ms": terms["cuda_core"],
               "design_bound_ms": mbconv_bound(nbytes + 2 * gbytes, tensor, cuda)[0],
               "old_bound_ms": max(terms["bytes"],
                                   (tensor + cuda) / PEAK_FLOPS["bfloat16"] * 1e3),
               "sfu_ms": swish_sfu_ms(plan._replace(params=p), BATCH_SERVE)}
        rows.append(row)
        for key in keys:
            tot[key] += row[key]
        log(f"K2 {name:14s} x{tuple(x.shape)} k{kw['kernel']} s{kw['stride']}: "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, cuDNN composition "
            f"{comp_ms:.4f} ms (rel {rel:.2e} from K2), per call with the host "
            f"{row['call_ms']:.4f} ms; bound {bound:.4f} ms ({by}; bytes {terms['bytes']:.4f}, "
            f"tensor {terms['tensor']:.4f}, CUDA cores {terms['cuda_core']:.4f}), with the g "
            f"round trip {row['design_bound_ms']:.4f} ms; swish on the SFU {row['sfu_ms']:.4f} ms "
            f"[{smi}]")
    slower = [r["block"] for r in rows if r["ms"] >= r["composition_ms"]]
    tot["bound_by"] = ("bytes" if tot["bytes_ms"] >= max(tot["tensor_ms"], tot["cuda_core_ms"])
                       else "operations")
    tot["slower_than_composition"] = slower
    log(f"K2 per forward (16 blocks, batch {BATCH_SERVE}, device time): {tot['ms']:.3f} ms, "
        f"plain {tot['plain_ms']:.3f} ms, cuDNN composition {tot['composition_ms']:.3f} ms; "
        f"bound {tot['bound_ms']:.4f} ms (bytes {tot['bytes_ms']:.4f}, tensor "
        f"{tot['tensor_ms']:.4f}, CUDA cores {tot['cuda_core_ms']:.4f}), with the g round "
        f"trip {tot['design_bound_ms']:.4f} ms, swish on the SFU {tot['sfu_ms']:.4f} ms, with "
        f"every flop at the tensor peak {tot['old_bound_ms']:.4f} ms; per call with the host "
        f"{tot['call_ms']:.3f} ms; "
        f"blocks where K2 does not beat the composition: {slower or 'none'} [{smi}]")
    return rows, tot


def k1_cost(n: int, k: int):
    """(bytes, ops) of K1 forward and backward on (n, k) f32 lists: each
    input read once, each output written once; ~8 f32 operations per
    element of the forward recurrence, ~11 of the backward one."""
    fwd = (4 * (2 * n * k + n), 8 * n * max(k - 1, 1))
    bwd = (4 * (3 * n * k + n), 11 * n * k)
    return fwd, bwd


def bound_ms(nbytes: float, ops: float, peak: float):
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def load_config(name: str):
    """An ExperimentConfig from configs/ beside this script."""
    from pldepth_torch.core.config import ExperimentConfig

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "configs", name)) as f:
        return ExperimentConfig.from_json(f.read())


def k1_path_shapes():
    """(N, K) of the K1 calls of the training phases: batch x rankings per
    image (train steps) and batch x val rankings per image (validation), for
    phase 6 (ff_effnet at BATCH_TRAIN) and phase 11 (ff_redweb at its
    config's batch through fit, and at BATCH_TRAIN in its timed steps)."""
    shapes = set()
    for config, batches in ((EFFNET_CONFIG, (BATCH_TRAIN,)), (REDWEB_CONFIG, (None, BATCH_TRAIN))):
        cfg = load_config(config)
        for b in batches:
            b = b or cfg.batch_size
            shapes |= {(b * r, cfg.ranking_size) for r in (cfg.rankings_per_image, cfg.val_rpi)}
    return sorted(shapes)


def check_k1(device="cuda"):
    """Phase 5: K1 against its plain version at every listed (N, K), at
    every training phase's (N, K), and on the spread > 87 list. Returns
    (checks, max|d| forward, max|d| backward)."""
    import numpy as np
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    def one(name, s, g):
        nll, lse = k1.listmle_fwd(s)
        ds = k1.listmle_bwd(s, lse, g)
        if s.is_cuda:
            torch.cuda.synchronize()
        want_nll, want_lse = k1.listmle_fwd_plain(s)
        want_ds = k1.listmle_bwd_plain(s, want_lse, g)
        row = {"case": name, "n": s.shape[0], "k": s.shape[1]}
        for key, got, want in (("nll", nll, want_nll), ("lse", lse, want_lse), ("ds", ds, want_ds)):
            if not torch.isfinite(got).all():
                fail(f"K1 {name}: non-finite {key}")
            err = float((got - want).abs().max())
            ref = float(want.abs().max())
            row[key] = {"max_abs_err": err, "rel": err / max(ref, 1e-12)}
            if err > K1_ATOL + K1_RTOL * ref:
                fail(f"K1 {name} {key} disagrees with its plain version: max|d| {err:.3e} "
                     f"(max|ref| {ref:.3e})")
        log(f"K1 vs plain {name:18s} nll max|d| {row['nll']['max_abs_err']:.3e} rel "
            f"{row['nll']['rel']:.3e}; lse {row['lse']['max_abs_err']:.3e}; ds max|d| "
            f"{row['ds']['max_abs_err']:.3e} rel {row['ds']['rel']:.3e} "
            f"(tol {K1_ATOL:g} + {K1_RTOL:g} max|ref|)")
        return row, nll, ds

    checks = []
    for n, k in K1_SHAPES + [s for s in k1_path_shapes() if s not in K1_SHAPES]:
        rng = np.random.default_rng(1000 * k + n)
        s = torch.from_numpy((rng.normal(size=(n, k)) * 3).astype(np.float32)).to(device)
        g = torch.from_numpy(rng.uniform(0.5, 1.5, n).astype(np.float32)).to(device)
        checks.append(one(f"N={n} K={k}", s, g)[0])
    spread = torch.tensor([[0.0, -50.0, -120.0], [5.0, -100.0, -230.0]], device=device)
    row, nll, ds = one("spread>87", spread, torch.ones(2, device=device))
    if float(nll.abs().max()) > 1e-6 or float(ds.abs().max()) > 1e-4:
        fail(f"K1 spread>87 list: nll {nll.tolist()} ds max {float(ds.abs().max()):.3e}")
    checks.append(row)
    return (checks, max(c[key]["max_abs_err"] for c in checks for key in ("nll", "lse")),
            max(c["ds"]["max_abs_err"] for c in checks))


def k1_batch(n: int) -> int:
    """Images of a (N lists) check: 32 as phase 6 and 4 as phase 11 give
    them, else as many as divide N (at most 32)."""
    return 4 if n == 400 else math.gcd(n, BATCH_TRAIN)


def ranking_case(n: int, k: int, faults: bool, size: int = SIZE, seed: int = 0,
                 device="cuda"):
    """(map (B, size^2), rankings (B, N / B, K, 2)) for a phase-5 check:
    depths rounded to 1/255 (ties), every other list drawing its pixels from
    a pool of 16 (repeats inside and across lists). With ``faults``: a NaN
    label in every 5th list, in every 7th list one index from -1 (wraps to
    the last pixel), -size^2 (wraps to 0), -size^2 - 1, size^2, 1e9 (out:
    NaN, no gradient), NaN (reads 0, as XLA converts it) and -2.7 (wraps),
    and list 0 in label order on scores 60 apart (a spread > 87: its NLL is
    ~1e-26)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed + 7 * n + k)
    b, p = k1_batch(n), size * size
    rpi = n // b
    pred = rng.normal(size=(b, p)).astype(np.float32) * 3
    idx = rng.integers(0, p, size=(n, k)).astype(np.float32)
    pool = rng.integers(0, p, size=16)
    idx[1::2] = pool[rng.integers(0, 16, size=idx[1::2].shape)]
    labels = (np.round(rng.uniform(0.05, 1.0, (n, k)) * 255) / 255).astype(np.float32)
    if faults:
        labels[::5, rng.integers(0, k)] = np.nan
        bad = np.array([-1, -p, -p - 1, p, 1e9, np.nan, -2.7], np.float32)
        idx[3::7, rng.integers(0, k)] = bad[np.arange(len(idx[3::7])) % len(bad)]
        if k >= 2:  # list 0: pixels p-1 ... p-k of image 0, 60 apart, in label order
            idx[0] = p - 1 - np.arange(k)
            labels[0] = np.arange(k, 0, -1)
            pred[0, p - k:] = -60.0 * np.arange(k)[::-1]
    rankings = np.stack([idx, labels], -1).reshape(b, rpi, k, 2)
    return (torch.from_numpy(pred).to(device),
            torch.from_numpy(rankings.astype(np.float32)).to(device))


def nan_close(what: str, got, want, atol: float = K1_ATOL, rtol: float = K1_RTOL):
    """max|d| over the finite reference, after requiring NaN exactly where
    the reference is NaN; fails beyond atol + rtol * max|ref|."""
    import torch

    got, want = got.float(), want.float()
    gn, wn = torch.isnan(got), torch.isnan(want)
    if not torch.equal(gn, wn):
        fail(f"{what}: NaN at {int(gn.sum())} places, the plain version at {int(wn.sum())}")
    fin = ~wn
    if not bool(fin.any()):
        return 0.0, 0.0
    err = float((got[fin] - want[fin]).abs().max())
    ref = float(want[fin].abs().max())
    if not err <= atol + rtol * ref:
        fail(f"{what} disagrees with its plain version: max|d| {err:.3e} (max|ref| {ref:.3e}, "
             f"tol {atol:g} + {rtol:g} max|ref|)")
    return err, ref


def check_ranking_loss(device="cuda", size: int = SIZE):
    """Phase 5: the fused K1 forward and backward against the plain loss
    (``ranking_loss_plain`` and its autograd gradient) at every (N, K) of
    K1_SHAPES and the training phases, at K = 1 and at 12800 lists of K 10,
    on 448^2 maps, clean (ties, collisions, ragged N) and with faults (NaN
    labels, out-of-range and negative indices, the spread > 87 list).
    Per-list NLL, loss and lse within K1_ATOL + K1_RTOL max|ref| with NaN
    where the reference is NaN, the sorted indices equal; the gradient map
    (for a cotangent of N, so its entries are O(1)) within the same bound:
    pixels that several lists share are summed in the atomics' order on
    the card and in scatter_add's on the plain path. Returns (checks,
    max|d| forward, max|d| backward)."""
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    shapes = sorted(set(K1_SHAPES) | set(k1_path_shapes()) | {(257, 1), (12800, 10)})
    checks = []
    for n, k in shapes:
        for faults in (False, True):
            pred, rk = ranking_case(n, k, faults, size, device=device)
            name = f"N={n} K={k}{' faults' if faults else ''}"
            g = torch.tensor(float(n), device=device)
            loss, nll, lse, sidx = k1.ranking_loss_fwd(pred, rk)
            grad = k1.ranking_loss_bwd(pred, lse, sidx, g)
            if pred.is_cuda:
                torch.cuda.synchronize()
            ref_pred = pred.clone().requires_grad_(True)
            want_nll = k1.ranking_nll_plain(ref_pred, rk)
            want_loss = want_nll.mean()
            (want_grad,) = torch.autograd.grad(want_loss, ref_pred, g)
            _, _, want_lse, want_sidx = k1.ranking_loss_fwd_plain(pred, rk)
            if not torch.equal(sidx, want_sidx):
                fail(f"K1 fused {name}: sorted indices differ from the plain version's at "
                     f"{int((sidx != want_sidx).sum())} places")
            row = {"case": name, "n": n, "k": k, "faults": faults,
                   "nan_lists": int(torch.isnan(want_nll).sum())}
            for key, got, want in (("nll", nll, want_nll.detach()), ("loss", loss, want_loss),
                                   ("lse", lse, want_lse), ("grad", grad, want_grad)):
                err, ref = nan_close(f"K1 fused {name} {key}", got, want.detach())
                row[key] = {"max_abs_err": err, "rel": err / max(ref, 1e-12)}
            if faults and abs(float(nll[0])) > 1e-6:
                fail(f"K1 fused {name}: the spread>87 list's NLL is {float(nll[0]):.3e}")
            log(f"K1 fused vs plain {name:24s} nll max|d| {row['nll']['max_abs_err']:.3e}; loss "
                f"{row['loss']['max_abs_err']:.3e}; grad max|d| {row['grad']['max_abs_err']:.3e} "
                f"rel {row['grad']['rel']:.3e}; NaN lists {row['nan_lists']} "
                f"(tol {K1_ATOL:g} + {K1_RTOL:g} max|ref|)")
            checks.append(row)
    return (checks, max(c[key]["max_abs_err"] for c in checks for key in ("nll", "loss", "lse")),
            max(c["grad"]["max_abs_err"] for c in checks))


def train_phase(config: str, size=SIZE, batch=None, n_train=N_TRAIN, n_val=N_VAL,
                epochs=EPOCHS, device="cuda"):
    """Phases 6 and 11: a training config of configs/ through Trainer.fit
    on a seeded synthetic set, at ``batch`` (None: the config's). Returns
    (trainer, state, cfg, record).

    The fixed-rankings probe loss is the inference forward's, except for a
    model with caffe preprocessing (ff_redweb): its encoder BNs see
    caffe-scale inputs (variance ~1e3 at the stem) and their running
    statistics move 1% a step (momentum 0.99), so after a few dozen steps
    the running-statistics forward is still far from the trained one; its
    probe runs the train-mode forward (batch statistics, nothing
    committed)."""
    import numpy as np
    import torch

    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.data.pipeline import BatchIterator, pregenerate_val_rankings, val_batches
    from pldepth_torch.data.preprocess import normalize_images
    from pldepth_torch.models.layers import BatchNorm, TrainPass
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops.listmle import pl_ranking_loss
    from pldepth_torch.train import Trainer

    cfg = load_config(config)
    batch = batch or cfg.batch_size
    cfg = cfg.replace(input_size=size, batch_size=batch, epochs=epochs, dataset="synthetic")
    model_name = cfg.model_name
    t0 = time.time()
    train_ds = SyntheticDepthDataset(n_train, size, seed=0).cached()
    val_ds = SyntheticDepthDataset(n_val, size, seed=1).cached()
    steps_per_epoch = n_train // batch
    trainer = Trainer(cfg, steps_per_epoch, device=device)
    state = trainer.init_state()
    rk = dict(sampler_name="thresholded", rankings_per_image=cfg.val_rpi,
              ranking_size=cfg.ranking_size, threshold=cfg.equality_threshold, seed=cfg.seed,
              device=device)
    val_rankings = pregenerate_val_rankings(val_ds, **rk)
    # a batch the run trains on every epoch, with fixed rankings
    probe = {"image": np.stack([train_ds[i]["image"] for i in range(batch)]),
             "rankings": pregenerate_val_rankings(train_ds.take(batch), **rk)}
    probe_batch_stats = trainer.model.preprocess == "caffe"

    def probe_loss(st):
        if not probe_batch_stats:
            return float(trainer.eval_step(st, probe))
        with torch.no_grad():
            x = normalize_images(torch.as_tensor(probe["image"]).to(device),
                                 trainer.model.preprocess)
            pred = st.model(x, TrainPass())
            return float(pl_ranking_loss(pred, torch.as_tensor(probe["rankings"]).to(device),
                                         impl=cfg.listmle_impl))

    probe_before = probe_loss(state)
    setup_s = time.time() - t0

    model = state.model
    frozen = {n: p.detach().clone() for n, p in model.named_parameters() if not p.requires_grad}
    bns = {n: m for n, m in model.named_modules() if isinstance(m, BatchNorm)}
    bn_before = {n: [t.detach().clone() for t in (m.weight, m.bias, m.running_mean,
                                                  m.running_var)] for n, m in bns.items()}
    n_val_batches = len(val_ds) // batch
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    it = BatchIterator(train_ds, batch, seed=cfg.seed, prefetch=cfg.prefetch_depth)
    k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
    t0 = time.time()
    state, history = trainer.fit(state, it, val_iter_factory=lambda: val_batches(
        val_ds, val_rankings, batch))
    fit_s = time.time() - t0
    launches = {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                "ranking_loss_bwd": k1.ranking_loss_bwd.launches}
    it.close()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 if device == "cuda" else None
    n_steps = state.step
    probe_after = probe_loss(state)

    losses = history["loss"] + history["val_loss"]
    log(f"fit: {n_steps} steps of {model_name} {size}^2 batch {batch} in {fit_s:.2f} s; "
        f"epoch losses {[round(x, 4) for x in history['loss']]}; val "
        f"{[round(x, 4) for x in history['val_loss']]}; fixed-rankings loss of a trained batch "
        f"{probe_before:.4f} -> {probe_after:.4f} ({'batch' if probe_batch_stats else 'running'} "
        f"statistics); K1 launches {launches}")
    if n_steps != epochs * steps_per_epoch or not np.all(np.isfinite(losses)):
        fail(f"training did not run {epochs * steps_per_epoch} finite steps: {history}")
    want_fwd = n_steps + epochs * n_val_batches
    if device == "cuda" and (launches["ranking_loss_fwd"] != want_fwd or
                             launches["ranking_loss_bwd"] != n_steps):
        fail(f"K1 launches {launches}, expected forward {want_fwd} (steps + val batches) "
             f"and backward {n_steps}")
    params = dict(model.named_parameters())
    moved_frozen = [n for n, v in frozen.items() if not torch.equal(params[n], v)]
    if not frozen or moved_frozen:
        fail(f"frozen encoder weights moved: {moved_frozen[:5]} (frozen: {len(frozen)})")
    still = [f"{n}.{t}" for n, m in bns.items()
             for t, old in zip(("weight", "bias", "running_mean", "running_var"), bn_before[n])
             if torch.equal(getattr(m, t), old)]
    if still:
        fail(f"BN tensors that did not move: {still[:8]} ({len(still)} in all)")
    if not probe_after < probe_before:
        fail(f"the fixed-rankings loss of a trained batch did not fall: "
             f"{probe_before:.4f} -> {probe_after:.4f}")
    ips = history["ips"]
    record = {"steps": n_steps, "val_batches": epochs * n_val_batches, "launches": launches,
              "history": history, "probe_loss": [probe_before, probe_after],
              "frozen_tensors": len(frozen), "bn_modules": len(bns), "setup_s": setup_s,
              "fit_s": fit_s, "peak_mem_gb": peak_gb,
              "train_img_per_s_epochs": ips,
              "train_img_per_s": float(np.median(ips[1:] if len(ips) > 1 else ips))}
    return trainer, state, cfg, record


def train_times(trainer, state, cfg, smi: str, device="cuda"):
    """Phase 7: ms per step (rounds alternating the K1 loss with the plain
    loss, CUDA events), the idle share of a profiled 3-step window, and the
    top kernels by device time."""
    import numpy as np
    import torch

    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.train import Trainer

    ds = SyntheticDepthDataset(cfg.batch_size, cfg.input_size, seed=2)
    batch = {k: torch.from_numpy(np.stack([ds[i][k] for i in range(cfg.batch_size)])).to(device)
             for k in ("image", "gt", "mask")}
    plain = Trainer(cfg.replace(listmle_impl="xla"), trainer.steps_per_epoch, device=device)
    box = [state]

    def steps(tr, n):
        for _ in range(n):
            box[0], _m = tr.train_step(box[0], batch)

    samples = {"k1": [], "plain": []}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for r in range(6):
        for name in (("k1", "plain") if r % 2 == 0 else ("plain", "k1")):
            tr = trainer if name == "k1" else plain
            samples[name].append(cuda_ms(lambda: steps(tr, 1), reps=5, warmup=1))
    step_ms = {k: float(np.median(v)) for k, v in samples.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, v in samples.items():
        log(f"train step ({k} loss): {step_ms[k]:.3f} ms per step of {cfg.batch_size} at "
            f"{cfg.input_size}^2 (median of {len(v)} rounds of 5, min {min(v):.3f}, "
            f"max {max(v):.3f}) [{smi}]")

    prof = profile_idle(lambda: steps(trainer, 1), 3, step_ms["k1"], smi, "train step")
    log(f"peak device memory over the timed steps: {peak_gb:.2f} GB [{smi}]")
    return {"step_ms": step_ms, "step_ms_samples": samples, "peak_mem_gb": peak_gb,
            "profile": prof}


def kernel_window(fn, reps: int, spin: int = SPIN_KERNELS):
    """One profiler window of ``reps`` calls of ``fn``, after one call
    outside it: (the profiler's key_averages, {kernel name: device ms per
    call} (host launch gaps excluded), kernels launched in the window).
    The window opens with ``spin`` spin kernels, left out of the result:
    the first launches of a window can go missing."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(spin):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    events = [e for e in averages if e.device_type == DeviceType.CUDA
              and e.self_device_time_total > 0 and "spin_kernel" not in e.key]
    return (averages, {e.key: e.self_device_time_total / 1e3 / reps for e in events},
            sum(e.count for e in events))


def full_windows(fn, reps: int, what: str, per_call=None, n=None, tries=None,
                 fatal: bool = True):
    """{kernel name: device ms per call} of ``n`` profiler windows of
    ``reps`` calls of ``fn`` that hold every kernel it launched. A window
    can come back with kernels missing (seen: a window summing to 0.0 ms; 2
    of 5 launches in six windows running); it then counts fewer launches
    than expected (``per_call`` launches per call, where known) or than the
    fullest window, and is taken again, with twice the spin kernels at its
    head each time. ``n`` defaults to 1 where ``per_call`` is known, else 2
    (two windows that agree). After ``tries`` windows without ``n`` full
    ones (default 12 where it fails, seen: 3 of 6 windows of a K3 block
    short; 6 where the caller falls back) it fails, or returns None where
    ``fatal`` is false."""
    n = n or (1 if per_call else 2)
    tries = tries or (12 if fatal else 6)
    seen = []
    for attempt in range(tries):
        seen.append(kernel_window(fn, reps, SPIN_KERNELS << min(attempt, 4))[1:])
        most = max(c for _, c in seen)
        full = [w for w, c in seen if c == most]
        if len(full) >= n and (per_call is None or most == per_call * reps):
            return full[:n]
    if not fatal:
        log(f"{what}: fewer than {n} of {tries} profiler windows held all its kernels "
            f"(launches per window of {reps} calls: {[c for _, c in seen]})")
        return None
    fail(f"{what}: fewer than {n} of {tries} profiler windows held all its kernels "
         f"(launches per window of {reps} calls: {[c for _, c in seen]}"
         + (f", expected {per_call * reps})" if per_call else ")"))


def graph_ms(fn, reps: int) -> float:
    """Device-timeline time per call of ``fn``: ``reps`` calls captured into
    one CUDA graph and replayed between two events, so the host launches
    nothing in between (a few tenths of a microsecond of gap a kernel
    remain, which the profiler's durations leave out)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, what: str, per_call=None, n=None) -> float:
    """Device time per call of ``fn``: the sum of its kernels' durations,
    the median over full_windows; where the profiler keeps losing launches,
    graph_ms instead (logged)."""
    import numpy as np

    windows = full_windows(fn, reps, what, per_call, n, fatal=False)
    ms = None if windows is None else float(np.median([sum(w.values()) for w in windows]))
    if not ms:  # no full window, or (seen once) full windows that summed to 0
        ms = graph_ms(fn, reps)
        log(f"{what}: timed by CUDA-graph replay instead, {ms:.4f} ms per call")
    return ms


def profile_idle(fn, n: int, unprofiled_ms: float, smi: str, what: str):
    """Device busy time per call of ``fn`` over a profiled window of ``n``
    calls, the idle share against the unprofiled time (the profiler's own
    host overhead stretches the profiled wall), the top kernels."""
    # of two windows the one with the most launches (a window can lose
    # kernels, full_windows; a train step's launch count may vary)
    averages, by_kernel, _ = max((kernel_window(fn, n) for _ in range(2)), key=lambda w: w[2])
    table = averages.table(sort_by="cuda_time_total", row_limit=20)
    kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    idle = 1 - busy / unprofiled_ms
    log(table)
    log(f"profiled {what} x{n}: device busy {busy:.3f} ms per call; unprofiled "
        f"{unprofiled_ms:.3f} ms -> idle share {idle:.3f} [{smi}]")
    for name, ms in kernels[:10]:
        log(f"  top kernel {ms:9.3f} ms/call  {name[:110]}")
    return {"table": table, "device_busy_ms": busy, "idle_share": idle,
            "kernels_ms": dict(kernels),
            "top_kernels": [{"name": k, "ms_per_call": ms} for k, ms in kernels[:15]]}


def alternating_ms(fns, smi: str, what: str, rounds: int = 6, reps: int = 10):
    """Median ms per call of each of ``fns`` (CUDA events, ``rounds``
    rounds of ``reps`` calls, the order reversed every other round: host
    launch overhead makes single timings of many-op forwards noisy).
    Returns (medians, samples)."""
    import numpy as np

    samples = {name: [] for name in fns}
    order = list(fns)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            samples[name].append(cuda_ms(fns[name], reps=reps))
    times = {name: float(np.median(v)) for name, v in samples.items()}
    for name, v in samples.items():
        log(f"{name}: {times[name]:.3f} ms per {what} (median of {len(v)} rounds of {reps}, "
            f"min {min(v):.3f}, max {max(v):.3f}) [{smi}]")
    return times, samples


def serve_maps(predict_fn, chunks, decode, size: int, what: str):
    """Serve ``chunks`` through run_pipeline into a fresh directory; fail
    unless every image gives a finite (size, size) map. Returns (maps,
    seconds the pipeline took)."""
    import numpy as np
    import torch

    from pldepth_torch.serve.pipeline import depth_writer, run_pipeline

    with tempfile.TemporaryDirectory() as tmp:
        write = depth_writer(tmp, save_png=False, stems={f: f for c in chunks for f in c})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_pipeline(chunks, decode, predict_fn, write)
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(tmp))
        want = sum(len(c) for c in chunks)
        if len(files) != want:
            fail(f"{what}: expected {want} depth maps, found {len(files)}")
        for f in files:
            d = np.load(os.path.join(tmp, f))
            if d.shape != (size, size) or not np.isfinite(d).all():
                fail(f"{what} {f}: shape {d.shape} or non-finite values")
    return len(files), wall


def served_img_per_s(predict_fn, decode, chunks, smi: str, what: str, n_e2e: int = 8):
    """Served images/s through the pipeline, warm: ``n_e2e`` batches of the
    decoded ``chunks`` (decode is a lookup here, so this times H2D, the
    forward, D2H and the writes, not image decoding)."""
    batches = [decode(c) for c in chunks] * (n_e2e // len(chunks))
    e2e = [[f"e{b}_{i}" for i in range(len(chunks[0]))] for b in range(n_e2e)]
    index = {c[0]: b for b, c in enumerate(e2e)}
    n, wall = serve_maps(predict_fn, e2e, lambda c: batches[index[c[0]]], SIZE, what)
    log(f"served {n} images through the pipeline (warm, {what}): {n / wall:.1f} img/s, "
        f"{wall * 1e3 / n_e2e:.3f} ms per batch [{smi}]")
    return n / wall


def sorted_k1_times(smi: str, n: int = BATCH_TRAIN * 100, k: int = 5, device="cuda"):
    """The sorted K1 forward and backward at (n, k) beside the plain
    versions, the bound, and one PyTorch call (reverse logcumsumexp
    forward; its autograd backward). ``ms`` is device time per call (the
    profiler's kernel durations); ``call_ms`` the device-timeline time per
    call with the host launching back to back (CUDA events)."""
    import numpy as np
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    rng = np.random.default_rng(7)
    s = torch.from_numpy(rng.normal(size=(n, k)).astype(np.float32)).to(device)
    g = torch.full((n,), 1.0 / n, device=device)
    _, lse = k1.listmle_fwd(s)
    sl = s.clone().requires_grad_(True)
    lib_nll = (torch.logcumsumexp(sl.flip(-1), dim=-1).flip(-1) - sl).sum(-1)
    reps = 200
    out = {}
    (fb, fo), (bb, bo) = k1_cost(n, k)
    for name, fns, (nb, no) in (
        ("listmle_fwd", {"ms": lambda: k1.listmle_fwd(s),
                         "plain_ms": lambda: k1.listmle_fwd_plain(s),
                         "library_ms": lambda: torch.logcumsumexp(s.flip(-1), dim=-1)}, (fb, fo)),
        ("listmle_bwd", {"ms": lambda: k1.listmle_bwd(s, lse, g),
                         "plain_ms": lambda: k1.listmle_bwd_plain(s, lse, g),
                         "library_ms": lambda: torch.autograd.grad(lib_nll, sl, g,
                                                                   retain_graph=True)},
         (bb, bo)),
    ):
        row = {key: device_ms(fn, reps, f"{name} {key}", per_call=1 if key == "ms" else None)
               for key, fn in fns.items()}
        row.update({key.replace("ms", "call_ms"): cuda_ms(fn, reps=reps, warmup=5)
                    for key, fn in fns.items()})
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no, PEAK_FLOPS["float32"])
        row.update(bytes=nb, ops=no)
        out[name] = row
        log(f"{name} N={n} K={k}: device {row['ms'] * 1e3:.2f} us per call, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: {nb} B); per call with "
            f"the host launching back to back: {row['call_ms'] * 1e3:.2f} / "
            f"{row['plain_call_ms'] * 1e3:.2f} / {row['library_call_ms'] * 1e3:.2f} us [{smi}]")
    return out


def kernel_split(fn, reps: int, what: str, per_call: int, match: str, rest=None) -> float:
    """Device ms per call of the kernels of ``fn`` whose names hold
    ``match`` (profiler windows that hold all its launches); where the
    windows keep losing launches, graph_ms of ``fn`` less graph_ms of
    ``rest`` (the other launches alone), logged."""
    windows = full_windows(fn, reps, what, per_call, fatal=False)
    ms = None if windows is None else sum(v for name, v in windows[0].items() if match in name)
    if not ms:
        ms = graph_ms(fn, reps) - (graph_ms(rest, reps) if rest else 0.0)
        log(f"{what}: timed by CUDA-graph replay instead, {ms:.4f} ms per call")
    return ms


def fused_k1_cost(n: int, k: int, b: int, p: int):
    """(bytes, ops) of the fused K1 forward and backward, and the bytes of
    the backward's zero fill of the (b, p) map (stated apart). Forward:
    the rankings (8 N K), the gathered scores (4 N K), lse and the sorted
    indices written (8 N K), nll and the loss; backward: lse and the
    indices read (8 N K), the scores gathered again (4 N K), the scattered
    gradient (4 N K). Operations: a comparison sort's log2 K compares and
    ~12 f32 operations an element forward, ~14 backward."""
    fwd = (20 * n * k + 4 * n + 4, n * k * (math.log2(max(k, 2)) + 12))
    bwd = (16 * n * k + 4, 14 * n * k)
    return fwd, bwd, 4 * b * p


def fused_k1_times(smi: str, n: int, k: int, floor_ms: float, device="cuda", reps: int = 200):
    """The fused K1 forward and backward at (n, k) on 448^2 maps: device
    time per launch (the backward's kernel apart from its zero fill), per
    call with the host launching back to back (``call_ms``, fill
    included), the plain versions, the unfused chain forward and backward as
    the composition yardstick (no single PyTorch call computes the fused
    function), the bound, the empty-kernel floor."""
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    b = k1_batch(n)
    pred, rk = loss_inputs(b, n // b, k, seed=11, device=device)
    flat = pred.detach().reshape(b, -1)
    one = torch.ones((), device=device)
    _, _, lse, sidx = k1.ranking_loss_fwd(flat, rk)
    chain = chain_loss(pred, rk)
    (fb, fo), (bb, bo), fill_bytes = fused_k1_cost(n, k, b, flat.shape[1])
    out = {}
    for name, fns, (nb, no) in (
        ("ranking_loss_fwd", {"ms": lambda: k1.ranking_loss_fwd(flat, rk),
                              "plain_ms": lambda: k1.ranking_loss_fwd_plain(flat, rk),
                              "composition_ms": lambda: chain_loss(flat, rk)}, (fb, fo)),
        ("ranking_loss_bwd", {"ms": lambda: k1.ranking_loss_bwd(flat, lse, sidx, one),
                              "plain_ms": lambda: k1.ranking_loss_bwd_plain(flat, lse, sidx, one),
                              "composition_ms": lambda: torch.autograd.grad(
                                  chain, pred, one, retain_graph=True)}, (bb, bo)),
    ):
        with torch.no_grad() if name == "ranking_loss_fwd" else contextlib.nullcontext():
            row = {key: device_ms(fn, reps, f"{name} {key}") for key, fn in fns.items()
                   if key != "ms"}
            if name == "ranking_loss_fwd":
                row["ms"] = device_ms(fns["ms"], reps, f"{name} ms", per_call=1)
            else:
                row["ms"] = kernel_split(fns["ms"], reps, f"{name} ms", 2, "k1_bwd",
                                         rest=lambda: torch.zeros_like(flat))
                row["fill_ms"] = device_ms(lambda: torch.zeros_like(flat), reps, "fill", 1)
                row["fill_bytes"] = fill_bytes
                row["fill_bound_ms"] = fill_bytes / HBM_BYTES_PER_S * 1e3
            row["call_ms"] = cuda_ms(fns["ms"], reps=reps, warmup=5)
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no, PEAK_FLOPS["float32"])
        row.update(bytes=nb, ops=no, floor_ms=floor_ms)
        out[name] = row
        log(f"{name} N={n} K={k} (B={b}, 448^2 maps): device {row['ms'] * 1e3:.2f} us per "
            f"launch, {row['ms'] / floor_ms:.2f}x the empty kernel's {floor_ms * 1e3:.2f} us; "
            f"plain {row['plain_ms'] * 1e3:.2f} us, unfused chain {row['composition_ms'] * 1e3:.2f} "
            f"us, bound {row['bound_ms'] * 1e3:.4f} us ({row['bound_by']}: {nb} B)"
            + (f", zero fill {row['fill_ms'] * 1e3:.2f} us (bound {row['fill_bound_ms'] * 1e3:.2f}"
               f" us, {fill_bytes} B)" if "fill_ms" in row else "")
            + f"; per call with the host launching back to back {row['call_ms'] * 1e3:.2f} us "
            f"[{smi}]")
    return out


def k1_sweep(smi: str, n: int = BATCH_TRAIN * 100, ks=(5, 10, 25, 32, 64, 128, 500),
             device="cuda", reps: int = 100):
    """Device time per launch of the fused forward and backward at N = n,
    448^2 maps, for each K in ``ks`` with each layout that takes it (the
    thread layout only at K 3, 5, 10): where the warp layout takes over."""
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    rows = []
    for k in ks:
        b = k1_batch(n)
        pred, rk = loss_inputs(b, n // b, k, seed=13, device=device)
        flat = pred.detach().reshape(b, -1)
        one = torch.ones((), device=device)
        for layout in (("thread", "warp") if k in (3, 5, 10) else ("warp",)):
            _, _, lse, sidx = k1.ranking_loss_fwd(flat, rk, layout=layout)
            row = {"k": k, "layout": layout,
                   "fwd_ms": device_ms(lambda: k1.ranking_loss_fwd(flat, rk, layout=layout),
                                       reps, f"sweep fwd K={k} {layout}", per_call=1),
                   "bwd_ms": kernel_split(
                       lambda: k1.ranking_loss_bwd(flat, lse, sidx, one, layout=layout),
                       reps, f"sweep bwd K={k} {layout}", 2, "k1_bwd",
                       rest=lambda: torch.zeros_like(flat))}
            rows.append(row)
            log(f"K1 sweep N={n} K={k:3d} {layout:6s}: forward {row['fwd_ms'] * 1e3:.2f} us, "
                f"backward {row['bwd_ms'] * 1e3:.2f} us per launch [{smi}]")
    return rows


def k1_times(smi: str, device="cuda"):
    """Phase 7's K1 times: the empty-kernel launch floor; the sorted and the
    fused kernels at every (N, K) of K1_TIME_SHAPES; the layout sweep."""
    import torch

    from pldepth_torch.ops import listmle_kernel as k1

    dev = torch.device(device)
    floor = device_ms(lambda: k1.launch_floor(dev), 200, "empty kernel", per_call=1)
    floor_call = cuda_ms(lambda: k1.launch_floor(dev), reps=200, warmup=5)
    log(f"empty kernel of the listmle library: {floor * 1e3:.2f} us device, "
        f"{floor_call * 1e3:.2f} us per call back to back [{smi}]")
    out = {"floor_ms": floor, "floor_call_ms": floor_call, "sorted": {}, "fused": {}}
    for n, k in K1_TIME_SHAPES:
        out["sorted"][f"{n}x{k}"] = sorted_k1_times(smi, n, k, device)
        out["fused"][f"{n}x{k}"] = fused_k1_times(smi, n, k, floor, device)
    out["sweep"] = k1_sweep(smi, device=device)
    return out


def loss_inputs(batch: int, rpi: int = 100, k: int = 5, size: int = SIZE, seed: int = 0,
                device="cuda"):
    """A (batch, size, size, 1) f32 depth map that needs a gradient and
    (batch, rpi, k, 2) f32 rankings as the samplers emit them: flat pixel
    indices in [0, size^2), depths rounded to 1/255 (ties), seeded."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    pred = torch.from_numpy(rng.normal(size=(batch, size, size, 1)).astype(np.float32))
    idx = rng.integers(0, size * size, size=(batch, rpi, k))
    depth = np.round(rng.uniform(0.05, 1.0, (batch, rpi, k)) * 255) / 255
    rankings = torch.from_numpy(np.stack([idx, depth], -1).astype(np.float32))
    return pred.to(device).requires_grad_(True), rankings.to(device)


def chain_loss(pred, rankings):
    """The loss as the port computed it before the fused kernels: index
    copy, gather, stable label argsort, take_along_dim, the sorted K1
    kernel, mean (and their backwards). The composition yardstick."""
    import torch

    from pldepth_torch.ops.listmle_kernel import listmle_sorted

    b, k = pred.shape[0], rankings.shape[-2]
    idx = rankings[..., 0].to(torch.int64)
    labels = rankings[..., 1].reshape(-1, k)
    s = torch.gather(pred.reshape(b, -1), 1, idx.reshape(b, -1)).reshape(-1, k)
    order = torch.argsort(-labels, dim=-1, stable=True)
    return listmle_sorted(torch.take_along_dim(s, order, dim=-1)).mean()


def window_launches(fn, reps: int, tries: int = 3):
    """{kernel name: launches per call} of the fullest of ``tries``
    profiler windows of ``reps`` calls (a window can lose launches)."""
    from torch.autograd import DeviceType

    best = {}
    for _ in range(tries):
        averages = kernel_window(fn, reps)[0]
        got = {e.key: e.count / reps for e in averages if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0 and "spin_kernel" not in e.key}
        if sum(got.values()) > sum(best.values()):
            best = got
    return best


def loss_path_times(smi: str, reps: int = 50, device="cuda"):
    """The loss path of one train step alone, from the (B, 448, 448, 1)
    map to its gradient map (``torch.autograd.grad`` with a given
    cotangent, so autograd fills no ones), at ff_effnet's batch 32 and
    ff_redweb's batch 4 (RPI 100, K 5): ``pl_ranking_loss`` as the entry
    point runs it (``loss``), the chain of the port before the fused
    kernels (``chain``) and the plain loss (``plain``, impl="xla").
    Each: device time per call (profiler windows), device launches per call
    by kernel, ``call_ms`` (CUDA events, the host launching back to back)
    and ``host_ms`` (the host's time to issue a call)."""
    import torch

    from pldepth_torch.ops.listmle import pl_ranking_loss

    out = {}
    for model, batch in LOSS_PATHS:
        pred, rk = loss_inputs(batch, device=device)
        one = torch.ones((), device=device)
        fns = {"loss": lambda: torch.autograd.grad(pl_ranking_loss(pred, rk), pred, one),
               "chain": lambda: torch.autograd.grad(chain_loss(pred, rk), pred, one),
               "plain": lambda: torch.autograd.grad(pl_ranking_loss(pred, rk, impl="xla"),
                                                    pred, one)}
        rows = {}
        for name, fn in fns.items():
            launches = window_launches(fn, reps)
            per_call = round(sum(launches.values()))
            row = {"ms": device_ms(fn, reps, f"{model} loss path {name}", per_call=per_call),
                   "call_ms": cuda_ms(fn, reps=reps, warmup=5),
                   "launches": sum(launches.values()), "kernels": launches}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            row["host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
            torch.cuda.synchronize()
            rows[name] = row
            log(f"loss path {model} batch {batch} ({batch * 100} lists, K=5, map "
                f"{SIZE}^2) {name}: device {row['ms'] * 1e3:.2f} us in {row['launches']:g} "
                f"launches per call, {row['call_ms'] * 1e3:.2f} us per call back to back, host "
                f"{row['host_ms'] * 1e3:.2f} us per call [{smi}]")
            for kname, count in sorted(launches.items()):
                log(f"    {count:g} x {kname[:120]}")
        out[f"{model}_b{batch}"] = rows
    return out


def gate_loss_path(paths) -> None:
    """The loss path alone (``pl_ranking_loss`` and its gradient) launches
    exactly the fused forward, one zero fill and the fused backward: no
    gather, sort, take_along_dim or scatter kernel of the composition."""
    for path, rows in paths.items():
        kernels = rows["loss"]["kernels"]
        fwd = sum(c for name, c in kernels.items() if "k1_fwd" in name)
        bwd = sum(c for name, c in kernels.items() if "k1_bwd" in name)
        fill = sum(c for name, c in kernels.items() if "FillFunctor" in name)
        composed = [name for name in kernels
                    if re.search(r"gather|sort|take_along|scatter", name, re.I)]
        if (fwd, bwd, fill) != (1, 1, 1) or len(kernels) != 3 or composed:
            fail(f"loss path {path}: launches per call {kernels}; expected the fused forward, "
                 f"one fill and the fused backward only")
        log(f"loss path {path}: the fused forward, one fill and the fused backward, nothing else")


@contextlib.contextmanager
def plain_k4_route():
    """Route the int8 conv sites to K4's plain version (im2col, then an f64
    product on the card) for the duration: the reference route of phase 8."""
    from pldepth_torch.models import quantize
    from pldepth_torch.ops.quant_conv import quant_conv2d_plain

    def plain(q, kernel_q, w_scale, bias, a_scale, stride=1, out_dtype=None, padding=None,
              act=None, w_packed=None):
        return quant_conv2d_plain(q, kernel_q, w_scale, bias, a_scale, stride, out_dtype,
                                  padding, act)

    saved = quantize.quant_conv2d
    quantize.quant_conv2d = plain
    try:
        yield
    finally:
        quantize.quant_conv2d = saved


def k4_sites(trainer, qstate, batch: int, size: int):
    """The dense int8 sites of one forward in order: dicts with name, M, K,
    N, the window (size, stride, padding), the input's (H, W, Cin), whether
    the site reads a window in place, and the QuantConv; from a batch-1
    forward on the plain route (M scaled to ``batch``)."""
    import torch

    from pldepth_torch.models.quantize import quant_sites

    rows, hooks = [], []
    for name, mod in quant_sites(qstate.model).items():
        if mod.groups == 1:
            def hook(m, inputs, out, name=name):
                kh, kw, cin, cout = m.kernel_q.shape
                rows.append({"site": name, "m": batch * out.shape[1] * out.shape[2],
                             "k": kh * kw * cin, "n": cout, "mod": m, "batch": batch,
                             "h": inputs[0].shape[1], "w": inputs[0].shape[2], "cin": cin,
                             "ksize": kh, "stride": m.stride, "padding": m.padding,
                             "window": kh > 1 or m.stride > 1})
            hooks.append(mod.register_forward_hook(hook))
    with plain_k4_route():
        trainer.predict_quant(qstate, torch.zeros((1, size, size, 3), device="cuda"))
    for h in hooks:
        h.remove()
    return rows


def site_shape(s):
    """What makes two sites the same K4 problem."""
    return tuple(s[key] for key in ("m", "k", "n", "h", "w", "ksize", "stride", "padding"))


def k4_case(s, seed: int = 0):
    """Seeded operands of one K4 case on the card. ``s`` is a site
    (k4_sites) or an extra with the same keys and ``mod`` None. Returns the
    three ways to compute it: K4 (through the entry point the serving graph
    takes for it, from the NHWC int8 input where it reads a window), its
    plain version (im2col + the plain product), and the library yardstick
    (im2col + torch._int_mm + a torch epilogue), plus the im2col alone."""
    import torch
    import torch.nn.functional as F

    from pldepth_torch.ops import quant_conv as qc
    from pldepth_torch.ops import quant_matmul as k4

    g = torch.Generator(device="cuda").manual_seed(seed)
    m, k, n, mod = s["m"], s["k"], s["n"], s.get("mod")
    conv = (s["ksize"], s["stride"], s["padding"]) if s.get("window") else None
    shape = (s["batch"], s["h"], s["w"], s["cin"]) if conv else (m, k)
    x = torch.randint(-127, 128, shape, dtype=torch.int8, device="cuda", generator=g)
    if mod is not None:
        _, _, a = mod.derived()
        w, ws, b, packed = mod.kernel_q, mod.w_scale, mod.bias, mod.packed_weight()
    else:
        wshape = (conv[0], conv[0], s["cin"], n) if conv else (k, n)
        w = torch.randint(-127, 128, wshape, dtype=torch.int8, device="cuda", generator=g)
        ws = torch.rand(n, device="cuda", generator=g) * 0.01 + 1e-3
        b = torch.randn(n, device="cuda", generator=g) * 0.1
        a = torch.tensor(0.05 / max(1, k) ** 0.5, device="cuda")
        packed = qc.pack_kernel(w) if conv else k4.pack_weight(w)
    w2 = w.reshape(k, n)

    def kernel(act=None, dt=torch.bfloat16):
        if conv:
            return qc.quant_conv2d(x, w, ws, b, a, conv[1], dt, conv[2], act,
                                   w_packed=packed).reshape(m, n)
        return k4.quant_matmul(x, w2, ws, b, a, act, dt, w_packed=packed)

    def plain(act=None, dt=torch.bfloat16):
        if conv:
            return qc.quant_conv2d_plain(x, w, ws, b, a, conv[1], dt, conv[2], act).reshape(m, n)
        return k4.quant_matmul_plain(x, w2, ws, b, a, act, dt)

    def im2col():
        return qc.im2col_same(x, *conv).contiguous() if conv else x

    # _int_mm takes K and N in multiples of 8 only; zero columns add nothing
    pad, pad_n = -k % 8, -n % 8
    w_lib = F.pad(w2, (0, pad_n, 0, pad)).contiguous()

    def library():
        cols = im2col()
        acc = torch._int_mm(F.pad(cols, (0, pad)) if pad else cols, w_lib)[:, :n]
        return (acc.float() * (ws * a) + b).to(torch.bfloat16)

    # a window site whose channels the wrapper pads to 4 (a stem) launches
    # the pad's kernels beside K4's one
    return {"kernel": kernel, "plain": plain, "library": library, "im2col": im2col,
            "k_padded": bool(pad),
            "kernels_per_call": None if conv and s["cin"] % qc.CIN_ALIGN else 1}


def k4_extras(extras=K4_EXTRA, conv_extras=K4_CONV_EXTRA):
    """The extra cases as site-like dicts (with ``act``)."""
    from pldepth_torch.ops.quant_conv import _out_hw

    rows = [{"site": f"extra{i}", "m": m, "k": k, "n": n, "act": act}
            for i, (m, k, n, act) in enumerate(extras)]
    for i, (b, h, w, cin, cout, ks, stride, padding, act) in enumerate(conv_extras):
        ho, wo, _ = _out_hw(h, w, ks, stride, padding)
        rows.append({"site": f"window{i}", "m": b * ho * wo, "k": ks * ks * cin, "n": cout,
                     "batch": b, "h": h, "w": w, "cin": cin, "ksize": ks, "stride": stride,
                     "padding": padding, "window": True, "act": act})
    return rows


def check_k4(sites, extras=None):
    """Phase 8 (1): K4 against its plain version at every site shape (the
    window sites through the window entry point, from a seeded NHWC input,
    against im2col + the plain product) and ``extras``, f32 and bf16 out.
    Returns (rows, max|d| of the bf16 outputs at the site shapes)."""
    import torch

    cases = list(sites) + list(k4_extras() if extras is None else extras)
    rows, max_err = [], 0.0
    for i, s in enumerate(cases):
        name, m, k, n, act = s["site"], s["m"], s["k"], s["n"], s.get("act")
        case = k4_case(s, seed=500 + i)
        row = {"case": name, "m": m, "k": k, "n": n, "act": act,
               "window": bool(s.get("window"))}
        for dname, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            got = case["kernel"](act, dt).float()
            torch.cuda.synchronize()
            want = case["plain"](act, dt).float()
            if got.shape != (m, n) or not torch.isfinite(got).all():
                fail(f"K4 {name} {dname}: shape {tuple(got.shape)} or non-finite")
            d = (got - want).abs()
            if dname == "float32":
                bad = int((d > K4_TOL + K4_TOL * want.abs()).sum())
            else:  # one bf16 ulp of the reference: 2^(e - 7) for |want| in [2^e, 2^(e+1))
                ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
                bad = int((d > ulp).sum())
            err = float(d.max())
            row[dname] = {"max_abs_err": err, "rel": err / max(float(want.abs().max()), 1e-12),
                          "outside_tol": bad, "bit_equal": bool(torch.equal(got, want))}
            if bad:
                fail(f"K4 {name} {dname} (M {m}, K {k}, N {n}, act {act}): {bad} values "
                     f"outside the tolerance, max|d| {err:.3e}")
            if dname == "bfloat16" and s.get("mod") is not None:
                max_err = max(max_err, err)
        if act != "swish" and not row["float32"]["bit_equal"]:
            fail(f"K4 {name}: f32 out is not bit-equal to the plain version (max|d| "
                 f"{row['float32']['max_abs_err']:.3e}); the int32 sum and the epilogue are exact")
        rows.append(row)
        where = (f"window {s['ksize']}x{s['ksize']} s{s['stride']} pad {s['padding']} of "
                 f"({s['batch']}, {s['h']}, {s['w']}, {s['cin']})" if s.get("window") else "product")
        log(f"K4 vs plain {name:36s} M {m:6d} K {k:5d} N {n:4d} act {str(act):5s} {where}: f32 "
            f"max|d| {row['float32']['max_abs_err']:.3e} (bit-equal "
            f"{row['float32']['bit_equal']}), bf16 max|d| {row['bfloat16']['max_abs_err']:.3e} "
            f"(f32 {K4_TOL:g} + {K4_TOL:g}|ref|, bf16 1 ulp)")
    return rows, max_err


def k4_counts(reset: bool = False):
    """(K4 launches, of which window reads, im2col_same calls) so far."""
    from pldepth_torch.ops import quant_conv as qc
    from pldepth_torch.ops import quant_matmul as k4

    if reset:
        k4.quant_matmul.launches = qc.quant_conv2d.window_launches = qc.im2col_same.calls = 0
    return k4.quant_matmul.launches, qc.quant_conv2d.window_launches, qc.im2col_same.calls


def gate_k4_path(what: str, forwards: int, sites: int, windows: int):
    """Fail unless the run since ``k4_counts(reset=True)`` launched K4
    ``sites`` times a forward, ``windows`` of them window reads, and built
    no patch matrix. Returns the launches."""
    launches, window_reads, patches = k4_counts()
    log(f"{what}: K4 launches {launches} over {forwards} forwards, {window_reads} of them "
        f"window reads in place; im2col_same calls {patches}")
    if launches != sites * forwards or window_reads != windows * forwards:
        fail(f"{what}: K4 launched {launches} times ({window_reads} window reads) over "
             f"{forwards} forwards, expected {sites} ({windows}) each")
    if patches:
        fail(f"{what}: {patches} patch matrices were built on the card's route")
    return launches


def _rel_pearson(a, b):
    import numpy as np

    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12)), float(np.corrcoef(a, b)[0, 1])


def quant_phase(decode, chunks, gtr, gstate, smi: str):
    """Phase 8: K4 checks, then int8 serving end to end with its gates.
    Returns (trainer, state, qstate, sites, record)."""
    import torch

    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models.pretrained import flax_from_state_dict, overlay_synthetic
    from pldepth_torch.train import Trainer

    rec = {}
    trainer = Trainer(ExperimentConfig(model_name="ff_effnet", input_size=SIZE),
                      steps_per_epoch=1)
    state = trainer.init_state()
    overlay_synthetic(state.model, list(flax_from_state_dict(state.model.state_dict())))
    randomise_bn(state.model, seed=3)

    first = decode(chunks[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qstate = trainer.prepare_quant(state, first)
    torch.cuda.synchronize()
    rec["calib_s_first"] = time.perf_counter() - t0  # fold + pack + one calibration forward
    t0 = time.perf_counter()
    trainer.prepare_quant(state, first)
    torch.cuda.synchronize()
    rec["calib_s_cached_pack"] = time.perf_counter() - t0
    log(f"prepare_quant (calibration on one batch of {BATCH_SERVE} at {SIZE}^2): "
        f"{rec['calib_s_first'] * 1e3:.1f} ms first (fold + pack + calibrate), "
        f"{rec['calib_s_cached_pack'] * 1e3:.1f} ms with the pack cached [{smi}]")

    sites = k4_sites(trainer, qstate, BATCH_SERVE, SIZE)
    if len(sites) != K4_SITES:
        fail(f"expected {K4_SITES} dense int8 sites, found {len(sites)}")
    macs = sum(s["m"] * s["k"] * s["n"] for s in sites)
    log(f"{len(sites)} dense int8 sites ({sum(s['window'] for s in sites)} read a window), "
        f"{macs / 1e9:.2f} G multiply-adds per forward of {BATCH_SERVE} at {SIZE}^2")
    rec["k4_checks"], rec["k4_max_abs_err"] = check_k4(sites)

    serve = trainer.jit_predict(fused="quant")
    k4_counts(reset=True)
    n, rec["pipeline_s_cold"] = serve_maps(lambda imgs: serve(qstate, imgs), chunks,
                                           lambda c: first if c is chunks[0] else decode(c),
                                           SIZE, "int8 serving")
    log(f"served {n} int8 depth maps (448, 448), finite")
    rec["k4_launches_main_path"] = gate_k4_path("ff_effnet int8 serving", len(chunks), K4_SITES,
                                                K4_WINDOWS)

    imgs = torch.from_numpy(first).cuda()
    pq = trainer.predict_quant(qstate, imgs).float().cpu()
    pb = trainer.predict_bnfold(state, imgs).float().cpu()
    pp = trainer.predict(state, imgs).float().cpu()
    with plain_k4_route():
        pq_plain = trainer.predict_quant(qstate, imgs).float().cpu()
    gx = gold_images()
    g_fold = gtr.predict_bnfold(gstate, gx).cpu()
    g_plain = gtr.predict(gstate, gx).cpu()
    gates = [("quant_vs_bnfold", pq, pb, 0.15, 0.98),
             ("bnfold_vs_predict_bf16", pb, pp, 3e-2, None),
             ("k4_route_vs_plain_route", pq, pq_plain, 1e-2, None),
             ("bnfold_vs_predict_f32_96", g_fold, g_plain, 2e-5, None)]
    for name, a, b, tol, ptol in gates:
        rel, r = _rel_pearson(a, b)
        rec[name] = {"rel": rel, "pearson": r}
        log(f"{name}: rel {rel:.3e} (tol {tol:g}), pearson {r:.6f}"
            + (f" (tol > {ptol})" if ptol else ""))
        if not rel <= tol or (ptol is not None and not r > ptol):
            fail(f"{name}: rel {rel:.3e}, pearson {r:.6f}")
    return trainer, state, qstate, sites, rec


def gold_images():
    """The TF golden's 96^2 input images in [0, 1]."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    with np.load(os.path.join(here, "tests", "golden", "full_model_ff_effnet.npz")) as gold:
        return gold["x_raw"] / 255.0


def k4_cost(s):
    """(bytes in place, bytes with the input im2col'd, ops) of one K4 site:
    the int8 input read once (the NHWC activation in place, or no more than
    the windows cover where the stride passes the window, a 1x1 at stride
    2; or the (M, K) patch matrix, the bound earlier records state), the
    weight, w_scale, bias and a_scale read once, the bf16 output written
    once; 2 M K N int8 operations."""
    m, k, n = s["m"], s["k"], s["n"]
    rest = k * n + 8 * n + 4 + 2 * m * n
    in_place = min(s["batch"] * s["h"] * s["w"] * s["cin"], m * k) if s["window"] else m * k
    return in_place + rest, m * k + rest, 2 * m * k * n


def k4_graph_ms(prof) -> float:
    """K4's device ms per forward in a profile_idle record."""
    return sum(ms for name, ms in prof["kernels_ms"].items() if "k4_kernel" in name)


def k4_times(sites, smi: str, model: str, reps: int = 5):
    """Phase 9: K4 per site shape (through the entry point the graph takes,
    from the NHWC input where it reads a window) beside its plain version,
    the bound of the work in place, the bound with the input im2col'd, and
    the library yardstick im2col + torch._int_mm + a torch epilogue with
    the im2col's share; device time per call. Sites of one shape are timed
    once. Returns (rows per shape, totals per forward)."""
    shapes = {}
    for s in sites:
        shapes.setdefault(site_shape(s), []).append(s)
    rows = []
    for i, group in enumerate(shapes.values()):
        s = group[0]
        m, k, n = s["m"], s["k"], s["n"]
        case = k4_case(s, seed=900 + i)
        nb, nb_cols, no = k4_cost(s)
        row = {"site": s["site"], "count": len(group), "m": m, "k": k, "n": n,
               "window": s["window"], "ksize": s["ksize"], "stride": s["stride"],
               "ms": device_ms(case["kernel"], reps, f"K4 {s['site']}",
                               per_call=case["kernels_per_call"]),
               "plain_ms": device_ms(case["plain"], reps, f"K4 plain {s['site']}"),
               "library_ms": device_ms(case["library"], reps, f"_int_mm {s['site']}"),
               "im2col_ms": (device_ms(case["im2col"], reps, f"im2col {s['site']}")
                             if s["window"] else 0.0),
               "library_k_padded": case["k_padded"],
               "bytes": nb, "bytes_im2col": nb_cols, "ops": no,
               "bytes_ms": nb / HBM_BYTES_PER_S * 1e3, "ops_ms": no / PEAK_FLOPS["int8"] * 1e3}
        row["bound_ms"], row["bound_by"] = bound_ms(nb, no, PEAK_FLOPS["int8"])
        row["bound_im2col_ms"], _ = bound_ms(nb_cols, no, PEAK_FLOPS["int8"])
        row["tops"] = no / (row["ms"] * 1e-3) / 1e12
        row["over_bound"] = row["ms"] / row["bound_ms"]
        rows.append(row)
        log(f"K4 {model} {s['site']:34s} x{len(group)} M {m:6d} K {k:5d} N {n:4d} "
            f"{'window' if s['window'] else 'product'}: {row['ms']:.4f} ms "
            f"({row['tops']:.1f} TOP/s, {row['over_bound']:.1f}x bound), plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}; "
            f"im2col'd {row['bound_im2col_ms']:.4f}), im2col+_int_mm+epilogue "
            f"{row['library_ms']:.4f} ms (im2col {row['im2col_ms']:.4f}"
            f"{', K zero-padded' if row['library_k_padded'] else ''}) [{smi}]")
        if row["ms"] > row["library_ms"]:
            log(f"  NOTE: K4 is slower than the library yardstick at {s['site']}")
    tot = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "im2col_ms", "bound_ms", "bound_im2col_ms",
                       "bytes_ms", "ops_ms", "bytes", "bytes_im2col", "ops")}
    tot["slower_than_library"] = [r["site"] for r in rows if r["ms"] > r["library_ms"]]
    tot["over_twice_bound"] = [r["site"] for r in rows if r["over_bound"] > 2]
    log(f"K4 per {model} forward ({len(sites)} sites, {len(rows)} shapes, batch {BATCH_SERVE}): "
        f"{tot['ms']:.3f} ms, plain {tot['plain_ms']:.3f} ms, bound in place "
        f"{tot['bound_ms']:.4f} ms (bytes {tot['bytes_ms']:.4f}: {tot['bytes'] / 1e6:.0f} MB, ops "
        f"{tot['ops_ms']:.4f}), bound im2col'd {tot['bound_im2col_ms']:.4f} ms "
        f"({tot['bytes_im2col'] / 1e6:.0f} MB); im2col+_int_mm+epilogue {tot['library_ms']:.3f} ms "
        f"(im2col {tot['im2col_ms']:.3f}); slower than the library at "
        f"{tot['slower_than_library']}; {len(tot['over_twice_bound'])} shapes above twice their "
        f"bound [{smi}]")
    for r in sorted(rows, key=lambda r: -r["ms"] * r["count"])[:10]:
        log(f"  slowest: {r['site']:34s} x{r['count']} {r['ms']:.4f} ms each, "
            f"{r['over_bound']:.1f}x its bound ({r['bound_by']})")
    if tot["ms"] >= tot["library_ms"]:
        fail(f"K4 per {model} forward ({tot['ms']:.3f} ms) does not beat im2col + _int_mm + "
             f"epilogue ({tot['library_ms']:.3f} ms)")
    return rows, tot


def k3_bounds():
    """K3 (pldepth_tpu/ops/banded_mbconv.py) computes one whole inference
    MBConv, so the bound of the whole call is block_cost's for the blocks it
    was written for: the B0 stage-2 and stage-3 blocks at 448^2, batch 8,
    bf16 (224^2 and 112^2 inputs); beside it the bound of K3's design, which
    writes g and reads it back. Reckoned from the shapes."""
    import torch

    from pldepth_torch.models import get_pl_depth_net
    from pldepth_torch.models.fused_infer import plan_encoder

    b0 = get_pl_depth_net("ff_effnet", "bfloat16").make()
    rows = []
    for plan in plan_encoder(b0.encoder, (SIZE, SIZE), torch.bfloat16):
        if not plan.name.startswith(("stage2_", "stage3_")):
            continue
        nb, tensor, cuda, gb = block_cost(plan, BATCH_SERVE, "bfloat16")
        bound, by, terms = mbconv_bound(nb, tensor, cuda)
        design = mbconv_bound(nb + 2 * gb, tensor, cuda)[0]
        rows.append({"block": plan.name, "in_hw": list(plan.in_hw), "bytes": nb,
                     "tensor_flops": tensor, "cuda_flops": cuda, "g_bytes": gb,
                     "bound_ms": bound, "bound_by": by, "terms_ms": terms,
                     "design_bound_ms": design})
        log(f"K3 bound {plan.name} x(8, {plan.in_hw[0]}, {plan.in_hw[1]}) k{plan.kernel} "
            f"s{plan.stride}: {bound:.4f} ms ({by}: {nb} B, {tensor / 1e9:.3f} GFLOP tensor, "
            f"{cuda / 1e9:.3f} GFLOP CUDA-core); with g written and read back {design:.4f} ms")
    log(f"K3 bound, stage-2 and stage-3 blocks: {sum(r['bound_ms'] for r in rows):.4f} ms "
        f"(with the g round trip {sum(r['design_bound_ms'] for r in rows):.4f} ms) per forward "
        f"of {BATCH_SERVE} at {SIZE}^2")
    return rows


def k3_cases(b0, dtype, batch: int, seed: int):
    """The four K3 blocks of B0 at 448^2 as whole blocks (expand included):
    [(plan, name, params, kwargs, x)]."""
    from pldepth_torch.models.fused_infer import plan_encoder

    plans = [p for p in plan_encoder(b0.encoder, (SIZE, SIZE), dtype) if p.name in K3_BLOCKS]
    calls = [(p.name, p.params, dict(kernel=p.kernel, stride=p.stride, residual=p.residual))
             for p in plans]
    xs = block_inputs(calls, plans, batch, dtype, seed)
    return [(plan, *call, x) for plan, call, x in zip(plans, calls, xs)]


def check_k3(b0):
    """Phase 10 (1): K3 against its plain version and against K2 on the
    same inputs, bf16 and f32, at the default band and the next smaller
    divisor of the output height; one launch per call. Returns (rows,
    max|d| of the bf16 outputs against the plain version)."""
    import torch

    from pldepth_torch.ops import banded_mbconv as k3
    from pldepth_torch.ops import fused_mbconv as k2

    rows, max_err = [], 0.0
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for plan, name, p, kw, x in k3_cases(b0, dtype, BATCH_SERVE, seed=300):
            ho = plan.in_hw[0] // kw["stride"]
            band = k3.pick_band(ho)
            smaller = max(d for d in range(1, band) if ho % d == 0)
            k2_out = k2.fused_mbconv_infer(x, p, **kw).float()
            for b in (band, smaller):
                before = k3.banded_mbconv_infer.launches
                got = k3.banded_mbconv_infer(x, p, band_rows=b, **kw).float()
                torch.cuda.synchronize()
                if k3.banded_mbconv_infer.launches != before + 1:
                    fail(f"K3 {name}: a call counted {k3.banded_mbconv_infer.launches - before} "
                         f"launches")
                want = k3.banded_mbconv_plain(x, p, band_rows=b, **kw).float()
                if got.shape != want.shape or not torch.isfinite(got).all():
                    fail(f"K3 {name} {dname} band {b}: shape {tuple(got.shape)} or non-finite")
                err = float((got - want).abs().max())
                rel = err / max(float(want.abs().max()), 1e-12)
                rel_k2 = float((got - k2_out).abs().max()) / max(float(k2_out.abs().max()), 1e-12)
                rows.append({"block": name, "dtype": dname, "band": b, "shape": list(x.shape),
                             "max_abs_err": err, "rel": rel, "rel_vs_k2": rel_k2,
                             "tol": TOL[dname]})
                log(f"K3 vs plain {name:14s} {dname:8s} x{tuple(x.shape)} band {b:2d}: max|d| "
                    f"{err:.3e} rel {rel:.3e}; vs K2 rel {rel_k2:.3e} (tol {TOL[dname]:g})")
                if rel > TOL[dname] or rel_k2 > TOL[dname]:
                    fail(f"K3 {name} {dname} band {b} disagrees: rel {rel:.3e} vs plain, "
                         f"{rel_k2:.3e} vs K2")
                # bf16: the same expand, depthwise and project code in the same
                # K and tap orders; the SE partials group otherwise, and the
                # scale's bf16 rounding absorbs that at these inputs
                if dname == "bfloat16" and rel_k2 != 0:
                    fail(f"K3 {name} bf16 band {b} is not bit-equal to K2: rel {rel_k2:.3e}")
                if dname == "bfloat16":
                    max_err = max(max_err, err)
    return rows, max_err


def k3_path(b0):
    """Phase 10 (2): K3's path, the public function at the four blocks
    (bf16, batch 8, default band), with the count from 0. Returns the
    launches."""
    import torch

    from pldepth_torch.ops import banded_mbconv as k3

    cases = k3_cases(b0, torch.bfloat16, BATCH_SERVE, seed=400)
    k3.banded_mbconv_infer.launches = 0
    for _, _, p, kw, x in cases:
        y = k3.banded_mbconv_infer(x, p, **kw)
    torch.cuda.synchronize()
    launches = k3.banded_mbconv_infer.launches
    if launches != len(K3_BLOCKS) or not torch.isfinite(y).all():
        fail(f"K3's path launched it {launches} times, expected {len(K3_BLOCKS)}")
    log(f"K3 path: {launches} launches over the {len(K3_BLOCKS)} blocks")
    return launches


def k3_cost(plan, p, batch: int, es: int):
    """(bytes, tensor flops, CUDA-core flops) of each K3 pass: pass 1 reads
    x and the expand, depthwise and SE weights once, runs the expand (tensor)
    and the depthwise and SE (CUDA cores), and writes g and the f32 scale;
    pass 2 reads g, the scale, the project weights (and x for the residual),
    forms g * scale (CUDA cores), runs the project (tensor) and writes y."""
    h, w = plan.in_hw
    cin = p.we.shape[0] if p.we is not None else p.dw.shape[-1]
    ce, cse, cout = p.dw.shape[-1], p.se_w1.shape[-1], p.wp.shape[-1]
    ho, wo = h // plan.stride, w // plan.stride
    numel = lambda *ts: sum(t.numel() for t in ts if t is not None)  # noqa: E731
    g_elems = batch * ho * wo * ce
    pass1 = (es * (batch * h * w * cin + numel(p.we, p.dw, p.se_w1, p.se_w2) + g_elems)
             + 4 * (numel(p.e_scale, p.e_shift, p.d_scale, p.d_shift, p.se_b1, p.se_b2)
                    + batch * ce),
             2 * batch * (h * w * cin * ce if p.we is not None else 0),
             2 * batch * (ho * wo * ce * plan.kernel ** 2 + ho * wo * ce + 2 * ce * cse))
    y_elems = batch * ho * wo * cout
    pass2 = (es * (g_elems + p.wp.numel() + y_elems * (2 if plan.residual else 1))
             + 4 * (batch * ce + 2 * cout),
             2 * batch * ho * wo * ce * cout, g_elems)
    return {"expand_dw": pass1, "project": pass2}


def k3_times(b0, smi: str, reps: int = 10):
    """Phase 10 (3): per block, bf16, batch 8, default band, all as device
    time (profiler kernel durations, the median of three full windows,
    full_windows): K3 per pass (pass 1 = its expand/depthwise and SE
    launches, pass 2 = its project launch) beside the plain passes and each
    pass's bound, and per call beside K2 on the same block; per call with
    the host launching back to back (CUDA events) for K3 and K2 too; totals
    per forward of the four blocks."""
    import numpy as np
    import torch

    from pldepth_torch.ops import banded_mbconv as k3
    from pldepth_torch.ops import fused_mbconv as k2

    rows = []
    tot = {f"{part}_{key}": 0.0 for part in ("expand_dw", "project")
           for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    tot.update(call_ms=0.0, k2_ms=0.0, k2_call_ms=0.0)
    for plan, name, p, kw, x in k3_cases(b0, torch.bfloat16, BATCH_SERVE, seed=500):
        band = k3.pick_band(plan.in_hw[0] // kw["stride"])
        call = lambda: k3.banded_mbconv_infer(x, p, **kw)  # noqa: E731
        k2_call = lambda: k2.fused_mbconv_infer(x, p, **kw)  # noqa: E731
        windows = full_windows(call, reps, f"K3 {name}", per_call=3, n=3)
        unknown = [n for w in windows for n in w if "band_" not in n]
        if unknown:
            fail(f"K3 launched kernels that are not its own: {unknown}")
        g, scale = k3.banded_pass1_plain(x, p, kernel=kw["kernel"], stride=kw["stride"],
                                         band=band)
        row = {"block": name, "x": list(x.shape), "kernel": kw["kernel"],
               "stride": kw["stride"], "band": band, "kernels": windows,
               "call_ms": cuda_ms(call, reps=reps),
               "k2_ms": device_ms(k2_call, reps, f"K2 {name}", per_call=3, n=3),
               "k2_call_ms": cuda_ms(k2_call, reps=reps)}
        plains = {
            "expand_dw": lambda: k3.banded_pass1_plain(x, p, kernel=kw["kernel"],
                                                       stride=kw["stride"], band=band),
            "project": lambda: k3.banded_pass2_plain(g, scale, x, p,
                                                     residual=kw["residual"])}
        for part, (nb, tensor, cuda) in k3_cost(plan, p, BATCH_SERVE, 2).items():
            names = ("band_project",) if part == "project" else ("band_expand_dw", "band_se")
            bound, _, terms = mbconv_bound(nb, tensor, cuda)
            row[part] = {"ms": float(np.median([sum(ms for n, ms in w.items()
                                                    if any(k in n for k in names))
                                                for w in windows])),
                         "plain_ms": device_ms(plains[part], reps, f"K3 plain {part} {name}",
                                               n=3),
                         "bytes": nb, "tensor_flops": tensor, "cuda_flops": cuda,
                         "bytes_ms": terms["bytes"],
                         "ops_ms": max(terms["tensor"], terms["cuda_core"]),
                         "bound_ms": bound}
            for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms"):
                tot[f"{part}_{key}"] += row[part][key]
        for key in ("call_ms", "k2_ms", "k2_call_ms"):
            tot[key] += row[key]
        rows.append(row)
        e, pr = row["expand_dw"], row["project"]
        log(f"K3 {name:14s} x{tuple(x.shape)} k{kw['kernel']} s{kw['stride']} band {band}: "
            f"pass 1 {e['ms']:.4f} ms (plain {e['plain_ms']:.4f}, bound {e['bound_ms']:.4f}), "
            f"pass 2 {pr['ms']:.4f} ms (plain {pr['plain_ms']:.4f}, bound {pr['bound_ms']:.4f}); "
            f"K2 {row['k2_ms']:.4f} ms; per call with the host {row['call_ms']:.4f} ms, K2 "
            f"{row['k2_call_ms']:.4f} ms [{smi}]")
    log(f"K3 per forward (4 blocks, batch {BATCH_SERVE}): pass 1 {tot['expand_dw_ms']:.3f} ms, "
        f"pass 2 {tot['project_ms']:.3f} ms, total "
        f"{tot['expand_dw_ms'] + tot['project_ms']:.3f} ms; plain "
        f"{tot['expand_dw_plain_ms'] + tot['project_plain_ms']:.3f} ms; K2 {tot['k2_ms']:.3f} ms; "
        f"bound {tot['expand_dw_bound_ms'] + tot['project_bound_ms']:.4f} ms (device time); per "
        f"call with the host K3 {tot['call_ms']:.3f} ms, K2 {tot['k2_call_ms']:.3f} ms [{smi}]")
    return rows, tot


def wrong_eps_fold(model):
    """A copy of a ff_redweb model whose encoder BNs carry the decoder's eps
    (1e-3 for 1.001e-5): what a fold that ignored the per-scope eps would
    make of it."""
    from pldepth_torch.models.layers import BatchNorm

    wrong = copy.deepcopy(model)
    for m in wrong.encoder.modules():
        if isinstance(m, BatchNorm):
            m.eps = 1e-3
    return wrong


def redweb_serve_phase(decode, chunks, smi: str):
    """Phase 12: ff_redweb served in its default mode (bn_fold) and in int8,
    with the gates of the docstring, then its serving times."""
    import numpy as np
    import torch

    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models.layers import TrainPass
    from pldepth_torch.models.pretrained import flax_from_state_dict, overlay_synthetic
    from pldepth_torch.train import Trainer

    rec = {}
    trainer = Trainer(ExperimentConfig(model_name="ff_redweb", input_size=SIZE),
                      steps_per_epoch=1)
    state = trainer.init_state()
    overlay_synthetic(state.model, list(flax_from_state_dict(state.model.state_dict())))
    randomise_bn(state.model, seed=5)
    mode = Trainer.serving_mode(False, True, "auto", "ff_redweb")  # cli predict's defaults
    if mode != "bn_fold":
        fail(f"ff_redweb's default serving mode is {mode!r}, expected 'bn_fold'")
    serve = trainer.jit_predict(fused=mode)
    n, rec["pipeline_s_cold"] = serve_maps(lambda imgs: serve(state, imgs), chunks, decode,
                                           SIZE, "ff_redweb bn_fold")
    log(f"served {n} ff_redweb depth maps ({SIZE}, {SIZE}) in the default mode ({mode}), "
        f"finite")

    imgs = torch.from_numpy(decode(chunks[0])).cuda()
    # bf16 predict_bnfold and predict, each against the f32 graph of the same
    # weights, at two seeds of BN statistics; and a fold made with the
    # decoder's eps (1e-3) in the encoder, to read what the gates see of it
    ftr = Trainer(ExperimentConfig(model_name="ff_redweb", input_size=SIZE,
                                   compute_dtype="float32"), steps_per_epoch=1)
    fstate = ftr.init_state()
    bf16_pairs = []
    for seed in (5, 6):
        model = state.model
        if seed != 5:
            model = copy.deepcopy(state.model)
            randomise_bn(model, seed=seed)
        fstate.model.load_state_dict(model.state_dict())
        p32 = ftr.predict(fstate, imgs).cpu()
        pb = trainer.predict_bnfold(state.replace(model=model), imgs).float().cpu()
        pp = trainer.predict(state.replace(model=model), imgs).float().cpu()
        bf16_pairs += [(f"bnfold_bf16_vs_f32_seed{seed}", pb, p32, 3e-2),
                       (f"predict_bf16_vs_f32_seed{seed}", pp, p32, 3e-2),
                       (f"bnfold_vs_predict_bf16_seed{seed}", pb, pp, None)]
        if seed == 5:
            pb5, p32_5 = pb, p32
    del ftr, fstate
    wrong = wrong_eps_fold(state.model)
    bf16_pairs.append(("wrong_fold_bf16_vs_f32_seed5",
                       trainer.predict_bnfold(state.replace(model=wrong), imgs).float().cpu(),
                       p32_5, None))
    del wrong
    here = os.path.dirname(os.path.abspath(__file__))
    gold = np.load(os.path.join(here, "tests", "golden", "full_model_ff_redweb.npz"))
    gtr = Trainer(ExperimentConfig(model_name="ff_redweb", input_size=96,
                                   compute_dtype="float32"), steps_per_epoch=1)
    gstate = gtr.init_state()
    overlay_synthetic(gstate.model, gold["names"])
    x_raw = torch.from_numpy(gold["x_raw"]).cuda()
    with torch.no_grad():
        g_infer = gstate.model(x_raw).cpu()[..., 0]
        g_train = gstate.model(x_raw, TrainPass()).cpu()[..., 0]
    g_fold = gtr.predict_bnfold(gstate, gold["x_raw"] / 255.0).cpu()
    g_plain = gtr.predict(gstate, gold["x_raw"] / 255.0).cpu()
    g_wrong = gtr.predict_bnfold(gstate.replace(model=wrong_eps_fold(gstate.model)),
                                 gold["x_raw"] / 255.0).cpu()

    first = decode(chunks[0])
    t0 = time.perf_counter()
    qstate = trainer.prepare_quant(state, first)
    torch.cuda.synchronize()
    rec["calib_s_first"] = time.perf_counter() - t0
    sites = k4_sites(trainer, qstate, BATCH_SERVE, SIZE)
    if len(sites) != K4_SITES_REDWEB:
        fail(f"expected {K4_SITES_REDWEB} dense int8 sites in ff_redweb, found {len(sites)}")
    shapes = {}
    for site in sites:
        shapes.setdefault(site_shape(site), site)
    macs = sum(site["m"] * site["k"] * site["n"] for site in sites)
    log(f"ff_redweb: {len(sites)} dense int8 sites ({len(shapes)} shapes; "
        f"{sum(site['window'] for site in sites)} read a window), "
        f"{macs / 1e9:.2f} G multiply-adds per forward of {BATCH_SERVE} at {SIZE}^2")
    rec["k4_checks"], rec["k4_max_abs_err"] = check_k4(list(shapes.values()), extras=())

    qserve = trainer.jit_predict(fused="quant")
    k4_counts(reset=True)
    n, _ = serve_maps(lambda imgs: qserve(qstate, imgs), chunks,
                      lambda c: first if c is chunks[0] else decode(c), SIZE, "ff_redweb int8")
    log(f"served {n} ff_redweb int8 depth maps, finite")
    rec["k4_launches_main_path"] = gate_k4_path("ff_redweb int8 serving", len(chunks),
                                                K4_SITES_REDWEB, K4_WINDOWS_REDWEB)
    pq = trainer.predict_quant(qstate, imgs).float().cpu()
    with plain_k4_route():
        pq_plain = trainer.predict_quant(qstate, imgs).float().cpu()

    # bf16: the folded and unfolded graphs round at other points through 96
    # convs, each 2.1-2.4e-2 from the f32 graph on the H100 (the two 3.25e-2
    # apart), so each is held to the f32 graph at 3e-2 and their distance
    # recorded; the f32 check at 96^2 holds the fold itself
    gates = bf16_pairs + [
             ("bnfold_vs_predict_f32_96", g_fold, g_plain, 2e-5),
             ("wrong_fold_vs_predict_f32_96", g_wrong, g_plain, None),
             ("golden_infer_f32_96", g_infer, gold["ref_infer"][..., 0], 5e-5),
             ("golden_train_f32_96", g_train, gold["ref_train"][..., 0], 5e-4),
             ("k4_route_vs_plain_route", pq, pq_plain, 1e-2),
             ("quant_vs_bnfold", pq, pb5, None)]
    for name, a, b, tol in gates:
        rel, r = _rel_pearson(a, b)
        rec[name] = {"rel": rel, "pearson": r}
        log(f"ff_redweb {name}: rel {rel:.3e}" + (f" (tol {tol:g})" if tol else " (recorded)")
            + f", pearson {r:.6f}")
        if tol is not None and not rel <= tol:
            fail(f"ff_redweb {name}: rel {rel:.3e} > {tol:g}")
    if not rec["wrong_fold_vs_predict_f32_96"]["rel"] > 2e-5:
        fail("a fold with the decoder's eps in the encoder passes the f32 fold gate (2e-5)")

    # times: alternating rounds, then served img/s (bn_fold, warm) and the
    # device idle share of predict_bnfold
    fns = {"predict_bnfold": lambda: trainer.predict_bnfold(state, imgs),
           "predict": lambda: trainer.predict(state, imgs),
           "predict_quant": lambda: trainer.predict_quant(qstate, imgs)}
    times, samples = alternating_ms(fns, smi, f"ff_redweb batch of {BATCH_SERVE} at {SIZE}^2 "
                                    f"bf16", rounds=4)
    rec["batch_ms"], rec["batch_ms_samples"] = times, samples
    rec["served_img_per_s_bnfold"] = served_img_per_s(lambda imgs: serve(state, imgs), decode,
                                                      chunks, smi, "ff_redweb bn_fold")
    rec["bnfold_profile"] = profile_idle(fns["predict_bnfold"], 3, times["predict_bnfold"], smi,
                                         "ff_redweb predict_bnfold")
    # K4 in ff_redweb's int8 graph: its 96 launches' device time per forward,
    # then each site shape on its own beside its bounds and the library
    rec["quant_profile"] = prof = profile_idle(fns["predict_quant"], 3, times["predict_quant"],
                                               smi, "ff_redweb predict_quant")
    rec["k4_graph_ms"] = k4_graph_ms(prof)
    log(f"K4 in the ff_redweb int8 graph: {rec['k4_graph_ms']:.3f} ms per forward of "
        f"{BATCH_SERVE} ({K4_SITES_REDWEB} launches) [{smi}]")
    rec["k4_sites"], rec["k4_totals"] = k4_times(sites, smi, "ff_redweb")
    return rec


def serving_times(trainer, state, qstate, decode, chunks, smi: str):
    """Phase 9: served img/s in "quant" mode, ms per batch of the four
    serving modes in alternating rounds, and a profiler breakdown of
    predict_quant with the device idle share."""
    import torch

    rec = {}
    serve = trainer.jit_predict(fused="quant")
    rec["served_img_per_s_quant"] = served_img_per_s(lambda imgs: serve(qstate, imgs), decode,
                                                     chunks, smi, "quant")
    imgs = torch.from_numpy(decode(chunks[0])).cuda()
    fns = {"predict_quant": lambda: trainer.predict_quant(qstate, imgs),
           "predict_bnfold": lambda: trainer.predict_bnfold(state, imgs),
           "predict": lambda: trainer.predict(state, imgs),
           "predict_fused": lambda: trainer.predict_fused(state, imgs)}
    times, samples = alternating_ms(fns, smi, f"batch of {BATCH_SERVE} at {SIZE}^2 bf16")
    rec["batch_ms"], rec["batch_ms_samples"] = times, samples
    rec["quant_profile"] = profile_idle(fns["predict_quant"], 3, times["predict_quant"], smi,
                                        "predict_quant")
    rec["k4_graph_ms"] = k4_graph_ms(rec["quant_profile"])
    log(f"K4 in the ff_effnet int8 graph: {rec['k4_graph_ms']:.3f} ms per forward of "
        f"{BATCH_SERVE} ({K4_SITES} launches) [{smi}]")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every number here as JSON")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pldepth_torch  # noqa: F401
    except ImportError as e:
        fail(f"pldepth_torch is not importable next to this script: {e}")
    import numpy as np

    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models import get_pl_depth_net
    from pldepth_torch.models.fused_infer import plan_encoder
    from pldepth_torch.models.pretrained import flax_from_state_dict, overlay_synthetic
    from pldepth_torch.ops import _build
    from pldepth_torch.ops import fused_mbconv as k2
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz, save_weights_npz

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    record = {"torch": torch.__version__, "cuda": torch.version.cuda}

    started = time.time()
    record["phase_end_s"] = {}

    def mark(phase: str) -> None:
        record["phase_end_s"][phase] = time.time() - started
        log(f"[phase {phase} done {record['phase_end_s'][phase]:.0f} s after the start]")

    # 1. build ---------------------------------------------------------------
    t0 = time.time()
    reports = _build.build()
    record["build_s"] = time.time() - t0
    record["compiled"] = compiled_code(reports)
    log(f"built {sorted(_build.SIGNATURES)} in {record['build_s']:.1f} s "
        f"(compiled now: {sorted(reports)})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = torch.cuda.get_device_name(0)
    record["card"], record["nvidia_smi"] = card, smi
    log(smi)

    mark("1")

    # 2. K2 against its plain version at the B0 448^2 shapes ------------------
    b0 = get_pl_depth_net("ff_effnet", "float32").init_module(
        torch.Generator().manual_seed(0), "cuda")
    randomise_bn(b0, seed=1)
    checks, max_abs_err = [], 0.0
    for dname, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        plans = plan_encoder(b0.encoder, (SIZE, SIZE), dtype)
        calls = k2_calls(plans)
        xs = block_inputs(calls, plans, BATCH_CHECK, dtype, seed=100)
        for (name, p, kw), x in zip(calls, xs):
            got = k2.fused_mbconv_infer(x, p, **kw).float()
            torch.cuda.synchronize()
            want = k2.mbconv_infer_plain(x, p, **kw).float()
            if got.shape != want.shape or not torch.isfinite(got).all():
                fail(f"K2 {name} {dname}: shape {tuple(got.shape)} or non-finite")
            err = float((got - want).abs().max())
            rel = err / max(float(want.abs().max()), 1e-12)
            checks.append({"block": name, "dtype": dname, "shape": list(x.shape),
                           "max_abs_err": err, "rel": rel, "tol": TOL[dname]})
            log(f"K2 vs plain {name:14s} {dname:8s} x{tuple(x.shape)} "
                f"max|d| {err:.3e} rel {rel:.3e} (tol {TOL[dname]:g})")
            if rel > TOL[dname]:
                fail(f"K2 {name} {dname} disagrees with its plain version: rel {rel:.3e}")
            if dname == "bfloat16":
                max_abs_err = max(max_abs_err, err)
    record["k2_checks"] = checks

    mark("2")

    # 3. the serving slice ------------------------------------------------------
    cfg = ExperimentConfig(model_name="ff_effnet", input_size=SIZE)
    trainer = Trainer(cfg, steps_per_epoch=1)
    seeded = trainer.init_state()
    names = list(flax_from_state_dict(seeded.model.state_dict()))
    overlay_synthetic(seeded.model, names)
    with tempfile.TemporaryDirectory() as tmp:
        wpath = os.path.join(tmp, "weights.npz")
        save_weights_npz(wpath, seeded)
        state = load_weights_npz(wpath, trainer.init_state(torch.Generator().manual_seed(7)))
        for k, v in seeded.model.state_dict().items():
            if not torch.equal(v, state.model.state_dict()[k]):
                fail(f"weights changed through save/load: {k}")

        n_batches = 4
        chunks = [[f"img{b * BATCH_SERVE + i:02d}" for i in range(BATCH_SERVE)]
                  for b in range(n_batches)]

        def decode(chunk):
            seed = int(chunk[0][3:])
            return np.random.default_rng(seed).uniform(
                size=(len(chunk), SIZE, SIZE, 3)).astype(np.float32)

    serve = trainer.jit_predict(fused=True)
    k2.fused_mbconv_infer.launches = 0
    n, record["pipeline_s_cold"] = serve_maps(lambda imgs: serve(state, imgs), chunks, decode,
                                              SIZE, "fused serving")
    launches = k2.fused_mbconv_infer.launches
    log(f"served {n} depth maps (448, 448), finite; K2 launches {launches} "
        f"over {n_batches} forwards")
    if launches != 16 * n_batches:
        fail(f"K2 launched {launches} times over {n_batches} forwards, expected 16 each")
    record["k2_launches_main_path"] = launches

    imgs = torch.from_numpy(decode(chunks[0])).cuda()
    a = trainer.predict(state, imgs).float()
    b = trainer.predict_fused(state, imgs).float()
    rel = float((a - b).abs().max() / a.abs().max())
    record["fused_vs_predict_rel_bf16"] = rel
    log(f"predict_fused vs predict, ff_effnet bf16 {SIZE}^2 batch {BATCH_SERVE}: rel {rel:.3e} (tol 0.03)")
    if rel > 0.03:
        fail(f"predict_fused disagrees with predict: rel {rel:.3e}")

    golden_path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "tests", "golden", "full_model_ff_effnet.npz")
    gold = np.load(golden_path)
    gcfg = ExperimentConfig(model_name="ff_effnet", input_size=96, compute_dtype="float32")
    gtr = Trainer(gcfg, steps_per_epoch=1)
    gstate = gtr.init_state()
    overlay_synthetic(gstate.model, gold["names"])
    ref = gold["ref_infer"][..., 0]
    for fn, tol in (("predict", 5e-5), ("predict_fused", 2e-4)):
        out = getattr(gtr, fn)(gstate, gold["x_raw"] / 255.0).cpu().numpy()
        grel = float(np.abs(out - ref).max() / np.abs(ref).max())
        record[f"golden_rel_{fn}"] = grel
        log(f"ff_effnet f32 96^2 {fn} vs TF golden: rel {grel:.3e} (tol {tol:g})")
        if grel > tol:
            fail(f"{fn} disagrees with the TF golden: rel {grel:.3e}")

    mark("3")

    # 4. times --------------------------------------------------------------------
    record["served_img_per_s"] = served_img_per_s(lambda imgs: serve(state, imgs), decode,
                                                  chunks, smi, "fused")
    times, samples = alternating_ms(
        {fn: (lambda f=getattr(trainer, fn): f(state, imgs)) for fn in ("predict_fused", "predict")},
        smi, f"batch of {BATCH_SERVE} at {SIZE}^2 bf16")
    record["batch_ms"], record["batch_ms_samples"] = times, samples

    record["k2_blocks_bf16_batch8"], tot = k2_times(trainer, state, smi)
    record["k2_totals"] = tot

    record["profile"] = profile_idle(lambda: trainer.predict_fused(state, imgs), 3,
                                     times["predict_fused"], smi, "predict_fused")

    mark("4")

    # 5. K1 against its plain version ---------------------------------------------
    record["k1_checks"], _, _ = check_k1()
    record["k1_fused_checks"], k1_fwd_err, k1_bwd_err = check_ranking_loss()

    mark("5")

    # 6. the training slice --------------------------------------------------------
    trainer_t, state_t, cfg_t, rec_t = train_phase(EFFNET_CONFIG, batch=BATCH_TRAIN)
    record["train"] = rec_t
    log(f"train images/s through fit (host BatchIterator feed): "
        f"{rec_t['train_img_per_s']:.1f} (per epoch {[round(x, 1) for x in rec_t['train_img_per_s_epochs']]}); "
        f"peak device memory {rec_t['peak_mem_gb']:.2f} GB [{smi}]")

    mark("6")

    # 7. training times --------------------------------------------------------------
    record["train_times"] = train_times(trainer_t, state_t, cfg_t, smi)
    record["k1_times"] = k1t = k1_times(smi)
    record["loss_path"] = loss_path_times(smi)
    gate_loss_path(record["loss_path"])
    del trainer_t, state_t
    torch.cuda.empty_cache()

    mark("7")

    # 8. K4 and int8 serving -----------------------------------------------------------
    trainer_q, state_q, qstate, sites, rec_q = quant_phase(decode, chunks, gtr, gstate, smi)
    record["quant"] = rec_q

    mark("8")

    # 9. serving times of the four modes, K4 per site ------------------------------------
    record["quant_times"] = serving_times(trainer_q, state_q, qstate, decode, chunks, smi)
    record["k4_sites"], k4t = k4_times(sites, smi, "ff_effnet")
    record["k4_totals"] = k4t
    record["k3_bounds"] = k3_bounds()
    del trainer_q, state_q, qstate, sites
    torch.cuda.empty_cache()

    mark("9")

    # 10. K3 against its plain version and K2, its path, its times ----------------------
    record["k3_checks"], k3_err = check_k3(b0)
    record["k3_launches_main_path"] = k3_launches = k3_path(b0)
    record["k3_blocks"], k3t = k3_times(b0, smi)
    record["k3_totals"] = k3t
    torch.cuda.empty_cache()

    mark("10")

    # 11. ff_redweb training -------------------------------------------------------------
    trainer_r, state_r, cfg_r, rec_rt = train_phase(REDWEB_CONFIG, n_train=16, n_val=8, epochs=5)
    record["redweb_train"] = rec_rt
    log(f"ff_redweb train images/s through fit (batch {cfg_r.batch_size}): "
        f"{rec_rt['train_img_per_s']:.1f} (per "
        f"epoch {[round(x, 1) for x in rec_rt['train_img_per_s_epochs']]}); peak device memory "
        f"{rec_rt['peak_mem_gb']:.2f} GB [{smi}]")
    cfg32 = cfg_r.replace(batch_size=BATCH_TRAIN)
    record["redweb_train_times"] = {
        "batch4": train_times(trainer_r, state_r, cfg_r, smi),
        "batch32": train_times(Trainer(cfg32, trainer_r.steps_per_epoch), state_r, cfg32, smi)}
    del trainer_r, state_r
    torch.cuda.empty_cache()

    mark("11")

    # 12. ff_redweb serving, bn_fold and int8 ----------------------------------------------
    record["redweb_serve"] = rec_rs = redweb_serve_phase(decode, chunks, smi)

    mark("12")

    kernels = [{
        "name": "fused_mbconv", "route": "cuda",
        "source": "pldepth_torch/csrc/fused_mbconv.cu",
        "replaces": "pldepth_tpu/ops/fused_mbconv.py:104",
        "launches": launches, "max_abs_err": max_abs_err,
        **{key: tot[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,
    }] + [{
        "name": f"banded_{part}", "route": "cuda", "source": "pldepth_torch/csrc/banded_mbconv.cu",
        "replaces": f"pldepth_tpu/ops/banded_mbconv.py:{line}", "launches": k3_launches,
        "max_abs_err": k3_err,
        **{key: k3t[f"{part}_{key}"] for key in ("ms", "plain_ms", "bound_ms")},
        "bound_by": "bytes" if k3t[f"{part}_bytes_ms"] >= k3t[f"{part}_ops_ms"] else "operations",
        "library_ms": None,
    } for part, line in (("expand_dw", 62), ("project", 159))] + [{
        "name": name, "route": "cuda", "source": "pldepth_torch/csrc/listmle.cu",
        "replaces": replaces,
        "launches": rec_t["launches"][name] + rec_rt["launches"][name], "max_abs_err": err,
        **{key: k1t["fused"][K1_MAIN][name][key] for key in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by")},
        "library_ms": None,  # no single PyTorch call computes the fused loss
    } for name, replaces, err in (
        ("ranking_loss_fwd", "pldepth_tpu/ops/listmle_pallas.py:111", k1_fwd_err),
        ("ranking_loss_bwd", "pldepth_tpu/ops/listmle_pallas.py:121", k1_bwd_err))] + [{
        "name": "quant_matmul", "route": "cuda", "source": "pldepth_torch/csrc/quant_matmul.cu",
        "replaces": "pldepth_tpu/ops/quant_matmul.py:44",
        "launches": rec_q["k4_launches_main_path"] + rec_rs["k4_launches_main_path"],
        "max_abs_err": max(rec_q["k4_max_abs_err"], rec_rs["k4_max_abs_err"]),
        "ms": k4t["ms"], "plain_ms": k4t["plain_ms"], "bound_ms": k4t["bound_ms"],
        "bound_by": "bytes" if k4t["bytes_ms"] >= k4t["ops_ms"] else "operations",
        "library_ms": k4t["library_ms"],
    }]
    record["kernels"] = kernels
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
