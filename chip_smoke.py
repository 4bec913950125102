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
     configs; phase 16's gate and cli active steps too), and on a list whose scores spread by more than 87; the fused
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
     in phase 9;
 13. evaluation: cli train (configs/ff_effnet_448.json on 96 seeded
     synthetic 448^2 images, one epoch, --parity_report true): K1 launches
     both ways, a finite post-train line, summary.json and
     parity_report.json with the JAX command's keys, the edge metrics and
     example PNGs as far as this machine's cv2 and PIL allow (logged); cli
     eval on those weights, 64 images at 448^2, host and device reports
     within 0.03 / 0.03 / 0.05; the device metrics with injected indices
     equal to the host numpy count (NDCG rel <= 1e-6); seconds per image of
     both reports (CUDA events) and the share of the host path's numpy
     draws; cli zeroshot on 8 seeded Ibims-layout files at 480x640 (scored
     in ascending order) and, where PIL is present, DIODE, Sintel and DIW
     trees at their datasets' sizes;
 14. the training data path: 512 seeded scenes at 448^2 (made by spawned
     workers, which make phase 16's other scenes too), split as cli train splits them; the training split packed
     (pack_dataset) and held on the card (build_resident_store from the
     PackedDataset); gates: the native reader's in-order batches equal the
     pack's rows (u8 and f32 wire), the store's decode on the card equals
     the CPU decode, resident_chain(4) against four resident_step calls
     (loss rel <= 1e-2, update rel <= 5e-2; a second run of the single
     steps gives the card's own spread); then configs/ff_effnet_448.json at
     batch 32 through Trainer.fit for 20 steps (+ 2 val batches) on each of
     five feeds (BatchIterator f32, BatchIterator uint8_wire, the native
     packed reader, the resident store with chains of 1 and of 4): finite
     losses, K1 forward == steps + val batches and backward == steps, the
     profiler's HtoD bytes a step at least the batch's on the streaming
     feeds and under 1 MB on the resident ones; numbers per feed: train
     img/s through fit, ms a step (CUDA events), idle share, HtoD MB a
     step, peak memory; pack and store seconds and sizes; then cli train
     --data_resident true --resident_chain_steps 2 on 80 scenes (K1
     launches, the store line, weights.npz).
 15. export and the training options: ff_effnet at 448^2 (bf16, seeded
     synth_weight weights, randomised BN statistics) through cli export at
     fixed batch 8 and batch-polymorphic, each artifact loaded and run in a
     fresh process that imports serve/export.py alone (no model code):
     maps against predict_bnfold (rel <= 3e-2; the polymorphic one at
     batches 1, 3 and 8; f32 at 96^2 rel <= 1e-5), a fixed-batch artifact
     refuses another batch, cli serve --artifact --once true over 32 PNGs
     writes the in-process artifact's maps exactly; ms per batch and served
     img/s beside predict_bnfold. Then configs/ff_effnet_448.json at batch
     32 for 6 steps each: plain, grad_accum 2, remat_encoder, sparse_tail,
     qres int8, qres bf16, qenc bf16, qenc int8, and ff_redweb with
     sparse_tail at batch 4: the loss of every step, ms a step (events),
     peak memory, the idle share of a 1-step window; gates: finite losses;
     grad_accum params bit-equal after odd micro-steps and moved after even
     ones; remat's first loss equal to the plain run's, its first gradient
     within rel 1e-2 (its first update recorded beside the card's own
     spread) and its peak below; sparse_tail one sorted K1 forward
     and backward a step and no fused one, its first loss within rel 1e-2
     of the dense run's; qres peak int8 < bf16 < off; qenc int8 one K4
     launch a step at every dense int8 encoder site and each site's pack
     built once; qenc's encoder bit-equal after its steps.
 16. the quant metric gate, active learning and the small commands, on
     scenes at 448^2 made once beforehand by phase 14's spawned workers (the
     runs measure no scene synthesis): (a) pldepth_torch/tools/quant_metric_gate.py
     for ff_effnet and ff_redweb, each trained in-process (80 resident steps
     at batch 8) and evaluated on 104 held-out scenes, calibrated on 16:
     K1 one fused forward and backward a step, K4 38 / 96 launches a int8
     forward (6 / 42 window reads, no im2col_same), finite ordinal error
     and WHDR on >= 100 images; the metric rows and verdicts are printed,
     not gated; (b) cli active from configs/ff_effnet_448.json at batch
     32, 80 scenes, 2 rounds, split 32, one pretrain epoch, with
     --data_resident true and false: every pool row acquired once a round,
     (N, 204, 5, 2) lists depth-descending inside the image with gt labels,
     finite losses, K1 launches == fixed-ranking + pretrain steps,
     weights.npz, the JAX history keys, tile_hausdorff_batch on the card
     equal to numpy on 8 of the round's edge-map pairs; seconds per
     acquired image (predict as device time, host Canny, Hausdorff,
     oracle), HtoD MB per predict batch on each path (resident < 1 MB), ms
     a fixed-ranking step, peak memory; (c) cli chi2 at sampling types 1
     and 3: finite, info_score below purely_masked; (d) cli dump of 32
     scenes as jpg and npz: (32, 100, 5, 2) read back, depths = gt at the
     indices, the npz images = the scenes' u8 images.
 17. --profile and the sinks, sweeps and their analysis, warmup, on
     synthetic 448^2 images made once beforehand (threads):
     (a) cli train --profile true --use_tensorboard true from
     configs/ff_effnet_448.json at batch 32, one epoch on 480 images:
     exactly 3 fused K1 launches each way in the Chrome trace under
     <run>/profile, K1 launches of the command = 1 + 3 profiled + fit steps
     + val batches, weights.npz, the event file where tensorboard imports;
     trace MB and device ms a traced step; (b) cli sweep --search tpe
     --num_runs 5 --space base on 16 images a run: every record error-free
     with a finite test_error, each run's steps as its draw gives them, K1
     launches = the runs' steps; resumed with --num_runs 6: one more
     record, the first five lines byte-equal; then --search random
     --num_runs 2 --space large_rankings (K 25-500 in a 448^2 step):
     finite, error-free; seconds, peak memory and ms a step of each run;
     (c) cli analyze on (b)'s state file names the least test_error (plots
     where matplotlib imports); (d) cli warmup --serve_batch 8 at batch 32
     in a copy of pldepth_torch (PYTHONPATH) builds the four CUDA
     libraries and packio, a second warmup builds nothing, and cli train
     --pack_cache in the copy leaves its build directory unchanged; cold
     build_s and the first-call seconds. cli convert is not run here (it
     needs TensorFlow; the CPU tests hold it).
 18. data parallelism (core/mesh.py), each rank a child process started
     with torchrun's variables, any non-zero exit failing the phase; every
     time printed as "2 ranks share 1 card, not a scaling figure": (a)
     NCCL at world 1: configs/ff_effnet_448.json at batch 32 (bf16), 3
     steps with the group against the same steps with none (step-1 loss
     rel <= 1e-6, the first all-reduced flat gradient rel L2 <= 1e-2, the
     new BN running statistics rel <= 1e-5), beside the step's sensitivity
     to one f32 rounding in its BN statistics (the card's own spread, no
     group twice, is cut: 6.3e-3 in every run, PERF.md); (b) two ranks on the card over gloo, 16 rows a
     rank, against the single-process batch-32 steps on the same rows, at
     the same bounds in f32, reported in bf16; the ranks' states bit-equal
     after 3 steps and K1 one fused forward and one backward a rank a step
     in both; ms a step, ms of it in collectives, peak GB a rank; (c), in
     (b)'s ranks after it: config #5's model (ff_effnet_b4,
     640^2, K 10, RPI 100, unfrozen, SGDR, bf16) at 8 rows a rank, mesh
     data 2 in place of 16: 3 finite steps, the ranks equal, ms a step, ms
     in collectives, peak GB a rank; (d) cli train at two ranks on 16
     scenes at 448^2 with --data_resident true: each rank's store bytes,
     one gt_scale on both, weights.npz from rank 0 loaded back and served.
 19. spatial sharding (ops/halo.py, the mesh's model axis), ranks as in
     18, every time printed as "ranks share 1 card over gloo, not a scaling
     figure": the single-process steps first, alone on the card, then at
     data 1 x model 2 (19a) config #1 (ff_effnet 448^2 batch 32) in f32
     and in its own bf16 and config #5's model (ff_effnet_b4 640^2, 8 rows,
     unfrozen) in f32, and at model 4 (19b: a deepest level of 4/4/4/2
     rows) config #1 in f32, on the same global batches, 2 steps each:
     step-1 loss, the first all-reduced flat gradient and the new BN
     statistics within SP_TOL (f32 or bf16), the ranks' states bit-equal
     (sha256), K1 one fused forward and one backward in every rank's step;
     ms of step 2, ms a step in collectives, peak GB a rank beside one
     process's. Config #1's bf16 at model 4 and config #5's bf16 are cut
     to keep the script inside its time limit (PERF.md keeps their last
     numbers). (d) cli train --mesh_model 2 --spatial_sharding true
     --data_resident true with ff_effnet runs beside phase 20's (c).
 20. spatial sharding of ff_redweb and of the training options, each case
     in phase 19's ranks after its cases, 2 steps against one process on
     the same global batches within SP_TOL's f32 bounds, the ranks
     bit-equal, every time printed as phase 19's (SP20_REPORTED: ff_redweb's
     gradient, where it exceeds its bound, is held under SP20_ROOM times
     the gap one f32 rounding of its BN statistics makes in one process):
     (a) config #2 (ff_redweb 448^2, batch 4) in f32 at model 2 and 4; (b)
     config #1 in f32 at model 2 with qenc int8 (after
     prepare_qenc, every rank calibrating on the whole images: K4 once a
     step at every dense int8 encoder site, the stem's window read, and the
     stem's window read on a rank's extended int8 rows bit-equal to its
     plain twin and to the unsharded conv's rows; the elements of the
     sharded int8 encoder's outputs that differ from the unsharded
     encoder's rows, reported), qenc bf16, sparse_tail (the sorted K1 once
     each way a rank a step, no fused launch), qres int8, remat_encoder
     and grad_accum 2 (one update); every other case the fused K1 once
     each way a rank a step; ms of step 2, ms in collectives, peak GB a
     rank beside one process's; (c) cli train --model_name ff_redweb
     --mesh_model 2 --spatial_sharding true --data_resident true on 16
     scenes, two ranks started beside 19d's two: each rank's store of its
     rows, one gt_scale, weights.npz from rank 0 loaded back and served.
The line before the last is the {"kernels": [...]} record; the last is
{"ok": true, "device": {...}}. ``--out`` also writes every number as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import hashlib
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
# K1 timed at the main path's (ff_effnet batch 32, RPI 100, K 5) and at K
# 500 (ff_redweb's batch 4 and 12800 lists of K 10 cut to keep the script
# inside its time limit with phase 19; their last times are in PERF.md)
# cut to the main path's shape to keep the script inside its time limit
# (3200 x 500's last times: PERF.md)
K1_TIME_SHAPES = [(3200, 5)]
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
    config's batch through fit, and at BATCH_TRAIN in its timed steps); and
    phase 16's: the gate's training steps, and cli active's fixed-ranking
    steps (ACTIVE_SPLIT^2 // K lists an image; its pretrain fit is phase 6's
    shape); and every (N, K) that phase 17's sweeps can draw: batch x
    rankings per image (and x val rankings per image) for each K of the
    base space, and of the large_rankings space at the config's batch
    (phases 17a and 17d run phase 6's shapes)."""
    from pldepth_torch.sweep.search_spaces import SEARCH_SPACES

    shapes = set()
    for config, batches in ((EFFNET_CONFIG, (BATCH_TRAIN,)), (REDWEB_CONFIG, (None, BATCH_TRAIN))):
        cfg = load_config(config)
        for b in batches:
            b = b or cfg.batch_size
            shapes |= {(b * r, cfg.ranking_size) for r in (cfg.rankings_per_image, cfg.val_rpi)}
    cfg = load_config(EFFNET_CONFIG)
    k = cfg.ranking_size
    shapes |= {(GATE_TRAIN_BATCH * GATE_RPI, GATE_K),
               (ACTIVE_BATCH * (ACTIVE_SPLIT ** 2 // k), k)}
    for space in (SEARCH_SPACES["base"], SEARCH_SPACES["large_rankings"]):
        batches = space.get("batch_size", {"values": [cfg.batch_size]})["values"]
        rpis = space["rankings_per_image"]["values"] + [cfg.val_rpi]
        shapes |= {(b * r, kk) for b in batches for r in rpis
                   for kk in space["ranking_size"]["values"]}
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
    for r in range(4):
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


# the layout sweep's K: both layouts where the thread one takes K (5), the
# warp layout at 32 (10, 25, 64, 128 and 500 cut to keep the script inside
# its time limit with phases 18 and 19; K 500 is timed above)
K1_SWEEP_KS = (5,)  # K 32 cut as K1_TIME_SHAPES' K 500 (its last times: PERF.md)


def k1_sweep(smi: str, n: int = BATCH_TRAIN * 100, ks=K1_SWEEP_KS,
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


EVAL_DS_SIZE, EVAL_LIMIT, ZS_FILES = 96, 64, 8
# the zero-shot sets' image sizes (H, W)
IBIMS_HW, DIODE_HW, SINTEL_HW, DIW_HW = (480, 640), (768, 1024), (436, 1024), (375, 500)
EVAL_TOL = {"test_error": 0.03, "whdr_tau_0.03": 0.03, "ndcg_200": 0.05}  # device vs host
PARITY_KEYS = {"test_error", "whdr_tau_0.03", "ndcg_200", "config", "parity"}
EDGE_KEYS = {"depth_boundary_metric", "depth_completeness"}


def import_state(name: str) -> str:
    """What ``import name`` gives here: its version, or the error."""
    import importlib

    try:
        mod = importlib.import_module(name)
    except ImportError as e:
        return f"not importable: {e}"
    return f"version {getattr(mod, '__version__', '?')}"


def run_cli(argv):
    """``pldepth_torch.cli.main(argv)`` in this process; returns its standard
    output's lines (echoed here) and its seconds on the host clock."""
    import io

    import torch

    from pldepth_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = buf.getvalue().strip().splitlines()
    for line in lines:
        log(f"  | {line}")
    if rc != 0:
        fail(f"cli {argv[0]} returned {rc}")
    return lines, secs


def json_report(lines, what: str) -> dict:
    """The JSON object a command printed last (``eval`` / ``zeroshot`` print
    one indented object)."""
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    try:
        return json.loads("\n".join(lines[start:]))
    except json.JSONDecodeError as e:
        fail(f"{what}: no JSON report on its output ({e})")


def finite_report(rep: dict, what: str) -> None:
    bad = {k: v for k, v in rep.items() if not isinstance(v, dict) and not math.isfinite(v)}
    if bad:
        fail(f"{what}: non-finite metrics {bad}")


def injected_check(trainer, state, ds, device="cuda", pairs: int = 5000, ids: int = 200):
    """Device metrics on the card with host-drawn indices against the host
    numpy formulas in float32 (the device's dtype): disagreement fractions
    equal, NDCG within rel 1e-6."""
    import numpy as np
    import torch

    from pldepth_torch.eval import device_metrics as D

    images = np.stack([ds[i]["image"] for i in range(BATCH_SERVE)])
    gts = np.stack([ds[i]["gt"] for i in range(BATCH_SERVE)]).reshape(BATCH_SERVE, -1)
    preds = trainer.predict(state, images).float().reshape(BATCH_SERVE, -1)
    p_host = preds.cpu().numpy()
    n = p_host.shape[1]
    rng = np.random.default_rng(13)
    idx = np.stack([rng.choice(n, 2 * pairs, replace=False) for _ in range(BATCH_SERVE)])
    sel = np.stack([rng.choice(n, ids, replace=False) for _ in range(BATCH_SERVE)])
    i0, i1 = idx[:, :pairs], idx[:, pairs:]
    take = lambda a, i: np.take_along_axis(a, i, 1)  # noqa: E731
    p0, p1, g0, g1 = take(p_host, i0), take(p_host, i1), take(gts, i0), take(gts, i1)
    one, f32 = np.float32(1.0), np.float32

    def rel(a, b):
        r = (a + f32(1e-10)) / (b + f32(1e-10))
        return np.where(r >= f32(1.03), 1, np.where(r <= f32(1 / 1.03), -1, 0))

    counts = {0.0: ((p0 > p1) != (g0 > g1)).sum(1), 0.03: (rel(p0, p1) != rel(g0, g1)).sum(1)}
    dev = [torch.from_numpy(a).to(device) for a in (gts, i0, i1, sel)]
    out = {}
    for tau, count in counts.items():
        got = D.pairwise_disagreement(preds, dev[0], dev[1], dev[2], tau).cpu().numpy()
        want = (one - f32(pairs - count) / f32(pairs)) if tau == 0.0 else f32(count) / f32(pairs)
        if not np.array_equal(got, want.astype(np.float32)):
            fail(f"pairwise_disagreement tau {tau} on the card: {got} != host {want}")
        out[f"disagreeing_pairs_tau_{tau}"] = count.tolist()
    pm = (p_host - p_host.min(1, keepdims=True)) / (
        p_host.max(1, keepdims=True) - p_host.min(1, keepdims=True))
    sp, sg = np.sort(take(pm, sel), 1), np.sort(take(gts, sel), 1)
    w = np.log2(np.arange(ids, dtype=np.float32) + f32(2))
    want = (one / (sp + one) / w).sum(1) / (one / (sg + one) / w).sum(1)
    got = D.ndcg_sampled(preds, dev[0], dev[3]).cpu().numpy()
    nd_rel = float(np.abs(got / want - 1).max())
    if nd_rel > 1e-6:
        fail(f"ndcg_sampled on the card vs host float32: rel {nd_rel:.3e} > 1e-6")
    out["ndcg_rel"] = nd_rel
    log(f"device metrics on the card, injected indices ({BATCH_SERVE} maps of {n} pixels, "
        f"{pairs} pairs): disagreement equal to the host count at tau 0 and 0.03; NDCG rel "
        f"{nd_rel:.2e} (tol 1e-6)")
    return out


def report_times(trainer, state, ds, smi: str):
    """Seconds per image of full_report (host metrics) and full_report_device
    on a decoded, cached set (CUDA events around the whole report, the
    second of two runs), and the share of the host path's three
    RandomState.choice draws (host clock)."""
    import numpy as np
    import torch

    from pldepth_torch.eval.evaluator import Evaluator

    ev = Evaluator(trainer, state)
    n = len(ds)
    out = {}
    for name, fn in (("host", ev.full_report), ("device", ev.full_report_device)):
        for _ in range(2):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn(ds)
            end.record()
            end.synchronize()
        out[f"{name}_s_per_image"] = start.elapsed_time(end) / 1e3 / n
    size = ds[0]["gt"].size
    pairs, ids = 2 * min(5000, size // 2), min(200, size)  # the metrics' small-image guards
    t0 = time.perf_counter()
    for _ in range(n):
        np.random.RandomState(10).choice(size, pairs, replace=False)
        np.random.RandomState(10).choice(size, pairs, replace=False)
        np.random.RandomState(69).choice(size, ids, replace=False)
    out["host_draws_s_per_image"] = (time.perf_counter() - t0) / n
    out["host_draws_share"] = out["host_draws_s_per_image"] / out["host_s_per_image"]
    log(f"report over {n} images at {ds[0]['gt'].shape[0]}^2: host path "
        f"{out['host_s_per_image'] * 1e3:.3f} ms per image (its three numpy draws of "
        f"{size} pixels: {out['host_draws_s_per_image'] * 1e3:.3f} ms, "
        f"{100 * out['host_draws_share']:.1f}%), device path "
        f"{out['device_s_per_image'] * 1e3:.3f} ms per image [{smi}]")
    return out


def seeded_scene(rng, hw):
    """(image (H, W, 3) in 0-255, depth (H, W) in metres), float32: depth
    grows left to right with a step at a random row; red is inverse depth."""
    import numpy as np

    yy, xx = np.mgrid[: hw[0], : hw[1]].astype(np.float32)
    depth = 1.0 + 4.0 * xx / hw[1] + rng.uniform(0, 3) * (yy > hw[0] * rng.uniform(0.3, 0.7))
    depth = (depth + rng.normal(0, 0.05, hw)).astype(np.float32)
    image = np.stack([255 * (depth.min() / depth), rng.uniform(0, 255, hw), np.full(hw, 128.0)],
                     -1).astype(np.float32)
    return image, depth


def write_ibims(root: str, n: int, hw, seed: int = 0) -> None:
    """Seeded files in the Ibims layout: a data struct, image at field 2 in
    0-255, depth at field 3."""
    import numpy as np
    from scipy import io as sio

    rng = np.random.default_rng(seed)
    for i in range(n):
        image, depth = seeded_scene(rng, hw)
        data = np.zeros((1, 1), dtype=[("a", "O"), ("b", "O"), ("rgb", "O"), ("depth", "O")])
        data[0, 0]["a"], data[0, 0]["b"] = np.zeros(1), np.zeros(1)
        data[0, 0]["rgb"], data[0, 0]["depth"] = image, depth
        sio.savemat(os.path.join(root, f"ibims_{i:02d}.mat"), {"data": data})


def write_png_sets(tmp: str, n: int, seed: int = 1) -> dict:
    """Seeded DIODE (png + _depth.npy), Sintel (images/ + depth_viz/ pngs)
    and DIW (jpgs + DIW_test.csv, one pair each, 1-indexed) trees at their
    datasets' sizes. Returns {flag: root}."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    roots = {k: os.path.join(tmp, k) for k in ("diode", "sintel", "diw")}
    scene = os.path.join(roots["diode"], "val", "indoors", "scene_00000")
    frames = [os.path.join(roots["sintel"], d, "alley_1") for d in ("images", "depth_viz")]
    for d in (scene, *frames, os.path.join(roots["diw"], "DIW_test")):
        os.makedirs(d)
    csv = []
    for i in range(n):
        image, depth = seeded_scene(rng, DIODE_HW)
        Image.fromarray(image.astype(np.uint8)).save(os.path.join(scene, f"{i:05d}.png"))
        np.save(os.path.join(scene, f"{i:05d}_depth.npy"), depth[..., None])
        image, depth = seeded_scene(rng, SINTEL_HW)
        Image.fromarray(image.astype(np.uint8)).save(os.path.join(frames[0], f"frame_{i:04d}.png"))
        Image.fromarray((255 * depth / depth.max()).astype(np.uint8)).save(
            os.path.join(frames[1], f"frame_{i:04d}.png"))
        image, depth = seeded_scene(rng, DIW_HW)
        Image.fromarray(image.astype(np.uint8)).save(
            os.path.join(roots["diw"], "DIW_test", f"{i:03d}.jpg"), quality=95)
        ya, yb = rng.integers(1, DIW_HW[0] + 1, 2)
        xa, xb = rng.integers(1, DIW_HW[1] + 1, 2)
        rel = ">" if depth[ya - 1, xa - 1] > depth[yb - 1, xb - 1] else "<"
        csv += [f"/DIW_test/{i:03d}.jpg", f"{ya},{xa},{yb},{xb},{rel},{DIW_HW[1]},{DIW_HW[0]}"]
    with open(os.path.join(roots["diw"], "DIW_test.csv"), "w") as f:
        f.write("\n".join(csv) + "\n")
    return roots


def eval_phase(smi: str) -> dict:
    """Phase 13: cli train with the post-train report, cli eval on both
    paths, device metrics with injected indices, report times, cli zeroshot
    on Ibims files."""
    import numpy as np
    import torch

    from pldepth_torch import cli
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.data.datasets import get_dataset
    from pldepth_torch.eval import Evaluator
    from pldepth_torch.eval import metrics as M
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import infer_decoder_head_ch, load_weights_npz

    here = os.path.dirname(os.path.abspath(__file__))
    model = load_config(EFFNET_CONFIG).model_name
    libs = {m: import_state(m) for m in ("cv2", "PIL", "h5py", "scipy")}
    rec = {"imports": libs, **{f"has_{m}": not v.startswith("not") for m, v in libs.items()}}
    log(f"optional host libraries: {libs}")
    with tempfile.TemporaryDirectory() as tmp:
        # train: ff_effnet at 448^2 from BASELINE config #1, one epoch, the
        # post-train block with the parity report (timed alone)
        real_post = cli._post_train_eval

        def timed_post(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            real_post(*a, **k)
            torch.cuda.synchronize()
            rec["post_train_s"] = time.perf_counter() - t0

        cli._post_train_eval = timed_post
        k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
        try:
            lines, rec["train_cli_s"] = run_cli([
                "train", "--config_json", os.path.join(here, "configs", EFFNET_CONFIG),
                "--dataset", "synthetic", "--ds_size", str(EVAL_DS_SIZE), "--epochs", "1",
                "--parity_report", "true", "--parity_target_whdr", "1.0",
                "--output_dir", tmp, "--run_name", "eval"])
        finally:
            cli._post_train_eval = real_post
        rec["k1_launches"] = {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                              "ranking_loss_bwd": k1.ranking_loss_bwd.launches}
        if min(rec["k1_launches"].values()) == 0:
            fail(f"cli train did not launch the fused K1 both ways: {rec['k1_launches']}")
        post = json.loads(next(line for line in lines if line.startswith('{"test_error"')))
        finite_report(post, "post-train evaluation")
        verdict = [line for line in lines if line.startswith("PARITY ")]
        run = os.path.join(tmp, "eval")
        with open(os.path.join(run, "summary.json")) as f:
            summary = json.load(f)
        with open(os.path.join(run, "parity_report.json")) as f:
            parity = json.load(f)
        if summary != post or set(summary) != {"test_error", "ndcg_200"}:
            fail(f"summary.json {summary} is not the post-train line {post}")
        if not PARITY_KEYS <= set(parity) or set(parity) - PARITY_KEYS - EDGE_KEYS or not verdict:
            fail(f"parity_report.json keys {sorted(parity)} / verdict line {verdict}")
        finite_report(parity, "parity report")
        rec.update(post_train=post, parity_report=parity, parity_line=verdict[0])
        if EDGE_KEYS & set(parity):
            log("edge metrics in the parity report: cv2 is present")
        else:
            why = ("cv2 is present but Canny found no edges in these maps" if rec["has_cv2"]
                   else "cv2 does not import on this machine")
            log(f"edge metrics (depth_boundary_metric, depth_completeness) left out of the "
                f"parity report: {why}")
        pngs = sorted(os.listdir(os.path.join(run, "examples")))
        rec["example_pngs"] = pngs
        if rec["has_PIL"] and len(pngs) != 3:
            fail(f"log_images wrote {pngs} with PIL present")
        if not rec["has_PIL"]:
            log("log_images wrote no PNG: this machine has no PIL (the warnings above say so)")
        n_val = EVAL_DS_SIZE // load_config(EFFNET_CONFIG).val_split_denom
        log(f"post-train block: {rec['post_train_s']:.3f} s on {n_val} val images "
            f"at {SIZE}^2 (calc_err, dcg_metric, example, full_report); cli train "
            f"{rec['train_cli_s']:.1f} s in all; K1 launches {rec['k1_launches']} [{smi}]")

        # eval: both paths through the CLI, then the same reports timed
        weights = os.path.join(run, "weights.npz")
        common = ["eval", "--model_name", model, "--load_model_path", weights,
                  "--dataset", "synthetic", "--input_size", str(SIZE), "--limit", str(EVAL_LIMIT)]
        reports = {}
        for flag in ("false", "true"):
            lines, secs = run_cli(common + ["--device_metrics", flag])
            reports[flag] = json_report(lines, f"cli eval --device_metrics {flag}")
            finite_report(reports[flag], f"cli eval --device_metrics {flag}")
            rec[f"eval_cli_s_device_metrics_{flag}"] = secs
        rec["eval_host"], rec["eval_device"] = reports["false"], reports["true"]
        gaps = {k: abs(reports["true"][k] - reports["false"][k]) for k in EVAL_TOL}
        rec["eval_gaps"] = gaps
        log(f"cli eval {EVAL_LIMIT} images at {SIZE}^2: device vs host report {gaps} "
            f"(tol {EVAL_TOL})")
        if any(gaps[k] > EVAL_TOL[k] for k in EVAL_TOL):
            fail(f"the device report is off the host report: {gaps}")

        cfg = ExperimentConfig(model_name=model, input_size=SIZE,
                               decoder_head_ch=infer_decoder_head_ch(weights))
        trainer = Trainer(cfg, steps_per_epoch=1)
        state = load_weights_npz(weights, trainer.init_state())
        ds = get_dataset("synthetic", target_size=SIZE, size=EVAL_LIMIT).cached()
        rec["injected"] = injected_check(trainer, state, ds)
        rec["times"] = report_times(trainer, state, ds, smi)

        # zeroshot: seeded files in the Ibims layout at Ibims' 480x640, and
        # where PIL is present DIODE, Sintel and DIW trees at their sizes
        ibims = os.path.join(tmp, "ibims")
        os.makedirs(ibims)
        write_ibims(ibims, ZS_FILES, IBIMS_HW)
        roots = {"ibims": ibims, **(write_png_sets(tmp, ZS_FILES) if rec["has_PIL"] else {})}
        lines, rec["zeroshot_cli_s"] = run_cli([
            "zeroshot", "--model_name", model, "--load_model_path", weights,
            "--input_size", str(SIZE), *[a for k, root in roots.items()
                                         for a in (f"--{k}_root", root)]])
        zs = json_report(lines, "cli zeroshot")
        dense = set(roots) - {"diw"}
        if set(zs) != set(roots) or any(set(zs[k]) != {"ordinal_error", "whdr_0.03"}
                                        for k in dense):
            fail(f"cli zeroshot report {zs} for roots {sorted(roots)}")
        for k in dense:
            finite_report(zs[k], f"cli zeroshot {k}")
        if "diw" in zs and not (zs["diw"]["n_pairs"] == zs["diw"]["n_images"] == ZS_FILES
                                and 0.0 <= zs["diw"]["diw_whdr"] <= 1.0):
            fail(f"cli zeroshot DIW report {zs['diw']}")
        zds = get_dataset("IBIMS", root=ibims, target_size=SIZE)
        preds = list(Evaluator(trainer, state)._predict_dataset(zds))
        flipped = float(np.mean([M.ordinal_error(p, g, invert_pred_order=True) for p, g in preds]))
        plain = float(np.mean([M.ordinal_error(p, g) for p, g in preds]))
        if not (zds.asc_depth_order and len(zds) == ZS_FILES
                and abs(zs["ibims"]["ordinal_error"] - flipped) <= 1e-3):
            fail(f"zeroshot Ibims did not score in ascending order: {zs['ibims']} vs inverted "
                 f"{flipped} / not inverted {plain}")
        rec["zeroshot"] = zs
        log(f"cli zeroshot, {ZS_FILES} files a set ({sorted(roots)}; Ibims {IBIMS_HW}, DIODE "
            f"{DIODE_HW}, Sintel {SINTEL_HW}, DIW {DIW_HW} -> {SIZE}^2): {zs}; Ibims in "
            f"ascending order (the descending comparison would read {plain:.4f}) "
            f"[{rec['zeroshot_cli_s']:.1f} s]")
        held = ([] if rec["has_PIL"] else ["DIODE", "Sintel", "DIW"]) + (
            [] if rec["has_h5py"] else ["TUM"])
        if held:
            log(f"held on the CPU only (tests/test_torch_zeroshot.py), their readers' library "
                f"missing here: {held}")
    return rec


# phase 14: scenes at 448^2, split as cli train splits them; each feed trains
# DATA_EPOCHS x DATA_STEPS steps through Trainer.fit (one val batch an epoch)
DATA_N, DATA_STEPS, DATA_EPOCHS, DATA_CLI_N = 512, 10, 2, 80
DATA_CHAIN = 4  # resident_chain_steps of the chained resident feed
HTOD_RESIDENT_MB = 1.0  # gate: batch data a resident step may copy host-to-device
# resident_chain(4) against four resident_step calls: K1's backward adds its
# gradient map with atomics, so the card is not bit-deterministic, and
# AMSGrad's first steps move every trainable by about +-lr whatever its
# gradient's size, so a gradient whose sign sits at that noise floor flips
# its update: two runs of the same four single steps differ by loss rel
# 6.9e-4 and update rel 6.7e-2 (||p - p'|| / ||p - p0||) on the H100. A chain
# that drew other batches or skipped a step differs by O(1e-1) / O(1).
CHAIN_LOSS_RTOL, CHAIN_UPDATE_RTOL = 1e-2, 0.25


def scene_sample(index: int, size: int, seed: int):
    """One ``scenes`` sample (a spawned worker's job in phases 14 and 16)."""
    import cv2

    from pldepth_torch.data.scenes import generate_scene

    cv2.setNumThreads(1)  # the workers run side by side
    s = generate_scene(index, size, seed)
    return {k: s[k] for k in ("image", "gt", "mask")}


SCENE_SETS = {}  # (size, seed) -> the scenes scenes_cached made in this run


def scenes_cached(specs, size: int, also=()):
    """``get_dataset("scenes", size=n, seed=seed, target_size=size)`` for each
    (n, seed) of ``specs``, every sample made once in parallel (spawned
    workers: this process has CUDA and threads) and kept in host memory;
    the first and last sample of each set checked against the dataset's own
    loader. The sets of ``also`` are made by the same workers and kept for a
    later call (one pool start, not two); a set already made serves any
    ``n`` up to its own (``take``). Returns ({(size, seed): dataset},
    workers)."""
    import dataclasses
    from concurrent.futures import ProcessPoolExecutor
    from multiprocessing import get_context

    import numpy as np

    from pldepth_torch.data.datasets import get_dataset

    workers = max(1, min(8, (os.cpu_count() or 1)))
    most = {}
    for n, seed in (*specs, *also):
        most[seed] = max(n, most.get(seed, 0))
    todo = [(n, seed) for seed, n in most.items() if len(SCENE_SETS.get((size, seed), ())) < n]
    asked = {(size, seed) for _, seed in specs}
    if not todo:
        return {key: SCENE_SETS[key] for key in asked}, workers
    jobs = [(i, seed) for n, seed in todo for i in range(n)]
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=get_context("spawn")) as pool:
        results = pool.map(scene_sample, [i for i, _ in jobs], [size] * len(jobs),
                           [seed for _, seed in jobs], chunksize=8)
        items = [next(results)]
        first_s = time.perf_counter() - t0
        items += list(results)
    log(f"scenes: the first of {len(jobs)} ({todo} at {size}^2) back from a worker after "
        f"{first_s:.1f} s, all after {time.perf_counter() - t0:.1f} s")
    k = 0
    for n, seed in todo:
        ds = get_dataset("scenes", size=n, seed=seed, target_size=size)
        mine, k = items[k: k + n], k + n
        for i in (0, n - 1):
            if any(not np.array_equal(mine[i][key], v) for key, v in ds[i].items()):
                fail(f"scene {i} of seed {seed} made by a worker differs from the dataset's own")
        SCENE_SETS[(size, seed)] = dataclasses.replace(ds, loader=mine.__getitem__)
    return {key: SCENE_SETS[key] for key in asked}, workers


# feed_window attempts before a host-to-device gate fails (was 3: three
# windows in a row have been seen to lose their last call's batch upload)
FEED_WINDOW_TRIES = 6


def feed_window(fn, n: int, steps_per_call: int, unprofiled_ms: float, spin: int = SPIN_KERNELS):
    """One profiled window of ``n`` calls of ``fn`` (after one call outside
    it, opened by ``spin`` spin kernels as kernel_window's are): device busy
    ms a step (kernels and copies), the idle share against the unprofiled
    ms a step, the top kernels, and the host-to-device bytes: the memcpy
    HtoD events of the profiler's trace, MB and copies a step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(spin):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    steps = n * steps_per_call
    by_kernel = {e.key: e.self_device_time_total / 1e3 / steps for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                 and "spin_kernel" not in e.key}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy" and "HtoD" in e.get("name", "")]
    blind = [e for e in copies if "bytes" not in e.get("args", {})]
    if blind:
        fail(f"memcpy HtoD events without a byte count in the trace: {blind[:2]}")
    busy = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:5]
    return {"device_busy_ms": busy, "idle_share": 1 - busy / unprofiled_ms,
            "top_kernels": [{"name": k, "ms_per_step": ms} for k, ms in top],
            "htod_mb": sum(e["args"]["bytes"] for e in copies) / 1e6 / steps,
            "htod_copies": len(copies) / steps,
            "htod_events": [(e["name"], e["args"]["bytes"]) for e in copies]}


def data_path_phase(smi: str, device="cuda", size=SIZE, batch=BATCH_TRAIN, n=DATA_N) -> dict:
    """Phase 14: the training data path. BASELINE config #1 (bf16, batch 32)
    on ``n`` scenes at 448^2 through Trainer.fit on each of five feeds
    (BatchIterator f32, BatchIterator uint8_wire, the native packed reader,
    the resident store with chains of 1 and of DATA_CHAIN steps), their
    gates and numbers, then cli train --data_resident true end to end.
    ``device="cpu"`` rehearses the control flow (no K1 launch or HtoD gate,
    the timing helpers stubbed by the caller)."""
    import numpy as np
    import torch

    from pldepth_torch.data.packed import NativePackedIterator, PackedDataset, pack_dataset
    from pldepth_torch.data.pipeline import (
        BatchIterator,
        pregenerate_val_rankings,
        train_val_split,
        val_batches,
    )
    from pldepth_torch.data.resident import build_resident_store
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import Trainer

    here = os.path.dirname(os.path.abspath(__file__))
    cuda = device == "cuda"
    cfg = load_config(EFFNET_CONFIG).replace(
        input_size=size, batch_size=batch, dataset="scenes", ds_size=n, epochs=DATA_EPOCHS)
    rec = {"n": n, "size": size, "batch": batch, "steps": DATA_STEPS * DATA_EPOCHS}
    t0 = time.perf_counter()
    sets, rec["scene_workers"] = scenes_cached([(n, cfg.seed)], size, also=(
        PHASE16_SCENES if size == SIZE else ()))
    ds = sets[(size, cfg.seed)]
    rec["scenes_s"] = time.perf_counter() - t0
    train_ds, val_ds = train_val_split(ds, cfg.val_split_denom)
    rec["train_n"], rec["val_n"] = len(train_ds), len(val_ds)
    log(f"scenes: {n} at {size}^2 (and phase 16's) in {rec['scenes_s']:.1f} s on {rec['scene_workers']} "
        f"workers; train {len(train_ds)}, val {len(val_ds)}")
    val_rankings = pregenerate_val_rankings(
        val_ds, sampler_name="thresholded", rankings_per_image=cfg.val_rpi,
        ranking_size=cfg.ranking_size, threshold=cfg.equality_threshold, seed=cfg.seed,
        device=device)
    n_val = len(val_ds) // batch

    with tempfile.TemporaryDirectory() as tmp:
        pack = os.path.join(tmp, "train.pldpack")
        t0 = time.perf_counter()
        pack_dataset(train_ds, pack)
        rec["pack_s"], rec["pack_gb"] = time.perf_counter() - t0, os.path.getsize(pack) / 1e9
        rows = PackedDataset(pack)
        t0 = time.perf_counter()
        store = build_resident_store(rows, device)
        if cuda:
            torch.cuda.synchronize()
        rec["store_s"], rec["store_gb"] = time.perf_counter() - t0, store.nbytes / 1e9
        log(f"pack: {len(train_ds)} samples -> {rec['pack_gb']:.3f} GB in {rec['pack_s']:.2f} s; "
            f"resident store {rec['store_gb']:.3f} GB on the card in {rec['store_s']:.2f} s")

        # gates on the readers and the store -------------------------------
        for wire in (True, False):
            it = NativePackedIterator(pack, batch, shuffle=False, loop=False, uint8_wire=wire)
            for b in range(2):
                got = next(it)
                for j in range(batch):
                    row = rows[b * batch + j]
                    img = np.round(row["image"] * 255.0).astype(np.uint8)
                    want = {"image": img if wire else img * np.float32(1 / 255), "gt": row["gt"],
                            "mask": row["mask"].astype(np.uint8 if wire else np.float32)}
                    bad = [k for k, v in want.items() if not np.array_equal(got[k][j], v)]
                    if bad:
                        fail(f"native reader batch {b} row {j} ({'u8' if wire else 'f32'} "
                             f"wire): {bad} differ from the pack's rows")
            it.close()
        tr1 = Trainer(cfg, DATA_STEPS, device=device)
        idx = torch.tensor([0, 5, len(rows) - 1, 5], device=device)
        drawn = tr1.resident_batch(tr1.init_state(), store.arrays, idx)
        cpu = {k: v.cpu() for k, v in store.arrays.items()}
        want = tr1.resident_batch(tr1.init_state(), cpu, idx.cpu())
        host_gt = (cpu["gt"].numpy().view(np.uint16)[idx.cpu().numpy()].astype(np.float32)
                   * np.float32(store.gt_scale))
        if any(not torch.equal(drawn[k].cpu(), want[k]) for k in want) or not np.array_equal(
                want["gt"].numpy(), host_gt):
            fail("the store's decode on the card differs from the CPU decode")
        rec["decode_equal"] = True

        # chain against single steps ----------------------------------------
        trc = Trainer(cfg.replace(resident_chain_steps=DATA_CHAIN), DATA_STEPS, device=device)
        runs = []
        for how in ("chain", "singles", "singles"):
            st = trc.init_state()
            p0 = torch.cat([p.detach().float().flatten() for p in st.model.parameters()
                            if p.requires_grad])
            if how == "chain":
                st, m = trc.resident_chain(DATA_CHAIN)(st, store.arrays)
                losses = m.loss.float().cpu()
            else:
                ls = []
                for _ in range(DATA_CHAIN):
                    st, m = trc.resident_step(st, store.arrays)
                    ls.append(m.loss)
                losses = torch.stack(ls).float().cpu()
            p1 = torch.cat([p.detach().float().flatten() for p in st.model.parameters()
                            if p.requires_grad])
            runs.append((losses, p0, p1))
        (la, p0, pa), (lb, _, pb), (lc, _, pc) = runs
        upd = float((pa - p0).norm())
        loss_rel = float(((la - lb).abs() / lb.abs()).max())
        upd_rel = float((pa - pb).norm()) / upd
        spread = {"loss_rel": float(((lc - lb).abs() / lb.abs()).max()),
                  "update_rel": float((pc - pb).norm()) / upd}
        rec["chain_vs_singles"] = {"loss_rel": loss_rel, "update_rel": upd_rel,
                                   "singles_vs_singles": spread, "losses": la.tolist()}
        log(f"resident_chain({DATA_CHAIN}) vs {DATA_CHAIN} resident_step calls: loss rel "
            f"{loss_rel:.2e} (tol {CHAIN_LOSS_RTOL:g}), update rel {upd_rel:.2e} (tol "
            f"{CHAIN_UPDATE_RTOL:g}); two runs of the single steps: {spread}")
        if not (loss_rel <= CHAIN_LOSS_RTOL and upd_rel <= CHAIN_UPDATE_RTOL):
            fail(f"resident_chain({DATA_CHAIN}) differs from single steps: loss rel "
                 f"{loss_rel:.3e}, update rel {upd_rel:.3e}")
        del runs

        # the five feeds through fit --------------------------------------------
        # (trainer, host iterator factory, resident store, batch bytes a pixel
        # on the wire: f32 image + gt + mask 20, uint8 image and mask 8)
        feeds = {
            "batch_iterator_f32": (tr1, lambda: BatchIterator(
                train_ds, batch, seed=cfg.seed, prefetch=cfg.prefetch_depth), None, 20),
            "batch_iterator_uint8": (tr1, lambda: BatchIterator(
                train_ds, batch, seed=cfg.seed, prefetch=cfg.prefetch_depth, uint8_wire=True),
                None, 8),
            "native_packed": (tr1, lambda: NativePackedIterator(
                pack, batch, seed=cfg.seed, ring=cfg.prefetch_depth), None, 8),
            "resident": (tr1, None, store, 0),
            f"resident_chain{DATA_CHAIN}": (trc, None, store, 0),
        }
        rec["feeds"], rec["k1_launches"] = {}, {"ranking_loss_fwd": 0, "ranking_loss_bwd": 0}
        for name, (tr, make_iter, res, wire_bytes) in feeds.items():
            it = make_iter() if make_iter else None
            state = tr.init_state()
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
            t0 = time.perf_counter()
            state, hist = tr.fit(state, it, val_iter_factory=(lambda: val_batches(
                val_ds, val_rankings, batch)) if n_val else None, resident_store=res)
            fit_s = time.perf_counter() - t0
            launches = {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                        "ranking_loss_bwd": k1.ranking_loss_bwd.launches}
            peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else None
            steps = DATA_STEPS * DATA_EPOCHS
            losses = hist["loss"] + hist["val_loss"]
            if state.step != steps or not np.all(np.isfinite(losses)):
                fail(f"{name}: fit did not run {steps} finite steps: {hist}")
            want_fwd = steps + DATA_EPOCHS * n_val
            if cuda and launches != {"ranking_loss_fwd": want_fwd, "ranking_loss_bwd": steps}:
                fail(f"{name}: K1 launches {launches}, expected forward {want_fwd} (steps + "
                     f"val batches) and backward {steps}")
            for k, v in launches.items():
                rec["k1_launches"][k] += v

            box = [state]
            chain = DATA_CHAIN if tr is trc else 1
            if res is not None:
                def unit(tr=tr, chain=chain):
                    box[0], _ = tr.resident_chain(chain)(box[0], store.arrays)
            else:
                def unit(tr=tr, it=it):
                    box[0], _ = tr.train_step(box[0], next(it))
            ms = cuda_ms(unit, reps=max(2, 6 // chain), warmup=1) / chain
            expect = batch * size * size * wire_bytes
            seen = []
            for attempt in range(FEED_WINDOW_TRIES):  # a window that lost copies is retaken
                win = feed_window(unit, max(1, 3 // chain), chain, ms,
                                  SPIN_KERNELS << min(2 * attempt, 6))
                mb, copies = win["htod_mb"], win["htod_copies"]
                seen.append(round(mb, 3))
                if mb * 1e6 >= expect:
                    break
                log(f"{name}: a window of HtoD copies short of the batch: {win['htod_events']}")
            if it is not None:
                it.close()
            if cuda and mb * 1e6 < expect:
                fail(f"{name}: the profiler saw {seen} MB host-to-device a step in its windows, "
                     f"less than the batch's {expect / 1e6:.2f} MB: the measure is blind")
            if cuda and res is not None and mb >= HTOD_RESIDENT_MB:
                fail(f"{name}: {mb:.3f} MB host-to-device a step (gate < {HTOD_RESIDENT_MB} MB)")
            feed = {"fit_s": fit_s, "fit_img_per_s_epochs": hist["ips"],
                    "fit_img_per_s": hist["ips"][-1], "step_ms": ms,
                    "idle_share": win["idle_share"], "device_busy_ms_per_step":
                    win["device_busy_ms"], "htod_mb_per_step": mb,
                    "htod_copies_per_step": copies, "batch_mb": expect / 1e6,
                    "peak_mem_gb": peak, "launches": launches, "history": hist,
                    "top_kernels": win["top_kernels"]}
            rec["feeds"][name] = feed
            log(f"feed {name}: fit {feed['fit_img_per_s']:.1f} img/s (epochs "
                f"{[round(x, 1) for x in hist['ips']]}), {ms:.2f} ms a step (1/step "
                f"{1000 * batch / ms:.1f} img/s), device busy {win['device_busy_ms']:.2f} ms "
                f"a step, idle {feed['idle_share']:.3f}, HtoD "
                f"{mb:.3f} MB a step in {copies:.1f} copies, peak {peak} GB, K1 "
                f"{launches} [{smi}]")
            del state, box
        del store, feeds, unit
        torch.cuda.empty_cache()

    # cli train from a resident store, end to end -------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
        lines, rec["cli_s"] = run_cli([
            "train", "--config_json", os.path.join(here, "configs", EFFNET_CONFIG),
            "--dataset", "scenes", "--ds_size", str(DATA_CLI_N), "--batch_size", "8",
            "--input_size", str(size), "--epochs", "1", "--data_resident", "true",
            "--resident_chain_steps", "2", "--output_dir", tmp, "--run_name", "resident",
            "--device", device])
        n_train = DATA_CLI_N - DATA_CLI_N // cfg.val_split_denom
        steps = n_train // 8
        cli_launches = (k1.ranking_loss_fwd.launches, k1.ranking_loss_bwd.launches)
        said = [line for line in lines if line.startswith("resident store: ")]
        if not said or not said[0].startswith(f"resident store: {n_train} samples"):
            fail(f"cli train --data_resident: no resident store line for {n_train} samples")
        if cuda and cli_launches != (steps, steps):
            fail(f"cli train --data_resident: K1 launches {cli_launches}, expected {steps} each")
        if not os.path.exists(os.path.join(tmp, "resident", "weights.npz")):
            fail("cli train --data_resident wrote no weights.npz")
        res = json.loads(next(line for line in lines if line.startswith('{"run_dir"')))
        if not np.all(np.isfinite(res["loss"])):
            fail(f"cli train --data_resident: non-finite loss {res['loss']}")
        rec["cli"] = {"store_line": said[0], "k1_launches": cli_launches, "loss": res["loss"]}
    return rec


# phase 15: export and the training options ------------------------------------------
OPT_STEPS = 6  # train steps of each option run (10 until the phase-19 slice)
EXPORT_TOL = {"bfloat16": 3e-2, "float32": 1e-5}  # artifact vs predict_bnfold, max rel
EXPORT_POLY_BATCHES = (1, 3, 8)
ARTIFACT_CHILD = r"""
import json, sys
import numpy as np
import torch
from pldepth_torch.serve.export import load_exported
path, x_path, out_path, batches = sys.argv[1], sys.argv[2], sys.argv[3], json.loads(sys.argv[4])
call, meta = load_exported(path)
x = np.load(x_path)
outs = {str(b): call(x[:b]).float().cpu().numpy() for b in batches}
np.savez(out_path, **outs)
print(json.dumps({"meta": meta, "models_imported": "pldepth_torch.models" in sys.modules,
                  "pldepth": sorted(m for m in sys.modules if m.startswith("pldepth"))}))
"""


def max_rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


def start_artifact_children(paths, x_path: str, tmp: str):
    """Each artifact loaded and run in its own fresh process that imports
    serve/export.py alone (torch, json, numpy), all started at once; pass
    the result to :func:`artifact_children`."""
    procs = {}
    for path, batches in paths.items():
        out = os.path.join(tmp, os.path.basename(path) + ".npz")
        procs[path] = (out, subprocess.Popen(
            [sys.executable, "-c", ARTIFACT_CHILD, path, x_path, out, json.dumps(batches)],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def artifact_children(procs):
    """{path: (report, {batch: maps})} of the processes
    :func:`start_artifact_children` started, once each has ended."""
    import numpy as np

    got = {}
    for path, (out, proc) in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"loading {path} in a fresh process failed: {stderr[-2000:]}")
        report = json.loads(stdout.strip().splitlines()[-1])
        if report["models_imported"]:
            fail(f"loading {path} imported the model code: {report['pldepth']}")
        with np.load(out) as z:
            got[path] = (report, {int(k): z[k] for k in z.files})
    return got


def export_phase(decode, chunks, smi: str) -> dict:
    """Phase 15a: ff_effnet at 448^2, bf16, the bn_fold graph through ``cli
    export`` (fixed batch 8 and polymorphic), each artifact loaded in a
    fresh process without the model code (started as soon as it is
    written, while this process goes on), held against predict_bnfold; f32
    at 96^2; ``cli serve --artifact`` over 32 images; times."""
    import numpy as np
    import torch
    from PIL import Image

    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models.pretrained import flax_from_state_dict, overlay_synthetic
    from pldepth_torch.serve.daemon import artifact_infer
    from pldepth_torch.serve.export import export_predict, load_exported
    from pldepth_torch.serve.pipeline import decode_image_chunk
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import save_weights_npz

    rec = {}
    trainer = Trainer(ExperimentConfig(model_name="ff_effnet", input_size=SIZE))
    state = trainer.init_state()
    overlay_synthetic(state.model, list(flax_from_state_dict(state.model.state_dict())))
    randomise_bn(state.model, seed=5)
    imgs = torch.from_numpy(np.random.default_rng(15).uniform(
        size=(BATCH_SERVE, SIZE, SIZE, 3)).astype(np.float32)).cuda()
    want = trainer.predict_bnfold(state, imgs)
    with tempfile.TemporaryDirectory() as tmp:
        wpath, x_path = os.path.join(tmp, "weights.npz"), os.path.join(tmp, "x.npy")
        save_weights_npz(wpath, state)
        np.save(x_path, imgs.cpu().numpy())
        paths, procs, t0 = {}, {}, time.time()
        for name, batch, runs in (("fixed", BATCH_SERVE, [BATCH_SERVE]),
                                  ("poly", 0, list(EXPORT_POLY_BATCHES))):
            paths[name] = os.path.join(tmp, f"{name}.plx")
            lines, secs = run_cli(["export", "--model_name", "ff_effnet", "--load_model_path",
                                   wpath, "--out", paths[name], "--input_size", str(SIZE),
                                   "--batch_size", str(batch)])
            rec[f"export_{name}_s"] = secs
            rec[f"artifact_{name}_mb"] = os.path.getsize(paths[name]) / 1e6
            log(f"cli export {name}: {secs:.2f} s, {rec[f'artifact_{name}_mb']:.2f} MB")
            procs.update(start_artifact_children({paths[name]: runs}, x_path, tmp))
        call, meta = load_exported(paths["fixed"])
        try:
            call(imgs[:3])
        except Exception as e:  # the guard of a fixed-batch program
            log(f"fixed-batch artifact refuses batch 3: {type(e).__name__}")
        else:
            fail("the fixed-batch artifact ran a batch of 3")
        # f32 at 96^2
        g32 = Trainer(ExperimentConfig(model_name="ff_effnet", input_size=96,
                                       compute_dtype="float32"))
        s32 = g32.init_state()
        overlay_synthetic(s32.model, list(flax_from_state_dict(s32.model.state_dict())))
        randomise_bn(s32.model, seed=6)
        p32 = os.path.join(tmp, "f32.plx")
        export_predict(g32, s32, 2, p32, bn_fold=True)
        x96 = torch.from_numpy(np.random.default_rng(16).uniform(
            size=(2, 96, 96, 3)).astype(np.float32)).cuda()
        rec["f32_rel"] = rel = max_rel(load_exported(p32)[0](x96), g32.predict_bnfold(s32, x96))
        log(f"artifact f32 96^2 vs predict_bnfold: rel {rel:.3e} (tol {EXPORT_TOL['float32']:g})")
        if rel > EXPORT_TOL["float32"]:
            fail(f"the f32 artifact disagrees with predict_bnfold: rel {rel:.3e}")
        # cli serve --artifact over 32 images
        watch, out = os.path.join(tmp, "watch"), os.path.join(tmp, "out")
        os.makedirs(watch)
        rng = np.random.default_rng(17)
        for i in range(32):
            Image.fromarray(rng.integers(0, 256, (SIZE, SIZE, 3), np.uint8)).save(
                os.path.join(watch, f"im{i:02d}.png"))
        lines, secs = run_cli(["serve", "--artifact", paths["fixed"], "--watch_dir", watch,
                               "--out_dir", out, "--once", "true", "--poll_interval", "0.01"])
        rec["cli_serve_s"] = secs
        files = sorted(os.listdir(watch))
        written = sorted(os.listdir(out))
        if len(written) != 32:
            fail(f"cli serve --artifact wrote {len(written)} maps of 32")
        worst = 0.0
        for c in range(0, 32, BATCH_SERVE):
            chunk = files[c: c + BATCH_SERVE]
            ref = call(decode_image_chunk([os.path.join(watch, f) for f in chunk], SIZE))
            for f, r in zip(chunk, ref.float().cpu().numpy()):
                got = np.load(os.path.join(out, f[:-4] + "_depth.npy"))
                worst = max(worst, float(np.abs(got - r).max()))
        rec["cli_serve_max_abs_diff"] = worst
        log(f"cli serve --artifact --once true: 32 maps in {secs:.2f} s; max |d| against the "
            f"in-process artifact {worst:.3e}")
        if worst != 0.0:
            fail(f"cli serve --artifact maps differ from the in-process artifact's: {worst:.3e}")
        # the fresh processes
        child = artifact_children(procs)
        rec["child_s"] = time.time() - t0
        checks = []
        for name in ("fixed", "poly"):
            report, outs = child[paths[name]]
            for b, maps in outs.items():
                rel = max_rel(torch.from_numpy(maps), want[:b].cpu())
                checks.append({"artifact": name, "batch": b, "rel": rel})
                log(f"artifact {name} in a fresh process ({report['pldepth']}), batch {b}: "
                    f"{maps.shape}, vs predict_bnfold rel {rel:.3e} "
                    f"(tol {EXPORT_TOL['bfloat16']:g})")
                if maps.shape != (b, SIZE, SIZE) or not np.isfinite(maps).all() \
                        or rel > EXPORT_TOL["bfloat16"]:
                    fail(f"artifact {name} at batch {b}: shape {maps.shape} or rel {rel:.3e}")
        rec["checks"] = checks
        # times
        times, _ = alternating_ms({"artifact": lambda: call(imgs),
                                   "predict_bnfold": lambda: trainer.predict_bnfold(state, imgs)},
                                  smi, f"batch of {BATCH_SERVE} at {SIZE}^2 bf16", rounds=4,
                                  reps=5)
        rec["batch_ms"] = times
        infer, _ = artifact_infer(paths["fixed"])
        bnfold = trainer.jit_predict("bn_fold")
        rec["served_img_per_s"] = {
            "artifact": served_img_per_s(infer, decode, chunks, smi, "artifact", n_e2e=4),
            "predict_bnfold": served_img_per_s(lambda a: bnfold(state, a), decode, chunks, smi,
                                               "bn_fold", n_e2e=4)}
    return rec


def trainable_flat(model, skip_zero_grad: bool = False):
    """The trainable parameters as one flat tensor; without the decoder
    conv biases that feed a batch-statistics BN (zero gradient: their
    first AMSGrad update is lr * sign(noise)) when ``skip_zero_grad``."""
    import torch

    keep = [p for n, p in model.named_parameters() if p.requires_grad and not (
        skip_zero_grad and re.fullmatch(r"decoder\.conv\d\.bias", n))]
    return torch.cat([p.detach().reshape(-1) for p in keep])


def k_counts():
    from pldepth_torch.models.quantize import QuantConv
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops import quant_conv
    from pldepth_torch.ops import quant_matmul as k4

    out = {n: getattr(k1, n).launches for n in ("listmle_fwd", "listmle_bwd",
                                                "ranking_loss_fwd", "ranking_loss_bwd")}
    out["quant_matmul"] = k4.quant_matmul.launches
    out["window_reads"] = quant_conv.quant_conv2d.window_launches
    out["pack_builds"] = QuantConv.derivations
    return out


def reset_counts() -> None:
    from pldepth_torch.models.quantize import QuantConv
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.ops import quant_conv
    from pldepth_torch.ops import quant_matmul as k4

    for n in ("listmle_fwd", "listmle_bwd", "ranking_loss_fwd", "ranking_loss_bwd"):
        getattr(k1, n).launches = 0
    k4.quant_matmul.launches = 0
    quant_conv.quant_conv2d.window_launches = 0
    QuantConv.derivations = 0


def option_run(name: str, cfg, batches, smi: str, watch=None) -> dict:
    """OPT_STEPS train steps of ``cfg`` from its seeded initial state over
    ``batches`` (device batches, in turn): the loss of every step, ms a
    step (CUDA events, the median from the third step), peak memory, the
    kernel counts of the run (set to 0 before it), the trainable
    parameters before and after the first step, and the idle share of a
    1-step profiler window taken afterwards. ``watch(i, trainer, state)``
    runs after step i."""
    import numpy as np
    import torch

    from pldepth_torch.train import Trainer

    trainer = Trainer(cfg, steps_per_epoch=OPT_STEPS)
    state = trainer.init_state()
    rec = {"name": name}
    if cfg.qenc == "int8":
        trainer.prepare_qenc(state, batches[0]["image"])
    enc0 = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
    init = trainable_flat(state.model, skip_zero_grad=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(OPT_STEPS + 1)]
    losses = []
    ev[0].record()
    for i in range(OPT_STEPS):
        state, m = trainer.train_step(state, batches[i % len(batches)])
        ev[i + 1].record()
        losses.append(m.loss)
        if i == 0:
            rec["first_update"] = trainable_flat(state.model, skip_zero_grad=True) - init
        if watch is not None:
            watch(i, trainer, state)
    torch.cuda.synchronize()
    rec["counts"] = k_counts()
    rec["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(OPT_STEPS)]
    rec["step_ms_all"], rec["step_ms"] = step_ms, float(np.median(step_ms[2:]))
    rec["losses"] = [float(v) for v in losses]
    rec["encoder_unchanged"] = all(torch.equal(v, enc0[k])
                                   for k, v in state.model.encoder.state_dict().items())
    if not np.all(np.isfinite(rec["losses"])):
        fail(f"option {name}: non-finite losses {rec['losses']}")
    rec["trainer"], rec["state"] = trainer, state
    box = [state]

    def one():
        box[0], _m = trainer.train_step(box[0], batches[0])

    _, by_kernel, _ = kernel_window(one, 1)
    rec["busy_ms"] = busy = sum(by_kernel.values())
    rec["idle_share"] = 1 - busy / rec["step_ms"]
    log(f"option {name:16s}: {rec['step_ms']:.3f} ms a step of {cfg.batch_size} at "
        f"{cfg.input_size}^2 (events, median of steps 3-{OPT_STEPS}); peak "
        f"{rec['peak_gb']:.2f} GB; busy {busy:.3f} ms, idle {rec['idle_share']:.3f}; counts "
        f"{rec['counts']}; losses {[round(v, 4) for v in rec['losses']]} [{smi}]")
    return rec


def first_step_grads(cfg, batch, n: int = 1):
    """The gradients of step 0 of ``cfg`` from its seeded initial state on
    ``batch``, ``n`` times (the train step's own rankings, generator and
    loss; the trainable parameters as one flat tensor without the decoder
    conv biases that feed a BN): [(loss, grads)]."""
    import torch

    from pldepth_torch.data.preprocess import normalize_images
    from pldepth_torch.models.layers import TrainPass
    from pldepth_torch.ops.listmle import pl_ranking_loss
    from pldepth_torch.train import Trainer

    trainer = Trainer(cfg, steps_per_epoch=OPT_STEPS)
    state = trainer.init_state()
    images, rankings = trainer._rankings(state, trainer._to_device(batch))
    x = normalize_images(images, trainer.model.preprocess)
    params = [p for name, p in state.model.named_parameters() if p.requires_grad
              and not re.fullmatch(r"decoder\.conv\d\.bias", name)]
    out = []
    for _ in range(n):
        for p in state.model.parameters():
            p.grad = None
        pred = state.model(x, TrainPass(gen=trainer._gen(state, "droppath")))
        loss = pl_ranking_loss(pred, rankings, impl=cfg.listmle_impl)
        loss.backward()
        out.append((float(loss), torch.cat([p.grad.reshape(-1) for p in params])))
    return out


def options_phase(smi: str) -> dict:
    """Phase 15b: configs/ff_effnet_448.json at batch 32 for OPT_STEPS steps
    with each training option, and ff_redweb with sparse_tail at its
    config's batch, with the gates on each."""
    import numpy as np
    import torch

    from pldepth_torch.data.datasets import SyntheticDepthDataset
    from pldepth_torch.models.quantize import quant_sites

    base = load_config(EFFNET_CONFIG).replace(batch_size=BATCH_TRAIN, input_size=SIZE,
                                              dataset="synthetic")
    rw = load_config(REDWEB_CONFIG).replace(input_size=SIZE, dataset="synthetic", sparse_tail=True)
    n = 2 * max(BATCH_TRAIN, rw.batch_size)
    ds = SyntheticDepthDataset(n, SIZE, seed=3)
    rows = [ds[i] for i in range(n)]

    def device_batches(b):
        return [{k: torch.from_numpy(np.stack([r[k] for r in rows[j * b:(j + 1) * b]])).cuda()
                 for k in ("image", "gt", "mask")} for j in range(2)]

    batches = device_batches(BATCH_TRAIN)
    runs = {}
    accum = {"prev": None, "moved": []}

    def watch_accum(i, trainer, state):
        now = trainable_flat(state.model)
        if accum["prev"] is not None:
            accum["moved"].append(not torch.equal(now, accum["prev"]))
        accum["prev"] = now

    options = [("plain", {}), ("grad_accum_2", {"grad_accum": 2}),
               ("remat_encoder", {"remat_encoder": True}), ("sparse_tail", {"sparse_tail": True}),
               ("qres_int8", {"qres": "int8"}), ("qres_bf16", {"qres": "bf16"}),
               ("qenc_bf16", {"qenc": "bf16"}), ("qenc_int8", {"qenc": "int8"})]
    for name, opt in options:
        rec = option_run(name, base.replace(**opt), batches, smi,
                         watch=watch_accum if name == "grad_accum_2" else None)
        if name == "qenc_int8":
            enc = rec["trainer"]._qenc[1]
            rec["int8_dense_sites"] = sum(m.groups == 1 for m in quant_sites(enc).values())
            rec["int8_sites"] = len(quant_sites(enc))
        rec.pop("trainer"), rec.pop("state")
        runs[name] = rec
        torch.cuda.empty_cache()
    runs["redweb_sparse_tail"] = rec = option_run("redweb_sparse", rw, device_batches(rw.batch_size),
                                                  smi)
    rec.pop("trainer"), rec.pop("state")
    torch.cuda.empty_cache()

    # gates
    plain, c = runs["plain"], lambda r: r["counts"]
    # micro-step 1 leaves the params bit-equal; then every second one moves them
    moved = [bool(runs["grad_accum_2"]["first_update"].abs().max() > 0)] + accum["moved"]
    want = [i % 2 == 1 for i in range(OPT_STEPS)]
    log(f"grad_accum 2: params moved after steps 1-{OPT_STEPS}: {moved}")
    if moved != want:
        fail(f"grad_accum 2: params must stay after odd micro-steps and move after even ones: "
             f"{moved}")
    # remat: the first step's gradient against the plain path's. AMSGrad's
    # first update is lr * g / (|g| + eps), lr * sign(g) at eps 1e-7, so an
    # update rel counts the sign flips of gradients at the noise floor of
    # the atomic backward: recorded beside the card's own spread (two plain
    # backward passes), gated through the gradient it is made of
    r = runs["remat_encoder"]
    rel = lambda a, b: float((a - b).norm() / b.norm())  # noqa: E731
    upd = lambda g: g / (g.abs() + base.adam_eps)  # noqa: E731
    (lp, gp), (_, gp2) = first_step_grads(base, batches[0], 2)
    ((lr_, gr),) = first_step_grads(base.replace(remat_encoder=True), batches[0])
    r["first_update_rel"] = rel(r["first_update"], plain["first_update"])
    r["first_grad_rel"], r["first_grad_rel_plain_twice"] = rel(gr, gp), rel(gp2, gp)
    r["first_update_rel_from_grads"] = rel(upd(gr), upd(gp))
    r["first_update_rel_plain_twice"] = rel(upd(gp2), upd(gp))
    log(f"remat_encoder: first loss {r['losses'][0]!r} vs plain {plain['losses'][0]!r} (step "
        f"0 again: {lr_!r} / {lp!r}); first gradient rel {r['first_grad_rel']:.3e} (tol 1e-2; "
        f"plain twice {r['first_grad_rel_plain_twice']:.3e}); first update rel "
        f"{r['first_update_rel']:.3e} in the runs, {r['first_update_rel_from_grads']:.3e} from "
        f"the gradients (plain twice {r['first_update_rel_plain_twice']:.3e}); peak "
        f"{r['peak_gb']:.2f} vs {plain['peak_gb']:.2f} GB")
    if (r["losses"][0] != plain["losses"][0] or lr_ != lp or r["first_grad_rel"] > 1e-2
            or not r["peak_gb"] < plain["peak_gb"]):
        fail("remat_encoder: its first loss must equal the plain run's, its first gradient be "
             "within rel 1e-2 and its peak memory below the plain run's")
    for name, n in (("sparse_tail", OPT_STEPS), ("redweb_sparse_tail", OPT_STEPS)):
        got = c(runs[name])
        if (got["listmle_fwd"], got["listmle_bwd"], got["ranking_loss_fwd"],
                got["ranking_loss_bwd"]) != (n, n, 0, 0):
            fail(f"{name}: K1 counts {got}, expected one sorted forward and backward a step "
                 "and no fused launch")
    s = runs["sparse_tail"]
    rel = abs(s["losses"][0] / plain["losses"][0] - 1)
    s["first_loss_rel"] = rel
    log(f"sparse_tail: first loss {s['losses'][0]:.6f} vs dense {plain['losses'][0]:.6f}: rel "
        f"{rel:.3e} (tol 1e-2)")
    if rel > 1e-2:
        fail(f"sparse_tail: first loss off the dense run's by rel {rel:.3e}")
    peaks = [runs[n]["peak_gb"] for n in ("qres_int8", "qres_bf16", "plain")]
    log(f"qres peak memory int8 / bf16 / off: {peaks} GB")
    if not peaks[0] < peaks[1] < peaks[2]:
        fail(f"qres: peak memory must order int8 < bf16 < off: {peaks}")
    q = runs["qenc_int8"]
    per_step = c(q)["quant_matmul"] / OPT_STEPS
    log(f"qenc int8: K4 {c(q)['quant_matmul']} launches over {OPT_STEPS} steps ({per_step} a "
        f"step; {q['int8_dense_sites']} dense int8 encoder sites); {c(q)['pack_builds']} site "
        f"derivations ({q['int8_sites']} sites); encoder unchanged {q['encoder_unchanged']}")
    if per_step != q["int8_dense_sites"] or c(q)["pack_builds"] != q["int8_sites"]:
        fail("qenc int8: K4 must launch once a step at every dense int8 encoder site and each "
             "site's pack be built once")
    for name in ("qenc_int8", "qenc_bf16"):
        if not runs[name]["encoder_unchanged"]:
            fail(f"{name}: the encoder's parameters or BN buffers moved")
    for name, rec in runs.items():
        for key in ("first_update",):
            rec[key] = float(rec[key].norm())
    return runs


# phase 16: the quant metric gate, active learning, chi2 and dump -----------------------
GATE_N, GATE_BATCH, GATE_EPOCHS, GATE_MIN_VALID = 104, 8, 5, 100
GATE_MODELS = (("ff_effnet", K4_SITES), ("ff_redweb", K4_SITES_REDWEB))
GATE_TRAIN_N, GATE_CALIB_SEED, GATE_EVAL_SEED = 128, 7, 123  # the JAX tool's protocol
# phase 16's scene sets (n, seed), made by phase 14's workers at SIZE
PHASE16_SCENES = ((GATE_TRAIN_N, 0), (GATE_N, GATE_EVAL_SEED), (2 * GATE_BATCH, GATE_CALIB_SEED))
GATE_TRAIN_BATCH, GATE_RPI, GATE_K = 8, 100, 5  # its training steps (quant_metric_gate._train)
ACTIVE_N, ACTIVE_ROUNDS, ACTIVE_SPLIT, ACTIVE_BATCH = 80, 2, 32, 32
DUMP_N = 34  # scenes whose training split (cli's 1/15 validation cut) holds 32
HAUSDORFF_PAIRS = 8  # edge-map pairs of a round held card vs numpy


@contextlib.contextmanager
def patched(obj, name: str, make):
    """``obj.<name>`` replaced by ``make(the original)`` for the block."""
    real = getattr(obj, name)
    setattr(obj, name, make(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def cached_sets(sets, name: str = "scenes"):
    """The commands' loader (``get_dataset(name, ...)``) and the quant
    gate's (``_make_ds(name, ...)``) serve the first ``n`` samples of a set
    of ``sets`` made for their (input size, seed): the same samples, made
    beforehand, so the runs measure no synthesis. Other requests go to
    their own loaders."""
    from pldepth_torch.data import datasets as dsets
    from pldepth_torch.tools import quant_metric_gate as gate

    def cached(size, seed, n):
        ds = sets.get((size, seed))
        return ds.take(n) if ds is not None and n is not None and n <= len(ds) else None

    def registry(real):
        def load(root="", target_size=224, size=None, split="train", seed=0, shuffle=False):
            ds = cached(target_size, seed, size) if split == "train" else None
            return ds if ds is not None else real(
                root=root, target_size=target_size, size=size, split=split, seed=seed,
                shuffle=shuffle)
        return load

    def make_ds(real):
        def load(dataset, n, size, seed):
            ds = cached(size, seed, n) if dataset == name else None
            return ds if ds is not None else real(dataset, n, size, seed)
        return load

    real = dsets.DATASETS[name]
    dsets.DATASETS[name] = registry(real)
    try:
        with patched(gate, "_make_ds", make_ds):
            yield
    finally:
        dsets.DATASETS[name] = real


def stamp(device: str):
    """A point on the device's timeline: a recorded CUDA event on the card,
    the host clock on the CPU (rehearsal)."""
    import torch

    if device != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def stamp_ms(a, b) -> float:
    return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)


def gate_phase(smi: str, sets, device="cuda", size=SIZE, n=GATE_N, batch=GATE_BATCH,
               epochs=GATE_EPOCHS, models=GATE_MODELS, min_valid=GATE_MIN_VALID) -> dict:
    """Phase 16a: the port's quant metric gate (pldepth_torch/tools/
    quant_metric_gate.py) for each model, trained in-process; gates on K1
    (one fused forward and backward a training step) and K4 (``sites`` a
    int8 forward, no patch matrix) and on finite gating metrics over at
    least ``min_valid`` images. The verdicts are findings, not gates."""
    import torch

    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.tools import quant_metric_gate as gate

    cuda = device == "cuda"
    rec = {}
    for model, sites in models:
        k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
        k4_counts(reset=True)
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cached_sets(sets):
            res = gate.run_gate(model=model, size=size, n=n, batch=batch, dataset="scenes",
                                weights="train", train_epochs=epochs, device=device)
        if cuda:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        steps = epochs * (GATE_TRAIN_N // GATE_TRAIN_BATCH)
        forwards = res["n_images"] // batch
        launches = {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                    "ranking_loss_bwd": k1.ranking_loss_bwd.launches}
        log(f"quant gate {model} ({secs:.1f} s): {json.dumps(res)}")
        if cuda:
            if launches != {"ranking_loss_fwd": steps, "ranking_loss_bwd": steps}:
                fail(f"quant gate {model}: K1 launches {launches} over {steps} training steps")
            k4 = gate_k4_path(f"quant gate {model}", forwards, sites,
                              K4_WINDOWS if model == "ff_effnet" else K4_WINDOWS_REDWEB)
        else:
            k4 = 0
        for name in ("ordinal_error", "whdr_003"):
            row = res["metrics"][name]
            if row["n_valid"] < min_valid or not all(
                    math.isfinite(row[k]) for k in ("float", "int8", "delta")):
                fail(f"quant gate {model}: {name} {row} (need finite values on at least "
                     f"{min_valid} images)")
        for name, row in res["metrics"].items():
            if row["n_valid"] and not all(math.isfinite(row[k]) for k in ("float", "int8")):
                fail(f"quant gate {model}: non-finite {name} {row}")
        verdict = "PASS" if res["pass"] else "FAIL"
        failing = [k for k, v in res["metrics"].items() if not v["pass"]]
        log(f"quant gate {model}: {verdict} (failing budgets: {failing}); K1 {launches}, K4 "
            f"{k4} over {forwards} int8 forwards; {secs:.1f} s [{smi}]")
        rec[model] = {"result": res, "s": secs, "k1_launches": launches, "k4_launches": k4,
                      "train_steps": steps, "int8_forwards": forwards}
        if cuda:
            torch.cuda.empty_cache()
    rec["k1_launches"] = {k: sum(rec[m]["k1_launches"][k] for m, _ in models)
                          for k in ("ranking_loss_fwd", "ranking_loss_bwd")}
    rec["k4_launches"] = sum(rec[m]["k4_launches"] for m, _ in models)
    return rec


def check_round(images, rankings, pool, split: int, k: int, what: str) -> None:
    """A round's arrays: every pool row once, in order; (N, split^2 // k, k,
    2) lists, depth-descending, inside the image, labelled with gt."""
    import numpy as np

    n = len(pool)
    if images.shape[0] != n or any(not np.array_equal(images[i], pool[i]["image"])
                                   for i in range(n)):
        fail(f"{what}: the round's images are not the pool's {n} rows in order")
    want = (n, split * split // k, k, 2)
    if rankings.shape != want:
        fail(f"{what}: rankings {rankings.shape}, expected {want}")
    h, w = pool[0]["gt"].shape
    flat = rankings[..., 0].astype(np.int64)
    if (flat < 0).any() or (flat >= h * w).any() or not np.array_equal(flat, rankings[..., 0]):
        fail(f"{what}: ranking indices outside the {h}x{w} image")
    if (np.diff(rankings[..., 1], axis=-1) > 0).any():
        fail(f"{what}: lists are not depth-descending")
    for i in range(n):
        if not np.array_equal(rankings[i, ..., 1], pool[i]["gt"].reshape(-1)[flat[i]]):
            fail(f"{what}: row {i}'s labels are not gt at their pixels")


def active_phase(smi: str, sets, device="cuda", size=SIZE, n=ACTIVE_N, batch=ACTIVE_BATCH,
                 split=ACTIVE_SPLIT, rounds=ACTIVE_ROUNDS, config=None) -> dict:
    """Phase 16b: cli active on both feeds (--data_resident true / false)
    from ``config`` (configs/ff_effnet_448.json) at batch ``batch``: gates on
    the rounds' arrays, the losses, K1 launches, weights.npz, the history
    keys and the card's Hausdorff against numpy; seconds per acquired image
    by part, host-to-device MB per predict batch, ms a fixed-ranking step,
    peak memory."""
    import numpy as np
    import torch

    from pldepth_torch.active import acquisition as acq
    from pldepth_torch.active import loop as al
    from pldepth_torch.data.pipeline import train_val_split
    from pldepth_torch.data.resident import build_resident_store
    from pldepth_torch.ops import listmle_kernel as k1
    from pldepth_torch.train import Trainer

    from pldepth_torch.core.config import ExperimentConfig

    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    cuda = device == "cuda"
    with open(config) as f:
        base = ExperimentConfig.from_json(f.read())
    k = base.ranking_size
    pool, _ = train_val_split(sets[(size, 0)].take(n))
    pool_items = [pool[i] for i in range(len(pool))]
    pretrain_steps = len(pool) // batch
    rec = {"pool": len(pool), "batch": batch, "split": split, "rounds": rounds, "k1_launches": {
        "ranking_loss_fwd": 0, "ranking_loss_bwd": 0}}
    pairs = {}
    for resident in ("true", "false"):
        name = "resident" if resident == "true" else "streaming"
        acc = {"canny_s": 0.0, "hausdorff_s": 0.0, "oracle_s": 0.0, "oracle_calls": 0}
        predict_marks, step_marks, rounds_seen = [], [], []

        def host_timer(key):
            def make(real):
                def f(*a, **kw):
                    t0 = time.perf_counter()
                    out = real(*a, **kw)
                    acc[key] += time.perf_counter() - t0
                    if key == "oracle_s":
                        acc["oracle_calls"] += 1
                    return out
                return f
            return make

        def hausdorff(real):
            def f(a, b, sp, dev=None):
                if name == "resident" and not pairs:
                    pairs.update(a=a[:HAUSDORFF_PAIRS].copy(), b=b[:HAUSDORFF_PAIRS].copy())
                t0 = time.perf_counter()
                out = real(a, b, sp, dev)
                acc["hausdorff_s"] += time.perf_counter() - t0
                return out
            return f

        def batches(real):
            def gen(*a, **kw):
                it = real(*a, **kw)
                while True:
                    e0 = stamp(device)
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                    predict_marks.append((e0, stamp(device)))
                    yield item
            return gen

        def fixed_step(real):
            def step(self, state, b):
                e0 = stamp(device)
                out = real(self, state, b)
                step_marks.append((e0, stamp(device)))
                return out
            return step

        def round_check(real):
            def rnd(*a, **kw):
                calls = acc["oracle_calls"]
                t0 = time.perf_counter()
                images, rankings, stats = real(*a, **kw)
                secs = time.perf_counter() - t0
                what = f"cli active ({name}) round {len(rounds_seen)}"
                check_round(images, rankings, pool_items, split, k, what)
                if acc["oracle_calls"] - calls != len(pool):
                    fail(f"{what}: the oracle drew {acc['oracle_calls'] - calls} times for "
                         f"{len(pool)} rows")
                rounds_seen.append({"s": secs, **stats})
                return images, rankings, stats
            return rnd

        k1.ranking_loss_fwd.launches = k1.ranking_loss_bwd.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as stack:
            for fn in ("input_edge_map", "pred_edge_map"):
                stack.enter_context(patched(al, fn, host_timer("canny_s")))
            stack.enter_context(patched(al, "oracle_label", host_timer("oracle_s")))
            stack.enter_context(patched(al, "tile_hausdorff_batch", hausdorff))
            stack.enter_context(patched(al, "_stream_batches", batches))
            stack.enter_context(patched(al, "_resident_batches", batches))
            stack.enter_context(patched(al, "active_learning_round", round_check))
            stack.enter_context(patched(Trainer, "train_step_fixed", fixed_step))
            stack.enter_context(cached_sets(sets))
            lines, secs = run_cli([
                "active", "--config_json", config, "--dataset", "scenes", "--ds_size", str(n),
                "--batch_size", str(batch), "--input_size", str(size), "--rounds", str(rounds),
                "--split_num", str(split), "--pretrain_epochs", "1", "--data_resident", resident,
                "--output_dir", tmp, "--device", device])
            runs = os.listdir(tmp)
            if len(runs) != 1 or not os.path.exists(os.path.join(tmp, runs[0], "weights.npz")):
                fail(f"cli active ({name}) wrote no weights.npz: {runs}")
        peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
        history = json.loads(lines[-1])
        if list(history) != ["loss", "err", "hd_mean"] or any(
                len(history[key]) != rounds for key in history):
            fail(f"cli active ({name}): history {history} lacks the JAX keys or rounds")
        if not np.all(np.isfinite(history["loss"])) or not np.all(np.isfinite(history["err"])):
            fail(f"cli active ({name}): non-finite history {history}")
        if len(rounds_seen) != rounds:
            fail(f"cli active ({name}): {len(rounds_seen)} rounds run, expected {rounds}")
        fixed_steps = len(step_marks)
        if fixed_steps != rounds * (len(pool) // batch):
            fail(f"cli active ({name}): {fixed_steps} fixed-ranking steps, expected "
                 f"{rounds * (len(pool) // batch)}")
        launches = {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                    "ranking_loss_bwd": k1.ranking_loss_bwd.launches}
        want = fixed_steps + pretrain_steps
        if cuda and launches != {"ranking_loss_fwd": want, "ranking_loss_bwd": want}:
            fail(f"cli active ({name}): K1 launches {launches}, expected {want} each "
                 f"({fixed_steps} fixed-ranking + {pretrain_steps} pretrain steps)")
        for key in launches:
            rec["k1_launches"][key] += launches[key]
        if cuda:
            torch.cuda.synchronize()
        predict_ms = [stamp_ms(a, b) for a, b in predict_marks]
        step_ms = [stamp_ms(a, b) for a, b in step_marks]
        acquired = rounds * len(pool)
        round_s = sum(r["s"] for r in rounds_seen)
        per_image = {"predict_s": sum(predict_ms) / 1e3 / acquired,
                     "canny_s": acc["canny_s"] / acquired,
                     "hausdorff_s": acc["hausdorff_s"] / acquired,
                     "oracle_s": acc["oracle_s"] / acquired,
                     "round_s": round_s / acquired}
        r = {"cli_s": secs, "history": history, "rounds": rounds_seen, "k1_launches": launches,
             "fixed_steps": fixed_steps, "pretrain_steps": pretrain_steps,
             "predict_batches": len(predict_ms), "predict_ms_per_batch": float(np.mean(predict_ms)),
             "s_per_image": per_image, "fixed_step_ms": float(np.median(step_ms)),
             "fixed_step_ms_all": step_ms, "peak_gb": peak}
        rec[name] = r
        log(f"cli active ({name}): {secs:.1f} s; per acquired image (of {acquired}) "
            f"{ {key: round(v * 1e3, 3) for key, v in per_image.items()} } ms (predict: "
            f"device time of {len(predict_ms)} batches, {r['predict_ms_per_batch']:.2f} ms "
            f"each); fixed-ranking step {r['fixed_step_ms']:.2f} ms (device, median of "
            f"{fixed_steps}); peak {peak:.2f} GB; K1 {launches}; history {history} [{smi}]")

    # the card's Hausdorff on the round's own edge maps, against numpy
    dist, pts = acq.tile_hausdorff_batch(pairs["a"], pairs["b"], split, device)
    for i in range(len(pairs["a"])):
        want_d, want_p = acq.tile_hausdorff(pairs["a"][i], pairs["b"][i], split)
        if not (np.array_equal(dist[i], want_d) and np.array_equal(pts[i], want_p)):
            fail(f"tile_hausdorff_batch on {device} differs from numpy on edge-map pair {i}")
    rec["hausdorff_pairs_equal"] = len(pairs["a"])
    log(f"tile_hausdorff_batch on {device} equals numpy on {len(pairs['a'])} of the round's "
        f"edge-map pairs (distances and witnesses)")

    # host-to-device bytes of one predict batch on each path
    trainer = Trainer(base.replace(input_size=size, batch_size=batch), device=device)
    state = trainer.init_state()
    store = build_resident_store(pool, device)
    imgs = np.stack([pool_items[i]["image"] for i in range(8)])
    fns = {"streaming": lambda: np.asarray(trainer.jit_predict()(state, imgs)),
           "resident": lambda: np.asarray(trainer.jit_predict_resident(8)(
               state, store.arrays["image"], 0))}
    expect = imgs.nbytes
    for name, fn in fns.items():
        ms = cuda_ms(fn, reps=5, warmup=1)
        seen = []
        for attempt in range(FEED_WINDOW_TRIES):  # a window that lost copies is retaken
            win = feed_window(fn, 3, 1, ms, SPIN_KERNELS << min(2 * attempt, 6))
            mb = win["htod_mb"]
            seen.append(round(mb, 4))
            if name == "resident" or mb * 1e6 >= expect:
                break
            log(f"active predict ({name}): a window of HtoD copies short of the batch: "
                f"{win['htod_events']}")
        rec[name].update(htod_mb_per_batch=mb, predict_alone_ms=ms,
                         predict_idle_share=win["idle_share"])
        log(f"active predict ({name}): {ms:.2f} ms a batch of 8 alone, HtoD {mb:.4f} MB a "
            f"batch, idle {win['idle_share']:.3f} [{smi}]")
        if cuda and name == "resident" and mb >= HTOD_RESIDENT_MB:
            fail(f"resident predict copies {mb:.3f} MB host-to-device a batch (gate < "
                 f"{HTOD_RESIDENT_MB} MB)")
        if cuda and name == "streaming" and mb * 1e6 < expect:
            fail(f"streaming predict: the profiler saw {seen} MB host-to-device a batch in "
                 f"its windows, less than the batch's {expect / 1e6:.2f} MB")
    del store, trainer, state
    if cuda:
        torch.cuda.empty_cache()
    return rec


def chi2_phase(smi: str, device="cuda", config=None, trials=2, batches=4) -> dict:
    """Phase 16c: cli chi2 at --sampling_type 1 (info_score) and 3
    (purely_masked): finite results, info_score's mean below."""
    import numpy as np

    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    rec = {}
    for st in (1, 3):
        lines, secs = run_cli(["chi2", "--config_json", config, "--trials", str(trials),
                               "--batches_per_trial", str(batches), "--sampling_type", str(st),
                               "--device", device])
        rep = json_report(lines, f"cli chi2 --sampling_type {st}")
        if not (np.all(np.isfinite(rep["trials"])) and math.isfinite(rep["mean"])
                and math.isfinite(rep["variance"]) and len(rep["trials"]) == trials):
            fail(f"cli chi2 --sampling_type {st}: {rep}")
        rec[rep["sampler"]] = {**rep, "s": secs}
        log(f"cli chi2 {rep['sampler']}: mean {rep['mean']:.4f}, variance "
            f"{rep['variance']:.3e} over {trials} trials of {batches} batches, {secs:.1f} s")
    if not rec["info_score"]["mean"] < rec["purely_masked"]["mean"]:
        fail(f"cli chi2: info_score's mean {rec['info_score']['mean']} is not below "
             f"purely_masked's {rec['purely_masked']['mean']}")
    return rec


def dump_phase(smi: str, sets, device="cuda", size=SIZE, n=DUMP_N, config=None) -> dict:
    """Phase 16d: cli dump of a scenes training split as jpg and as npz;
    read back, depths equal gt at the indices, npz images equal the u8
    scenes."""
    import numpy as np

    from pldepth_torch.data.offline import load_offline_rankings
    from pldepth_torch.data.pipeline import train_val_split

    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    train, _ = train_val_split(sets[(size, 0)].take(n))
    items = [train[i] for i in range(len(train))]
    with open(config) as f:
        spec = json.load(f)
    want = (len(items), spec["rankings_per_image"], spec["ranking_size"], 2)
    rec = {}
    for fmt in ("jpg", "npz"):
        with tempfile.TemporaryDirectory() as tmp, cached_sets(sets):
            out = os.path.join(tmp, "d")
            lines, secs = run_cli(["dump", "--config_json", config, "--dataset", "scenes",
                                   "--ds_size", str(n), "--input_size", str(size), "--out_dir",
                                   out, "--image_format", fmt, "--device", device])
            r = load_offline_rankings(out)
            if r.shape != want:
                fail(f"cli dump {fmt}: rankings {r.shape}, expected {want}")
            for i, s in enumerate(items):
                flat = r[i, ..., 0].astype(np.int64)
                if not np.array_equal(r[i, ..., 1], s["gt"].reshape(-1)[flat]):
                    fail(f"cli dump {fmt}: sample {i}'s depths are not gt at the indices")
            if fmt == "npz":
                images = np.load(os.path.join(out, "offline_data.npz"))["images"]
                u8 = np.stack([(np.clip(s["image"], 0, 1) * 255).astype(np.uint8)
                               for s in items])
                if not np.array_equal(images, u8):
                    fail("cli dump npz: the images are not the scenes' u8 images")
            with open(os.path.join(out, "meta.json")) as f:
                meta = json.load(f)
            rec[fmt] = {"s": secs, "shape": list(r.shape), "meta": meta,
                        "files": len(os.listdir(out))}
            log(f"cli dump {fmt}: {len(os.listdir(out))} files, rankings {r.shape}, {secs:.1f} s")
    return rec


def phase16(smi: str) -> dict:
    """Phase 16: the gate (16a), active learning (16b), chi2 (16c), dump
    (16d) on scenes made once beforehand."""
    t0 = time.perf_counter()
    sets, _ = scenes_cached(PHASE16_SCENES, SIZE)
    rec = {"scenes_s": time.perf_counter() - t0}
    rec["gate"] = gate_phase(smi, sets)
    rec["active"] = active_phase(smi, sets)
    rec["chi2"] = chi2_phase(smi)
    rec["dump"] = dump_phase(smi, sets)
    rec["s"] = time.perf_counter() - t0
    log(f"phase 16: {rec['s']:.1f} s (scenes {rec['scenes_s']:.1f} s) [{smi}]")
    return rec


# phase 17: --profile and the sinks, sweeps and trial analysis, warmup ------------------
# 17a: cli train --profile true on PROFILE_N synthetic images at 448^2 (1/15 validation:
# one val batch of 32; 14 train steps at batch 32: 1 + 3 profiled, 10 through fit)
PROFILE_N, PROFILE_BATCH, PROFILE_STEPS = 480, 32, 3
# 17b: sweep runs on SWEEP_N images (15 train, 1 val); the base space draws batch
# 4 / 6 / 8 and 10-30 epochs: 10 to 90 steps a run
# TPE draws at random below 4 scored runs: runs 5 and the resumed 6th use it
SWEEP_N, SWEEP_TPE_RUNS, SWEEP_LARGE_RUNS, SWEEP_LARGE_EPOCHS = 16, 5, 2, 2
WARMUP_N, WARMUP_BATCH, WARMUP_SERVE = 40, 32, 8  # 17d: cli train after warmup: 1 step
WARMUP_BUILT = sorted(["banded_mbconv", "fused_mbconv", "listmle", "quant_matmul", "packio"])


def synthetic_cached(n: int, size: int, seed: int = 0):
    """``get_dataset("synthetic", size=n, seed=seed, target_size=size)`` with
    every sample made once and kept in host memory: each sample draws from
    its own generator, and numpy and torch release the interpreter lock in
    the work, so threads make them side by side (processes would pickle
    4 MB a sample back); the first and last checked against a second
    call of the dataset's loader."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from pldepth_torch.data.datasets import get_dataset

    t0 = time.perf_counter()
    ds = get_dataset("synthetic", size=n, seed=seed, target_size=size)
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as pool:
        items = list(pool.map(ds.loader, range(n)))
    for i in (0, n - 1):
        if any(not np.array_equal(items[i][k], v) for k, v in ds[i].items()):
            fail(f"synthetic sample {i} made by a worker differs from the dataset's own")
    log(f"synthetic: {n} samples at {size}^2 made in {time.perf_counter() - t0:.1f} s")
    return dataclasses.replace(ds, loader=items.__getitem__)


def trace_kernels(logdir: str):
    """(kernel launches by name, as ``kernel_name`` gives them, of the one
    Chrome trace under ``logdir``; its device ms; its size in MB)."""
    import glob

    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts, dev_us = {}, 0.0
    for e in events:
        if e.get("cat") != "kernel":
            continue
        name = e["name"]
        if not name.startswith("_Z"):  # demangled: "void ns::k1_fwd_thread_kernel<5, 1>(...)"
            m = re.search(r"(\w+_kernel)(<[^()]*?>)?\(", name)
            name = m.group(1) + (m.group(2) or "") if m else name[:60]
        else:
            name = kernel_name(name)
        counts[name] = counts.get(name, 0) + 1
        dev_us += float(e.get("dur", 0.0))
    return counts, dev_us / 1e3, os.path.getsize(path) / 1e6


def k1_trace_counts(counts):
    """Fused (template MODE 1) and sorted (MODE 0) K1 launches of a trace."""
    out = {"ranking_loss_fwd": 0, "ranking_loss_bwd": 0, "listmle_fwd": 0, "listmle_bwd": 0}
    for name, c in counts.items():
        m = re.match(r"k1_(fwd|bwd)_(thread|warp)_kernel<(?:\d+, )?(\d)>", name)
        if m:
            key = ("ranking_loss_" if m.group(3) == "1" else "listmle_") + m.group(1)
            out[key] += c
    return out


def fused_k1_counts():
    c = k_counts()
    return {n: c[n] for n in ("ranking_loss_fwd", "ranking_loss_bwd")}


def profile_phase(smi: str, ds, device="cuda", size=SIZE, n=PROFILE_N, batch=PROFILE_BATCH,
                  config=None) -> dict:
    """Phase 17a: cli train --profile true --use_tensorboard true, one
    epoch: exactly PROFILE_STEPS fused K1 launches each way in the trace,
    K1 launches of the command = 1 + PROFILE_STEPS + fit steps + val
    batches (backward without the val batches), weights.npz, the event file
    where TensorBoard imports; trace MB, device ms a traced step."""
    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    tb = import_state("tensorboard")
    rec = {"tensorboard": tb}
    n_val = n // 15
    steps = (n - n_val) // batch
    val_batches = n_val // batch
    with tempfile.TemporaryDirectory() as tmp, cached_sets({(size, 0): ds}, "synthetic"):
        reset_counts()
        lines, rec["cli_s"] = run_cli([
            "train", "--config_json", config, "--dataset", "synthetic", "--ds_size", str(n),
            "--batch_size", str(batch), "--epochs", "1", "--input_size", str(size),
            "--profile", "true", "--use_tensorboard", "true", "--output_dir", tmp,
            "--run_name", "prof", "--device", device])
        rec["k1_launches"] = launches = fused_k1_counts()
        run = os.path.join(tmp, "prof")
        out = json.loads(lines[-1])
        if out["step"] != steps:
            fail(f"cli train --profile ended at step {out['step']}, expected {steps}")
        want = {"ranking_loss_fwd": steps + val_batches, "ranking_loss_bwd": steps}
        if device == "cuda" and launches != want:
            fail(f"cli train --profile: K1 launches {launches}, expected {want} (1 + "
                 f"{PROFILE_STEPS} profiled + {steps - 1 - PROFILE_STEPS} fit steps, "
                 f"{val_batches} val batches)")
        if not os.path.exists(os.path.join(run, "weights.npz")):
            fail("cli train --profile wrote no weights.npz")
        counts, dev_ms, mb = trace_kernels(os.path.join(run, "profile"))
        rec["trace_mb"], rec["trace_kernels"] = mb, sum(counts.values())
        rec["device_ms_per_step"] = dev_ms / PROFILE_STEPS
        rec["trace_k1"] = traced = k1_trace_counts(counts)
        if device == "cuda" and traced != {"ranking_loss_fwd": PROFILE_STEPS,
                                           "ranking_loss_bwd": PROFILE_STEPS,
                                           "listmle_fwd": 0, "listmle_bwd": 0}:
            fail(f"the profiled window holds K1 launches {traced}, expected {PROFILE_STEPS} "
                 f"fused each way (kernels {sorted(counts)[:12]} ...)")
        events = [f for f in os.listdir(os.path.join(run, "tb"))
                  if f.startswith("events.")] if os.path.isdir(os.path.join(run, "tb")) else []
        rec["tb_event_files"] = len(events)
        if not tb.startswith("not") and not events:
            fail("cli train --use_tensorboard true wrote no event file with tensorboard present")
        if tb.startswith("not"):
            log(f"tensorboard {tb}: the sink logged its warning and the run stayed local-only")
    log(f"cli train --profile: {rec['cli_s']:.1f} s, trace {mb:.1f} MB with "
        f"{rec['trace_kernels']} kernels, {rec['device_ms_per_step']:.2f} device ms a traced "
        f"step, K1 in the window {traced}, K1 of the command {launches}, "
        f"{rec['tb_event_files']} event file(s) [{smi}]")
    return rec


def fit_meter(runs: list, device: str):
    """``Trainer.fit`` wrapped to record each call's steps, seconds (to the
    end of its device work), ms a step and peak device memory."""
    import torch

    def make(real):
        def fit(self, state, *a, **kw):
            step0 = state.step
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, history = real(self, state, *a, **kw)
            if device == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            steps = state.step - step0
            runs.append({"steps": steps, "batch": self.cfg.batch_size,
                         "ranking_size": self.cfg.ranking_size,
                         "rankings_per_image": self.cfg.rankings_per_image,
                         "fit_s": secs, "ms_per_step": secs * 1e3 / max(1, steps),
                         "peak_mem_gb": (torch.cuda.max_memory_allocated() / 1e9
                                         if device == "cuda" else None)})
            return state, history
        return fit
    return make


def sweep_run(argv, what: str, device: str):
    """One cli sweep: its records, the K1 launches, the fit of each run."""
    from pldepth_torch.train.trainer import Trainer

    runs = []
    reset_counts()
    with patched(Trainer, "fit", fit_meter(runs, device)):
        lines, secs = run_cli(argv)
    launches = fused_k1_counts()
    out = json_report(lines, what)
    steps = sum(r["steps"] for r in runs)
    if device == "cuda" and launches != {"ranking_loss_fwd": steps, "ranking_loss_bwd": steps}:
        fail(f"{what}: K1 launches {launches}, expected {steps} each way (the runs' steps)")
    return out, runs, launches, secs


def check_records(path: str, n: int, target: str, what: str):
    """The state file's records: ``n``, none with an error, finite target."""
    with open(path) as f:
        lines = f.read().splitlines()
    recs = [json.loads(line) for line in lines]
    if len(recs) != n:
        fail(f"{what}: {len(recs)} records, expected {n}")
    for i, r in enumerate(recs):
        if "error" in r["metrics"] or not math.isfinite(r["metrics"].get(target, math.inf)):
            fail(f"{what}: record {i} failed: {r}")
    return recs, lines


def sweep_phase(smi: str, ds, device="cuda", size=SIZE, n=SWEEP_N, config=None) -> dict:
    """Phase 17b: cli sweep --search tpe over the base space (6 runs, then
    resumed to 7), then --search random over large_rankings (2 runs of
    SWEEP_LARGE_EPOCHS epochs): every record error-free and finite, each
    run's steps as its draw gives them, K1 launches = the runs' steps, the
    resume adds one record and keeps the first five byte-equal; seconds,
    peak memory and ms a step of each run. Phase 17c: cli analyze on the
    TPE state file names the least test_error."""
    import numpy as np

    from pldepth_torch.sweep import analyze as an

    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    n_train = n - n // 15
    rec = {"n": n, "n_train": n_train}
    launches = {"ranking_loss_fwd": 0, "ranking_loss_bwd": 0}
    with tempfile.TemporaryDirectory() as tmp, cached_sets({(size, 0): ds}, "synthetic"):
        tpe = os.path.join(tmp, "tpe")
        base = ["sweep", "--config_json", config, "--ds_size", str(n), "--input_size", str(size),
                "--search", "tpe", "--space", "base", "--output_dir", tpe, "--device", device]
        rec["tpe"] = {}
        for runs_n in (SWEEP_TPE_RUNS, SWEEP_TPE_RUNS + 1):
            what = f"cli sweep --search tpe --num_runs {runs_n}"
            out, runs, k1n, secs = sweep_run([*base, "--num_runs", str(runs_n)], what, device)
            recs, lines = check_records(os.path.join(tpe, "sweep_state.jsonl"), runs_n,
                                        "test_error", what)
            new = recs[len(recs) - len(runs):]
            for r, o in zip(runs, new):
                want = o["overrides"]["epochs"] * (n_train // o["overrides"]["batch_size"])
                if r["steps"] != want or r["batch"] != o["overrides"]["batch_size"]:
                    fail(f"{what}: a run of {o['overrides']} took {r['steps']} steps at batch "
                         f"{r['batch']}, expected {want}")
                r.update(overrides=o["overrides"], metrics=o["metrics"])
            if runs_n > SWEEP_TPE_RUNS:
                if len(runs) != 1 or lines[:SWEEP_TPE_RUNS] != first:
                    fail(f"{what}: the resume ran {len(runs)} runs or changed the first "
                         f"{SWEEP_TPE_RUNS} records")
            first = lines[:SWEEP_TPE_RUNS]
            best = min(recs, key=lambda r: r["metrics"]["test_error"])
            if out["best"] != best or out["num_runs"] != runs_n:
                fail(f"{what}: reported {out['best']} of {out['num_runs']}, expected {best}")
            for k in launches:
                launches[k] += k1n[k]
            rec["tpe"][runs_n] = {"s": secs, "runs": runs, "k1_launches": k1n}
            for i, r in enumerate(runs):
                log(f"  run {i}: {r['overrides']} -> test_error {r['metrics']['test_error']:.4f}"
                    f", {r['steps']} steps, fit {r['fit_s']:.1f} s, {r['ms_per_step']:.1f} ms a "
                    f"step, peak {r['peak_mem_gb'] or 0:.2f} GB")
            log(f"{what}: {secs:.1f} s, K1 {k1n} [{smi}]")
        # 17c: the analysis of the TPE file
        state = os.path.join(tpe, "sweep_state.jsonl")
        trials = an.load_trials(state)
        best = min(trials, key=lambda r: r["metrics"]["test_error"])
        mpl = import_state("matplotlib")
        rec["analyze"] = {"matplotlib": mpl}
        if mpl.startswith("not"):
            log(f"matplotlib {mpl}: cli analyze draws its plots with it, so best_trial is "
                "checked directly")
            got = an.best_trial(trials)
        else:
            lines, rec["analyze"]["s"] = run_cli(["analyze", "--state_path", state, "--out_dir",
                                                  os.path.join(tmp, "plots")])
            rep = json_report(lines, "cli analyze")
            got = rep["best"]
            rec["analyze"]["plots"] = [os.path.basename(p) for p in rep["plots"]]
            if sorted(rec["analyze"]["plots"]) != sorted(
                    f"{k}_vs_test_error.png" for k in best["overrides"]):
                fail(f"cli analyze plotted {rec['analyze']['plots']}")
        if got != best:
            fail(f"cli analyze: best {got}, expected the least test_error {best}")
        log(f"cli analyze: best {best['overrides']} (test_error "
            f"{best['metrics']['test_error']:.4f}), plots {rec['analyze'].get('plots')}")
        # K1 at K 25-500 inside a 448^2 train step
        large = os.path.join(tmp, "large")
        what = f"cli sweep --search random --space large_rankings --num_runs {SWEEP_LARGE_RUNS}"
        out, runs, k1n, secs = sweep_run([
            "sweep", "--config_json", config, "--ds_size", str(n), "--input_size", str(size),
            "--epochs", str(SWEEP_LARGE_EPOCHS), "--search", "random", "--space",
            "large_rankings", "--num_runs", str(SWEEP_LARGE_RUNS), "--output_dir", large,
            "--device", device], what, device)
        recs, _ = check_records(os.path.join(large, "sweep_state.jsonl"), SWEEP_LARGE_RUNS,
                                "test_error", what)
        for r, o in zip(runs, recs):
            r.update(overrides=o["overrides"], metrics=o["metrics"])
            if not all(np.isfinite(v) for v in o["metrics"].values()):
                fail(f"{what}: non-finite {o}")
            log(f"  run: {o['overrides']} -> {o['metrics']}, {r['steps']} steps, "
                f"{r['ms_per_step']:.1f} ms a step, peak {r['peak_mem_gb'] or 0:.2f} GB")
        for k in launches:
            launches[k] += k1n[k]
        rec["large_rankings"] = {"s": secs, "runs": runs, "k1_launches": k1n}
        log(f"{what}: {secs:.1f} s, K1 {k1n} [{smi}]")
    rec["k1_launches"] = launches
    return rec


def warmup_phase(smi: str, device="cuda", config=None) -> dict:
    """Phase 17d: cli warmup --serve_batch WARMUP_SERVE at batch
    WARMUP_BATCH in a copy of pldepth_torch (PYTHONPATH; its build
    directory starts empty): it builds the four CUDA libraries and packio;
    a second warmup builds nothing; cli train with --pack_cache in that
    copy leaves the build directory as it was. Cold build_s and each
    graph's first-call seconds."""
    import shutil

    here = os.path.dirname(os.path.abspath(__file__))
    config = config or os.path.join(here, "configs", EFFNET_CONFIG)
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(here, "pldepth_torch"), os.path.join(tmp, "pldepth_torch"),
                        ignore=shutil.ignore_patterns("_kernels_build", "__pycache__"))
        build_dir = os.path.join(tmp, "pldepth_torch", "_kernels_build")
        env = {**os.environ, "PYTHONPATH": tmp}

        def cli_copy(*argv, what):
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, "-m", "pldepth_torch.cli", *argv], cwd=tmp,
                               env=env, capture_output=True, text=True, timeout=900)
            secs = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"{what} in a copy of the package returned {r.returncode}:\n"
                     f"{r.stderr[-3000:]}")
            return r.stdout.strip().splitlines(), secs

        def listing():
            return sorted((e.name, e.stat().st_size, e.stat().st_mtime_ns)
                          for e in os.scandir(build_dir)) if os.path.isdir(build_dir) else []

        warm = ["warmup", "--config_json", config, "--batch_size", str(WARMUP_BATCH),
                "--serve_batch", str(WARMUP_SERVE), "--device", device]
        for key in ("cold", "warm"):
            lines, secs = cli_copy(*warm, what=f"cli warmup ({key})")
            out = json.loads(lines[-1])
            want = WARMUP_BUILT if key == "cold" else []
            if device != "cuda":
                want = [b for b in want if b == "packio"]
            if sorted(out["built"]) != want or out["cache_dir"] != build_dir:
                fail(f"cli warmup ({key}) built {out['built']} into {out['cache_dir']}, "
                     f"expected {want} into {build_dir}")
            rec[key] = {**out, "s": secs}
            log(f"cli warmup ({key}): built {out['built']} in {out['build_s']:.1f} s; first "
                f"train step {out['train_step_s']:.2f} s, predict {out['predict_s']:.2f} s, "
                f"predict_bnfold {out['predict_bnfold_s']:.2f} s at batch {WARMUP_SERVE}; "
                f"{secs:.1f} s of command [{smi}]")
        before = listing()
        lines, secs = cli_copy(
            "train", "--config_json", config, "--dataset", "synthetic", "--ds_size",
            str(WARMUP_N), "--batch_size", str(WARMUP_BATCH), "--epochs", "1",
            "--pack_cache", os.path.join(tmp, "train.pldpack"), "--output_dir",
            os.path.join(tmp, "runs"), "--run_name", "after", "--device", device,
            what="cli train after warmup")
        after = listing()
        if after != before:
            fail(f"cli train after warmup changed the build directory: {before} -> {after}")
        if not os.path.exists(os.path.join(tmp, "runs", "after", "weights.npz")):
            fail("cli train after warmup wrote no weights.npz")
        rec["train_after"] = {"s": secs, "build_dir": [name for name, _, _ in after]}
        log(f"cli train --pack_cache after warmup: {secs:.1f} s, the build directory unchanged "
            f"({[name for name, _, _ in after]})")
    return rec


def phase17(smi: str) -> dict:
    """Phase 17: --profile and the sinks (17a), sweeps (17b), the analysis
    (17c) and warmup (17d) on synthetic sets made once beforehand."""
    import torch

    t0 = time.perf_counter()
    ds = synthetic_cached(PROFILE_N, SIZE)
    rec = {"synthetic_s": time.perf_counter() - t0}
    rec["profile"] = profile_phase(smi, ds)
    rec["sweep"] = sweep_phase(smi, ds)
    del ds
    torch.cuda.empty_cache()
    log("cli convert is not driven here: it needs TensorFlow, which this machine may lack "
        "(tests/test_torch_convert.py holds it against the JAX package on the CPU)")
    rec["warmup"] = warmup_phase(smi)
    rec["k1_launches"] = {k: rec["profile"]["k1_launches"][k] + rec["sweep"]["k1_launches"][k]
                          for k in ("ranking_loss_fwd", "ranking_loss_bwd")}
    rec["s"] = time.perf_counter() - t0
    log(f"phase 17: {rec['s']:.1f} s (synthetic {rec['synthetic_s']:.1f} s) [{smi}]")
    return rec


# phase 18: data parallelism. Config #1 at its global batch (16 a rank at 2
# ranks); config #5's model at the v5e-16's 8 rows a chip, mesh data 2 in
# place of 16; cli train on DP_SCENES scenes. Two ranks share the one card
# over gloo (NCCL refuses two ranks on one GPU): no time here is a scaling
# figure.
DP_STEPS, DP_BATCH, DP_B4_ROWS, DP_SCENES, DP_CLI_BATCH = 3, 32, 8, 16, 8
DP_B4_CONFIG = "ff_effnet_b4_640_v5e16.json"
SHARED = "2 ranks share 1 card, not a scaling figure"
# 18a / 18b against the single-process step: step-1 loss rel, the first
# step's all-reduced flat gradient rel L2, the new BN running statistics rel.
# 18b holds them in f32: in bf16 the seeded network turns one f32 rounding
# in its BN statistics into loss 9e-5, gradient 0.17 and statistics 2.7e-4
# (18a's "ulp" run measures this every time), so bf16 is reported, not gated.
# Measured on the H100: loss 0 and statistics <= 1.1e-7 in both, so those
# bounds are 1e-6 / 1e-5 (were 1e-4 / 1e-3); the gradient stays at 1e-2,
# over the card's own spread of 6.4e-3 (K1's backward adds with atomics)
DP_TOL = {"loss": 1e-6, "grad": 1e-2, "bn_stats": 1e-5}
DP_DTYPES = ("float32", "bfloat16")  # 18b: gated, then the config's own
DP_SMOKE_BATCH, DP_SMOKE_SIZE = 8, 64  # 18b's check at the smoke size (tests/test_torch_cuda.py)


def dp_smoke_config(batch: int):
    """ff_smoke with config #1's other settings (frozen encoder, info_score,
    K 5) at DP_SMOKE_SIZE, RPI 16, in f32 as 18b gates."""
    from pldepth_torch.core.config import ExperimentConfig

    return ExperimentConfig(model_name="ff_smoke", input_size=DP_SMOKE_SIZE, batch_size=batch,
                            rankings_per_image=16, ranking_size=5, compute_dtype="float32")


def dp_batches(rows: int, size: int, n: int, seed: int = 18):
    """``n`` seeded host batches of ``rows`` {"image", "gt", "mask"} rows."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(size=(rows, size, size, 3)).astype(np.float32),
             "gt": rng.uniform(0.05, 1.0, (rows, size, size)).astype(np.float32),
             "mask": (rng.uniform(size=(rows, size, size)) < 0.9).astype(np.float32)}
            for _ in range(n)]


def state_digest(state) -> str:
    """sha256 of the bits of every tensor of a train state (weights, BN
    statistics, optimizer state)."""
    import torch

    h = hashlib.sha256()
    for t in [*state.model.state_dict().values(), *state.opt.state_dict().values()]:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def dp_steps(trainer, batches, digest: bool = False, prepare=None, patch=None) -> dict:
    """One train step per batch from ``trainer``'s seeded state, each on
    this rank's part of the global batch (``trainer.shard_batch``: its data
    index's block, and under spatial sharding its image rows);
    ``prepare(trainer, state)`` runs before them (``prepare_qenc``), the
    context manager ``patch()`` around them. Returns the
    losses; the first step's flat gradient as the optimizer took it
    (all-reduced under a group; without the decoder conv biases that feed
    a batch-statistics BN, whose true gradient is 0, as ``trainable_flat``
    leaves them out); every BN's new running statistics after step 1; the
    final state (host; with ``digest`` its sha256 instead); the K1 launches
    (counts from 0) and every kernel count of ``k_counts``; the optimizer's
    update count and micro-step; ms a step (CUDA events); ms a step in the mesh's
    collectives (host clock around each all-reduce and all-gather: a
    collective staged through host memory first waits for the card to
    finish the work queued before it, so this bounds the transport from
    above); the peak device memory."""
    import numpy as np
    import torch

    from pldepth_torch.core import mesh as mesh_lib
    from pldepth_torch.models.layers import BatchNorm
    from pldepth_torch.ops import listmle_kernel as k1

    state = trainer.init_state()
    if prepare is not None:
        prepare(trainer, state)
    grads, coll = [], [0.0]
    step_fn = trainer.optimizer.step
    keep = torch.cat([torch.full((p.numel(),), not re.fullmatch(r"decoder\.conv\d\.bias", n))
                      for n, p in state.model.named_parameters() if p.requires_grad])

    def spy(params, opt, finite, grad=None):
        grads.append(grad.detach().float().cpu()[keep])
        return step_fn(params, opt, finite, grad=grad)

    real_all_reduce = mesh_lib.Mesh._all_reduce
    real_gather = mesh_lib.Mesh.model_gather

    def timed(real):
        def call(self, *a, **kw):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **kw)
            finally:
                coll[0] += time.perf_counter() - t0
        return call

    trainer.optimizer.step = spy
    stack = contextlib.ExitStack()
    mesh_lib.Mesh._all_reduce = timed(real_all_reduce)
    mesh_lib.Mesh.model_gather = timed(real_gather)
    bns = [m for m in state.model.modules() if isinstance(m, BatchNorm)]
    losses, bn_stats = [], None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(batches) + 1)]
    try:
        if patch is not None:
            stack.enter_context(patch())
        ev[0].record()
        for i, b in enumerate(batches):
            state, m = trainer.train_step(state, trainer.shard_batch(b))
            ev[i + 1].record()
            losses.append(m.loss)
            if i == 0:
                bn_stats = torch.cat([torch.cat([bn.running_mean, bn.running_var])
                                      for bn in bns]).float().cpu()
        torch.cuda.synchronize()
    finally:
        stack.close()
        mesh_lib.Mesh._all_reduce = real_all_reduce
        mesh_lib.Mesh.model_gather = real_gather
        trainer.optimizer.step = step_fn
    step_ms = [ev[i].elapsed_time(ev[i + 1]) for i in range(len(batches))]
    kept = ({"digest": state_digest(state)} if digest else {"state": {
        **{f"model/{k}": v.detach().cpu() for k, v in state.model.state_dict().items()},
        **{f"opt/{k}": v.cpu() for k, v in state.opt.state_dict().items()}}})
    return {"losses": [float(v) for v in losses], "grad0": grads[0], "bn_stats1": bn_stats,
            **kept,
            "k1": {"ranking_loss_fwd": k1.ranking_loss_fwd.launches,
                   "ranking_loss_bwd": k1.ranking_loss_bwd.launches},
            "counts": k_counts(), "opt_count": int(state.opt.count),
            "mini_step": None if state.opt.mini_step is None else int(state.opt.mini_step),
            "step_ms": step_ms, "ms_median": float(np.median(step_ms)),
            "collective_ms_per_step": 1e3 * coll[0] / len(batches),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def dp_gaps(got: dict, want: dict) -> dict:
    """18a / 18b: a DP run against the single-process run."""
    rel_l2 = float((got["grad0"] - want["grad0"]).norm() / want["grad0"].norm())
    return {"loss": abs(got["losses"][0] - want["losses"][0]) / abs(want["losses"][0]),
            "grad": rel_l2, "bn_stats": max_rel(got["bn_stats1"], want["bn_stats1"])}


@contextlib.contextmanager
def one_rounding_bn():
    """Single-process BN statistics divided by the count where the card's
    ``mean`` multiplies by its reciprocal: at most one f32 rounding apart,
    a step's sensitivity to that."""
    import torch

    from pldepth_torch.models import layers

    moments = layers.batch_moments

    def divided(x, mesh=None):
        dims = tuple(range(x.dim() - 1))
        n = torch.tensor(float(x.numel() // x.shape[-1]), device=x.device)
        mean = x.sum(dim=dims) / n
        y = x - mean
        return mean, y, torch.square(y).sum(dim=dims) / n

    layers.batch_moments = divided
    try:
        yield
    finally:
        layers.batch_moments = moments


def dp_child(case: str, out: str) -> int:
    """One rank of phase 18, started by ``spawn_ranks`` with torchrun's
    variables; writes its results to ``out``/``case``_r<rank>.pt."""
    import torch

    from pldepth_torch.core import mesh as mesh_lib
    from pldepth_torch.core.config import MeshConfig
    from pldepth_torch.train import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.init_distributed()
    log(f"rank {mesh.rank} of {mesh.world}: {mesh.backend} on {mesh.device}")
    if mesh_lib.warmup_collectives(mesh) != mesh.world:
        fail("warmup_collectives does not count every rank")
    rec = {"backend": mesh.backend}
    if case == "18a":  # NCCL at world 1 against the same steps with no group
        cfg = load_config(EFFNET_CONFIG).replace(input_size=SIZE, batch_size=DP_BATCH)
        batches = dp_batches(DP_BATCH, SIZE, DP_STEPS)
        rec["group"] = dp_steps(Trainer(cfg, DP_STEPS), batches)
        rec["none"] = dp_steps(Trainer(cfg, DP_STEPS, mesh=mesh_lib.Mesh()), batches)
        # the step's sensitivity: no group, the BN statistics divided by the
        # count (at most one f32 rounding from the reciprocal product of mean)
        with one_rounding_bn():
            rec["ulp"] = dp_steps(Trainer(cfg, DP_STEPS, mesh=mesh_lib.Mesh()), batches)
    elif case == "18b":  # config #1, DP_BATCH global over the ranks; then 18c
        batches = dp_batches(DP_BATCH, SIZE, DP_STEPS)
        for dtype in DP_DTYPES:
            cfg = load_config(EFFNET_CONFIG).replace(
                input_size=SIZE, batch_size=DP_BATCH // mesh.world, compute_dtype=dtype)
            rec[dtype] = dp_steps(Trainer(cfg, DP_STEPS), batches)
        torch.cuda.empty_cache()
        # 18c in the same ranks (one start of two processes fewer)
        cfg = load_config(DP_B4_CONFIG).replace(batch_size=DP_B4_ROWS,
                                                mesh=MeshConfig(data=mesh.world))
        c = {"backend": mesh.backend, **dp_steps(
            Trainer(cfg, DP_STEPS), dp_batches(DP_B4_ROWS * mesh.world, cfg.input_size, DP_STEPS))}
        del c["grad0"], c["bn_stats1"]
        torch.save(c, os.path.join(out, f"18c_r{mesh.rank}.pt"))
    elif case == "20-smoke":  # phase 20's qenc int8 case at the smoke size (card test)
        cfg = dp_smoke_config(DP_SMOKE_BATCH).replace(
            qenc="int8", freeze_encoder=True, mesh=MeshConfig(data=1, model=mesh.world),
            spatial_sharding=True)
        batches = dp_batches(DP_SMOKE_BATCH, DP_SMOKE_SIZE, SP_STEPS)
        trainer = Trainer(cfg, SP_STEPS)
        rec.update(dp_steps(trainer, batches, digest=True,
                            prepare=lambda tr, st: tr.prepare_qenc(st, batches[0]["image"])))
        rec.update(sites=qenc_sites(trainer), k4_site=k4_row_site(trainer, batches[0]))
    elif case == "18b-smoke":
        rec.update(dp_steps(Trainer(dp_smoke_config(DP_SMOKE_BATCH // mesh.world), DP_STEPS),
                            dp_batches(DP_SMOKE_BATCH, DP_SMOKE_SIZE, DP_STEPS)))
    else:
        fail(f"unknown phase-18 case {case!r}")
    torch.save(rec, os.path.join(out, f"{case}_r{mesh.rank}.pt"))
    mesh_lib.shutdown()
    return 0


def start_ranks(argv, world: int, local_world: int):
    """Start ``world`` processes of ``argv`` with torchrun's variables
    (ranks of one host, a free localhost port) in this script's directory;
    ``finish_ranks`` waits for them."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
               "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(local_world),
               "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      cwd=os.path.dirname(os.path.abspath(__file__))))
    return procs


def finish_ranks(procs, what: str, timeout: int = 600):
    """Wait for the ranks of ``start_ranks``: every one must exit 0 within
    ``timeout`` s, else the phase fails (the others are stopped). Returns
    their outputs."""
    outs = [""] * len(procs)
    deadline = time.time() + timeout
    try:
        for rank, p in enumerate(procs):
            outs[rank] = p.communicate(timeout=max(1.0, deadline - time.time()))[0]
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, text) in enumerate(zip(procs, outs)):
        for line in (text or "").strip().splitlines()[-12:]:
            log(f"  [{what} rank {rank}] {line}")
        if p.returncode != 0:
            fail(f"{what}: rank {rank} of {len(procs)} exited {p.returncode}:\n"
                 f"{(text or '')[-3000:]}")
    return outs


def spawn_ranks(argv, world: int, local_world: int, what: str, timeout: int = 600):
    """``start_ranks`` then ``finish_ranks``: the ranks' outputs."""
    return finish_ranks(start_ranks(argv, world, local_world), what, timeout)


def phase18(smi: str) -> dict:
    """Phase 18: data parallelism (core/mesh.py) in child processes with
    torchrun's variables: (a) NCCL at world 1 against no group, (b) two
    ranks of config #1 on the one card over gloo against the single-process
    step, (c) config #5's model at 8 rows a rank, (d) cli train at two ranks
    with a sharded resident store."""
    import numpy as np
    import torch

    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz

    here = os.path.abspath(__file__)
    t_phase = time.perf_counter()
    rec = {"label": SHARED}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as out:
        child = [sys.executable, here, "--dp_child"]

        # 18a --------------------------------------------------------------------
        t0 = time.perf_counter()
        spawn_ranks(child + ["18a", "--dp_out", out], 1, 1, "18a")
        a = torch.load(os.path.join(out, "18a_r0.pt"), weights_only=False)
        gaps = dp_gaps(a["group"], a["none"])
        ulp = dp_gaps(a["ulp"], a["none"])
        rec["18a"] = {"backend": a["backend"], "gaps": gaps, "ulp": ulp,
                      "s": time.perf_counter() - t0, "ms_group": a["group"]["ms_median"],
                      "ms_none": a["none"]["ms_median"],
                      "collective_ms": a["group"]["collective_ms_per_step"]}
        log(f"18a NCCL at world 1 vs no group, config #1 batch {DP_BATCH}: backend "
            f"{a['backend']}; " + ", ".join(f"{k} {v:.3e} (bound {DP_TOL[k]:g})"
                                             for k, v in gaps.items())
            + "; one f32 rounding in the BN statistics (no group, divided): "
            + ", ".join(f"{k} {v:.3e}" for k, v in ulp.items())
            + f"; ms a step {a['group']['ms_median']:.2f} with the group "
            f"({a['group']['collective_ms_per_step']:.2f} of it in collectives, host clock), "
            f"{a['none']['ms_median']:.2f} without [{smi}]")
        if a["backend"] != "nccl" or any(gaps[k] > DP_TOL[k] for k in DP_TOL):
            fail(f"18a: backend {a['backend']} or gaps {gaps} beyond {DP_TOL}")

        # 18b: the single-process references first, alone on the card ------------
        t0 = time.perf_counter()
        batches = dp_batches(DP_BATCH, SIZE, DP_STEPS)
        refs = {dtype: dp_steps(Trainer(load_config(EFFNET_CONFIG).replace(
            input_size=SIZE, batch_size=DP_BATCH, compute_dtype=dtype), DP_STEPS), batches)
            for dtype in DP_DTYPES}
        del batches
        torch.cuda.empty_cache()
        spawn_ranks(child + ["18b", "--dp_out", out], 2, 2, "18b")
        ranks = [torch.load(os.path.join(out, f"18b_r{r}.pt"), weights_only=False)
                 for r in range(2)]
        want_k1 = {"ranking_loss_fwd": DP_STEPS, "ranking_loss_bwd": DP_STEPS}
        rec["18b"] = {"backend": ranks[0]["backend"], "bounds": DP_TOL,
                      "s": time.perf_counter() - t0}
        bad = []
        for dtype in DP_DTYPES:
            ref, runs = refs[dtype], [r[dtype] for r in ranks]
            gaps = [dp_gaps(r, ref) for r in runs]
            equal = all(torch.equal(v, runs[1]["state"][k]) for k, v in runs[0]["state"].items())
            rec["18b"][dtype] = {
                "gaps": gaps, "ranks_equal": equal, "k1": [r["k1"] for r in runs],
                "ms": [r["ms_median"] for r in runs], "ms_single": ref["ms_median"],
                "collective_ms": [r["collective_ms_per_step"] for r in runs],
                "peak_gb": [r["peak_gb"] for r in runs], "peak_gb_single": ref["peak_gb"]}
            gated = dtype == "float32"
            for r, (rk, g) in enumerate(zip(runs, gaps)):
                log(f"18b {dtype} rank {r} ({ranks[r]['backend']}) vs the single-process "
                    f"batch-{DP_BATCH} step: " + ", ".join(
                        f"{k} {v:.3e}" + (f" (bound {DP_TOL[k]:g})" if gated else "")
                        for k, v in g.items())
                    + ("" if gated else " (reported: 18a's one-rounding sensitivity above)")
                    + f"; K1 {rk['k1']}; {rk['ms_median']:.1f} ms a step, "
                    f"{rk['collective_ms_per_step']:.1f} ms of it in collectives, peak "
                    f"{rk['peak_gb']:.2f} GB ({SHARED}; one process alone: "
                    f"{ref['ms_median']:.1f} ms, {ref['peak_gb']:.2f} GB) [{smi}]")
            log(f"18b {dtype}: the ranks' weights, statistics and optimizer state bit-equal "
                f"after {DP_STEPS} steps: {equal}")
            if not equal or any(r["k1"] != want_k1 for r in runs) or (gated and any(
                    g[k] > DP_TOL[k] for g in gaps for k in DP_TOL)):
                bad.append(f"{dtype}: ranks equal {equal}, gaps {gaps}, K1 "
                           f"{[r['k1'] for r in runs]} (want {want_k1} a rank)")
        if ranks[0]["backend"] != "gloo" or bad:
            fail(f"18b: backend {ranks[0]['backend']}; {bad} (bounds {DP_TOL})")
        rec["k1_launches"] = {k: sum(r[d]["k1"][k] for r in ranks for d in DP_DTYPES)
                              for k in want_k1}
        del refs, ranks
        torch.cuda.empty_cache()

        # 18c (run in 18b's ranks after its cases) ----------------------------------
        ranks = [torch.load(os.path.join(out, f"18c_r{r}.pt"), weights_only=False)
                 for r in range(2)]
        equal = all(torch.equal(v, ranks[1]["state"][k]) for k, v in ranks[0]["state"].items())
        finite = all(np.all(np.isfinite(r["losses"])) for r in ranks)
        rec["18c"] = {"losses": ranks[0]["losses"], "ranks_equal": equal,
                      "ms": [r["ms_median"] for r in ranks],
                      "collective_ms": [r["collective_ms_per_step"] for r in ranks],
                      "peak_gb": [r["peak_gb"] for r in ranks]}
        for r, rk in enumerate(ranks):
            log(f"18c rank {r}: config #5's ff_effnet_b4 640^2 K 10 RPI 100 unfrozen, "
                f"{DP_B4_ROWS} rows a rank, mesh data 2: losses "
                f"{[round(v, 4) for v in rk['losses']]}; {rk['ms_median']:.1f} ms a step, "
                f"{rk['collective_ms_per_step']:.1f} ms of it in collectives, peak "
                f"{rk['peak_gb']:.2f} GB ({SHARED}) [{smi}]")
        log(f"18c ranks' states bit-equal after {DP_STEPS} steps: {equal}")
        if not (finite and equal):
            fail(f"18c: finite {finite}, ranks equal {equal}")
        del ranks

        # 18d --------------------------------------------------------------------
        t0 = time.perf_counter()
        runs = os.path.join(out, "runs")
        outs = spawn_ranks([sys.executable, "-m", "pldepth_torch.cli", "train", "--config_json",
                            os.path.join(os.path.dirname(here), "configs", EFFNET_CONFIG),
                            "--dataset", "scenes", "--ds_size", str(DP_SCENES), "--input_size",
                            str(SIZE), "--batch_size", str(DP_CLI_BATCH), "--epochs", "1",
                            "--data_resident", "true", "--output_dir", runs,
                            "--run_name", "dp18d"], 2, 2, "18d")
        stores = [re.search(r"resident store \(rank (\d) of 2\): (\d+) samples, ([0-9.]+) GB "
                            r"in HBM, gt_scale (\S+)", o) for o in outs]
        if not all(stores):
            fail("18d: a rank printed no resident store line")
        scales = {m.group(4) for m in stores}
        cfg = load_config(EFFNET_CONFIG).replace(input_size=SIZE)
        tr = Trainer(cfg, 1)
        state = load_weights_npz(os.path.join(runs, "dp18d", "weights.npz"), tr.init_state())
        pred = tr.predict(state, dp_batches(2, SIZE, 1)[0]["image"])
        rec["18d"] = {"store_gb": [float(m.group(3)) for m in stores],
                      "store_n": [int(m.group(2)) for m in stores], "gt_scale": sorted(scales),
                      "s": time.perf_counter() - t0}
        log(f"18d cli train at 2 ranks, {DP_SCENES} scenes, resident: stores "
            f"{rec['18d']['store_gb']} GB a rank of {rec['18d']['store_n']} samples, gt_scale "
            f"{sorted(scales)}; weights.npz from rank 0 loaded back and served: finite "
            f"{bool(torch.isfinite(pred).all())}; {rec['18d']['s']:.1f} s of command ({SHARED})")
        if len(scales) != 1 or not torch.isfinite(pred).all():
            fail(f"18d: gt_scale {scales} or a non-finite prediction from weights.npz")
    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 18: {rec['s']:.1f} s [{smi}]")
    return rec


# phase 19: spatial sharding, the mesh's model axis. Config #1 (ff_effnet
# 448^2, batch 32) and config #5's model (ff_effnet_b4 640^2 unfrozen, 8
# rows) at data 1 x model 2 and x model 4 against the single-process step on
# the same global batch; cli train --mesh_model 2 --spatial_sharding true on
# SP_SCENES resident scenes (19d, started beside phase 20's 20c). The ranks
# share the one card over gloo (NCCL refuses two ranks on one GPU): no time
# here is a scaling figure, and each rank's peak is set beside one process's.
# two steps a case (the gaps read step 1; "ms a step" is step 2's)
SP_STEPS, SP_BATCH, SP_B4_ROWS, SP_SCENES, SP_CLI_BATCH = 2, 32, 8, 16, 8
# (model, dtype) of each model axis: config #1 in f32 at both and in its
# own bf16 at model 2, config #5's model in f32 at model 2. Cut to keep
# the script inside its time limit, each with its last numbers in PERF.md:
# config #1's bf16 step at model 4 (4.2 s a step a rank) and config #5's
# bf16 at model 2 and 4 (reported only: its gaps were those one f32
# rounding of its BN statistics makes).
SP_CASES = {2: (("b0", "float32"), ("b0", "bfloat16"), ("b4", "float32")),
            4: (("b0", "float32"),)}
SP_SHARED = "ranks share 1 card over gloo, not a scaling figure"
# step-1 loss rel, the first step's all-reduced flat gradient rel L2 and the
# new BN running statistics rel, against the single-process step. A sharded
# conv convolves other row counts (cuDNN may pick another algorithm) and
# the BN, squeeze-excite and gradient sums run in another order, so f32
# holds the loss and statistics a decade over phase 18's data-parallel
# bounds and the gradient at 2e-2 (the card's own spread of the gradient is
# 6.4e-3, phase 18a). bf16: phase 18a measured one f32 rounding of the BN
# statistics turning config #1's bf16 step into loss 9e-5, gradient 0.17
# and statistics 2.7e-4, so config #1's bf16 is held only to what such
# roundings give.
SP_TOL = {"float32": {"loss": 1e-5, "grad": 2e-2, "bn_stats": 1e-4},
          "bfloat16": {"loss": 1e-3, "grad": 0.5, "bn_stats": 1e-2}}


def sp_config(model: str, dtype: str, m: int):
    """Config #1 (``b0``) or config #5's model (``b4``) at data 1 x model
    ``m``, spatially sharded when ``m`` > 1."""
    from pldepth_torch.core.config import MeshConfig

    if model == "b0":
        cfg = load_config(EFFNET_CONFIG).replace(input_size=SIZE, batch_size=SP_BATCH)
    else:
        cfg = load_config(DP_B4_CONFIG).replace(batch_size=SP_B4_ROWS)
    return cfg.replace(compute_dtype=dtype, mesh=MeshConfig(data=1, model=m),
                       spatial_sharding=m > 1)


def sp_batches(model: str):
    cfg = sp_config(model, "float32", 1)
    return dp_batches(cfg.batch_size, cfg.input_size, SP_STEPS, seed=19)


def sp_child(m: int, out: str) -> int:
    """One rank of phases 19 and 20 at model ``m``: every case of SP_CASES,
    then of ``sp20_cases(m)``, through ``dp_steps``; writes
    ``19-m<m>_r<rank>.pt`` to ``out``."""
    import torch

    from pldepth_torch.core import mesh as mesh_lib
    from pldepth_torch.train import Trainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = mesh_lib.init_distributed()
    if mesh_lib.warmup_collectives(mesh) != mesh.world:
        fail("warmup_collectives does not count every rank")
    rec = {"backend": mesh.backend}
    for model, dtype in SP_CASES[m]:
        trainer = Trainer(sp_config(model, dtype, m), SP_STEPS)
        rec[f"{model}-{dtype}"] = {**dp_steps(trainer, sp_batches(model), digest=True),
                                   "rows": trainer.input_rows()}
        del trainer
        torch.cuda.empty_cache()
    for key, cfg, batches, prepare in sp20_cases(m):
        t0 = time.perf_counter()
        trainer = Trainer(cfg, SP_STEPS)
        rec[key] = {**dp_steps(trainer, batches, digest=True, prepare=prepare),
                    "rows": trainer.input_rows()}
        if cfg.qenc == "int8":  # after the steps: these launches are not the path's
            rec[key].update(sites=qenc_sites(trainer), k4_site=k4_row_site(trainer, batches[0]),
                            enc_diff=qenc_rows_diff(trainer, batches[0]))
        rec[key]["s"] = time.perf_counter() - t0
        del trainer
        torch.cuda.empty_cache()
    torch.save(rec, os.path.join(out, f"19-m{m}_r{mesh.rank}.pt"))
    mesh_lib.shutdown()
    return 0


def phase19(smi: str) -> dict:
    """Phase 19: spatial sharding (ops/halo.py, core/mesh.py's model axis)
    in child processes with torchrun's variables: (a) config #1 in f32 and
    bf16 and config #5's model in f32 at model 2, (b) config #1 at model 4
    (a deepest level of 14 rows: 4/4/4/2), each rank's peak beside one
    process's, each against the single-process step (SP_CASES, gated).
    Phase 20's cases run in the same ranks after these (``rec["_p20"]``);
    (d), the spatially sharded cli train with ff_effnet, runs beside 20c."""
    import torch

    from pldepth_torch.train import Trainer

    here = os.path.abspath(__file__)
    t_phase = time.perf_counter()
    rec = {"label": SP_SHARED, "bounds": SP_TOL, "_p20": {}}
    torch.cuda.empty_cache()
    want_k1 = {"ranking_loss_fwd": SP_STEPS, "ranking_loss_bwd": SP_STEPS}
    k1_total = {k: 0 for k in want_k1}
    with tempfile.TemporaryDirectory() as out:
        # the single-process references, alone on the card
        t0 = time.perf_counter()
        refs = {}
        for model, dtype in sorted({c for cases in SP_CASES.values() for c in cases}):
            refs[f"{model}-{dtype}"] = dp_steps(Trainer(sp_config(model, dtype, 1), SP_STEPS),
                                                sp_batches(model), digest=True)
            torch.cuda.empty_cache()
        rec["refs_s"] = time.perf_counter() - t0
        bad = []
        for m in SP_CASES:
            t0 = time.perf_counter()
            spawn_ranks([sys.executable, here, "--dp_child", f"19-m{m}", "--dp_out", out], m, m,
                        f"19 model {m}")
            ranks = [torch.load(os.path.join(out, f"19-m{m}_r{r}.pt"), weights_only=False)
                     for r in range(m)]
            rec[f"model{m}"] = cell = {"backend": ranks[0]["backend"],
                                       "s": time.perf_counter() - t0}
            # phase 20's cases ran in the same ranks: phase20 reads them
            rec["_p20"][m] = {k: [r[k] for r in ranks] for k in ranks[0] if k.startswith("20-")}
            for model, dtype in SP_CASES[m]:
                key, tol = f"{model}-{dtype}", SP_TOL[dtype]
                ref, runs = refs[key], [r[key] for r in ranks]
                gaps = [dp_gaps(r, ref) for r in runs]
                equal = len({r["digest"] for r in runs}) == 1
                cell[key] = {
                    "gaps": gaps, "ranks_equal": equal, "k1": [r["k1"] for r in runs],
                    "rows": [r["rows"] for r in runs], "losses": runs[0]["losses"],
                    "ms": [r["step_ms"][-1] for r in runs],
                    "ms_single": ref["step_ms"][-1],
                    "collective_ms": [r["collective_ms_per_step"] for r in runs],
                    "peak_gb": [r["peak_gb"] for r in runs], "peak_gb_single": ref["peak_gb"]}
                for r, (rk, g) in enumerate(zip(runs, gaps)):
                    log(f"19 {model} {dtype} data 1 x model {m}, rank {r} (rows {rk['rows']}) vs "
                        f"the single-process step: " + ", ".join(
                            f"{k} {v:.3e} (bound {tol[k]:g})" for k, v in g.items())
                        + f"; K1 {rk['k1']}; {rk['step_ms'][-1]:.1f} ms a step (step "
                        f"{SP_STEPS}), {rk['collective_ms_per_step']:.1f} ms a step in "
                        f"collectives (mean of {SP_STEPS}), peak {rk['peak_gb']:.2f} GB "
                        f"({SP_SHARED}; one process alone: {ref['step_ms'][-1]:.1f} ms, "
                        f"{ref['peak_gb']:.2f} GB) [{smi}]")
                log(f"19 {model} {dtype} model {m}: the ranks' weights, statistics and optimizer "
                    f"state bit-equal after {SP_STEPS} steps: {equal}")
                for r in runs:
                    for k in want_k1:
                        k1_total[k] += r["k1"][k]
                if not equal or any(r["k1"] != want_k1 for r in runs) or any(
                        g[k] > tol[k] for g in gaps for k in tol):
                    bad.append(f"{key} model {m}: ranks equal {equal}, gaps {gaps}, K1 "
                               f"{[r['k1'] for r in runs]} (want {want_k1} a rank)")
            if cell["backend"] != "gloo":
                bad.append(f"model {m}: backend {cell['backend']}")
            del ranks
            torch.cuda.empty_cache()
        del refs
        if bad:
            fail(f"19: {bad} (bounds {SP_TOL})")
        rec["k1_launches"] = k1_total

    rec["s"] = time.perf_counter() - t_phase
    log(f"phase 19: {rec['s']:.1f} s [{smi}]")
    return rec


# phase 20: spatial sharding of ff_redweb and of the training options ------------------
# Config #2 (ff_redweb 448^2, batch 4, thresholded sampler, SGDR) in f32 at
# model 2 and 4, and config #1 (batch 32) in f32 at model 2 with each option,
# run in phase 19's child groups after its cases (no new process start), two
# steps each, against one process on the same global batches at SP_TOL's f32
# bounds. SP20_REPORTED names the gaps that are gated there unless they
# exceed the bound: ff_redweb's gradient (eps 1.001e-5 BNs on caffe-scale
# inputs). Above its bound it is reported beside the gap one f32 rounding
# of its BN statistics makes in its own single-process step
# (``one_rounding_bn``), and held under SP20_ROOM times that gap: its
# readings were 2.51e-2 / 2.30e-2 at model 2 / 4 beside a one-rounding gap
# of 2.20e-2 (at most 1.14 times it).
SP20_OPTIONS = (("qenc_int8", {"qenc": "int8"}), ("qenc_bf16", {"qenc": "bf16"}),
                ("sparse_tail", {"sparse_tail": True}), ("qres_int8", {"qres": "int8"}),
                ("remat_encoder", {"remat_encoder": True}), ("grad_accum_2", {"grad_accum": 2}))
SP20_REDWEB_MODELS = (2, 4)
SP20_REPORTED = {"20-redweb": ("grad",)}
SP20_ROOM = 2.0
SP20_CLI_SCENES = 16  # 20c: 15 training scenes, 3 resident steps at batch 4


def sp20_cases(m: int):
    """Phase 20's cases at data 1 x model ``m`` (1: the single-process
    references): [(key, config, global batches, prepare)]."""
    from pldepth_torch.core.config import MeshConfig

    out = []
    if m == 1 or m in SP20_REDWEB_MODELS:
        cfg = load_config(REDWEB_CONFIG).replace(
            input_size=SIZE, compute_dtype="float32", mesh=MeshConfig(data=1, model=m),
            spatial_sharding=m > 1)
        out.append(("20-redweb", cfg, dp_batches(cfg.batch_size, SIZE, SP_STEPS, seed=20), None))
    if m in (1, 2):
        batches = sp_batches("b0")
        for name, opt in SP20_OPTIONS:
            prepare = None
            if opt.get("qenc") == "int8":  # every rank calibrates on the whole images
                prepare = lambda tr, st, b=batches: tr.prepare_qenc(st, b[0]["image"])  # noqa: E731
            out.append((f"20-{name}", sp_config("b0", "float32", m).replace(**opt), batches,
                        prepare))
    return out


def qenc_sites(trainer) -> dict:
    """The int8 encoder's dense sites (a K4 launch each a forward where the
    rank owns rows) and of those the window reads (k > 1 or stride 2)."""
    from pldepth_torch.models.quantize import quant_sites

    dense = [m for m in quant_sites(trainer._qenc[1]).values() if m.groups == 1]
    return {"dense": len(dense),
            "windows": sum(m.kernel_q.shape[0] > 1 or m.stride > 1 for m in dense)}


def qenc_rows_diff(trainer, batch) -> dict:
    """The frozen int8 encoder on this rank's rows (sharded: halos, model
    sums) against the unsharded encoder's rows on 8 of the batch's images:
    of each output (the decoder's taps and the top), the elements that
    differ (f32; 0 is bit-equal). Its squeeze-excite means are summed in
    float64 (``exact_mean``): one bit apart, they would flip int8
    roundings of the activations they gate."""
    import torch

    rows = trainer._spatial()
    encoder = trainer._qenc[1]
    x = trainer._images(batch["image"][:8])
    s, e = rows.span
    with torch.no_grad():
        outs = [encoder(x), encoder(x[:, s:e].contiguous(), rows=rows.at(0))]
    flat = [[top, *(taps.values() if isinstance(taps, dict) else taps)] for top, taps in outs]
    differ = total = 0
    for whole, mine in zip(*flat):
        so, eo = rows.at(rows.heights.index(whole.shape[1])).span
        differ += int((whole[:, so:eo] != mine).sum())
        total += mine.numel()
    return {"differ": differ, "of": total, "outputs": len(flat[0])}


def k4_row_site(trainer, batch) -> dict:
    """K4's window read at the int8 encoder's stem (3 x 3 stride 2) on this
    rank's int8 rows extended by their halo (exchanged over the model
    group, as the step does) against its plain twin and against the
    unsharded conv's rows: f32 out, bit-equal."""
    import torch

    from pldepth_torch.models.quantize import quantize_activation
    from pldepth_torch.ops import quant_conv
    from pldepth_torch.ops.conv import conv_row_plan
    from pldepth_torch.ops.halo import extend_rows

    rows = trainer._spatial().at(0)
    site = trainer._qenc[1].stem_conv
    _, inv, a_eff = site.derived()
    q_full = quantize_activation(trainer._images(batch["image"][:8]).to(site.dtype), inv)
    plan = conv_row_plan(rows, site.kernel_q.shape[0], site.stride)
    s, e = rows.span
    ext = extend_rows(q_full[:, s:e].contiguous(), rows, plan)
    args = (site.kernel_q, site.w_scale, site.bias, a_eff, site.stride, torch.float32, None,
            plan, rows.index)
    got = quant_conv.quant_conv2d_rows_local(ext, *args, w_packed=site.packed_weight())
    plain = quant_conv.quant_conv2d_rows_local_plain(ext, *args)
    so, eo = rows.parts[1][rows.index]
    whole = quant_conv.quant_conv2d_plain(q_full, site.kernel_q, site.w_scale, site.bias, a_eff,
                                          site.stride, torch.float32)[:, so:eo]
    torch.cuda.synchronize()
    return {"ext": list(ext.shape), "out": list(got.shape),
            "max_abs_err": float((got - plain).abs().max()) if got.numel() else 0.0,
            "equal_plain": bool(torch.equal(got, plain)),
            "equal_whole": bool(torch.equal(got, whole))}


def phase20(smi: str, runs20: dict) -> dict:
    """Phase 20: spatial sharding of ff_redweb and of the training options.
    ``runs20``: {model axis: {case: [each rank's dp_steps record]}} from
    phase 19's child groups. The single-process references run here, alone
    on the card; then (c) cli train --model_name ff_redweb --mesh_model 2
    --spatial_sharding true on a resident store of each rank's rows, and
    19d (the same with ff_effnet) in a second pair of ranks beside it."""
    import torch

    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz

    here = os.path.abspath(__file__)
    t_phase = time.perf_counter()
    tol = SP_TOL["float32"]
    rec = {"label": SP_SHARED, "bounds": tol}
    refs = {}
    for key, cfg, batches, prepare in sp20_cases(1):
        trainer = Trainer(cfg, SP_STEPS)
        refs[key] = dp_steps(trainer, batches, digest=True, prepare=prepare)
        if cfg.qenc == "int8":
            refs[key]["sites"] = qenc_sites(trainer)
        del trainer
        torch.cuda.empty_cache()
    rec["ulp"] = {}
    for key, cfg, batches, prepare in sp20_cases(1):
        if key not in SP20_REPORTED:
            continue
        ulp = dp_steps(Trainer(cfg, SP_STEPS), batches, digest=True, prepare=prepare,
                       patch=one_rounding_bn)
        rec["ulp"][key] = dp_gaps(ulp, refs[key])
        log(f"20 {key[3:]} f32: one f32 rounding in the single-process step's BN statistics "
            f"(divided by the count) moves " + ", ".join(
                f"{k} {v:.3e}" for k, v in rec["ulp"][key].items()) + f" [{smi}]")
        del ulp
        torch.cuda.empty_cache()
    rec["refs_s"] = time.perf_counter() - t_phase
    bad = []
    k1_fused = {"ranking_loss_fwd": 0, "ranking_loss_bwd": 0}
    k1_sorted = {"listmle_fwd": 0, "listmle_bwd": 0}
    rec["k4_launches"], rec["k4_max_abs_err"] = 0, 0.0
    for m, cases in sorted(runs20.items()):
        for key, runs in cases.items():
            ref = refs[key]
            gaps = [dp_gaps(r, ref) for r in runs]
            equal = len({r["digest"] for r in runs}) == 1
            reported = [k for k in SP20_REPORTED.get(key, ())
                        if any(g[k] > tol[k] for g in gaps)]
            gated = [k for k in tol if k not in reported]
            limit = {k: SP20_ROOM * rec["ulp"][key][k] for k in reported}
            rec[f"{key}-m{m}"] = cell = {
                "gaps": gaps, "ranks_equal": equal, "rows": [r["rows"] for r in runs],
                "counts": [r["counts"] for r in runs], "losses": runs[0]["losses"],
                "ms": [r["step_ms"][-1] for r in runs], "ms_single": ref["step_ms"][-1],
                "collective_ms": [r["collective_ms_per_step"] for r in runs],
                "peak_gb": [r["peak_gb"] for r in runs], "peak_gb_single": ref["peak_gb"],
                "child_s": [r["s"] for r in runs], "reported": reported, "limits": limit,
                "opt_count": [r["opt_count"] for r in runs]}
            for r, (rk, g) in enumerate(zip(runs, gaps)):
                log(f"20 {key[3:]} data 1 x model {m}, rank {r} (rows {rk['rows']}) vs the "
                    f"single-process step: " + ", ".join(
                        f"{k} {v:.3e}" + (f" (bound {tol[k]:g})" if k in gated else
                                          f" (reported beside its one-rounding gap above; "
                                          f"limit {limit[k]:.3e}, {SP20_ROOM:g} times it)")
                        for k, v in g.items())
                    + f"; counts {rk['counts']}; {rk['step_ms'][-1]:.1f} ms a step (step "
                    f"{SP_STEPS}), {rk['collective_ms_per_step']:.1f} ms a step in collectives "
                    f"(mean of {SP_STEPS}), peak {rk['peak_gb']:.2f} GB ({SP_SHARED}; one "
                    f"process alone: {ref['step_ms'][-1]:.1f} ms, {ref['peak_gb']:.2f} GB) "
                    f"[{smi}]")
            log(f"20 {key[3:]} model {m}: the ranks' weights, statistics and optimizer state "
                f"bit-equal after {SP_STEPS} steps: {equal}")
            if not equal or any(g[k] > tol[k] for g in gaps for k in gated) or any(
                    g[k] > limit[k] for g in gaps for k in reported):
                bad.append(f"{key} model {m}: ranks equal {equal}, gaps {gaps}, limits "
                           f"{limit}")
            sparse = key == "20-sparse_tail"
            want = {n: SP_STEPS if (n.startswith("listmle") == sparse) else 0
                    for n in (*k1_fused, *k1_sorted)}
            for r in runs:
                got = {n: r["counts"][n] for n in want}
                if got != want:
                    bad.append(f"{key} model {m}: K1 counts {got}, want {want} a rank")
                for n in k1_fused:
                    k1_fused[n] += got[n]
                for n in k1_sorted:
                    k1_sorted[n] += got[n]
            updates = 1 if key == "20-grad_accum_2" else SP_STEPS
            if any(c != updates for c in cell["opt_count"]) or ref["opt_count"] != updates:
                bad.append(f"{key} model {m}: {cell['opt_count']} optimizer updates a rank "
                           f"(one process {ref['opt_count']}), want {updates}")
            if key == "20-qenc_int8":
                sites = ref["sites"]
                want4 = {"quant_matmul": SP_STEPS * sites["dense"],
                         "window_reads": SP_STEPS * sites["windows"]}
                for r in runs:
                    got4 = {n: r["counts"][n] for n in want4}
                    site = r["k4_site"]
                    rec["k4_launches"] += got4["quant_matmul"]
                    rec["k4_max_abs_err"] = max(rec["k4_max_abs_err"], site["max_abs_err"])
                    diff = r["enc_diff"]
                    cell.setdefault("enc_diff", []).append(diff)
                    log(f"20 qenc int8 model {m}: K4 {got4} over {SP_STEPS} steps ({sites} int8 "
                        f"encoder sites a forward); the stem's window read on the rank's "
                        f"extended int8 rows {site['ext']} -> {site['out']} bit-equal to its "
                        f"plain twin {site['equal_plain']} and to the unsharded conv's rows "
                        f"{site['equal_whole']} (max|d| {site['max_abs_err']:.3e}, f32 out); "
                        f"the sharded int8 encoder's {diff['outputs']} outputs on 8 images: "
                        f"{diff['differ']} of {diff['of']} elements differ from the unsharded "
                        f"encoder's rows")
                    if got4 != want4 or not (site["equal_plain"] and site["equal_whole"]):
                        bad.append(f"qenc int8 model {m}: K4 {got4} (want {want4}), site {site}")
    rec["k1_fused"], rec["k1_sorted"] = k1_fused, k1_sorted
    if bad:
        fail(f"20: {bad} (bounds {tol})")

    # 20c, and 19d beside it (two groups of two ranks at once) ----------------------
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out:
        runs_dir = os.path.join(out, "runs")
        cli = [sys.executable, "-m", "pldepth_torch.cli", "train", "--dataset", "scenes",
               "--input_size", str(SIZE), "--epochs", "1", "--data_resident", "true",
               "--mesh_model", "2", "--spatial_sharding", "true", "--output_dir", runs_dir]
        configs = os.path.join(os.path.dirname(here), "configs")
        groups = {
            "20c": (REDWEB_CONFIG, start_ranks(cli + [
                "--config_json", os.path.join(configs, REDWEB_CONFIG), "--model_name", "ff_redweb",
                "--ds_size", str(SP20_CLI_SCENES), "--run_name", "sp20c"], 2, 2)),
            "19d": (EFFNET_CONFIG, start_ranks(cli + [
                "--config_json", os.path.join(configs, EFFNET_CONFIG), "--ds_size",
                str(SP_SCENES), "--batch_size", str(SP_CLI_BATCH), "--run_name", "sp19d"], 2, 2))}
        for name, (config, procs) in groups.items():
            outs = finish_ranks(procs, name)
            stores = [re.search(r"resident store \(rank (\d) of 2\): (\d+) samples, ([0-9.]+) "
                                r"GB in HBM, gt_scale (\S+)", o) for o in outs]
            if not all(stores):
                fail(f"{name}: a rank printed no resident store line")
            scales = {m.group(4) for m in stores}
            written = sorted(os.listdir(os.path.join(runs_dir, f"sp{name}")))
            tr = Trainer(load_config(config).replace(input_size=SIZE), 1)
            state = load_weights_npz(os.path.join(runs_dir, f"sp{name}", "weights.npz"),
                                     tr.init_state())
            pred = tr.predict(state, dp_batches(2, SIZE, 1)[0]["image"])
            rec[name] = {"store_gb": [float(m.group(3)) for m in stores],
                         "store_n": [int(m.group(2)) for m in stores], "gt_scale": sorted(scales),
                         "written": written}
            log(f"{name} cli train --model_name {tr.cfg.model_name} --mesh_model 2 "
                f"--spatial_sharding true, resident: stores {rec[name]['store_gb']} GB a rank "
                f"(each its image rows) of {rec[name]['store_n']} samples, gt_scale "
                f"{sorted(scales)}; run files {written}; weights.npz from rank 0 loaded back and "
                f"served: finite {bool(torch.isfinite(pred).all())} ({SP_SHARED})")
            if len(scales) != 1 or not torch.isfinite(pred).all() or "weights.npz" not in written:
                fail(f"{name}: gt_scale {scales}, run files {written} or a non-finite prediction")
    rec["cli_s"] = time.perf_counter() - t0
    log(f"20c and 19d side by side: {rec['cli_s']:.1f} s of commands ({SP_SHARED})")
    rec["s"] = time.perf_counter() - t_phase
    rec["child_s"] = {f"model{m}": max(sum(r["s"] for r in runs) for runs in zip(*cases.values()))
                      for m, cases in runs20.items()}
    log(f"phase 20: {rec['s']:.1f} s here, plus {rec['child_s']} s of cases in phase 19's "
        f"ranks [{smi}]")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="", help="also write every number here as JSON")
    ap.add_argument("--dp_child", default="", help=argparse.SUPPRESS)  # a phase-18/19 rank
    ap.add_argument("--dp_out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import pldepth_torch  # noqa: F401
    except ImportError as e:
        fail(f"pldepth_torch is not importable next to this script: {e}")
    if args.dp_child.startswith("19-m"):
        return sp_child(int(args.dp_child[len("19-m"):]), args.dp_out)
    if args.dp_child:
        return dp_child(args.dp_child, args.dp_out)
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
    record["k1_checks"], k1s_fwd_err, k1s_bwd_err = check_k1()
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

    # 13. evaluation: cli train's post-train report, cli eval, cli zeroshot ------------------
    record["eval"] = eval_phase(smi)

    mark("13")

    # 14. the training data path: five feeds through fit, cli train --data_resident ---------
    record["data_path"] = rec_d = data_path_phase(smi)

    mark("14")

    # 15. export and artifact serving; the training options -----------------------------
    record["export"] = export_phase(decode, chunks, smi)
    record["options"] = rec_o = options_phase(smi)

    mark("15")

    # 16. the quant metric gate, active learning, chi2 and dump -------------------------
    record["phase16"] = rec16 = phase16(smi)

    mark("16")

    # 17. --profile and the sinks, sweeps and their analysis, warmup --------------------
    record["phase17"] = rec17 = phase17(smi)

    mark("17")

    # 18. data parallelism: NCCL at world 1, two ranks on the card, cli train ------
    record["phase18"] = rec18 = phase18(smi)

    mark("18")

    # 19. spatial sharding: model 2 and 4 on the card, config #1 and #5's model, cli train ---
    record["phase19"] = rec19 = phase19(smi)

    mark("19")

    # 20. spatial sharding of ff_redweb and of the options (cases in phase 19's ranks), cli ---
    record["phase20"] = rec20 = phase20(smi, rec19.pop("_p20"))

    mark("20")

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
        "launches": (rec_t["launches"][name] + rec_rt["launches"][name]
                     + rec_d["k1_launches"][name] + rec16["gate"]["k1_launches"][name]
                     + rec16["active"]["k1_launches"][name] + rec17["k1_launches"][name]
                     + rec18["k1_launches"][name] + rec19["k1_launches"][name]
                     + rec20["k1_fused"][name]),
        "max_abs_err": err,
        **{key: k1t["fused"][K1_MAIN][name][key] for key in ("ms", "plain_ms", "bound_ms",
                                                              "bound_by")},
        "library_ms": None,  # no single PyTorch call computes the fused loss
    } for name, replaces, err in (
        ("ranking_loss_fwd", "pldepth_tpu/ops/listmle_pallas.py:111", k1_fwd_err),
        ("ranking_loss_bwd", "pldepth_tpu/ops/listmle_pallas.py:121", k1_bwd_err))] + [{
        "name": name, "route": "cuda", "source": "pldepth_torch/csrc/listmle.cu",
        "replaces": replaces,
        "launches": (rec_o["sparse_tail"]["counts"][name]
                     + rec_o["redweb_sparse_tail"]["counts"][name] + rec20["k1_sorted"][name]),
        "max_abs_err": err,
        **{key: k1t["sorted"][K1_MAIN][name][key] for key in ("ms", "plain_ms", "bound_ms",
                                                               "bound_by", "library_ms")},
    } for name, replaces, err in (
        ("listmle_fwd", "pldepth_tpu/ops/listmle_pallas.py:111", k1s_fwd_err),
        ("listmle_bwd", "pldepth_tpu/ops/listmle_pallas.py:121", k1s_bwd_err))] + [{
        "name": "quant_matmul", "route": "cuda", "source": "pldepth_torch/csrc/quant_matmul.cu",
        "replaces": "pldepth_tpu/ops/quant_matmul.py:44",
        "launches": (rec_q["k4_launches_main_path"] + rec_rs["k4_launches_main_path"]
                     + rec_o["qenc_int8"]["counts"]["quant_matmul"]
                     + rec16["gate"]["k4_launches"] + rec20["k4_launches"]),
        "max_abs_err": max(rec_q["k4_max_abs_err"], rec_rs["k4_max_abs_err"],
                           rec20["k4_max_abs_err"]),
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
