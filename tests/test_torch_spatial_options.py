"""Spatial sharding of ff_redweb and of the training options on the CPU.

(a) In one process, over the ``SIZES`` of tests/test_torch_spatial.py, each
    rank's rows cut from the whole tensor: the row-sharded max pool (-inf
    pad, stride 2, uneven and empty ranks) equals ``F.max_pool2d``'s
    forward and gradient (float64, 1e-12; ties included); the int8
    row-local conv's plain twin gives the int32 sums of the unsharded
    ``quant_conv2d_plain`` exactly (k 1, 3, 5; stride 1, 2); the sparse
    tail's owner-sum taps (each pixel, outside the image too, owned by one
    rank) sum to the unsharded taps (1e-12); the int8 graph's
    squeeze-excite on row pieces equals the whole image's rows bit for bit
    in f32 (its means summed in float64).

The rest runs in child processes, this file run as a script: two pairs
(world 2; the second runs the cli), a quad (world 4) and one process with
no group (the references), each
joined through a ``file://`` rendezvous under the test's temporary
directory, each child with tests/test_torch_spatial.py's ``CHILD_TIMEOUT``.
Every rank of a group runs the same cases in order and writes ``.npz``
results; the parent makes the JAX references of (c) while they run.

(b) In float64, at 64^2, data 1 x model 2 (pair) and data 1 x model 4
    (quad: ranks 2 and 3 own no rows at any level), the sharded
    ``train_step`` against the port's single-process step, loss, params and
    BN statistics to 1e-9 relative: ff_redweb (plain, sparse_tail, remat,
    grad_accum 2, and ``resident_step`` from a store of each rank's rows);
    ff_smoke with qres int8, qenc bf16, qenc int8 (``prepare_qenc``
    unsharded on every rank), sparse_tail, grad_accum 2 and 3; ff_effnet
    (B0: drop-path live) with remat. ff_redweb runs at reduced encoder
    depth (one bottleneck a stage, tests/test_torch_redweb.py's ``SMALL``)
    in these float64 cases; the cli runs the full model.
(c) Against the JAX package's spatial step on 2 virtual devices, from the
    same weights: the ff_redweb sharded step at reduced depth (the JAX
    registry exposes no ``stage_blocks``: the JAX encoder and decoder
    composed as tests/test_torch_redweb.py does, jitted with the image rows
    sharded ``P(None, "model")``) at that file's bounds: inference forward
    rel 1e-5, train forward and BN statistics rel 1e-4, loss rel 1e-5, and
    every gradient of the sharded step run in float64 against the JAX graph
    run in float64 (per tensor 1e-2, over all 2e-3; in f32 the sharded
    stem conv's gradient sat 1.07e-2 from float64's, the step's
    ill-conditioning, tests/test_torch_redweb.py); the ``qenc int8`` step (K4's path: loss rel 1e-5,
    params rtol 1e-4 / atol 1e-5) and the ``sparse_tail`` step with ranking
    indices outside the map (the sorted K1's path: loss rel 1e-6, params
    1e-5), tests/test_torch_train_options.py's bounds.
(d) A NaN in one rank's rows refuses a grad_accum micro-step on every
    rank: ``mini_step``, the accumulator and the weights roll back alike.
(e) ``cli train --model_name ff_redweb --mesh_model 2 --spatial_sharding
    true`` (full depth) on the streaming feed, resumed, and on the resident
    feed, and ``cli train`` with each option (``--sparse_tail``,
    ``--qres``, ``--qenc bf16``, and ``grad_accum`` / ``remat_encoder``
    through ``--config_json``) write on rank 0 only; ff_redweb's streaming
    run and grad_accum's (in the middle of its cycle) resume.

    python tests/test_torch_spatial_options.py GROUP RANK WORLD RENDEZVOUS_FILE OUT_DIR
"""

import builtins
import contextlib
import io
import itertools
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
for _p in (REPO, TESTS):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from pldepth_torch.core import mesh as mesh_lib  # noqa: E402
from pldepth_torch.core.config import ExperimentConfig, MeshConfig  # noqa: E402
from pldepth_torch.data.datasets import DepthDataset  # noqa: E402
from pldepth_torch.data.resident import build_resident_store  # noqa: E402
from pldepth_torch.models import pldepth_net  # noqa: E402
from pldepth_torch.models.pretrained import flax_from_state_dict  # noqa: E402
from pldepth_torch.ops import conv, halo, quant_conv, resize, sparse_tail  # noqa: E402
from pldepth_torch.ops import quant_matmul as k4  # noqa: E402
from pldepth_torch.train import Trainer  # noqa: E402
from test_torch_spatial import (  # noqa: E402
    CHILD_TIMEOUT,
    S,
    SIZES,
    STORE_N,
    assert_close_1e9,
    assert_ranks_equal,
    digest,
    sampled_batches,
    state_arrays,
    store_sample,
    to_float64,
)

torch.set_num_threads(1)
SMALL = dict(stage_blocks=(1, 1, 1, 1), c4_tap_block=0)  # tests/test_torch_redweb.py's
RW = dict(model_name="ff_redweb", input_size=S, batch_size=2, ranking_size=3,
          rankings_per_image=8, sampling_type=1, compute_dtype="float64", freeze_encoder=True,
          augmentation=True, initial_lr=0.01, adam_eps=1e-2, epochs=1)
SM = {**RW, "model_name": "ff_smoke"}
EF = {**RW, "model_name": "ff_effnet"}  # B0: residual blocks with live drop-path
F64_CASES = {
    "rw_plain": {**RW}, "rw_sparse": {**RW, "sparse_tail": True},
    "rw_remat": {**RW, "remat_encoder": True}, "rw_accum2": {**RW, "grad_accum": 2},
    "qres": {**SM, "qres": "int8"}, "qenc_bf16": {**SM, "qenc": "bf16"},
    "qenc_int8": {**SM, "qenc": "int8"}, "sparse": {**SM, "sparse_tail": True},
    "remat": {**EF, "remat_encoder": True}, "accum2": {**SM, "grad_accum": 2},
    "accum3": {**SM, "grad_accum": 3},
}
# tests/test_torch_train_options.py's STEP_CFG: the JAX comparisons of (c)
STEP_CFG = dict(model_name="ff_smoke", input_size=S, batch_size=2, ranking_size=4,
                rankings_per_image=8, compute_dtype="float32", freeze_encoder=True,
                augmentation=False, initial_lr=0.01, adam_eps=1e-2, epochs=1)
J_OPTIONS = {"jqenc": {"qenc": "int8"}, "jsparse": {"sparse_tail": True}}
RW_B, RW_RPI, RW_K = 2, 16, 5  # the ff_redweb module comparison's batch and lists
CLI_RW = ["train", "--device", "cpu", "--model_name", "ff_redweb", "--dataset", "synthetic",
          "--input_size", str(S), "--ds_size", "6", "--batch_size", "2", "--ranking_size", "3",
          "--rankings_per_image", "8", "--compute_dtype", "float32", "--mesh_model", "2",
          "--spatial_sharding", "true"]
CLI_SM = [("sparse_tail", ["--sparse_tail", "true"], None), ("qres", ["--qres", "int8"], None),
          ("qenc", ["--qenc", "bf16", "--freeze_encoder", "true"], None),
          ("accum", [], {"grad_accum": 2}), ("remat", [], {"remat_encoder": True})]


@contextlib.contextmanager
def small_redweb():
    """The registry's ff_redweb at reduced encoder depth (``SMALL``)."""
    real = pldepth_net.MODEL_REGISTRY["ff_redweb"]

    def make(dtype=torch.bfloat16, fused_tail=True, head_ch=32, drop_connect_rate=0.2,
             remat=False, qres=None):
        return pldepth_net.PLDepthModel(
            "ff_redweb", lambda **mode: pldepth_net.ReDWebFullyFledged(dtype, remat=remat,
                                                                       **SMALL, **mode),
            "caffe")

    pldepth_net.MODEL_REGISTRY["ff_redweb"] = make
    try:
        yield
    finally:
        pldepth_net.MODEL_REGISTRY["ff_redweb"] = real


def small_redweb_module(dtype=torch.float32):
    """The seeded reduced-depth ff_redweb module of (c), the same in the
    children and the parent."""
    from pldepth_torch.models.layers import BatchNorm, reset_parameters

    model = reset_parameters(pldepth_net.ReDWebFullyFledged(dtype, **SMALL),
                             torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():  # tests/test_torch_redweb.py's: init statistics would hide faults
        for bn in (m for m in model.modules() if isinstance(m, BatchNorm)):
            for buf in (bn.running_mean, bn.running_var):
                buf += (0.05 * torch.arange(buf.numel(), dtype=buf.dtype)) % 0.3
    return model


def redweb_inputs():
    """(normalized images, rankings) of (c)'s ff_redweb comparison."""
    from pldepth_torch.data.preprocess import normalize_images

    rng = np.random.default_rng(15)
    images = rng.uniform(size=(RW_B, S, S, 3)).astype(np.float32)
    idx = rng.integers(0, S * S, (RW_B, RW_RPI, RW_K))
    depths = np.sort(rng.uniform(0.1, 1.0, (RW_B, RW_RPI, RW_K)), axis=-1)[..., ::-1]
    rankings = np.stack([idx, depths], -1).astype(np.float32)
    return normalize_images(torch.from_numpy(images), "caffe").numpy(), rankings


def options_fixed_batch(out_of_range: bool):
    """(c)'s fixed batch: tests/test_torch_train_options.py's ``_fixed_batch(0)``."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, S * S, (2, 8, 4))
    if out_of_range:  # past the map, and negative: rows outside the image
        idx[0, 0, 1], idx[1, 2, 0] = S * S + 5, -3
    depths = np.sort(rng.uniform(0.1, 1.0, (2, 8, 4)), axis=-1)[..., ::-1]
    rankings = np.stack([idx, depths], -1).astype(np.float32)
    rng = np.random.default_rng(100)
    return {"image": rng.uniform(size=(2, S, S, 3)).astype(np.float32), "rankings": rankings}


# ---------------------------------------------------------------------------
# the children's cases
# ---------------------------------------------------------------------------
def f64_case(name, world, rank, resident=False):
    """(b): one case of ``F64_CASES`` at data 1 x model ``world`` (world 1:
    the single-process reference); ``max(2, grad_accum)`` train steps, and
    with ``resident`` two resident steps after them."""
    cfg = ExperimentConfig(**F64_CASES[name], mesh=MeshConfig(data=1, model=world),
                           spatial_sharding=world > 1)
    with small_redweb():
        tr = Trainer(cfg, steps_per_epoch=4, device="cpu")
        state = to_float64(tr, tr.init_state())
    batches = sampled_batches(max(2, cfg.grad_accum), seed=15, rows=2)
    if cfg.qenc == "int8":  # every rank calibrates on the whole images
        tr.prepare_qenc(state, batches[0]["image"])
    res = {}
    for i, b in enumerate(batches):
        state, m = tr.train_step(state, tr.shard_batch(b))
        res[f"loss{i}"], res[f"finite{i}"] = float(m.loss), bool(m.finite)
    if resident:
        store = build_resident_store(DepthDataset("np", STORE_N, store_sample), "cpu",
                                     rows=tr.input_rows())
        for i in range(2):
            state, m = tr.resident_step(state, store.arrays)
            res[f"rloss{i}"] = float(m.loss)
        res["store_rows"] = store.arrays["image"].shape[1]
    if cfg.grad_accum > 1:
        res["mini_step"] = int(state.opt.mini_step)
    res.update(state_arrays(state, rank=rank))
    return res


def redweb_module_case(world, rank, out):
    """(c): the reduced ff_redweb's sharded inference and train forwards,
    loss and BN statistics in f32, and its gradient (the all-reduced sum of
    the ranks' shares) in float64, as the spatial step computes them."""
    from pldepth_torch.core.mesh import make_mesh
    from pldepth_torch.models.layers import TrainPass
    from pldepth_torch.models.pretrained import flax_key
    from pldepth_torch.ops.halo import RowShard
    from pldepth_torch.ops.listmle import pl_ranking_loss

    mesh = make_mesh(MeshConfig(data=1, model=world))
    model = small_redweb_module()
    rows = RowShard.for_mesh(mesh, S, 5)
    x, rankings = redweb_inputs()
    s, e = rows.span
    xr = torch.from_numpy(x[:, s:e])
    with torch.no_grad():
        infer = rows.gather(model(xr, rows=rows))
    train = TrainPass(mesh=mesh)
    with torch.no_grad():
        pred = rows.gather(model(xr, train, rows=rows))
    res = {"loss": float(pl_ranking_loss(pred, torch.from_numpy(rankings)))}
    if rank == 0:
        names = {m: n for n, m in model.named_modules()}
        res.update({"infer": infer.numpy(), "train": pred.numpy()})
        for bn, (mean, var) in train.new_stats.items():
            path = names[bn].replace(".", "/")
            res[f"stats/batch_stats/{path}/mean"] = mean.numpy()
            res[f"stats/batch_stats/{path}/var"] = var.numpy()
    # the gradient in float64, against the JAX graph run in float64
    model = small_redweb_module(torch.float64).double()
    pred = rows.gather(model(xr.double(), TrainPass(mesh=mesh), rows=rows))
    loss = pl_ranking_loss(pred, torch.from_numpy(rankings))
    (loss * (1.0 / mesh.world)).backward()
    for n, p in model.named_parameters():
        g = mesh.reduce_(p.grad.clone())
        if rank == 0:
            res["grad/" + flax_key(n, p.dim())] = (g.numpy().transpose(2, 3, 1, 0)
                                                   if g.dim() == 4 else g.numpy())
    return res


def options_jax_case(name):
    """(c): one fixed step of ``J_OPTIONS[name]`` at data 1 x model ``world``."""
    def case(world, rank, out):
        opt = J_OPTIONS[name]
        cfg = ExperimentConfig(**STEP_CFG, **opt, mesh=MeshConfig(data=1, model=world),
                               spatial_sharding=True)
        tr = Trainer(cfg, steps_per_epoch=3, device="cpu")
        state = tr.init_state()
        b = options_fixed_batch(out_of_range=bool(opt.get("sparse_tail")))
        if cfg.qenc:
            tr.prepare_qenc(state, b["image"])
        state, m = tr.train_step_fixed(state, tr.shard_batch(b))
        res = {"loss": float(m.loss), "finite": bool(m.finite), "digest": digest(state)}
        if rank == 0:
            res.update({f"flax/{k}": np.array(v) for k, v in
                        flax_from_state_dict(state.model.state_dict()).items()})
        return res
    return case


def accum_nan_case(world, rank, out):
    """(d): grad_accum 2 at data 1 x model 4; micro-step 2 has a NaN in rank
    1's rows, then a good cycle follows."""
    cfg = ExperimentConfig(**{**SM, "compute_dtype": "float32", "grad_accum": 2},
                           mesh=MeshConfig(data=1, model=world), spatial_sharding=True)
    tr = Trainer(cfg, steps_per_epoch=4, device="cpu")
    state = tr.init_state()
    bs = sampled_batches(4, seed=16, rows=2)
    state, m = tr.train_step(state, tr.shard_batch(bs[0]))
    res = {"first/finite": bool(m.finite), "first/mini_step": int(state.opt.mini_step)}
    before = digest(state)
    nan = tr.shard_batch(bs[1])
    if rank == 1:
        nan["image"] = nan["image"].copy()
        nan["image"][0, 3, 5, 0] = np.nan
    state, m = tr.train_step(state, nan)
    res.update({"nan/finite": bool(m.finite), "nan/mini_step": int(state.opt.mini_step),
                "nan/unchanged": digest(state) == before, "nan/step": state.step})
    for i in (2, 3):
        state, m = tr.train_step(state, tr.shard_batch(bs[i]))
        res[f"good{i}/finite"] = bool(m.finite)
    res.update({"final/mini_step": int(state.opt.mini_step),
                "final/gradient_step": int(state.opt.gradient_step), "final/digest": digest(state)})
    return res


def cli_case(world, rank, out):
    """(e): cli train spatially sharded: ff_redweb streaming (then resumed)
    and resident, and ff_smoke with each option."""
    from pldepth_torch import cli

    runs = os.path.join(out, "runs")
    written = []
    real_open = builtins.open

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+") and str(file).startswith(runs):
            written.append(str(file))
        return real_open(file, mode, *a, **kw)

    def train(argv):
        return cli.train(cli._parser().parse_args(argv + ["--output_dir", runs]))

    builtins.open = io.open = spy_open
    res = {}
    try:
        for name, extra in (("rw_stream", ["--epochs", "1"]),
                            ("rw_stream", ["--epochs", "2", "--resume", "true"]),
                            ("rw_resident", ["--epochs", "1", "--data_resident", "true"])):
            r = train(CLI_RW + ["--run_name", name] + extra)
            key = name + ("_resume" if "--resume" in extra else "")
            res[f"{key}/step"] = r["step"]
            res[f"{key}/loss"] = np.asarray(r["loss"], np.float64)
        base = [a if a != "ff_redweb" else "ff_smoke" for a in CLI_RW]
        for name, flags, config in CLI_SM:
            extra = []
            if config is not None:
                path = os.path.join(out, f"cfg_{name}.json")
                if rank == 0:
                    with real_open(path, "w") as f:
                        json.dump(config, f)
                mesh_lib.current().barrier()
                extra = ["--config_json", path]
            # grad_accum resumes in the middle of its cycle (3 micro-steps an epoch)
            for epochs, resume in (("1", "false"), ("2", "true"))[:2 if name == "accum" else 1]:
                r = train(base + flags + extra + ["--run_name", f"opt_{name}", "--epochs",
                                                  epochs, "--resume", resume])
                res[f"opt_{name}/step{epochs}"] = r["step"]
                res[f"opt_{name}/loss{epochs}"] = np.asarray(r["loss"], np.float64)
    finally:
        builtins.open = io.open = real_open
    res["written"] = np.asarray(sorted(set(written)))
    return res


def f64_group(world, names, resident=()):
    return [(n, (lambda n: lambda w, r, o: f64_case(n, w, r, n in resident))(n)) for n in names]


F64_NAMES = list(F64_CASES)
GROUPS = {
    "pair": [*f64_group(2, F64_NAMES, resident=("rw_plain",)), ("jrw", redweb_module_case),
             *[(n, options_jax_case(n)) for n in J_OPTIONS]],
    "clipair": [("cli", cli_case)],
    "quad": [*f64_group(4, F64_NAMES, resident=("rw_plain",)), ("accum_nan", accum_nan_case)],
    "solo": f64_group(1, F64_NAMES, resident=("rw_plain",)),
}
WORLDS = {"pair": 2, "clipair": 2, "quad": 4, "solo": 1}


def child(group: str, rank: int, world: int, rendezvous: str, out: str) -> None:
    if world > 1:
        mesh_lib.init_distributed(device="cpu", init_method=f"file://{rendezvous}",
                                  world_size=world, rank=rank, timeout_s=CHILD_TIMEOUT)
    for name, fn in GROUPS[group]:
        t0 = time.perf_counter()
        res = fn(world, rank, out)
        np.savez(os.path.join(out, f"{group}_{name}_r{rank}.npz"), **res)
        print(f"{group} rank {rank}: case {name} done ({time.perf_counter() - t0:.1f} s)",
              flush=True)
    mesh_lib.shutdown()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Start the groups: (their processes, their logs, the output directory)."""
    out = str(tmp_path_factory.mktemp("spatial_options"))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    procs, logs = [], []
    for group, world in WORLDS.items():
        for r in range(world):
            log = open(os.path.join(out, f"{group}{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-u", os.path.abspath(__file__), group, str(r), str(world),
                 os.path.join(out, f"rendezvous_{group}"), out],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=out))
    yield procs, logs, out
    for p in procs:
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module")
def ranks(children, jax_redweb, jax_options):
    """``load(group, name)``, which waits for the groups once and loads case
    ``name`` of every rank of ``group``. The JAX references are made first,
    while the children run."""
    procs, logs, out = children
    state = {}

    def load(group, name):
        if not state:
            for p in procs:
                try:
                    p.wait(timeout=CHILD_TIMEOUT)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
            for f in logs:
                f.close()
            state["rc"] = [p.returncode for p in procs]
        res = []
        for r in range(WORLDS[group]):
            path = os.path.join(out, f"{group}_{name}_r{r}.npz")
            if not os.path.exists(path):
                with open(os.path.join(out, f"{group}{r}.log")) as f:
                    pytest.fail(f"{group} rank {r} wrote no {name} results (rc {state['rc']}):\n"
                                f"{f.read()[-4000:]}")
            res.append(dict(np.load(path)))
        return res

    load.out = out
    return load


def _shard(heights, parts, q, lvl):
    return halo.RowShard(tuple(heights), parts, q, lvl)


# (a) -----------------------------------------------------------------------
@pytest.mark.parametrize("h,levels,m", SIZES)
def test_sharded_max_pool_equals_unsharded_forward_and_gradient(h, levels, m):
    """Inputs rounded to a grid after a ReLU, so windows tie and hold 0:
    the gradient goes to the same element of each window either way."""
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(3 * h + m)
    for lvl in range(levels):
        x = torch.from_numpy(np.maximum(np.round(rng.normal(size=(2, heights[lvl], 9, 3)) * 2),
                                        0)).requires_grad_()
        full = conv.max_pool3x3s2(x)
        assert full.shape[1] == heights[lvl + 1]
        g = torch.from_numpy(rng.normal(size=full.shape))
        want_grad, = torch.autograd.grad((full * g).sum(), x)
        total = 0
        for q in range(m):
            plan = conv.pool_row_plan(_shard(heights, parts, q, lvl))
            got = conv.max_pool_rows_local(halo.extend_from_full(x, plan, q), plan, q)
            s, e = parts[lvl + 1][q]
            assert got.shape == full[:, s:e].shape
            np.testing.assert_array_equal(got.detach().numpy(), full[:, s:e].detach().numpy())
            total = total + (got * g[:, s:e]).sum()
        got_grad, = torch.autograd.grad(total, x)
        np.testing.assert_allclose(got_grad.numpy(), want_grad.numpy(), rtol=1e-12, atol=1e-12)


def test_sharded_max_pool_pads_with_minus_inf_at_the_border():
    """Negative inputs: a zero pad would win every border window."""
    x = -1.0 - torch.rand(1, 8, 6, 2, dtype=torch.float64)
    heights = halo.level_heights(8, 3)
    parts = halo.row_partition(heights, 2)
    full = conv.max_pool3x3s2(x)
    assert (full < 0).all()
    for q in range(2):
        plan = conv.pool_row_plan(_shard(heights, parts, q, 0))
        s, e = parts[1][q]
        got = conv.max_pool_rows_local(halo.extend_from_full(x, plan, q), plan, q)
        np.testing.assert_array_equal(got.numpy(), full[:, s:e].numpy())


@pytest.mark.parametrize("h,levels,m", SIZES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_int8_rows_local_sums_equal_the_unsharded_conv(h, levels, m, k):
    """``quant_conv2d_rows_local``'s plain twin with unit scales and no bias
    returns the int32 sums, which must equal the unsharded conv's bit for
    bit, SAME and explicitly padded, stride 1 and 2."""
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(5 * h + 11 * k + m)
    cin, cout = 3, 5
    kq = torch.from_numpy(rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8))
    ones, zeros = torch.ones(cout), torch.zeros(cout)
    for lvl in range(levels + 1):
        q8 = torch.from_numpy(rng.integers(-127, 128, (2, heights[lvl], 9, cin)).astype(np.int8))
        for stride, padding in itertools.product((1, 2), (None, k // 2)):
            if stride == 2 and lvl == levels:
                continue
            full = quant_conv.quant_conv2d_plain(q8, kq, ones, zeros, 1.0, stride,
                                                 torch.float32, padding)
            assert full.shape[1] == heights[lvl + stride - 1]
            for q in range(m):
                plan = conv.conv_row_plan(_shard(heights, parts, q, lvl), k, stride, padding)
                got = quant_conv.quant_conv2d_rows_local(
                    halo.extend_from_full(q8, plan, q), kq, ones, zeros, 1.0, stride,
                    torch.float32, padding, plan, q)
                s, e = parts[lvl + stride - 1][q]
                assert got.shape == full[:, s:e].shape and got.dtype == torch.float32
                np.testing.assert_array_equal(got.numpy(), full[:, s:e].numpy(),
                                              err_msg=f"level {lvl} stride {stride} q {q}")


class _OtherPieces:
    """A model group in one process: ``model_sum`` adds the other ranks'
    sums, made beforehand."""

    def __init__(self, other):
        self.other = other

    def model_sum(self, x):
        return x + self.other


@pytest.mark.parametrize("m", [2, 3])
def test_int8_graph_squeeze_excite_gives_the_same_bits_from_row_pieces(m):
    """The int8 graph's squeeze-excite (``exact_mean``: float64 sums, one
    rounding) on each rank's rows, its row sums added over the model ranks,
    equals the whole image's rows bit for bit in f32, where a mean one bit
    apart would flip the int8 roundings downstream."""
    from pldepth_torch.models.efficientnet import SqueezeExcite
    from pldepth_torch.models.layers import reset_parameters

    se = reset_parameters(SqueezeExcite(16, 4, dtype=torch.float32, exact_mean=True),
                          torch.Generator().manual_seed(0))
    rng = np.random.default_rng(m)
    x = torch.from_numpy((rng.normal(size=(2, 37, 29, 16))
                          * 10.0 ** rng.integers(-3, 3, (1, 37, 29, 16))).astype(np.float32))
    parts = halo.row_partition((37,), m)[0]
    with torch.no_grad():
        whole = se(x)
        for q, (s, e) in enumerate(parts):
            other = sum(x[:, a:b].sum(dim=(1, 2), keepdim=True, dtype=torch.float64)
                        for r, (a, b) in enumerate(parts) if r != q)
            rows = halo.RowShard((37,), (parts,), q, 0, _OtherPieces(other))
            assert torch.equal(se(x[:, s:e], rows=rows), whole[:, s:e]), f"rank {q} of {m}"


def test_int8_rows_local_plain_is_its_kernels_twin_and_launches_nothing_when_empty():
    """An empty rank returns (B, 0, Wo, Cout) and counts no launch; the
    card's wrapper on a CPU tensor is its plain twin."""
    heights = halo.level_heights(64, 5)
    parts = halo.row_partition(heights, 4)
    plan = conv.conv_row_plan(_shard(heights, parts, 3, 1), 3, 2)
    kq = torch.ones(3, 3, 4, 6, dtype=torch.int8)
    k4.quant_matmul.launches = 0
    out = quant_conv.quant_conv2d_rows_local(torch.zeros(1, 0, 32, 4, dtype=torch.int8), kq,
                                             torch.ones(6), torch.zeros(6), 1.0, 2,
                                             torch.bfloat16, None, plan, 3)
    assert out.shape == (1, 0, 16, 6) and out.dtype == torch.bfloat16
    assert k4.quant_matmul.launches == 0


@pytest.mark.parametrize("h,levels,m", SIZES)
@pytest.mark.parametrize("window", [1, 3])
def test_sparse_owner_sum_taps_equal_unsharded(h, levels, m, window):
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(13 * h + m + window)
    checked = 0
    for lvl in range(1, levels + 1):
        if heights[lvl - 1] != 2 * heights[lvl]:
            continue
        x = torch.from_numpy(rng.normal(size=(2, heights[lvl], 5, 3)))
        hf, wf = heights[lvl - 1], 10
        pix = np.stack([rng.integers(-3, hf + 3, (2, 40)), rng.integers(-3, wf + 3, (2, 40))], -1)
        pix[0, :4, 0] = (0, hf - 1, -7, hf + 9)  # both borders, far outside
        pixels = torch.from_numpy(pix)
        want = sparse_tail.sparse_upsample2x_taps(x, pixels, window)
        total = torch.zeros_like(want)
        owners = torch.zeros(pixels.shape[:2], dtype=torch.int64)
        for q in range(m):
            plan = resize.upsample_row_plan(_shard(heights, parts, q, lvl))
            taps, owned = sparse_tail.sparse_taps_rows_local(
                halo.extend_from_full(x, plan, q), pixels, window, plan, q, parts[lvl - 1][q])
            assert taps.shape == want.shape
            assert (taps[~owned] == 0).all()
            np.testing.assert_allclose(taps[owned].numpy(), want[owned].numpy(), rtol=1e-12,
                                       atol=1e-12)
            total += taps
            owners += owned.long()
        assert (owners == 1).all()
        np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
        checked += 1
    assert checked


# (b) -----------------------------------------------------------------------
def _losses(r, keys):
    return [float(r[k]) for k in keys]


@pytest.mark.parametrize("group", ["pair", "quad"])
@pytest.mark.parametrize("name", F64_NAMES)
def test_float64_sharded_option_step_matches_single_process(ranks, group, name):
    want = ranks("solo", name)[0]
    res = ranks(group, name)
    keys = [k for k in want if k.startswith(("loss", "rloss"))]
    assert len(keys) >= 2
    for r in res:
        assert all(bool(r[k]) for k in r if k.startswith("finite"))
        np.testing.assert_allclose(_losses(r, keys), _losses(want, keys), rtol=1e-9)
        if "mini_step" in want:
            assert int(r["mini_step"]) == int(want["mini_step"])
    assert_close_1e9(res[0], want)
    assert_ranks_equal(res)


@pytest.mark.parametrize("group,rows", [("pair", [32, 32]), ("quad", [32, 32, 0, 0])])
def test_float64_redweb_resident_store_holds_each_ranks_rows(ranks, group, rows):
    assert [int(r["store_rows"]) for r in ranks(group, "rw_plain")] == rows


# (c) -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_redweb():
    """The JAX reduced-depth ff_redweb (tests/test_torch_redweb.py's
    ``JSmall``) on 2 virtual devices, the image rows sharded over the model
    axis, from the port's seeded weights: the inference and train forwards
    and the loss in f32, the gradients in float64."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from test_torch_redweb import JSmall, _bn64, _flat

    from pldepth_tpu.models import decoders as j_decoders
    from pldepth_tpu.models import resnet as j_resnet
    from pldepth_tpu.ops.listmle import pl_ranking_loss as j_pl_ranking_loss

    flat = flax_from_state_dict(small_redweb_module().state_dict())
    tree = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    params, stats = tree["params"], tree["batch_stats"]
    x, rankings = redweb_inputs()
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    rows = NamedSharding(mesh, P(None, "model", None, None))
    repl = NamedSharding(mesh, P())
    jm = JSmall()
    with jax.default_matmul_precision("highest"):
        infer = jax.jit(lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x, False),
                        in_shardings=(repl, repl, rows))(params, stats, jnp.asarray(x))

        def train_loss(p, s, x):
            pred, upd = jm.apply({"params": p, "batch_stats": s}, x, True,
                                 mutable=["batch_stats"])
            return j_pl_ranking_loss(pred[..., 0], jnp.asarray(rankings), impl="xla"), (pred, upd)

        loss, (pred, upd) = jax.jit(train_loss, in_shardings=(repl, repl, rows))(
            params, stats, jnp.asarray(x))
    f64 = lambda t: jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), t)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_resnet, "_bn", _bn64(1.001e-5))
        mp.setattr(j_decoders, "_bn", _bn64(1e-3))
        jm64 = JSmall(dtype=jnp.float64)

        def loss64(p):
            out, _ = jm64.apply({"params": p, "batch_stats": f64(stats)},
                                jnp.asarray(x, jnp.float64), True, mutable=["batch_stats"])
            return j_pl_ranking_loss(out[..., 0], jnp.asarray(rankings), impl="xla")

        grads = jax.jit(jax.grad(loss64), in_shardings=(repl,))(f64(params))
        grads = _flat({"params": jax.tree.map(np.asarray, grads)})
    return {"infer": np.asarray(infer), "train": np.asarray(pred), "loss": float(loss),
            "stats": _flat({"batch_stats": jax.device_get(upd["batch_stats"])}),
            "grads": grads}


def test_redweb_sharded_forward_and_loss_match_jax_spatial(ranks, jax_redweb):
    from test_torch_redweb import _rel

    res = ranks("pair", "jrw")
    assert res[0]["infer"].shape == (RW_B, S, S, 1)
    assert _rel(res[0]["infer"], jax_redweb["infer"]) < 1e-5
    assert _rel(res[0]["train"], jax_redweb["train"]) < 1e-4
    for r in res:
        assert abs(float(r["loss"]) / jax_redweb["loss"] - 1) < 1e-5
    got = {k[len("stats/"):]: v for k, v in res[0].items() if k.startswith("stats/")}
    assert set(got) == set(jax_redweb["stats"])
    for k, v in got.items():
        assert _rel(v, jax_redweb["stats"][k]) < 1e-4, k


def test_redweb_sharded_gradients_match_the_jax_graph_in_float64(ranks, jax_redweb):
    from test_torch_redweb import _zero_by_construction

    res = ranks("pair", "jrw")[0]
    grads = {k[len("grad/"):]: v for k, v in res.items() if k.startswith("grad/")}
    want = jax_redweb["grads"]
    assert set(grads) == set(want)
    gmax = max(np.abs(g).max() for g in want.values())
    fro = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    live = [k for k in grads if not _zero_by_construction(k)]
    assert len(live) == 182
    for key in grads:
        if _zero_by_construction(key):
            for g in (grads[key], want[key]):
                assert np.abs(g).max() <= 1e-5 * gmax, key
        else:
            assert fro(grads[key], want[key]) <= 1e-2, key
    assert fro(np.concatenate([grads[k].ravel() for k in live]),
               np.concatenate([want[k].ravel() for k in live])) <= 2e-3


@pytest.fixture(scope="module")
def jax_options(tmp_path_factory):
    """The JAX package's spatial step of each of ``J_OPTIONS`` at data 1 x
    model 2 on virtual devices, from the port's seeded initial weights."""
    import jax

    from pldepth_torch.train.checkpoint import save_weights_npz
    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer
    from pldepth_tpu.train.checkpoint import load_weights_npz
    from test_torch_train_options import _jflat

    path = str(tmp_path_factory.mktemp("bridge") / "init.npz")
    init = Trainer(ExperimentConfig(**STEP_CFG), device="cpu").init_state()
    save_weights_npz(path, init)
    out = {"init": flax_from_state_dict(init.model.state_dict())}
    mcfg = JMeshConfig(data=1, model=2)
    for name, opt in J_OPTIONS.items():
        jtr = JTrainer(JConfig(**STEP_CFG, **opt, mesh=mcfg, spatial_sharding=True),
                       steps_per_epoch=3, mesh=make_mesh(mcfg, devices=jax.devices()[:2]))
        state = jtr.replicate(load_weights_npz(path, jtr.init_state()))
        b = options_fixed_batch(out_of_range=bool(opt.get("sparse_tail")))
        if opt.get("qenc"):
            jtr.prepare_qenc(state, b["image"])
        state, m = jtr.train_step_fixed(state, jtr.shard_batch(b))
        assert bool(m.finite)
        out[name] = {"loss": float(m.loss), "flat": _jflat(state)}
    return out


def test_qenc_int8_sharded_step_matches_jax_spatial(ranks, jax_options):
    from test_torch_train_options import _zero_gradient_bias

    want = jax_options["jqenc"]
    res = ranks("pair", "jqenc")
    for r in res:
        assert bool(r["finite"]) and float(r["loss"]) == pytest.approx(want["loss"], rel=1e-5)
    assert_ranks_equal(res)
    flat = {k[len("flax/"):]: v for k, v in res[0].items() if k.startswith("flax/")}
    init = jax_options["init"]
    assert set(flat) == set(want["flat"])
    moved = 0
    for k, v in want["flat"].items():
        if _zero_gradient_bias(k):
            assert np.abs(flat[k]).max() <= 1e-3 and np.abs(v).max() <= 1e-3, k
        else:
            np.testing.assert_allclose(flat[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
        if k.startswith(("params/encoder", "batch_stats/encoder")):
            np.testing.assert_array_equal(flat[k], init[k], err_msg=k)
        moved += not np.array_equal(flat[k], init[k])
    assert moved > 0


def test_sparse_tail_sharded_step_with_outside_pixels_matches_jax_spatial(ranks, jax_options):
    want = jax_options["jsparse"]
    res = ranks("pair", "jsparse")
    for r in res:
        assert bool(r["finite"]) and float(r["loss"]) == pytest.approx(want["loss"], rel=1e-6)
    assert_ranks_equal(res)
    flat = {k[len("flax/"):]: v for k, v in res[0].items() if k.startswith("flax/")}
    assert set(flat) == set(want["flat"])
    for k, v in want["flat"].items():
        np.testing.assert_allclose(flat[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


# (d) -----------------------------------------------------------------------
def test_nan_in_one_ranks_rows_refuses_the_micro_step_on_every_rank(ranks):
    res = ranks("quad", "accum_nan")
    for r in res:
        assert r["first/finite"] and int(r["first/mini_step"]) == 1
        assert not r["nan/finite"] and r["nan/unchanged"] and int(r["nan/mini_step"]) == 1
        assert int(r["nan/step"]) == 2
        assert r["good2/finite"] and r["good3/finite"]
        assert int(r["final/mini_step"]) == 1 and int(r["final/gradient_step"]) == 1
    assert_ranks_equal(res, "final/")


# (e) -----------------------------------------------------------------------
def test_cli_train_redweb_and_options_spatial_write_on_rank_0_only_and_resume(ranks):
    res = ranks("clipair", "cli")
    assert len(res[1]["written"]) == 0, res[1]["written"]
    written = {os.path.relpath(p, os.path.join(ranks.out, "runs")) for p in res[0]["written"]}
    runs = ["rw_stream", "rw_resident"] + [f"opt_{n}" for n, _, _ in CLI_SM]
    for run in runs:
        assert {f"{run}/metrics.jsonl", f"{run}/config.json", f"{run}/weights.npz"} <= written
    # 6 training samples (a 1/15 validation cut of 6 is empty), batch 2: 3 steps an epoch
    assert [int(r["rw_stream/step"]) for r in res] == [3, 3]
    assert [int(r["rw_stream_resume/step"]) for r in res] == [6, 6]
    assert [int(r["rw_resident/step"]) for r in res] == [3, 3]
    for name, _, _ in CLI_SM:
        assert [int(r[f"opt_{name}/step1"]) for r in res] == [3, 3]
    assert [int(r["opt_accum/step2"]) for r in res] == [6, 6]
    keys = [k for k in res[0] if "/loss" in k]
    assert len(keys) == 3 + len(CLI_SM) + 1
    for key in keys:
        np.testing.assert_array_equal(res[0][key], res[1][key])
        assert np.isfinite(res[0][key]).all(), key


if __name__ == "__main__":
    try:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
