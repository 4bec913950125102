"""Spatial sharding (the mesh's model axis) on the CPU.

(a) In one process: the nested row partition, the halo plans and the local
    ops of the sharded conv (k 1, 3, 5, 7; stride 1 and 2; SAME and
    explicit padding), the 2x upsample and the fused tail, each rank's rows
    cut from the whole tensor, equal the unsharded op to float64 rounding
    (1e-12), at sizes with uneven and empty ranges; the halo transport's
    pure parts (the edges, their assembly, the adjoint of the backward)
    against the whole tensor.

The rest runs in two groups of child processes, this file run as a script:
a pair (world 2) and a quad (world 4), each joined through a ``file://``
rendezvous under the test's temporary directory and each child with a
timeout. Every rank of a group runs the same cases in order (a collective
mismatch would hang) and writes ``.npz`` results:

(b) ff_smoke 64^2 f32 ``train_step_fixed`` at data 1 x model 2 (pair) and
    data 1 x model 4 (quad: ranks 2 and 3 own no rows at any level)
    against the JAX package's spatial step on 2 and 4 virtual devices, from
    the same bridged weights: loss rel 1e-6, params and BN statistics
    1e-5 after 1 and 3 steps (tests/test_spatial.py holds the JAX step to
    its single-device step at 2e-4 / 5e-3);
(c) in float64, ff_effnet 64^2 ``train_step`` (flip and drop-path on) and
    ``resident_step`` (a store of each rank's rows of its data index's
    samples) at data 2 x model 2, and ff_smoke 64^2 at data 1 x model 4
    (ranks 2 and 3 own no rows), against the port's single-process step:
    loss, params and BN statistics to 1e-9 relative;
(d) replication (model 2, flag off, float64) equals data parallelism at
    data 2 (the pair) to 1e-9;
(e) ``eval_step`` at data 2 x model 2 against the single process; an
    out-of-map ranking index gives a NaN loss and refuses the step (F4);
    a NaN in one rank's rows refuses the step on every rank; the ranks'
    states are bit-equal after every case;
(f) ``cli train --mesh_model 2 --spatial_sharding true`` on the streaming
    and the resident feed writes on rank 0 only, and ``--resume``
    continues; ``cli warmup`` runs the sharded step and resident step;
(g) ff_redweb and each option under spatial sharding (once refused,
    ROADMAP items 11.1-11.6, now run: tests/test_torch_spatial_options.py)
    build their Trainer and its rows; a model axis of 1 makes the flag a
    no-op; an input size that does not split raises from ``shard_batch``
    as in JAX.

    python tests/test_torch_spatial.py GROUP RANK WORLD RENDEZVOUS_FILE OUT_DIR
"""

import builtins
import hashlib
import io
import itertools
import os
import subprocess
import sys
import traceback

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from pldepth_torch.core import mesh as mesh_lib  # noqa: E402
from pldepth_torch.core.config import ExperimentConfig, MeshConfig  # noqa: E402
from pldepth_torch.data.datasets import DepthDataset  # noqa: E402
from pldepth_torch.data.resident import build_resident_store  # noqa: E402
from pldepth_torch.models.pretrained import flax_from_state_dict  # noqa: E402
from pldepth_torch.ops import conv, fused_tail, halo, resize  # noqa: E402
from pldepth_torch.train import Trainer  # noqa: E402
from pldepth_torch.train.trainer import trainable_params  # noqa: E402

torch.set_num_threads(1)
S = 64
FIXED = dict(model_name="ff_smoke", input_size=S, batch_size=2, ranking_size=5,
             rankings_per_image=16, compute_dtype="float32", freeze_encoder=True,
             augmentation=False, initial_lr=0.01, adam_eps=1e-2, epochs=1)
F64 = dict(model_name="ff_effnet", input_size=S, batch_size=4, ranking_size=3,
           rankings_per_image=8, sampling_type=1, compute_dtype="float64",
           freeze_encoder=True, augmentation=True, initial_lr=0.01, adam_eps=1e-2, epochs=1)
REPL = {**F64, "model_name": "ff_smoke", "freeze_encoder": False}
STORE_N = 9  # cut to 8 by two data shards
CLI = ["train", "--device", "cpu", "--model_name", "ff_smoke", "--dataset", "synthetic",
       "--input_size", str(S), "--ds_size", "24", "--batch_size", "2", "--ranking_size", "3",
       "--rankings_per_image", "8", "--compute_dtype", "float32", "--mesh_model", "2",
       "--spatial_sharding", "true"]
CHILD_TIMEOUT = 240


# ---------------------------------------------------------------------------
# inputs, the same in the children and the parent
# ---------------------------------------------------------------------------
def fixed_batches(n, seed=0, rows=2, size=S):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, size * size, (rows, 16, 5))
        depths = np.sort(rng.uniform(0.1, 1.0, (rows, 16, 5)), axis=-1)[..., ::-1]
        out.append({"image": rng.uniform(size=(rows, size, size, 3)).astype(np.float32),
                    "rankings": np.stack([idx, depths], -1).astype(np.float32)})
    return out


def sampled_batches(n, seed=1, rows=4):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(size=(rows, S, S, 3)).astype(np.float32),
             "gt": rng.uniform(0.05, 1.0, (rows, S, S)).astype(np.float32),
             "mask": (rng.uniform(size=(rows, S, S)) < 0.9).astype(np.float32)}
            for _ in range(n)]


def store_sample(i):
    rng = np.random.default_rng(90 + i)
    return {"image": rng.uniform(size=(S, S, 3)).astype(np.float32),
            "gt": rng.uniform(0.05, 1.0, (S, S)).astype(np.float32),
            "mask": (rng.uniform(size=(S, S)) < 0.9).astype(np.float32)}


def to_float64(tr, state):
    """The state's module in float64 and a fresh float64 optimizer state."""
    state.model.double()
    return state.replace(opt=tr.optimizer.init(trainable_params(state.model)))


def digest(state) -> str:
    """sha256 of the bits of every tensor of a state (weights, BN
    statistics, optimizer state)."""
    h = hashlib.sha256()
    for t in [*state.model.state_dict().values(), *state.opt.state_dict().values()]:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def state_arrays(state, prefix="", rank=0):
    """The state's digest and, on rank 0 only (the ranks' digests are held
    equal), what a step changes: the trainable weights, the BN statistics
    and the optimizer's count."""
    out = {f"{prefix}digest": digest(state)}
    if rank == 0:
        frozen = {n for n, p in state.model.named_parameters() if not p.requires_grad}
        out.update({f"{prefix}model/{k}": np.array(v.detach().cpu())
                    for k, v in state.model.state_dict().items() if k not in frozen})
        out[f"{prefix}opt/count"] = np.array(state.opt.count.cpu())
    return out


def resident_idx(seed, step, index, n_local, b):
    from pldepth_torch.core.rng import generator

    tag = "train/resident" + (f"/{index}" if index else "")
    return torch.randint(0, n_local, (b,), generator=generator(seed, tag, step, "cpu"))


# ---------------------------------------------------------------------------
# the children's cases
# ---------------------------------------------------------------------------
def case_fixed(world, rank, out):
    """(b): the fixed-rankings step at data 1 x model ``world``."""
    tr = Trainer(ExperimentConfig(**FIXED, mesh=MeshConfig(data=1, model=world),
                                  spatial_sharding=True), steps_per_epoch=3, device="cpu")
    state = tr.init_state()
    res = {}
    for i, b in enumerate(fixed_batches(3)):
        state, m = tr.train_step_fixed(state, tr.shard_batch(b))
        res[f"loss{i}"] = float(m.loss)
        res[f"finite{i}"] = bool(m.finite)
        if i in (0, 2) and rank == 0:
            res.update({f"after{i + 1}/flax/{k}": np.array(v) for k, v in
                        flax_from_state_dict(state.model.state_dict()).items()})
    res.update(state_arrays(state, rank=rank))
    return res


def case_dp(world, rank, out):
    """(d)'s reference: data parallelism at data 2 in float64."""
    tr = Trainer(ExperimentConfig(**{**REPL, "batch_size": 2}), steps_per_epoch=2, device="cpu")
    state = to_float64(tr, tr.init_state())
    res = {}
    for i, b in enumerate(sampled_batches(2)):
        state, m = tr.train_step(state, tr.shard_batch(b))
        res[f"loss{i}"] = float(m.loss)
    res.update(state_arrays(state, rank=rank))
    return res


def case_f64(world, rank, out):
    """(c): data 2 x model 2 spatial, float64: two ``train_step`` (host
    batches cut to the rank's rows), then two ``resident_step`` on the same
    state from a store of the rank's rows of its data index's samples."""
    cfg = ExperimentConfig(**{**F64, "mesh": MeshConfig(data=2, model=2),
                              "spatial_sharding": True})
    tr = Trainer(cfg, steps_per_epoch=4, device="cpu")
    state = to_float64(tr, tr.init_state())
    res = {"rows": np.asarray(tr.input_rows())}
    for i, b in enumerate(sampled_batches(2)):
        state, m = tr.train_step(state, tr.shard_batch(b))
        res[f"loss{i}"] = float(m.loss)
    store = build_resident_store(DepthDataset("np", STORE_N, store_sample), "cpu",
                                 shard_index=tr.mesh.data_index, num_shards=2,
                                 rows=tr.input_rows())
    res.update({"store/n": store.n, "store/scale": store.gt_scale,
                **{f"store/{k}": v.numpy() for k, v in store.arrays.items()}})
    for i in range(2):
        res[f"idx{i}"] = resident_idx(cfg.seed, state.step, tr.mesh.data_index,
                                      store.arrays["image"].shape[0], 2).numpy()
        state, m = tr.resident_step(state, store.arrays)
        res[f"rloss{i}"] = float(m.loss)
    res.update(state_arrays(state, rank=rank))
    return res


def case_single_f64(world, rank, out):
    """(c)'s reference: ``case_f64``'s steps in one process on the global
    batches, the resident ones on the whole store with the samples each
    data index draws (data index d's local sample j is global sample
    d + 2 j)."""
    tr = Trainer(ExperimentConfig(**F64), steps_per_epoch=4, device="cpu")
    state = to_float64(tr, tr.init_state())
    res = {}
    for i, b in enumerate(sampled_batches(2)):
        state, m = tr.train_step(state, b)
        res[f"loss{i}"] = float(m.loss)
    full = build_resident_store(DepthDataset("np", 8, store_sample), "cpu")
    for i in range(2):
        idx = [resident_idx(tr.cfg.seed, state.step, d, 4, 2) for d in range(2)]
        res[f"idx{i}"] = torch.stack(idx).numpy()
        state, m = tr.resident_step(state, full.arrays,
                                    torch.cat([d + 2 * ix for d, ix in enumerate(idx)]))
        res[f"rloss{i}"] = float(m.loss)
    res.update(state_arrays(state))
    return res


def m4_steps(tr, state, shard, store, index_of):
    """Two ``train_step`` then two ``resident_step`` of ``case_m4``; the
    resident rows come from ``index_of(step)`` (None: the trainer draws)."""
    res = {}
    for i, b in enumerate(sampled_batches(2, seed=5)):
        state, m = tr.train_step(state, shard(b))
        res[f"loss{i}"] = float(m.loss)
    for i in range(2):
        res[f"idx{i}"] = resident_idx(tr.cfg.seed, state.step, 0, STORE_N, 4).numpy()
        state, m = tr.resident_step(state, store.arrays, index_of(state.step))
        res[f"rloss{i}"] = float(m.loss)
    return state, res


def case_m4(world, rank, out):
    """(c) at data 1 x model 4, float64: ff_smoke at 64^2 leaves ranks 2
    and 3 no rows at any level (and no rows of the resident store)."""
    cfg = ExperimentConfig(**{**REPL, "mesh": MeshConfig(data=1, model=4),
                              "spatial_sharding": True})
    tr = Trainer(cfg, steps_per_epoch=4, device="cpu")
    store = build_resident_store(DepthDataset("np", STORE_N, store_sample), "cpu",
                                 rows=tr.input_rows())
    state, res = m4_steps(tr, to_float64(tr, tr.init_state()), tr.shard_batch, store,
                          lambda step: None)
    res.update({"rows": np.asarray(tr.input_rows()), "store_rows": store.arrays["image"].shape[1],
                **state_arrays(state, rank=rank)})
    return res


def case_single_m4(world, rank, out):
    """``case_m4``'s steps in one process, the resident ones on the same
    draws."""
    tr = Trainer(ExperimentConfig(**REPL), steps_per_epoch=4, device="cpu")
    store = build_resident_store(DepthDataset("np", STORE_N, store_sample), "cpu")
    state, res = m4_steps(tr, to_float64(tr, tr.init_state()), lambda b: b, store,
                          lambda step: resident_idx(tr.cfg.seed, step, 0, STORE_N, 4))
    res.update(state_arrays(state))
    return res


def case_repl(world, rank, out):
    """(d): data 2 x model 2 with the flag off (replication), float64."""
    tr = Trainer(ExperimentConfig(**{**REPL, "batch_size": 2, "mesh": MeshConfig(data=2, model=2)}),
                 steps_per_epoch=2, device="cpu")
    state = to_float64(tr, tr.init_state())
    res = {}
    for i, b in enumerate(sampled_batches(2)):
        state, m = tr.train_step(state, tr.shard_batch(b))
        res[f"loss{i}"] = float(m.loss)
    res.update(state_arrays(state, rank=rank))
    return res


def case_misc(world, rank, out):
    """(e): eval_step, F4, a NaN in one rank's rows, at data 2 x model 2."""
    cfg = ExperimentConfig(**{**FIXED, "mesh": MeshConfig(data=2, model=2),
                              "spatial_sharding": True})
    tr = Trainer(cfg, steps_per_epoch=3, device="cpu")
    state = tr.init_state()
    b = fixed_batches(1, seed=7, rows=4)[0]
    res = {"eval_loss": float(tr.eval_step(state, tr.shard_batch(b)))}
    # F4: data index 1's lists read a pixel past the map
    bad = fixed_batches(1, seed=8, rows=4)[0]
    bad["rankings"][3, 2, 1, 0] = S * S + 5
    before = digest(state)
    state, m = tr.train_step_fixed(state, tr.shard_batch(bad))
    res["f4/loss"] = float(m.loss)
    res["f4/finite"] = bool(m.finite)
    res["f4/unchanged"] = digest(state) == before
    # a NaN pixel in rank 3's rows alone
    nan = tr.shard_batch(fixed_batches(1, seed=9, rows=4)[0])
    if rank == 3:
        nan["image"] = nan["image"].copy()
        nan["image"][0, 2, 4, 1] = np.nan
    before = digest(state)
    state, m = tr.train_step_fixed(state, nan)
    res["nan/finite"] = bool(m.finite)
    res["nan/step"] = state.step
    res["nan/unchanged"] = digest(state) == before
    # a good step after both refusals
    state, m = tr.train_step_fixed(state, tr.shard_batch(b))
    res["good/finite"] = bool(m.finite)
    res["final/digest"] = digest(state)
    return res


def case_cli(world, rank, out):
    """(f): cli train spatially sharded, streaming (then resumed) and resident."""
    from pldepth_torch import cli

    runs = os.path.join(out, "runs")
    written = []
    real_open = builtins.open

    def spy_open(file, mode="r", *a, **kw):
        if any(c in mode for c in "wax+") and str(file).startswith(runs):
            written.append(str(file))
        return real_open(file, mode, *a, **kw)

    builtins.open = io.open = spy_open
    try:
        res = {}
        for name, extra in (("stream", ["--epochs", "1"]),
                            ("stream", ["--epochs", "2", "--resume", "true"]),
                            ("resident", ["--epochs", "1", "--data_resident", "true",
                                          "--resident_chain_steps", "2"])):
            r = cli.train(cli._parser().parse_args(
                CLI + ["--output_dir", runs, "--run_name", name] + extra))
            key = name + ("_resume" if "--resume" in extra else "")
            res[f"{key}/step"] = r["step"]
            res[f"{key}/loss"] = np.asarray(r["loss"], np.float64)
    finally:
        builtins.open = io.open = real_open
    res["written"] = np.asarray(sorted(set(written)))
    warm = cli.warmup(cli._parser().parse_args(
        ["warmup", "--device", "cpu", "--model_name", "ff_smoke", "--input_size", str(S),
         "--batch_size", "2", "--compute_dtype", "float32", "--mesh_model", "2",
         "--spatial_sharding", "true", "--data_resident", "true"]))
    res["warmup_collectives"] = warm["collectives"]
    res["warmup_steps"] = [warm["train_step_s"] > 0, warm["resident_s"] > 0]
    return res


# "solo" is one process with no group: the single-process references
GROUPS = {"quad": [("f64", case_f64), ("fixed", case_fixed), ("m4", case_m4),
                   ("repl", case_repl), ("misc", case_misc)],
          "pair": [("fixed", case_fixed), ("dp", case_dp), ("cli", case_cli)],
          "solo": [("f64", case_single_f64), ("m4", case_single_m4)]}
WORLDS = {"quad": 4, "pair": 2, "solo": 1}


def child(group: str, rank: int, world: int, rendezvous: str, out: str) -> None:
    if world > 1:
        mesh_lib.init_distributed(device="cpu", init_method=f"file://{rendezvous}",
                                  world_size=world, rank=rank, timeout_s=CHILD_TIMEOUT)
    for name, fn in GROUPS[group]:
        res = fn(world, rank, out)
        np.savez(os.path.join(out, f"{group}_{name}_r{rank}.npz"), **res)
        print(f"{group} rank {rank}: case {name} done", flush=True)
    mesh_lib.shutdown()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start both groups; hand back ``load(group, name)``, which waits for
    the groups once and loads case ``name`` of every rank of ``group``."""
    out = str(tmp_path_factory.mktemp("spatial"))
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
    yield load
    for p in procs:
        if p.poll() is None:
            p.kill()


def assert_ranks_equal(res, prefix=""):
    """Every rank's state bit-equal to rank 0's."""
    assert len({str(r[prefix + "digest"]) for r in res}) == 1


def assert_close_1e9(got, want, prefix=""):
    """Every float tensor of ``want``'s state under ``prefix`` (as
    :func:`state_arrays` keeps it) at rtol 1e-9, atol 1e-12 (a bias whose
    true gradient is 0, one a batch-statistics BN follows, holds AMSGrad's
    step of float64 noise, ~1e-16), the optimizer's count equal."""
    keys = [k for k in want if k.startswith((prefix + "model/", prefix + "opt/"))]
    assert keys
    for k in keys:
        v = want[k]
        if not np.issubdtype(v.dtype, np.floating):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
            continue
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-12, err_msg=k)


# (a) -----------------------------------------------------------------------
SIZES = [(64, 5, 4), (64, 5, 2), (112, 3, 4), (40, 3, 2), (26, 1, 4), (48, 4, 3), (96, 5, 3),
         (8, 2, 3)]


def _shard(heights, parts, q, lvl):
    return halo.RowShard(tuple(heights), parts, q, lvl)


def test_row_partition_is_nested_and_covers_each_level():
    for h, levels, m in SIZES:
        heights = halo.level_heights(h, levels)
        parts = halo.row_partition(heights, m)
        for lvl, hl in enumerate(heights):
            spans = parts[lvl]
            assert spans[0][0] == 0 and spans[-1][1] == hl
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            if lvl < levels:  # a stride-2 step maps [a, b) to [ceil(a/2), ceil(b/2))
                assert parts[lvl + 1] == tuple((-(-a // 2), -(-b // 2)) for a, b in spans)
    # B0 at 448^2 over 4 (4/4/4/2 deepest rows) and
    # ff_smoke at 64^2 over 4 (ranks 2 and 3 own nothing)
    assert halo.row_partition(halo.level_heights(448, 5), 4)[5] == ((0, 4), (4, 8), (8, 12),
                                                                      (12, 14))
    assert halo.row_partition(halo.level_heights(64, 5), 4)[0] == ((0, 32), (32, 64), (64, 64),
                                                                     (64, 64))


@pytest.mark.parametrize("h,levels,m", SIZES)
@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_sharded_conv_equals_unsharded(h, levels, m, k):
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(h * k + m)
    for lvl in range(levels + 1):
        x = torch.from_numpy(rng.normal(size=(2, heights[lvl], 9, 3)))
        w = torch.from_numpy(rng.normal(size=(4, 3, k, k)))
        for stride, padding in itertools.product((1, 2), (None, k // 2)):
            if stride == 2 and lvl == levels:
                continue
            full = conv.conv2d_same_nhwc(x, w, stride, padding=padding)
            assert full.shape[1] == heights[lvl + stride - 1]
            for q in range(m):
                plan = conv.conv_row_plan(_shard(heights, parts, q, lvl), k, stride, padding)
                got = conv.conv2d_rows_local(halo.extend_from_full(x, plan, q), w, stride, 1,
                                             padding, plan, q)
                s, e = parts[lvl + stride - 1][q]
                assert got.shape == full[:, s:e].shape
                np.testing.assert_allclose(got.numpy(), full[:, s:e].numpy(), rtol=1e-12,
                                           atol=1e-12, err_msg=f"level {lvl} stride {stride}")


@pytest.mark.parametrize("h,levels,m", SIZES)
def test_sharded_upsample_and_fused_tail_equal_unsharded(h, levels, m):
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(h + m)
    checked = 0
    for lvl in range(1, levels + 1):
        if heights[lvl - 1] != 2 * heights[lvl]:
            continue
        x = torch.from_numpy(rng.normal(size=(2, heights[lvl], 7, 3)))
        w = torch.from_numpy(rng.normal(size=(2, 3, 3, 3)))
        b = torch.from_numpy(rng.normal(size=(2,)))
        up = resize.upsample2x_bilinear(x)
        tail = fused_tail.fused_upsample2x_conv(x, w, b)
        for q in range(m):
            plan = resize.upsample_row_plan(_shard(heights, parts, q, lvl))
            ext = halo.extend_from_full(x, plan, q)
            s, e = parts[lvl - 1][q]
            for got, want in ((resize.upsample2x_rows_local(ext, plan, q), up[:, s:e]),
                              (fused_tail.fused_tail_rows_local(ext, w, b, plan, q),
                               tail[:, s:e])):
                assert got.shape == want.shape
                np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12, atol=1e-12)
            checked += 1
    assert checked


@pytest.mark.parametrize("h,levels,m", SIZES)
def test_halo_transport_assembles_and_its_backward_is_the_adjoint(h, levels, m):
    """The exchange's pure parts: each rank's rows assembled from every
    rank's edges equal the rows cut from the whole tensor, and the backward
    (halo cotangents added into their owners' rows) is the adjoint of that
    map: <extend(x), g> = <x, extend^T(g)> summed over the ranks."""
    heights = halo.level_heights(h, levels)
    parts = halo.row_partition(heights, m)
    rng = np.random.default_rng(7 * h + m)
    for lvl, k, stride in itertools.product(range(levels), (3, 5, 7), (1, 2)):
        plan = conv.conv_row_plan(_shard(heights, parts, 0, lvl), k, stride)
        x = torch.from_numpy(rng.normal(size=(2, heights[lvl], 5, 2)))
        own = [x[:, s:e] for s, e in parts[lvl]]
        stacks = torch.stack([halo.edges(o, plan.h) for o in own])
        exts = [halo.assemble(own[q], stacks, plan, q) for q in range(m)]
        for q in range(m):
            np.testing.assert_array_equal(exts[q].numpy(),
                                          halo.extend_from_full(x, plan, q).numpy())
        gs = [torch.from_numpy(rng.normal(size=e.shape)) for e in exts]
        cot = torch.stack([halo.halo_cotangents(g, plan, q) for q, g in enumerate(gs)])
        back = [halo.own_cotangent(gs[q], cot, plan, q, own[q].shape[1]) for q in range(m)]
        lhs = sum(float((e * g).sum()) for e, g in zip(exts, gs))
        rhs = sum(float((o * g).sum()) for o, g in zip(own, back))
        assert abs(lhs - rhs) <= 1e-12 * max(1.0, abs(lhs))


# (b) -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_spatial(tmp_path_factory):
    """The JAX package's fixed-rankings spatial step at data 1 x model 2 and
    x model 4 on virtual devices, from the port's seeded initial weights."""
    import jax

    from pldepth_torch.train.checkpoint import save_weights_npz
    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer
    from pldepth_tpu.train.checkpoint import load_weights_npz

    path = str(tmp_path_factory.mktemp("bridge") / "init.npz")
    save_weights_npz(path, Trainer(ExperimentConfig(**FIXED), device="cpu").init_state())
    out = {}
    for m in (2, 4):
        mcfg = JMeshConfig(data=1, model=m)
        jtr = JTrainer(JConfig(**FIXED, mesh=mcfg, spatial_sharding=True), steps_per_epoch=3,
                       mesh=make_mesh(mcfg, devices=jax.devices()[:m]))
        state = jtr.replicate(load_weights_npz(path, jtr.init_state()))
        res = {"losses": [], "after": {}}
        for i, b in enumerate(fixed_batches(3)):
            state, metrics = jtr.train_step_fixed(state, jtr.shard_batch(b))
            res["losses"].append(float(metrics.loss))
            tree = {"params": jax.device_get(state.params),
                    "batch_stats": jax.device_get(state.batch_stats)}
            res["after"][i + 1] = {
                "/".join(str(getattr(p, "key", p)) for p in kp): np.asarray(leaf)
                for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
        out[m] = res
    return out


@pytest.mark.parametrize("group,m", [("pair", 2), ("quad", 4)])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_fixed_step_matches_jax_spatial_step(ranks, jax_spatial, group, m, n_steps):
    want_all = jax_spatial[m]
    res_all = ranks(group, "fixed")
    for r, res in enumerate(res_all):
        for i in range(n_steps):
            assert res[f"finite{i}"]
            np.testing.assert_allclose(res[f"loss{i}"], want_all["losses"][i], rtol=1e-6,
                                       err_msg=f"rank {r} step {i + 1}")
    for r, res in enumerate(res_all[:1]):  # the others are bit-equal to rank 0
        want = want_all["after"][n_steps]
        got = {k[len(f"after{n_steps}/flax/"):]: v for k, v in res.items()
               if k.startswith(f"after{n_steps}/flax/")}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("group", ["pair", "quad"])
def test_fixed_step_ranks_bit_equal(ranks, group):
    assert_ranks_equal(ranks(group, "fixed"))


# (c) -----------------------------------------------------------------------
def test_float64_steps_match_single_process(ranks):
    """Two train steps, then two resident steps, on one state."""
    want = ranks("solo", "f64")[0]
    res = ranks("quad", "f64")
    assert [tuple(r["rows"]) for r in res] == [(0, 32), (32, 64), (0, 32), (32, 64)]
    for r in res:
        np.testing.assert_allclose([r[f"{k}{i}"] for k in ("loss", "rloss") for i in range(2)],
                                   [want[f"{k}{i}"] for k in ("loss", "rloss") for i in range(2)],
                                   rtol=1e-9)
    assert_close_1e9(res[0], want)
    assert_ranks_equal(res)


def test_float64_resident_store_holds_each_ranks_rows(ranks):
    want = ranks("solo", "f64")[0]
    res = ranks("quad", "f64")
    full = build_resident_store(DepthDataset("np", 8, store_sample), "cpu")
    for q, r in enumerate(res):
        assert int(r["store/n"]) == 8 and float(r["store/scale"]) == full.gt_scale
        s, e = r["rows"]
        d = q // 2
        for k in ("image", "gt", "mask"):
            np.testing.assert_array_equal(r[f"store/{k}"], full.arrays[k].numpy()[d::2, s:e])
        for i in range(2):  # the draws the single process was given
            np.testing.assert_array_equal(r[f"idx{i}"], want[f"idx{i}"][d])


def test_float64_model_4_with_empty_ranks_matches_single_process(ranks):
    want = ranks("solo", "m4")[0]
    res = ranks("quad", "m4")
    assert [tuple(r["rows"]) for r in res] == [(0, 32), (32, 64), (64, 64), (64, 64)]
    assert [int(r["store_rows"]) for r in res] == [32, 32, 0, 0]
    for r in res:
        for i in range(2):
            np.testing.assert_array_equal(r[f"idx{i}"], want[f"idx{i}"])
        np.testing.assert_allclose([r[f"{k}{i}"] for k in ("loss", "rloss") for i in range(2)],
                                   [want[f"{k}{i}"] for k in ("loss", "rloss") for i in range(2)],
                                   rtol=1e-9)
    assert_close_1e9(res[0], want)
    assert_ranks_equal(res)


# (d) -----------------------------------------------------------------------
def test_replication_equals_data_parallel(ranks):
    dp = ranks("pair", "dp")
    repl = ranks("quad", "repl")
    for r in repl:
        np.testing.assert_allclose([r["loss0"], r["loss1"]], [dp[0]["loss0"], dp[0]["loss1"]],
                                   rtol=1e-9)
    assert_close_1e9(repl[0], dp[0])
    assert_ranks_equal(repl)
    assert_ranks_equal(dp)


# (e) -----------------------------------------------------------------------
def test_eval_step_matches_single_process(ranks):
    tr = Trainer(ExperimentConfig(**{**FIXED, "batch_size": 4}), device="cpu")
    loss = float(tr.eval_step(tr.init_state(), fixed_batches(1, seed=7, rows=4)[0]))
    res = ranks("quad", "misc")
    for r in res:
        np.testing.assert_allclose(float(r["eval_loss"]), loss, rtol=1e-6)
    assert len({float(r["eval_loss"]) for r in res}) == 1


def test_out_of_map_index_gives_nan_and_refuses_the_step(ranks):
    for r in ranks("quad", "misc"):
        assert np.isnan(r["f4/loss"]) and not r["f4/finite"] and r["f4/unchanged"]


def test_nan_in_one_ranks_rows_refuses_the_step_on_every_rank(ranks):
    res = ranks("quad", "misc")
    for r in res:
        assert not r["nan/finite"] and int(r["nan/step"]) == 2 and r["nan/unchanged"]
        assert r["good/finite"]
    assert_ranks_equal(res, "final/")


# (f) -----------------------------------------------------------------------
def test_cli_train_spatial_writes_on_rank_0_only_and_resumes(ranks):
    from pldepth_torch.train.checkpoint import load_weights_npz

    res = ranks("pair", "cli")
    assert len(res[1]["written"]) == 0, res[1]["written"]
    written = {os.path.relpath(p, os.path.join(ranks.out, "runs")) for p in res[0]["written"]}
    for run in ("stream", "resident"):
        assert {f"{run}/metrics.jsonl", f"{run}/config.json", f"{run}/weights.npz"} <= written
    # 23 training samples, one data index: 11 steps an epoch either way
    assert [int(r["stream/step"]) for r in res] == [11, 11]
    assert [int(r["stream_resume/step"]) for r in res] == [22, 22]
    assert [int(r["resident/step"]) for r in res] == [11, 11]
    for key in ("stream/loss", "stream_resume/loss", "resident/loss"):
        np.testing.assert_array_equal(res[0][key], res[1][key])
        assert np.isfinite(res[0][key]).all()
    for r in res:
        assert float(r["warmup_collectives"]) == 2 and r["warmup_steps"].all()
    tr = Trainer(ExperimentConfig(model_name="ff_smoke", input_size=S, compute_dtype="float32"),
                 device="cpu")
    loaded = load_weights_npz(os.path.join(ranks.out, "runs", "stream", "weights.npz"),
                              tr.init_state())
    x = np.random.default_rng(0).uniform(size=(2, S, S, 3)).astype(np.float32)
    assert np.isfinite(np.asarray(tr.predict(loaded, x))).all()


# (g) -----------------------------------------------------------------------
@pytest.mark.parametrize("kw,item", [
    ({"model_name": "ff_redweb"}, "11.1"), ({"qres": "int8"}, "11.2"),
    ({"qenc": "bf16", "freeze_encoder": True}, "11.3"), ({"sparse_tail": True}, "11.4"),
    ({"remat_encoder": True}, "11.5"), ({"grad_accum": 2}, "11.6")])
def test_unported_options_under_spatial_sharding_name_their_item(kw, item):
    """Each option that ROADMAP item ``item`` once refused under spatial
    sharding builds its Trainer there, with the rows of the nested
    partition (the step itself: tests/test_torch_spatial_options.py)."""
    cfg = ExperimentConfig(**{**FIXED, **kw, "mesh": MeshConfig(data=1, model=2),
                              "spatial_sharding": True})
    for q, span in enumerate([(0, 32), (32, 64)]):
        tr = Trainer(cfg, device="cpu", mesh=mesh_lib.Mesh(world=2, rank=q, data=1, model=2))
        assert tr.input_rows() == span, item
    # replicated (the flag off) or at model 1 they run as before
    for mesh_cfg, spatial, mesh in ((MeshConfig(data=1, model=2), False,
                                     mesh_lib.Mesh(world=2, data=1, model=2)),
                                    (MeshConfig(), True, None)):
        Trainer(cfg.replace(mesh=mesh_cfg, spatial_sharding=spatial), device="cpu", mesh=mesh)


def test_spatial_sharding_needs_a_divisible_input_as_in_jax():
    import jax

    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer

    kw = dict(model_name="ff_smoke", input_size=100, batch_size=1, ranking_size=3,
              rankings_per_image=4, compute_dtype="float32", spatial_sharding=True)
    jtr = JTrainer(JConfig(**kw, mesh=JMeshConfig(data=1, model=3)), steps_per_epoch=1,
                   mesh=make_mesh(JMeshConfig(data=1, model=3), devices=jax.devices()[:3]))
    batch = {"image": np.zeros((1, 100, 100, 3), np.float32)}
    with pytest.raises(ValueError, match="not divisible") as want:
        jtr.shard_batch(batch)
    tr = Trainer(ExperimentConfig(**kw, mesh=MeshConfig(data=1, model=3)), device="cpu",
                 mesh=mesh_lib.Mesh(world=3, data=1, model=3))
    with pytest.raises(ValueError, match="not divisible") as got:
        tr.shard_batch(batch)
    assert str(got.value) == str(want.value)
    # the rows a divisible size gives each rank, and a model axis of 1
    tr = Trainer(ExperimentConfig(**{**kw, "input_size": 96}, mesh=MeshConfig(data=1, model=3)),
                 device="cpu", mesh=mesh_lib.Mesh(world=3, rank=1, data=1, model=3))
    assert tr.shard_batch({"image": np.zeros((1, 96, 96, 3))})["image"].shape == (1, 32, 96, 3)
    tr = Trainer(ExperimentConfig(**{**kw, "input_size": 100}), device="cpu")
    assert tr.input_rows() is None


if __name__ == "__main__":
    try:
        child(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
