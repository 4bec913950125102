"""Data parallelism over processes on the CPU: two ranks over gloo.

The children are this file run as a script, two processes that join one
process group through a ``file://`` rendezvous under the test's temporary
directory (parallel test workers never race for a port) and import no JAX.
One pair runs every case in order (a collective mismatch between ranks
would hang, so both ranks run the same list) and writes ``.npz`` results;
the tests here hold them against the JAX package and the port's own
single-process step:

(a) ``train_step_fixed`` at world 2 against the JAX package's step on a
    2-device mesh (ff_smoke 64^2 f32, frozen encoder, bridged weights,
    different images on the two ranks): loss rel 1e-6, params and BN
    statistics 1e-5 after 1 and 3 steps (``adam_eps`` 1e-2, as in
    tests/test_torch_train_slice.py);
(b) ``train_step`` (a sharded ``BatchIterator`` feed) and ``resident_step``
    (a sharded store) with flip and drop-path on, against the single-process
    step on the same global batch, at the same tolerances. ff_effnet, whose
    residual blocks drop paths, at 128^2: at 64^2 its 1/32 BNs see 16 values
    a channel and f32 moves the gradient by 1e-3 between two summation
    orders (float64 agrees to 5e-9);
(c) after every case the ranks' weights, BN statistics and optimizer state
    are bit-equal;
(d) a NaN pixel in rank 1's images alone refuses the step on both ranks,
    which keep their state and advance ``step``;
(e) ``grad_accum`` 2, ``remat_encoder`` and ``sparse_tail`` at world 2
    against their single-process runs; ``qres int8`` (the global int8
    ``amax`` of the compressed residuals) and ``qenc int8`` (each rank
    calibrates on its rows, the maxima all-reduced: the packed int8
    encoder equals the single process's) on their losses;
(f) the sharded resident store: each rank's rows are the JAX store's rows
    at its stride, the set cut to a multiple of 2, one ``gt_scale`` equal
    to the JAX store's;
(g) ``warmup_collectives``, ``round_batch``, ``pad_to_batch`` and
    ``make_mesh`` against ``pldepth_tpu/core/mesh.py``;
(h) ``cli train`` at world 2 with the streaming and the resident feed
    (chains of 2): rank 1 writes no file, ``weights.npz`` loads in both
    packages, and ``--resume`` continues from the last step;
    ``--pack_cache`` raises naming ROADMAP item 11; ``cli warmup`` counts
    both ranks in its collectives;
(i) ``eval_step`` (global mean) and ``jit_predict`` (each rank its rows) at
    world 2 against single-process results;
(j) the spans of ``fit``'s profiled window at world 2 (obs/spans.py in
    each rank's Chrome trace): one ``mesh.stop`` a step, every
    ``mesh.all_reduce`` inside the step's forward, backward or update under
    that step's identifier, in the same order on both ranks.

    python tests/test_torch_dp.py RANK WORLD RENDEZVOUS_FILE OUT_DIR
"""

import builtins
import glob
import json
import io
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
from pldepth_torch.core.rng import generator  # noqa: E402
from pldepth_torch.data.datasets import DepthDataset, SyntheticDepthDataset  # noqa: E402
from pldepth_torch.data.pipeline import BatchIterator  # noqa: E402
from pldepth_torch.data.resident import build_resident_store  # noqa: E402
from pldepth_torch.models.pretrained import flax_from_state_dict  # noqa: E402
from pldepth_torch.train import Trainer  # noqa: E402

torch.set_num_threads(1)
WORLD = 2
S = 64
FIXED = dict(model_name="ff_smoke", input_size=S, batch_size=2, ranking_size=5,
             rankings_per_image=16, compute_dtype="float32", freeze_encoder=True,
             augmentation=False, initial_lr=0.01, adam_eps=1e-2, epochs=1)
SAMPLED_S = 128
SAMPLED = dict(model_name="ff_effnet", input_size=SAMPLED_S, batch_size=2, ranking_size=3,
               rankings_per_image=8, sampling_type=1, compute_dtype="float32",
               freeze_encoder=True, augmentation=True, initial_lr=0.01, adam_eps=1e-2,
               epochs=1)
STORE_N = 9  # cut to 8 by two shards
OPTIONS = {"grad_accum": {"grad_accum": 2}, "remat": {"remat_encoder": True},
           "sparse_tail": {"sparse_tail": True}, "qres_int8": {"qres": "int8"},
           "qenc_int8": {"qenc": "int8"}}
OPT_S = 128
# their states are not held at 1e-5: an int8 rounding of the compressed
# residual flips with the BN sums' order (qres), and the decoder conv
# biases that feed a batch-statistics BN have a true gradient of 0, so
# AMSGrad moves them by their f32 noise (qenc, 1e-4): losses, the packed
# encoder and the ranks' equality are held instead
INT8_OPTIONS = ("qres_int8", "qenc_int8")
CLI = ["train", "--device", "cpu", "--model_name", "ff_smoke", "--dataset", "synthetic",
       "--input_size", str(S), "--ds_size", "64", "--batch_size", "2", "--ranking_size", "3",
       "--rankings_per_image", "8", "--compute_dtype", "float32"]


# ---------------------------------------------------------------------------
# inputs, the same in the children and the parent
# ---------------------------------------------------------------------------
def fixed_batches(n, seed=0, rows=2 * WORLD, size=S):
    """Global (image, rankings) batches: every row its own image."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        idx = rng.integers(0, size * size, (rows, 16, 5))
        depths = np.sort(rng.uniform(0.1, 1.0, (rows, 16, 5)), axis=-1)[..., ::-1]
        out.append({"image": rng.uniform(size=(rows, size, size, 3)).astype(np.float32),
                    "rankings": np.stack([idx, depths], -1).astype(np.float32)})
    return out


def sampled_ds():
    return SyntheticDepthDataset(n=16, image_size=SAMPLED_S, seed=3)


def store_sample(i):
    """Sample ``i`` of the resident set: seeded numpy, so the JAX package's
    store reads the same values."""
    rng = np.random.default_rng(70 + i)
    return {"image": rng.uniform(size=(SAMPLED_S, SAMPLED_S, 3)).astype(np.float32),
            "gt": rng.uniform(0.05, 1.0, (SAMPLED_S, SAMPLED_S)).astype(np.float32),
            "mask": (rng.uniform(size=(SAMPLED_S, SAMPLED_S)) < 0.9).astype(np.float32)}


def store_ds():
    return DepthDataset("np", STORE_N, store_sample)


def state_arrays(state, prefix=""):
    """A copy of every tensor of a state (weights, BN statistics,
    optimizer) as numpy (the step updates the tensors in place)."""
    out = {f"{prefix}model/{k}": np.array(v.detach().cpu())
           for k, v in state.model.state_dict().items()}
    out.update({f"{prefix}opt/{k}": np.array(v.cpu()) for k, v in state.opt.state_dict().items()})
    return out


def flax_arrays(state, prefix):
    return {f"{prefix}flax/{k}": np.array(v)
            for k, v in flax_from_state_dict(state.model.state_dict()).items()}


def resident_idx(seed, step, rank, n_local, b):
    """The rows ``Trainer.resident_batch`` draws on ``rank`` at ``step``."""
    tag = "train/resident" + (f"/{rank}" if rank else "")
    return torch.randint(0, n_local, (b,), generator=generator(seed, tag, step, "cpu"))


# ---------------------------------------------------------------------------
# the children's cases
# ---------------------------------------------------------------------------
def case_fixed(mesh, rank, out):
    tr = Trainer(ExperimentConfig(**FIXED), steps_per_epoch=3, device="cpu")
    state = tr.init_state()
    res = {}
    for i, b in enumerate(fixed_batches(3)):
        state, m = tr.train_step_fixed(state, mesh_lib.shard_batch(mesh, b))
        res[f"loss{i}"] = float(m.loss)
        res[f"finite{i}"] = bool(m.finite)
        if i in (0, 2):
            res.update(flax_arrays(state, f"after{i + 1}/"))
    res.update(state_arrays(state))
    # (d): a NaN input on rank 1 alone
    bad = mesh_lib.shard_batch(mesh, fixed_batches(1, seed=9)[0])
    if rank == 1:
        bad["image"] = bad["image"].copy()
        bad["image"][0, 3, 4, 1] = np.nan
    before = state_arrays(state)
    state, m = tr.train_step_fixed(state, bad)
    res["nan/finite"] = bool(m.finite)
    res["nan/step"] = state.step
    res["nan/unchanged"] = all(np.array_equal(v, before[k], equal_nan=True)
                               for k, v in state_arrays(state).items())
    return res


def case_sampled(mesh, rank, out):
    tr = Trainer(ExperimentConfig(**SAMPLED), steps_per_epoch=2, device="cpu")
    state = tr.init_state()
    it = BatchIterator(sampled_ds(), 2, seed=0, shard_index=rank, num_shards=WORLD)
    res = {}
    for i in range(2):
        state, m = tr.train_step(state, next(it))
        res[f"loss{i}"] = float(m.loss)
    it.close()
    res.update(state_arrays(state))
    return res


def case_resident(mesh, rank, out):
    cfg = ExperimentConfig(**{**SAMPLED, "batch_size": 2 * WORLD, "data_resident": True})
    tr = Trainer(cfg, steps_per_epoch=2, device="cpu")
    store = build_resident_store(store_ds(), "cpu", shard_index=rank, num_shards=WORLD)
    state = tr.init_state()
    res = {"store/n": store.n, "store/scale": store.gt_scale,
           **{f"store/{k}": v.numpy() for k, v in store.arrays.items()}}
    for i in range(2):
        res[f"idx{i}"] = resident_idx(cfg.seed, state.step, rank, store.arrays["image"].shape[0],
                                      cfg.batch_size // WORLD).numpy()
        state, m = tr.resident_step(state, store.arrays)
        res[f"loss{i}"] = float(m.loss)
    res.update(state_arrays(state))
    return res


def case_options(mesh, rank, out):
    res = {}
    for name, kw in OPTIONS.items():
        tr = Trainer(ExperimentConfig(**{**FIXED, **kw, "input_size": OPT_S}), steps_per_epoch=2,
                     device="cpu")
        state = tr.init_state()
        batches = fixed_batches(2, seed=4, size=OPT_S)
        if tr.cfg.qenc == "int8":  # each rank calibrates on its rows
            tr.prepare_qenc(state, mesh_lib.shard_batch(mesh, batches[0])["image"])
        for i, b in enumerate(batches):
            state, m = tr.train_step_fixed(state, mesh_lib.shard_batch(mesh, b))
            res[f"{name}/loss{i}"] = float(m.loss)
        res.update(state_arrays(state, f"{name}/"))
        if tr.cfg.qenc == "int8":
            res.update({f"{name}/qenc/{k}": np.array(v.cpu())
                        for k, v in tr._qenc_encoder(state.model).state_dict().items()})
    return res


def case_stop(mesh, rank, out):
    """A stop asked on rank 1 alone, after its second step."""
    from pldepth_torch.train.checkpoint import CheckpointManager

    tr = Trainer(ExperimentConfig(**{**FIXED, "sampling_type": 1, "log_every": 1}),
                 steps_per_epoch=4, device="cpu")

    class StopOnRank1:
        def on_train_begin(self, trainer):
            pass

        def on_step_end(self, trainer, step, metrics):
            if rank == 1 and step == 1:
                trainer.request_stop()

        def on_epoch_end(self, *a):
            pass

        def on_train_end(self, *a):
            pass

    ckpt = CheckpointManager(os.path.join(out, "stop_ckpt"))
    it = BatchIterator(SyntheticDepthDataset(n=16, image_size=S, seed=6), 2, seed=0,
                       shard_index=rank, num_shards=WORLD)
    state, hist = tr.fit(tr.init_state(), it, epochs=1, callbacks=[StopOnRank1()], ckpt=ckpt)
    it.close()
    return {"step": state.step, "preempted": bool(hist.get("preempted")),
            "ckpt_steps": np.asarray(ckpt.steps()), **state_arrays(state, "stop/")}


def case_eval(mesh, rank, out):
    tr = Trainer(ExperimentConfig(**FIXED), steps_per_epoch=1, device="cpu")
    state = tr.init_state()
    b = mesh_lib.shard_batch(mesh, fixed_batches(1, seed=7)[0])
    return {"eval_loss": float(tr.eval_step(state, b)),
            "pred": np.asarray(tr.jit_predict()(state, b["image"]))}


def case_mesh(mesh, rank, out):
    res = {"warmup": mesh_lib.warmup_collectives(mesh),
           "round_batch": [mesh_lib.round_batch(n, mesh) for n in (1, 2, 5, 8)]}
    try:
        mesh_lib.make_mesh(MeshConfig(data=4))
        res["mismatch"] = ""
    except ValueError as e:
        res["mismatch"] = str(e)
    res["data"] = mesh_lib.make_mesh(MeshConfig()).data
    return res


def case_cli(mesh, rank, out):
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
         "--batch_size", "2", "--compute_dtype", "float32"]))
    res["warmup_collectives"] = warm["collectives"]
    try:  # the packed feed has no shard contract across processes
        cli.train(cli._parser().parse_args(CLI + ["--output_dir", runs, "--run_name", "packed",
                                                  "--pack_cache", os.path.join(out, "x.pldpack")]))
        res["pack_cache"] = ""
    except NotImplementedError as e:
        res["pack_cache"] = str(e)
    return res


def case_spans(mesh, rank, out):
    tr = Trainer(ExperimentConfig(**FIXED), steps_per_epoch=2, device="cpu")
    it = BatchIterator(SyntheticDepthDataset(n=16, image_size=S, seed=6), 2, seed=0,
                       shard_index=rank, num_shards=WORLD)
    logdir = os.path.join(out, f"profile{rank}")
    state, _ = tr.fit(tr.init_state(), it, epochs=2, profile_dir=logdir)
    it.close()
    (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    with open(path) as f:
        got = sorted((e for e in json.load(f)["traceEvents"] if e.get("cat") == "program_span"),
                     key=lambda e: (e["ts"], e["args"]["id"]))
    by_id = {e["args"]["id"]: e["name"] for e in got}
    return {"step": state.step, "names": np.asarray([e["name"] for e in got]),
            "parents": np.asarray([by_id.get(e["args"]["parent"], "") for e in got]),
            "idents": np.asarray([-1 if e["args"]["ident"] is None else e["args"]["ident"]
                                  for e in got])}


CASES = [("fixed", case_fixed), ("sampled", case_sampled), ("resident", case_resident),
         ("options", case_options), ("stop", case_stop), ("eval", case_eval), ("mesh", case_mesh),
         ("spans", case_spans), ("cli", case_cli)]


def child(rank: int, world: int, rendezvous: str, out: str) -> None:
    mesh = mesh_lib.init_distributed(device="cpu", init_method=f"file://{rendezvous}",
                                     world_size=world, rank=rank, timeout_s=240)
    for name, fn in CASES:
        res = fn(mesh, rank, out)
        np.savez(os.path.join(out, f"{name}_r{rank}.npz"), **res)
        print(f"rank {rank}: case {name} done", flush=True)
    mesh_lib.shutdown()


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Start the pair; hand back a function that waits for it once and
    loads case ``name`` of both ranks."""
    out = str(tmp_path_factory.mktemp("dp"))
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    env.pop("WORLD_SIZE", None)
    logs = [open(os.path.join(out, f"rank{r}.log"), "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, "-u", os.path.abspath(__file__), str(r),
                               str(WORLD), os.path.join(out, "rendezvous"), out],
                              stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=out)
             for r in range(WORLD)]
    state = {}

    def load(name):
        if not state:
            for p in procs:
                try:
                    p.wait(timeout=600)
                except subprocess.TimeoutExpired:
                    for q in procs:
                        q.kill()
            for f in logs:
                f.close()
            state["rc"] = [p.returncode for p in procs]
        for r in range(WORLD):
            path = os.path.join(out, f"{name}_r{r}.npz")
            if not os.path.exists(path):
                with open(os.path.join(out, f"rank{r}.log")) as f:
                    pytest.fail(f"rank {r} wrote no {name} results (rc {state['rc']}):\n"
                                f"{f.read()[-4000:]}")
        return [dict(np.load(os.path.join(out, f"{name}_r{r}.npz"))) for r in range(WORLD)]

    load.out = out
    yield load
    for p in procs:
        if p.poll() is None:
            p.kill()


def single_state(cfg_kw, steps, step_fn, with_trainer=False):
    tr = Trainer(ExperimentConfig(**cfg_kw), steps_per_epoch=steps, device="cpu")
    state = tr.init_state()
    losses = []
    for i in range(steps):
        state, m = step_fn(tr, state, i)
        losses.append(float(m.loss))
    return (losses, state, tr) if with_trainer else (losses, state)


def assert_states_close(got, want, prefix=""):
    """Weights and BN statistics (atol / rtol 1e-5) and the optimizer count."""
    for k, v in want.items():
        if not k.startswith(prefix + "model/"):
            continue
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got[prefix + "opt/count"], want[prefix + "opt/count"])


def assert_ranks_equal(res, keys=None):
    a, b = res
    keys = keys or [k for k in a if "/" in k and not k.startswith(("store/", "written"))]
    for k in keys:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


# (a) -----------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """The JAX package's data-parallel fixed-rankings step on a 2-device
    mesh, from the port's seeded initial weights (saved and loaded through
    the npz bridge)."""
    import jax

    from pldepth_torch.train.checkpoint import save_weights_npz
    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer
    from pldepth_tpu.train.checkpoint import load_weights_npz

    path = str(tmp_path_factory.mktemp("bridge") / "init.npz")
    save_weights_npz(path, Trainer(ExperimentConfig(**FIXED), device="cpu").init_state())
    jtr = JTrainer(JConfig(**FIXED, mesh=JMeshConfig(data=2)), steps_per_epoch=3,
                   mesh=make_mesh(JMeshConfig(data=2), devices=jax.devices()[:2]))
    state = jtr.replicate(load_weights_npz(path, jtr.init_state()))
    out = {"losses": [], "after": {}}
    for i, b in enumerate(fixed_batches(3)):
        state, m = jtr.train_step_fixed(state, b)
        out["losses"].append(float(m.loss))
        tree = {"params": jax.device_get(state.params),
                "batch_stats": jax.device_get(state.batch_stats)}
        out["after"][i + 1] = {
            "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return out


@pytest.mark.parametrize("n_steps", [1, 3])
def test_fixed_step_matches_jax_data_parallel(ranks, jax_dp, n_steps):
    for r, res in enumerate(ranks("fixed")):
        for i in range(n_steps):
            assert res[f"finite{i}"]
            np.testing.assert_allclose(res[f"loss{i}"], jax_dp["losses"][i], rtol=1e-6,
                                       err_msg=f"rank {r} step {i + 1}")
        want = jax_dp["after"][n_steps]
        got = {k[len(f"after{n_steps}/flax/"):]: v for k, v in res.items()
               if k.startswith(f"after{n_steps}/flax/")}
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"rank {r} {k}")


def test_fixed_step_ranks_bit_equal(ranks):
    res = ranks("fixed")
    assert_ranks_equal(res, [k for k in res[0] if k.startswith(("model/", "opt/", "after"))])


def test_nan_on_one_rank_refuses_the_step_on_both(ranks):
    for res in ranks("fixed"):
        assert not res["nan/finite"]
        assert int(res["nan/step"]) == 4
        assert res["nan/unchanged"]


# (b) -----------------------------------------------------------------------
def test_sampled_step_matches_single_process(ranks):
    ds = sampled_ds()
    its = [BatchIterator(ds, 2, seed=0, shard_index=r, num_shards=WORLD) for r in range(WORLD)]
    batches = [{k: np.concatenate([b[k] for b in bs]) for k in bs[0]}
               for bs in ([next(it) for it in its] for _ in range(2))]
    for it in its:
        it.close()
    losses, state = single_state({**SAMPLED, "batch_size": 2 * WORLD}, 2,
                                 lambda tr, st, i: tr.train_step(st, batches[i]))
    want = state_arrays(state)
    res = ranks("sampled")
    for r in range(WORLD):
        np.testing.assert_allclose([res[r]["loss0"], res[r]["loss1"]], losses, rtol=1e-6)
        assert_states_close(res[r], want)
    assert_ranks_equal(res)


def test_resident_step_matches_single_process(ranks):
    res = ranks("resident")
    # rank r's local row j is global row r + W j of the 8 samples kept
    full = build_resident_store(store_ds().take(8), "cpu")
    cfg = {**SAMPLED, "batch_size": 2 * WORLD, "data_resident": True}

    def step(tr, st, i):
        idx = torch.from_numpy(np.concatenate([r + WORLD * res[r][f"idx{i}"]
                                               for r in range(WORLD)]))
        return tr.resident_step(st, full.arrays, idx)

    losses, state = single_state(cfg, 2, step)
    want = state_arrays(state)
    for r in range(WORLD):
        np.testing.assert_allclose([res[r]["loss0"], res[r]["loss1"]], losses, rtol=1e-6)
        assert_states_close(res[r], want)
    assert_ranks_equal(res)


# (e) -----------------------------------------------------------------------
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_training_option_matches_single_process(ranks, option):
    batches = fixed_batches(2, seed=4, size=OPT_S)

    def step(tr, st, i):
        if i == 0 and tr.cfg.qenc == "int8":
            tr.prepare_qenc(st, batches[0]["image"])
        return tr.train_step_fixed(st, batches[i])

    losses, state, tr = single_state({**FIXED, **OPTIONS[option], "batch_size": 2 * WORLD,
                                      "input_size": OPT_S}, 2, step, with_trainer=True)
    want = state_arrays(state, f"{option}/")
    res = ranks("options")
    for r in range(WORLD):
        np.testing.assert_allclose([res[r][f"{option}/loss{i}"] for i in range(2)], losses,
                                   rtol=1e-6)
        if option in INT8_OPTIONS:
            continue
        assert_states_close(res[r], want, f"{option}/")
    if option == "qenc_int8":
        # every rank packed the single process's int8 encoder: its activation
        # scales to an ulp (a conv of 2 rows may round otherwise than of 4; a
        # rank's own maxima would be off by the other rank's larger values)
        for k, v in tr._qenc_encoder(state.model).state_dict().items():
            for r in range(WORLD):
                np.testing.assert_allclose(res[r][f"{option}/qenc/{k}"], np.array(v),
                                           rtol=1e-6, atol=0, err_msg=k)
    assert_ranks_equal(res, [k for k in res[0] if k.startswith(f"{option}/")])


# (f) -----------------------------------------------------------------------
def test_sharded_store_matches_jax_store_at_the_stride(ranks):
    import jax

    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.data.datasets import DepthDataset as JDepthDataset
    from pldepth_tpu.data.resident import build_resident_store as j_build

    theirs = j_build(JDepthDataset("np", 8, store_sample), make_mesh(devices=jax.devices()[:1]))
    res = ranks("resident")
    for r in range(WORLD):
        assert int(res[r]["store/n"]) == 8 == theirs.n
        assert float(res[r]["store/scale"]) == theirs.gt_scale
        for k, dtype in (("image", np.uint8), ("gt", np.uint16), ("mask", np.uint8)):
            want = np.asarray(jax.device_get(theirs.arrays[k]))[r::WORLD]
            np.testing.assert_array_equal(res[r][f"store/{k}"].view(dtype), want, err_msg=k)
        np.testing.assert_array_equal(res[r]["store/gt_scale"], np.float32(theirs.gt_scale))
    assert float(res[0]["store/scale"]) == float(res[1]["store/scale"])


# (g) -----------------------------------------------------------------------
def test_mesh_helpers_match_jax(ranks):
    import jax

    from pldepth_tpu.core import mesh as jmesh
    from pldepth_tpu.core.config import MeshConfig as JMeshConfig

    jm = jmesh.make_mesh(JMeshConfig(data=2), devices=jax.devices()[:2])
    for res in ranks("mesh"):
        assert float(res["warmup"]) == 2.0 == jmesh.warmup_collectives(jm)
        assert list(res["round_batch"]) == [jmesh.round_batch(n, jm) for n in (1, 2, 5, 8)]
        assert int(res["data"]) == 2
        with pytest.raises(ValueError) as e:
            jmesh.make_mesh(JMeshConfig(data=4), devices=jax.devices()[:2])
        assert str(res["mismatch"]) == str(e.value)
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    for bs, fill in ((5, 0.0), (3, 1.0), (2, 0.0), (8, -1.0)):
        np.testing.assert_array_equal(mesh_lib.pad_to_batch(a, bs, fill),
                                      jmesh.pad_to_batch(a, bs, fill))


# (h) -----------------------------------------------------------------------
def test_cli_train_two_ranks_writes_on_rank_0_only(ranks):
    import jax

    from pldepth_torch.train.checkpoint import load_weights_npz
    from pldepth_tpu.core.config import ExperimentConfig as JConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer as JTrainer
    from pldepth_tpu.train.checkpoint import load_weights_npz as j_load

    res = ranks("cli")
    assert len(res[1]["written"]) == 0, res[1]["written"]
    written = {os.path.relpath(p, os.path.join(ranks.out, "runs")) for p in res[0]["written"]}
    for run in ("stream", "resident"):
        assert {f"{run}/metrics.jsonl", f"{run}/config.json", f"{run}/weights.npz"} <= written
    # 60 training samples: 30 a rank, 15 steps an epoch streaming; the
    # resident batch is global, 30 steps an epoch
    assert [int(res[r]["stream/step"]) for r in range(WORLD)] == [15, 15]
    assert [int(res[r]["stream_resume/step"]) for r in range(WORLD)] == [30, 30]
    assert [int(res[r]["resident/step"]) for r in range(WORLD)] == [30, 30]
    assert_ranks_equal(res, ["stream/loss", "stream_resume/loss", "resident/loss"])
    for r in range(WORLD):
        assert "ROADMAP.md queue 1 item 11" in str(res[r]["pack_cache"])
        assert float(res[r]["warmup_collectives"]) == WORLD
    assert np.isfinite(res[0]["stream_resume/loss"]).all()
    with open(os.path.join(ranks.out, "runs", "stream", "metrics.jsonl")) as f:
        assert sum('"images_per_sec"' in line for line in f) == 2  # one line an epoch
    cfg = dict(model_name="ff_smoke", input_size=S, compute_dtype="float32")
    for run in ("stream", "resident"):
        path = os.path.join(ranks.out, "runs", run, "weights.npz")
        tr = Trainer(ExperimentConfig(**cfg), device="cpu")
        loaded = load_weights_npz(path, tr.init_state())
        jtr = JTrainer(JConfig(**cfg), steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
        jstate = j_load(path, jtr.init_state())
        x = np.random.default_rng(0).uniform(size=(2, S, S, 3)).astype(np.float32)
        np.testing.assert_allclose(np.asarray(tr.predict(loaded, x)),
                                   np.asarray(jtr.predict(jstate, x)), rtol=1e-4, atol=1e-4)


# fit ---------------------------------------------------------------------------
def test_a_stop_on_one_rank_stops_both_at_the_same_step(ranks):
    res = ranks("stop")
    for r in range(WORLD):
        assert int(res[r]["step"]) == 2 and bool(res[r]["preempted"])
        assert list(res[r]["ckpt_steps"]) == [2]  # rank 0 wrote it, both see it
    assert_ranks_equal(res, [k for k in res[0] if k.startswith("stop/")])


# (j) -----------------------------------------------------------------------
def test_fit_spans_hold_the_stop_agreement_and_the_all_reduces(ranks):
    """``fit(profile_dir=)`` at world 2: steps 1-3 in each rank's trace."""
    res = ranks("spans")
    for r in range(WORLD):
        names, parents, idents = (list(res[r][k]) for k in ("names", "parents", "idents"))
        assert int(res[r]["step"]) == 4
        stops = [i for i, n in enumerate(names) if n == "mesh.stop"]
        assert len(stops) == 3 and all(parents[i] == "" for i in stops)
        reduces = [i for i, n in enumerate(names) if n == "mesh.all_reduce"]
        # global-batch BN's sums in the forward and their cotangents in the
        # backward; the gradient and the loss in the update
        assert {parents[i] for i in reduces} == {"step.forward", "step.backward",
                                                 "step.update"}
        assert sorted({int(idents[i]) for i in reduces}) == [1, 2, 3]
        steps = [i for i, n in enumerate(names) if n == "step"]
        assert [int(idents[i]) for i in steps] == [1, 2, 3]
        assert "fit.epoch" in names and "fit.feed" in names
    assert [n for n in res[0]["names"] if n.startswith("mesh.")] == \
        [n for n in res[1]["names"] if n.startswith("mesh.")]


# the draws -------------------------------------------------------------------
@pytest.mark.parametrize("sampler,method", [("info_score", "auto"), ("masked", "rejection"),
                                            ("segment", "auto"), ("thresholded", "hier")])
def test_rank_draws_are_rows_of_the_global_draws(sampler, method):
    """Flip, the samplers (each draw method) and drop-path draw at the
    global batch's shape: rank r's rankings and flags are rows of the
    world-1 ones (no process group needed; RowsGenerator alone)."""
    from pldepth_torch.data.preprocess import random_flip_batch
    from pldepth_torch.sampling import sample_rankings_batch

    b = fixed_batches(1, seed=3)[0]
    rng = np.random.default_rng(5)
    gts = torch.from_numpy(rng.uniform(0.1, 1.0, (2 * WORLD, S, S)).astype(np.float32))
    masks = torch.from_numpy((rng.uniform(size=(2 * WORLD, S, S)) < 0.8).astype(np.float32))
    images = torch.from_numpy(b["image"])

    def draw(rank, world, rows):
        gen = lambda tag: mesh_lib.RowsGenerator(generator(0, tag, 3), rank, world)  # noqa: E731
        im, gt, mk = random_flip_batch(gen("flip"), images[rows], gts[rows], masks[rows])
        r = sample_rankings_batch(gen("sample"), gt, mk, sampler_name=sampler,
                                  rankings_per_image=8, ranking_size=3, draw_method=method)
        return im, r, mesh_lib.batch_rand(gen("droppath"), (len(im),))

    whole = draw(0, 1, slice(None))
    for rank in range(WORLD):
        part = draw(rank, WORLD, slice(2 * rank, 2 * rank + 2))
        for w, p in zip(whole, part):
            assert torch.equal(w[2 * rank:2 * rank + 2], p)


# (i) -----------------------------------------------------------------------
def test_eval_and_predict_match_single_process(ranks):
    tr = Trainer(ExperimentConfig(**FIXED), device="cpu")
    state = tr.init_state()
    b = fixed_batches(1, seed=7)[0]
    loss = float(tr.eval_step(state, b))
    pred = np.asarray(tr.jit_predict()(state, b["image"]))
    res = ranks("eval")
    for r in range(WORLD):
        np.testing.assert_allclose(float(res[r]["eval_loss"]), loss, rtol=1e-6)
        np.testing.assert_allclose(res[r]["pred"], pred[2 * r:2 * r + 2], rtol=1e-6, atol=1e-6)
    assert float(res[0]["eval_loss"]) == float(res[1]["eval_loss"])


if __name__ == "__main__":
    try:
        child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    except Exception:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
