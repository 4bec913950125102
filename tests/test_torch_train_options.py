"""The single-device training options of the port, against the JAX package,
on the CPU: ``grad_accum``, ``remat_encoder``, ``sparse_tail``, ``qres``
and ``qenc``, in the optimizer, the model, the train step and ``cli
train``.

``ff_smoke`` at 64^2 in f32 with the JAX package's initial weights carried
across by the weight bridge, unless a test says otherwise. The gradients
of one forward (remat, sparse tail, qres) are compared at 96^2: at 64^2
the 1/32 BatchNorms see 8 values a channel and the JAX reference's own f32
gradients move by 2-3% between its optimized and unoptimized compiles (the
test suite's), where at 96^2 port and JAX agree to 1e-5. Bounds:

* ``grad_accum`` (k 2 and 3): params after every micro-step against optax
  ``MultiSteps(amsgrad)`` rel 1e-5 (bit-equal between updates); the LR on
  the micro-step clock; a NaN micro-step rolls back ``mini_step`` and the
  accumulator; a resume in the middle of a cycle is bit-exact.
* ``remat_encoder``: with drop-path live (ff_effnet, B0's 16 blocks, at
  32^2) loss, gradients, committed BN statistics and the generator's end
  state equal the non-remat path's exactly; against JAX remat in train
  mode, output atol 1e-5 and gradients atol 2e-4
  (tests/test_remat_accum.py's bounds).
* ``sparse_tail``: taps equal JAX's at windows 1 and 3, borders and pixels
  outside the image included; scores rtol 1e-4, BN statistics 1e-4 and
  gradients rtol 5e-4 / atol 1e-5 against the JAX sparse path
  (tests/test_sparse_tail.py's bounds); a trainer step with an
  out-of-range ranking index against JAX's (loss rel 1e-6, params 1e-5).
* ``qres``: the forward and the new statistics equal the standard path's
  (atol 1e-5); gradients against JAX ``qres`` of the same compression per
  leaf rel 1e-3 over a floor of 1% of the largest leaf's norm, and
  against the exact gradients within 2e-2 (bf16) / 2e-1 (int8)
  (tests/test_qres.py); saved-tensor bytes int8 < bf16 < off.
* ``qenc``: JAX's validation messages; bf16 trains the decoder only and
  its loss falls; one bf16 and one int8 step against JAX's (params rtol
  1e-4, atol 1e-5, as tests/test_torch_train_slice.py; the decoder conv
  biases before a BN, whose gradient is zero, only stay below 1e-3); int8
  raises without ``prepare_qenc``; the hint.
* ``cli train`` with every option (``grad_accum`` and ``remat_encoder``
  through ``--config_json``); ``--qenc int8`` raises as the JAX command does.
"""

import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.models import get_pl_depth_net
from pldepth_torch.models.layers import TrainPass
from pldepth_torch.models.pldepth_net import freeze_params
from pldepth_torch.models.pretrained import flax_from_state_dict, flax_key, load_flat
from pldepth_torch.ops.listmle import pl_ranking_loss_from_scores
from pldepth_torch.ops.sparse_tail import pixels_of, sparse_upsample2x_taps
from pldepth_torch.train import Trainer
from pldepth_torch.train import schedules
from pldepth_torch.train.checkpoint import CheckpointManager
from pldepth_torch.train.optim import AmsGrad
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.models import get_pl_depth_net as j_get_pl_depth_net
from pldepth_tpu.ops import pl_ranking_loss_from_scores as j_loss_from_scores
from pldepth_tpu.ops import sparse_upsample2x_taps as j_sparse_upsample2x_taps
from pldepth_tpu.train import Trainer as JTrainer
from pldepth_tpu.train import schedules as jschedules

torch.set_num_threads(1)
S, B, RPI, K = 64, 2, 8, 4
G = 96  # the input size of the one-forward gradient comparisons
STEP_CFG = dict(model_name="ff_smoke", input_size=S, batch_size=B, ranking_size=K,
                rankings_per_image=RPI, compute_dtype="float32", freeze_encoder=True,
                augmentation=False, initial_lr=0.01, adam_eps=1e-2, epochs=1)


def _mesh1():
    return make_mesh(devices=jax.devices()[:1])


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jflat(jstate):
    return _flat({"params": jax.device_get(jstate.params),
                  "batch_stats": jax.device_get(jstate.batch_stats)})


def _port_state(tr, flat):
    state = tr.init_state()
    loaded, skipped = load_flat(state.model, flat)
    assert skipped == 0 and loaded == len(state.model.state_dict())
    return state


def _grads(model):
    """{flax path: gradient} of a port model, kernels HWIO."""
    out = {}
    for n, p in model.named_parameters():
        if p.grad is None:
            continue
        g = p.grad.numpy()
        out["params/" + flax_key(n, p.dim()).removeprefix("params/")] = (
            g.transpose(2, 3, 1, 0) if g.ndim == 4 else g)
    return out


def _rankings(seed=0, out_of_range=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, S * S, (B, RPI, K))
    if out_of_range:  # past the map, and negative: rows outside the image
        idx[0, 0, 1], idx[1, 2, 0] = S * S + 5, -3
    depths = np.sort(rng.uniform(0.1, 1.0, (B, RPI, K)), axis=-1)[..., ::-1]
    return np.stack([idx, depths], -1).astype(np.float32)


def _fixed_batch(seed=0, out_of_range=False):
    rng = np.random.default_rng(seed + 100)
    return {"image": rng.uniform(size=(B, S, S, 3)).astype(np.float32),
            "rankings": _rankings(seed, out_of_range)}


def _rel_leafwise(got, want, floor=0.0):
    return max(np.linalg.norm(got[k] - want[k]) / max(np.linalg.norm(want[k]), floor)
               for k in want)


# ------------------------------------------------------------ grad_accum --

@pytest.mark.parametrize("k", [2, 3])
def test_grad_accum_matches_optax_multisteps(k):
    """3k micro-steps of optax MultiSteps(amsgrad) under the JAX trainer's
    finite guard, the inner schedule on the micro clock; micro-step k+1's
    gradient holds a NaN: the whole state rolls back there."""
    rng = np.random.default_rng(k)
    shapes = {"dec": (4, 3), "bn": (5,)}
    params = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    grads = [{n: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for n, s in shapes.items()} for _ in range(3 * k)]
    grads[k]["dec"][1, 1] = np.nan
    sched = schedules.sgdr_schedule(0.01, 0.0025, 4)
    jsched = jschedules.sgdr_schedule(0.01, 0.0025, 4)
    tx = optax.MultiSteps(optax.amsgrad(lambda c: jsched(c * k), 0.9, 0.999, 1e-7),
                          every_k_schedule=k)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    jopt = tx.init(jp)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    trainable = [tp["dec"], tp["bn"]]
    opt = AmsGrad(sched, 0.9, 0.999, 1e-7, every_k=k)
    state = opt.init(trainable)
    for g in grads:
        upd, nopt = tx.update({n: jnp.asarray(v) for n, v in g.items()}, jopt, jp)
        finite = all(np.isfinite(v).all() for v in g.values())
        if finite:
            jp, jopt = optax.apply_updates(jp, upd), nopt
        before = [t.clone() for t in trainable]
        for t, n in zip(trainable, ("dec", "bn")):
            t.grad = torch.from_numpy(g[n])
        assert bool(opt.step(trainable, state, torch.tensor(True))) == finite
        for n in shapes:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]), rtol=1e-5, atol=1e-8)
        assert int(state.mini_step) == int(jopt.mini_step)
        assert int(state.gradient_step) == int(jopt.gradient_step) == int(state.count)
        np.testing.assert_allclose(state.acc.numpy(), np.concatenate(
            [np.asarray(jopt.acc_grads[n]).ravel() for n in ("dec", "bn")]), rtol=1e-6)
        if int(state.mini_step) != 0 or not finite:  # no update landed
            assert all(torch.equal(a, b) for a, b in zip(before, trainable))
    assert int(state.count) == 2


def test_grad_accum_schedule_runs_on_microstep_clock():
    """The inner LR is schedule(count * k), JAX's ``_inner_schedule``; the
    step's reported LR stays schedule(step)."""
    cfg = dict(model_name="ff_smoke", input_size=S, batch_size=8, ranking_size=3,
               rankings_per_image=8, compute_dtype="float32", initial_lr=1e-3,
               grad_accum=4, epochs=2)
    jtr = JTrainer(JConfig(**cfg), steps_per_epoch=10, mesh=_mesh1())
    jtr._ensure_tx()
    tr = Trainer(ExperimentConfig(**cfg), steps_per_epoch=10, device="cpu")
    for c in (0, 1, 3, 5):
        got = float(tr.optimizer.inner_schedule(torch.tensor(c, dtype=torch.int32)))
        assert got == pytest.approx(float(jtr._inner_schedule(c)), rel=1e-7)
        assert got == float(tr.schedule(c * 4))
    tr1 = Trainer(ExperimentConfig(**{**cfg, "grad_accum": 1}), steps_per_epoch=10,
                  device="cpu")
    assert float(tr1.optimizer.inner_schedule(torch.tensor(3))) == float(tr1.schedule(3))
    state = tr.init_state()
    state, m = tr.train_step_fixed(state, _fixed_batch())
    assert float(m.lr) == float(tr.schedule(0))


def _params(state):
    return {k: v.clone() for k, v in state.model.state_dict().items()}


def test_grad_accum_trainer_updates_on_the_kth_step_and_resumes_mid_cycle(tmp_path):
    """k = 3: params bit-equal after micro-steps 1 and 2, moved after 3 (BN
    statistics move every step); 2 steps, a checkpoint, a restore and 3
    more equal 5 uninterrupted steps bit for bit."""
    cfg = ExperimentConfig(**{**STEP_CFG, "grad_accum": 3})
    batches = [_fixed_batch(i) for i in range(5)]
    tr = Trainer(cfg, steps_per_epoch=5, device="cpu")
    state = tr.init_state()
    trainable = lambda st: {n: p.detach().clone()  # noqa: E731
                            for n, p in st.model.named_parameters() if p.requires_grad}
    seen = [trainable(state)]
    stats = [_params(state)]
    for b in batches:
        state, m = tr.train_step_fixed(state, b)
        assert bool(m.finite)
        seen.append(trainable(state))
        stats.append(_params(state))
    same = lambda a, b: all(torch.equal(a[n], b[n]) for n in a)  # noqa: E731
    assert same(seen[0], seen[1]) and same(seen[1], seen[2]) and not same(seen[2], seen[3])
    assert same(seen[3], seen[4])
    rm = [n for n in stats[0] if n.endswith("running_mean")]
    assert all(not torch.equal(stats[i][n], stats[i + 1][n]) for i in range(2) for n in rm[:3])

    tr2 = Trainer(cfg, steps_per_epoch=5, device="cpu")
    s2 = tr2.init_state()
    for b in batches[:2]:
        s2, _ = tr2.train_step_fixed(s2, b)
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(s2.step, s2)
    s3 = ckpt.restore(Trainer(cfg, steps_per_epoch=5, device="cpu").init_state())
    assert int(s3.opt.mini_step) == 2 and s3.step == 2
    for b in batches[2:]:
        s3, _ = tr2.train_step_fixed(s3, b)
    assert all(torch.equal(v, stats[-1][n]) for n, v in _params(s3).items())
    for n, v in s3.opt.state_dict().items():
        assert torch.equal(v, state.opt.state_dict()[n]), n


def test_grad_accum_nan_micro_step_rolls_back_mini_step_and_accumulator():
    cfg = ExperimentConfig(**{**STEP_CFG, "grad_accum": 2})
    tr = Trainer(cfg, steps_per_epoch=5, device="cpu")
    state = tr.init_state()
    state, _ = tr.train_step_fixed(state, _fixed_batch(0))
    opt0 = {n: v.clone() for n, v in state.opt.state_dict().items()}
    before = _params(state)
    bad = _fixed_batch(1)
    bad["image"][0, 3, 4, 1] = np.nan
    state, m = tr.train_step_fixed(state, bad)
    assert not bool(m.finite) and state.step == 2
    assert int(state.opt.mini_step) == 1 and int(state.opt.count) == 0
    for n, v in state.opt.state_dict().items():
        assert torch.equal(v, opt0[n]), n
    assert all(torch.equal(v, before[n]) for n, v in _params(state).items())
    state, m = tr.train_step_fixed(state, _fixed_batch(2))
    assert bool(m.finite) and int(state.opt.count) == 1 and int(state.opt.mini_step) == 0


# --------------------------------------------------------- remat_encoder --

def _train_run(model, x, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    train = TrainPass(gen=gen)
    for p in model.parameters():
        p.grad = None
    out = model(x, train, **kw)
    w = torch.sin(torch.arange(out.numel(), dtype=torch.float32)).reshape(out.shape)
    loss = (out * w).sum()
    loss.backward()
    stats = {m: tuple(t.clone() for t in v) for m, v in train.new_stats.items()}
    return out.detach(), loss.detach(), _grads(model), stats, gen.get_state()


def test_remat_equals_the_plain_path_with_drop_path_live():
    net = get_pl_depth_net("ff_effnet", "float32", drop_connect_rate=0.5)
    model = net.init_module(torch.Generator().manual_seed(0))
    remat = get_pl_depth_net("ff_effnet", "float32", drop_connect_rate=0.5, remat=True).make()
    remat.load_state_dict(model.state_dict())
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 32, 32, 3)).astype(np.float32))
    out0, loss0, g0, st0, gen0 = _train_run(model, x, seed=3)
    out1, loss1, g1, st1, gen1 = _train_run(remat, x, seed=3)
    assert torch.equal(out0, out1) and torch.equal(loss0, loss1)
    assert set(g0) == set(g1) and all(np.array_equal(g0[k], g1[k]) for k in g0)
    names0 = {m: n for n, m in model.named_modules()}
    names1 = {m: n for n, m in remat.named_modules()}
    s0 = {names0[m]: v for m, v in st0.items()}
    s1 = {names1[m]: v for m, v in st1.items()}
    assert set(s0) == set(s1) and len(s0) == 54
    assert all(torch.equal(a, b) for n in s0 for a, b in zip(s0[n], s1[n]))
    assert torch.equal(gen0, gen1)
    # drop-path did drop: another draw gives another output
    out2 = _train_run(model, x, seed=4)[0]
    assert not torch.equal(out0, out2)


def _jax_train_grads(jm, variables, x, pixels=None):
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def fn(p):
        out, upd = jm.module.apply({"params": p, **rest}, x, True, pixels,
                                   rngs={"droppath": jax.random.key(1)},
                                   mutable=["batch_stats"])
        w = jnp.sin(jnp.arange(out.size, dtype=jnp.float32)).reshape(out.shape)
        return jnp.sum(out.astype(jnp.float32) * w), (out, upd)

    (_, (out, upd)), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    return np.asarray(out), _flat({"batch_stats": upd["batch_stats"]}), _flat({"params": g})


@pytest.fixture(scope="module")
def smoke_vars():
    jm = j_get_pl_depth_net("ff_smoke", compute_dtype="float32")
    variables = jm.init_variables(jax.random.key(0), (G, G, 3))
    x = np.random.default_rng(1).normal(size=(B, G, G, 3)).astype(np.float32)
    return variables, _flat(variables), x


def test_remat_matches_jax_remat(smoke_vars):
    variables, flat, x = smoke_vars
    with jax.default_matmul_precision("highest"):
        jout, _, jg = _jax_train_grads(
            j_get_pl_depth_net("ff_smoke", compute_dtype="float32", remat=True), variables,
            jnp.asarray(x))
    model = get_pl_depth_net("ff_smoke", "float32", remat=True).make()
    load_flat(model, flat)
    out, _, g, _, _ = _train_run(model, torch.from_numpy(x), seed=0)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5)
    assert set(g) == set(jg)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], atol=2e-4, err_msg=k)


# ----------------------------------------------------------- sparse_tail --

@pytest.mark.parametrize("window", [1, 3])
def test_taps_match_jax_borders_and_outside_pixels(window):
    rng = np.random.default_rng(window)
    b, h2, w2, c = 2, 7, 9, 5
    x = rng.normal(size=(b, h2, w2, c)).astype(np.float32)
    pts = rng.integers(0, [2 * h2, 2 * w2], size=(b, 24, 2))
    pts[:, :8] = [[0, 0], [0, 2 * w2 - 1], [2 * h2 - 1, 0], [2 * h2 - 1, 2 * w2 - 1],
                  [-1, 3], [2 * h2, 4], [5, -2], [2 * h2 + 6, 2 * w2 + 9]]
    want = np.asarray(j_sparse_upsample2x_taps(jnp.asarray(x), jnp.asarray(pts, jnp.int32),
                                               window=window))
    got = sparse_upsample2x_taps(torch.from_numpy(x), torch.from_numpy(pts), window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    assert not got[:, 7].any()  # wholly outside: every tap is padding


def test_pixels_follow_the_jax_index_rule():
    r = np.zeros((1, 1, 6, 2), np.float32)
    r[0, 0, :, 0] = [0, 65, S * S - 1, S * S + 5, -3, 7.9]
    got = pixels_of(torch.from_numpy(r), S).numpy()
    flat = jnp.asarray(r[..., 0]).astype(jnp.int32).reshape(1, -1)
    want = np.asarray(jnp.stack([flat // S, flat % S], axis=-1))
    np.testing.assert_array_equal(got, want)


def test_sparse_scores_stats_and_grads_match_jax(smoke_vars):
    variables, flat, x = smoke_vars
    rng = np.random.default_rng(3)
    idx = rng.integers(0, G * G, (B, RPI, K))
    depths = np.sort(rng.uniform(0.1, 1.0, (B, RPI, K)), axis=-1)[..., ::-1]
    rankings = np.stack([idx, depths], -1).astype(np.float32)
    fl = rankings[..., 0].astype(np.int32).reshape(B, -1)
    pixels = np.stack([fl // G, fl % G], -1).astype(np.int32)
    jm = j_get_pl_depth_net("ff_smoke", compute_dtype="float32")
    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p):
        scores, upd = jm.module.apply({"params": p, "batch_stats": stats}, jnp.asarray(x), True,
                                      jnp.asarray(pixels), rngs={"droppath": jax.random.key(1)},
                                      mutable=["batch_stats"])
        return j_loss_from_scores(scores, jnp.asarray(rankings), impl="xla"), (scores, upd)

    with jax.default_matmul_precision("highest"):
        (jloss, (jscores, jupd)), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = get_pl_depth_net("ff_smoke", "float32").make()
    load_flat(model, flat)
    train = TrainPass()
    px = pixels_of(torch.from_numpy(rankings), G)
    scores = model(torch.from_numpy(x), train, pixels=px)
    loss = pl_ranking_loss_from_scores(scores, torch.from_numpy(rankings), impl="xla")
    loss.backward()
    assert scores.shape == (B, RPI * K)
    np.testing.assert_allclose(scores.detach().numpy(), np.asarray(jscores), rtol=1e-4,
                               atol=1e-5)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    names = {m: n for n, m in model.named_modules()}
    jstats = _flat({"batch_stats": jupd["batch_stats"]})
    for bn, (mean, var) in train.new_stats.items():
        for leaf, v in (("mean", mean), ("var", var)):
            key = f"batch_stats/{names[bn].replace('.', '/')}/{leaf}"
            np.testing.assert_allclose(v.numpy(), jstats[key], rtol=1e-4, atol=1e-6,
                                       err_msg=key)
    g, jg = _grads(model), _flat({"params": jg})
    assert set(g) == set(jg)
    for k in jg:
        np.testing.assert_allclose(g[k], jg[k], rtol=5e-4, atol=1e-5, err_msg=k)
    # and the sparse path is the dense map at those pixels
    with torch.no_grad():
        dense = model(torch.from_numpy(x), TrainPass())[..., 0].reshape(B, -1)
    want = torch.gather(dense, 1, torch.from_numpy(fl.astype(np.int64)))
    np.testing.assert_allclose(scores.detach().numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def _step_pair(option, n_steps=1, prepare=False, **kw):
    """n fixed steps of the JAX and the port trainer with ``option`` from the
    same weights: (JAX losses, JAX state flat, port losses, port flat,
    port state, port trainer, initial flat)."""
    cfg = {**STEP_CFG, **option, **kw}
    jtr = JTrainer(JConfig(**cfg), steps_per_epoch=3, mesh=_mesh1())
    jstate = jtr.init_state()
    init = _jflat(jstate)
    tr = Trainer(ExperimentConfig(**cfg), steps_per_epoch=3, device="cpu")
    state = _port_state(tr, init)
    batches = [_fixed_batch(i, out_of_range=option.get("sparse_tail", False))
               for i in range(n_steps)]
    if prepare:
        jtr.prepare_qenc(jstate, batches[0]["image"])
        tr.prepare_qenc(state, batches[0]["image"])
    jl, pl = [], []
    for b in batches:
        jstate, jm = jtr.train_step_fixed(jstate, b)
        state, m = tr.train_step_fixed(state, b)
        jl.append(float(jm.loss))
        pl.append(float(m.loss))
        assert bool(jm.finite) and bool(m.finite)
    return jl, _jflat(jstate), pl, flax_from_state_dict(state.model.state_dict()), state, tr, init


def test_sparse_tail_step_with_an_out_of_range_index_matches_jax():
    jl, jflat, pl, flat, state, tr, init = _step_pair({"sparse_tail": True})
    assert np.isfinite(pl[0]) and pl[0] == pytest.approx(jl[0], rel=1e-6)
    for k in jflat:
        np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-5, atol=1e-5, err_msg=k)


# ------------------------------------------------------------------ qres --

def test_qres_forward_and_stats_identical_and_redweb_refused(smoke_vars):
    variables, flat, x = smoke_vars
    outs = {}
    for store in (None, "int8", "bf16"):
        model = get_pl_depth_net("ff_smoke", "float32", qres=store).make()
        load_flat(model, flat)
        names = {m: n for n, m in model.named_modules()}
        train = TrainPass()
        with torch.no_grad():
            out = model(torch.from_numpy(x), train)
            infer = model(torch.from_numpy(x))
        outs[store] = (out, {names[m]: v for m, v in train.new_stats.items()}, infer)
    for store in ("int8", "bf16"):
        np.testing.assert_allclose(outs[store][0].numpy(), outs[None][0].numpy(), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(outs[store][2].numpy(), outs[None][2].numpy(), rtol=0,
                                   atol=1e-5)
        assert set(outs[store][1]) == set(outs[None][1])
        for n, (m, v) in outs[store][1].items():
            np.testing.assert_allclose(m.numpy(), outs[None][1][n][0].numpy(), atol=1e-5)
            np.testing.assert_allclose(v.numpy(), outs[None][1][n][1].numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="ff_effnet family"):
        get_pl_depth_net("ff_redweb", qres="int8")
    with pytest.raises(ValueError, match="ff_effnet family"):
        Trainer(ExperimentConfig(model_name="ff_redweb", qres="bf16"), device="cpu")


@pytest.mark.parametrize("store,exact_tol", [("bf16", 2e-2), ("int8", 2e-1)])
def test_qres_gradients_match_jax_qres(smoke_vars, store, exact_tol):
    variables, flat, x = smoke_vars
    with jax.default_matmul_precision("highest"):
        _, _, jg = _jax_train_grads(j_get_pl_depth_net("ff_smoke", compute_dtype="float32",
                                                       qres=store), variables, jnp.asarray(x))
    exact = get_pl_depth_net("ff_smoke", "float32").make()
    load_flat(exact, flat)
    g0 = _train_run(exact, torch.from_numpy(x), seed=0)[2]
    model = get_pl_depth_net("ff_smoke", "float32", qres=store).make()
    load_flat(model, flat)
    g = _train_run(model, torch.from_numpy(x), seed=0)[2]
    assert set(g) == set(jg) == set(g0)
    floor = 1e-2 * max(np.linalg.norm(v) for v in jg.values())
    assert _rel_leafwise(g, jg, floor) <= 1e-3
    floor0 = 1e-2 * max(np.linalg.norm(v) for v in g0.values())
    assert _rel_leafwise(g, g0, floor0) <= exact_tol
    va = np.concatenate([g[k].ravel() for k in sorted(g0)])
    vb = np.concatenate([g0[k].ravel() for k in sorted(g0)])
    assert va @ vb / (np.linalg.norm(va) * np.linalg.norm(vb)) > 0.999


def test_qres_saved_tensor_bytes_int8_below_bf16_below_off():
    """What autograd keeps through one bf16 train-mode encoder forward,
    BN-only trainable as in training."""
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(2, S, S, 3)).astype(np.float32))
    saved = {}
    for store in (None, "bf16", "int8"):
        model = get_pl_depth_net("ff_smoke", "bfloat16", qres=store).init_module(
            torch.Generator().manual_seed(0))
        freeze_params(model, True)
        nbytes = []

        def pack(t):
            nbytes.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            top, _ = model.encoder(x, TrainPass())
        assert top.requires_grad
        saved[store] = sum(nbytes)
    assert saved["int8"] < saved["bf16"] < saved[None], saved


# ------------------------------------------------------------------ qenc --

@pytest.mark.parametrize("kw,match", [
    (dict(qenc="bf16", freeze_encoder=False), "freeze_encoder"),
    (dict(qenc="bf16", model_name="ff_redweb"), "ff_effnet family"),
    (dict(qenc="bf16", qres="int8"), "mutually exclusive"),
    (dict(qenc="fp8"), "qenc must be"),
])
def test_qenc_validation_messages_are_jax_s(kw, match):
    cfg = {**STEP_CFG, **kw}
    with pytest.raises(ValueError, match=match) as jerr:
        JTrainer(JConfig(**cfg), 1, mesh=_mesh1())
    with pytest.raises(ValueError, match=match) as err:
        Trainer(ExperimentConfig(**cfg), 1, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_qenc_bf16_trains_the_decoder_only_and_folds_once():
    from pldepth_torch.data import BatchIterator, SyntheticDepthDataset

    cfg = ExperimentConfig(**{**STEP_CFG, "qenc": "bf16", "batch_size": 8, "initial_lr": 3e-3,
                              "rankings_per_image": 16, "adam_eps": 1e-7,
                              "augmentation": True})
    tr = Trainer(cfg, steps_per_epoch=2, device="cpu")
    state = tr.init_state()
    p0 = _params(state)
    it = BatchIterator(SyntheticDepthDataset(n=16, image_size=S, seed=1), 8, seed=0)
    losses = []
    for _ in range(12):
        state, m = tr.train_step(state, next(it))
        assert bool(m.finite)
        losses.append(float(m.loss))
    it.close()
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    p1 = _params(state)
    enc = [n for n in p0 if n.startswith("encoder.")]
    dec = [n for n in p0 if n.startswith("decoder.")]
    assert all(torch.equal(p0[n], p1[n]) for n in enc)  # params, BN affine and statistics
    assert any(not torch.equal(p0[n], p1[n]) for n in dec if n.endswith("weight"))
    assert any(not torch.equal(p0[n], p1[n]) for n in dec if n.endswith("running_mean"))
    assert tr.qenc_builds == 1
    # the optimizer state's encoder entries stay zero (no gradient reaches them)
    params = [(n, p) for n, p in state.model.named_parameters() if p.requires_grad]
    off = 0
    for n, p in params:
        seg = state.opt.mu[off: off + p.numel()]
        assert (not n.startswith("encoder.")) or not seg.any(), n
        off += p.numel()


def _zero_gradient_bias(key):
    """The bias of a decoder conv that feeds a batch-statistics BN: zero
    gradient in exact arithmetic."""
    parts = key.split("/")
    return parts[:2] == ["params", "decoder"] and parts[-1] == "bias" and parts[-2].startswith(
        "conv")


@pytest.mark.parametrize("qenc", ["bf16", "int8"])
def test_qenc_step_matches_jax(qenc):
    jl, jflat, pl, flat, state, tr, init = _step_pair({"qenc": qenc}, prepare=qenc == "int8")
    assert pl[0] == pytest.approx(jl[0], rel=1e-5)
    moved = 0
    for k in jflat:
        if _zero_gradient_bias(k):  # its update is lr-scaled f32 noise in both
            assert np.abs(flat[k]).max() <= 1e-3 and np.abs(jflat[k]).max() <= 1e-3, k
        else:
            np.testing.assert_allclose(flat[k], jflat[k], rtol=1e-4, atol=1e-5, err_msg=k)
        if k.startswith(("params/encoder", "batch_stats/encoder")):
            np.testing.assert_array_equal(flat[k], init[k], err_msg=k)
        moved += not np.array_equal(flat[k], init[k])
    assert moved > 0


def test_qenc_int8_raises_before_prepare_qenc():
    tr = Trainer(ExperimentConfig(**{**STEP_CFG, "qenc": "int8"}), 1, device="cpu")
    state = tr.init_state()
    with pytest.raises(RuntimeError, match="prepare_qenc"):
        tr.train_step_fixed(state, _fixed_batch())
    with pytest.raises(ValueError, match="qenc='int8' only"):
        Trainer(ExperimentConfig(**STEP_CFG), 1, device="cpu").prepare_qenc(state, None)


def test_pretrained_frozen_encoder_hints_qenc(tmp_path, caplog):
    from pldepth_torch.models.pretrained import save_backbone

    tr = Trainer(ExperimentConfig(**STEP_CFG), 1, device="cpu")
    path = str(tmp_path / "backbone.npz")
    save_backbone(path, tr.init_state().model, prefixes=("params/encoder/",
                                                         "batch_stats/encoder/"))
    with caplog.at_level(logging.INFO, logger="pldepth_torch.train.trainer"):
        Trainer(ExperimentConfig(**{**STEP_CFG, "pretrained_path": path}), 1, device="cpu")
    assert any("--qenc bf16" in m for m in caplog.messages)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="pldepth_torch.train.trainer"):
        Trainer(ExperimentConfig(**{**STEP_CFG, "pretrained_path": path, "qenc": "bf16"}), 1,
                device="cpu")
    assert not any("--qenc bf16 runs" in m for m in caplog.messages)


# ------------------------------------------------------------- cli train --

CLI = ["train", "--device", "cpu", "--model_name", "ff_smoke", "--dataset", "synthetic",
       "--input_size", str(S), "--ds_size", "8", "--batch_size", "2", "--epochs", "1",
       "--ranking_size", "3", "--rankings_per_image", "4", "--compute_dtype", "float32",
       "--freeze_encoder", "true"]


@pytest.mark.parametrize("flags,config", [
    ([], {"grad_accum": 2}), ([], {"remat_encoder": True}), (["--sparse_tail", "true"], {}),
    (["--qres", "int8"], {}), (["--qres", "bf16"], {}), (["--qenc", "bf16"], {}),
])
def test_cli_train_runs_each_option(flags, config, tmp_path, capsys):
    from pldepth_torch.cli import main

    args = list(flags)
    if config:
        with open(tmp_path / "cfg.json", "w") as f:
            json.dump(config, f)
        args += ["--config_json", str(tmp_path / "cfg.json")]
    assert main(CLI + ["--output_dir", str(tmp_path), "--run_name", "r"] + args) == 0
    out = json.loads([ln for ln in capsys.readouterr().out.strip().splitlines()
                      if ln.startswith('{"run_dir"')][-1])
    assert out["step"] == 4 and np.isfinite(out["loss"]).all()  # 8 train samples / 2
    assert os.path.exists(out["weights"])
    with open(tmp_path / "r" / "config.json") as f:
        saved = json.load(f)
    want = dict(config)
    if "--sparse_tail" in flags:
        want["sparse_tail"] = True
    for k, v in want.items():
        assert saved[k] == v


def test_cli_train_qenc_int8_raises_at_the_first_step(tmp_path):
    """The JAX command never calls prepare_qenc: its first step raises."""
    from pldepth_torch.cli import main

    with pytest.raises(RuntimeError, match="prepare_qenc"):
        main(CLI + ["--output_dir", str(tmp_path), "--qenc", "int8"])


@pytest.mark.parametrize("option", [{"grad_accum": 2}, {"qenc": "bf16"}])
def test_resident_chain_runs_the_options_as_single_steps(option):
    """resident_chain(3) equals three resident_step calls bit for bit under
    ``grad_accum`` and ``qenc`` (JAX's test_qenc_bf16_resident_chain_compatible)."""
    from pldepth_torch.data import SyntheticDepthDataset
    from pldepth_torch.data.resident import build_resident_store

    cfg = ExperimentConfig(**{**STEP_CFG, **option, "rankings_per_image": 4})
    store = build_resident_store(SyntheticDepthDataset(n=6, image_size=S, seed=3), "cpu")
    out = []
    for chained in (True, False):
        tr = Trainer(cfg, steps_per_epoch=3, device="cpu")
        state = tr.init_state()
        enc0 = {k: v.clone() for k, v in state.model.encoder.state_dict().items()}
        if chained:
            state, m = tr.resident_chain(3)(state, store.arrays)
            losses = m.loss.tolist()
        else:
            losses = []
            for _ in range(3):
                state, m = tr.resident_step(state, store.arrays)
                losses.append(float(m.loss))
        assert np.isfinite(losses).all() and state.step == 3
        if "qenc" in option:
            assert all(torch.equal(v, enc0[k]) for k, v in state.model.encoder.state_dict().items())
        out.append((losses, _params(state), state.opt.state_dict()))
    (l1, p1, o1), (l2, p2, o2) = out
    assert l1 == l2
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(o1[k], o2[k]) for k in o1)
