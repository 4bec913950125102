"""The train-mode parts of the port against the JAX package (or the TF
goldens) on the CPU, each with its tolerance: batch-norm in train mode vs
flax (rel 5e-6: the f32 mean over the batch is summed in another order;
on the case below the port is 1.4e-6 and flax 4.9e-6 from an f64
reference), the ff_effnet f32 train forward vs the TF golden
``ref_train`` at 96^2 (rel < 5e-5, tests/test_full_parity.py's bound), the
parameter partition (exact), the schedules (rel 1e-6), AMSGrad vs optax
over five steps with a non-finite one (rel 1e-6) and drop-path."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.models import get_pl_depth_net
from pldepth_torch.models.layers import BatchNorm, TrainPass
from pldepth_torch.models.pldepth_net import freeze_params, partition_params
from pldepth_torch.models.pretrained import overlay_synthetic
from pldepth_torch.train import schedules
from pldepth_torch.train.optim import AmsGrad
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.train import schedules as jschedules

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "full_model_ff_effnet.npz")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    rng = np.random.default_rng(0)
    # |mean| >> std: the two-pass variance matters here
    x = (rng.normal(size=(3, 5, 6, 7)) * 0.3 + 4.0).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 7).astype(np.float32), rng.normal(size=7).astype(np.float32)
    mean0, var0 = rng.normal(size=7).astype(np.float32), rng.uniform(0.5, 2, 7).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-3,
                       dtype=jnp.float32, use_fast_variance=False)
    jx = jnp.asarray(x, jnp.dtype(dtype))
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean0, "var": var0}}, jx,
                         mutable=["batch_stats"])
    m = BatchNorm(7)
    with torch.no_grad():
        for t, v in ((m.weight, scale), (m.bias, bias), (m.running_mean, mean0),
                     (m.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    train = TrainPass()
    got = m(torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype)), train)
    assert got.dtype == torch.float32
    assert _rel(got.detach().numpy(), want) < 5e-6
    new_mean, new_var = train.new_stats[m]
    np.testing.assert_allclose(new_mean.numpy(), upd["batch_stats"]["mean"], rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(new_var.numpy(), upd["batch_stats"]["var"], rtol=5e-6, atol=1e-7)
    np.testing.assert_array_equal(m.running_mean.numpy(), mean0)  # buffers untouched


def test_train_forward_matches_tf_golden():
    gold = np.load(GOLDEN)
    module = get_pl_depth_net("ff_effnet", "float32", drop_connect_rate=0.0).make()
    overlay_synthetic(module, gold["names"])
    from pldepth_torch.data.preprocess import normalize_images

    x = normalize_images(torch.from_numpy(gold["x_raw"] / 255.0), "effnet")
    with torch.no_grad():
        train = TrainPass(gen=torch.Generator().manual_seed(0))
        pred = module(x, train)
    rel = _rel(pred.numpy(), gold["ref_train"])
    assert rel < 5e-5, f"train forward diverges from TF: rel {rel:.2e}"
    n_bn = sum(isinstance(m, BatchNorm) for m in module.modules())
    assert len(train.new_stats) == n_bn


@pytest.mark.parametrize("freeze", [True, False])
def test_partition_labels_equal_jax(freeze):
    from pldepth_tpu.models import get_pl_depth_net as j_get
    from pldepth_tpu.models.pldepth_net import partition_params as j_partition

    for name in ("ff_effnet", "ff_smoke"):
        jmodel = j_get(name, "float32")
        shapes = jax.eval_shape(lambda: jmodel.init_variables(jax.random.key(0), (64, 64, 3)))
        labels = j_partition(shapes["params"], freeze)
        want = {"params/" + "/".join(str(getattr(p, "key", p)) for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(labels)[0]}
        assert partition_params(want, freeze) == want
        module = get_pl_depth_net(name, "float32").make()
        got = freeze_params(module, freeze)
        assert sorted(got.values()) == sorted(want.values())
        assert all(p.requires_grad == (got[n] == "trainable")
                   for n, p in module.named_parameters())


@pytest.mark.parametrize("kw", [
    dict(schedule="sgdr", epochs=7),
    dict(schedule="sgdr", epochs=7, sgdr_cycle_epochs=2, sgdr_mult_factor=2.0, lr_decay=0.5),
    dict(schedule="step", step_milestones=(2, 4), warmup=1, lr_multi=0.1),
    dict(schedule="constant"),
])
def test_schedules_match_jax(kw):
    steps_per_epoch = 5
    got = schedules.build_schedule(ExperimentConfig(**kw), steps_per_epoch)
    want = jschedules.build_schedule(JConfig(**kw), steps_per_epoch)
    grid = [0, 1, 3, 4, 5, 9, 10, 17, 24, 34, 35, 60]
    g = np.array([float(got(s)) for s in grid])
    np.testing.assert_allclose(g, [float(want(s)) for s in grid], rtol=1e-6)
    np.testing.assert_allclose([float(got(torch.tensor(s, dtype=torch.int32))) for s in grid], g,
                               rtol=0)


def test_amsgrad_matches_optax_with_a_rejected_step():
    """Five steps of optax.amsgrad under multi_transform{trainable, frozen:
    set_to_zero}, the JAX trainer's finite guard around each; step 3's
    gradient holds a NaN, so nothing moves there and the count stays."""
    rng = np.random.default_rng(0)
    shapes = {"dec": (4, 3), "bn": (5,), "frozen": (2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.integers(-3, 2)).astype(np.float32)
              for k, s in shapes.items()} for _ in range(5)]
    grads[2]["dec"][1, 1] = np.nan
    sched = schedules.sgdr_schedule(0.01, 0.0025, 4)
    jsched = jschedules.sgdr_schedule(0.01, 0.0025, 4)

    labels = {"dec": "trainable", "bn": "trainable", "frozen": "frozen"}
    tx = optax.multi_transform({"trainable": optax.amsgrad(jsched, 0.9, 0.999, 1e-7),
                                "frozen": optax.set_to_zero()}, labels)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jopt = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    trainable = [tp["dec"], tp["bn"]]
    opt = AmsGrad(sched, 0.9, 0.999, 1e-7)
    state = opt.init(trainable)
    for step, g in enumerate(grads):
        upd, nopt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jopt, jp)
        finite = all(np.isfinite(v).all() for v in g.values())
        if finite:
            jp, jopt = optax.apply_updates(jp, upd), nopt
        for t, k in zip(trainable, ("dec", "bn")):
            t.grad = torch.from_numpy(g[k])
        ok = opt.step(trainable, state, torch.tensor(True))
        assert bool(ok) == finite
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-8)
    assert int(state.count) == 4
    np.testing.assert_array_equal(tp["frozen"].numpy(), params["frozen"])


def test_amsgrad_is_not_torch_amsgrad():
    """The max over the bias-corrected second moment differs from
    torch.optim.Adam(amsgrad=True) once the gradient shrinks."""
    p1 = torch.zeros(1, requires_grad=True)
    p2 = torch.zeros(1, requires_grad=True)
    opt = AmsGrad(lambda c: torch.tensor(0.1), 0.9, 0.999, 1e-7)
    state = opt.init([p1])
    ref = torch.optim.Adam([p2], lr=0.1, betas=(0.9, 0.999), eps=1e-7, amsgrad=True)
    for g in (1.0, 0.01, 0.01):
        p1.grad, p2.grad = torch.tensor([g]), torch.tensor([g])
        opt.step([p1], state, torch.tensor(True))
        ref.step()
    assert abs(p1.item() - p2.item()) > 1e-3


def test_drop_path_per_sample_and_rate():
    cfg_rate = 0.2
    module = get_pl_depth_net("ff_effnet", "float32", drop_connect_rate=cfg_rate).init_module(
        torch.Generator().manual_seed(0))
    enc = module.encoder
    rates = [getattr(enc, n).drop_rate for n in enc.block_names]
    assert rates == pytest.approx([cfg_rate * i / 16 for i in range(16)])
    blk = enc.stage6_block3  # residual, rate 0.2 * 14 / 16
    x = torch.randn(64, 4, 4, blk.in_ch, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        keep = 1 - blk.drop_rate
        train = TrainPass(gen=torch.Generator().manual_seed(3))
        out, _ = blk(x, train)
        branch = out - x
        dropped = branch.flatten(1).abs().amax(1) == 0
        assert 0 < int(dropped.sum()) < 64  # whole samples, some dropped
        draws = torch.rand(64, generator=torch.Generator().manual_seed(3)) < keep
        assert torch.equal(~dropped, draws)
        # the kept ones are the train-BN branch / keep
        plain = TrainPass()
        blk.drop_rate, rate = 0.0, blk.drop_rate
        base, _ = blk(x, plain)
        blk.drop_rate = rate
        torch.testing.assert_close(branch[~dropped], ((base - x) / keep)[~dropped],
                                   rtol=1e-5, atol=1e-5)
