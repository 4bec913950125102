"""The slice end to end on the CPU: ff_smoke at 64^2 with weights made by
the JAX package and carried across by the weight bridge. The port's
``predict`` and ``predict_fused`` against the JAX ``Trainer.predict`` /
``predict_fused`` on the same seeded images: f32 rel <= 2e-4, bf16 rel <=
0.03 (tests/test_fused_infer.py's bounds). Also the plan, the serving
policy, checkpoints both ways and the serving pipeline."""

import os

import jax
import numpy as np
import pytest
import torch

from pldepth_torch.core.config import ExperimentConfig
from pldepth_torch.models import get_pl_depth_net
from pldepth_torch.models.fused_infer import plan_encoder
from pldepth_torch.models.pretrained import (
    flax_from_state_dict,
    load_flat,
    state_dict_from_flax,
)
from pldepth_torch.serve.pipeline import depth_writer, run_pipeline, unique_stems
from pldepth_torch.train import Trainer
from pldepth_torch.train.checkpoint import (
    infer_decoder_head_ch,
    load_weights_npz,
    save_weights_npz,
)
from pldepth_tpu.core.config import ExperimentConfig as JConfig
from pldepth_tpu.core.mesh import make_mesh
from pldepth_tpu.train import Trainer as JTrainer

torch.set_num_threads(1)
SIZE = 64
DTYPES = ["float32", "bfloat16"]
TOL = {"float32": 2e-4, "bfloat16": 0.03}


def flat_jax(state):
    tree = {"params": jax.device_get(state.params),
            "batch_stats": jax.device_get(state.batch_stats)}
    return {
        "/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.fixture(scope="module")
def ref():
    """JAX weights and predictions for both dtypes, computed once."""
    images = np.random.default_rng(0).uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    out = {"images": images}
    for dt in DTYPES:
        cfg = JConfig(model_name="ff_smoke", input_size=SIZE, compute_dtype=dt)
        tr = JTrainer(cfg, steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
        state = tr.init_state()
        out[dt] = dict(
            flat=flat_jax(state),
            predict=np.asarray(jax.jit(tr.predict)(state, images), np.float32),
            predict_fused=np.asarray(jax.jit(tr.predict_fused)(state, images), np.float32),
        )
    return out


def port(dt, flat):
    cfg = ExperimentConfig(model_name="ff_smoke", input_size=SIZE, compute_dtype=dt)
    trainer = Trainer(cfg, device="cpu")
    state = trainer.init_state()
    loaded, skipped = load_flat(state.model, flat)
    assert skipped == 0 and loaded == len(state.model.state_dict())
    return trainer, state


def test_bridge_round_trip_is_exact(ref):
    flat = ref["float32"]["flat"]
    sd = state_dict_from_flax(flat)
    module = get_pl_depth_net("ff_smoke", "float32").make()
    own = module.state_dict()
    assert set(sd) == set(own)
    assert all(sd[k].shape == own[k].shape for k in sd)
    back = flax_from_state_dict(sd)
    assert set(back) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k])


@pytest.mark.parametrize("name", ["ff_effnet", "ff_smoke"] + [
    f"ff_effnet_b{i}" for i in range(1, 8)])
def test_every_variant_maps_onto_the_jax_tree(name):
    """Each registered model has exactly the JAX model's tensors, by flax
    path and flax shape (JAX side traced with eval_shape, no init)."""
    from pldepth_tpu.models import get_pl_depth_net as j_get

    jmodel = j_get(name, "float32")
    shapes = jax.eval_shape(lambda: jmodel.init_variables(jax.random.key(0), (64, 64, 3)))
    want = {
        "/".join(str(getattr(p, "key", p)) for p in path): tuple(leaf.shape)
        for path, leaf in jax.tree_util.tree_flatten_with_path(
            {"params": shapes["params"], "batch_stats": shapes["batch_stats"]})[0]
    }
    module = get_pl_depth_net(name, "float32").make()
    got = {k: v.shape for k, v in flax_from_state_dict(module.state_dict()).items()}
    assert got == want


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("fn", ["predict", "predict_fused"])
def test_port_matches_jax(ref, dt, fn):
    trainer, state = port(dt, ref[dt]["flat"])
    got = getattr(trainer, fn)(state, ref["images"]).float().numpy()
    want = ref[dt][fn]
    assert got.shape == want.shape == (2, SIZE, SIZE)
    assert np.isfinite(got).all()
    rel = _rel(got, want)
    assert rel <= TOL[dt], f"{fn} {dt}: rel {rel:.3e} vs JAX"


def test_plan_b0_448_every_block_on_k2_taps_on_stages_346():
    module = get_pl_depth_net("ff_effnet", "float32").make()
    plans = plan_encoder(module.encoder, (448, 448))
    by = {p.name: p for p in plans}
    assert len(plans) == 16
    assert [p.name for p in plans if p.tap] == [
        "stage3_block0", "stage4_block0", "stage6_block0"]
    assert by["stage4_block0"].tap == "expand_4" and not by["stage4_block0"].fused
    assert sum(p.fused for p in plans) == 13
    assert by["stage2_block0"].in_hw == (224, 224) and by["stage2_block0"].stride == 2
    assert by["stage7_block0"].in_hw == (14, 14)
    assert by["stage1_block0"].params.we is None  # expand == 1


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("bn_fold", [False, True])
@pytest.mark.parametrize("quantize", ["auto", "", "int8"])
def test_serving_mode_matches_jax(fused, bn_fold, quantize):
    for name in ("ff_effnet", "ff_redweb"):
        assert Trainer.serving_mode(fused, bn_fold, quantize, name) == \
            JTrainer.serving_mode(fused, bn_fold, quantize, name)


def test_jit_predict_memoised_and_unported_modes_raise(ref):
    """jit_predict is memoised per mode, and every serving mode serves: the
    fused encoder, bn_fold and quant (on the QuantState of prepare_quant)."""
    trainer, state = port("float32", ref["float32"]["flat"])
    images = ref["images"]
    fn = trainer.jit_predict(fused=True)
    assert trainer.jit_predict(fused=True) is fn
    np.testing.assert_allclose(np.asarray(fn(state, images)),
                               trainer.predict_fused(state, images).numpy())
    qstate = trainer.prepare_quant(state, images)
    for mode, arg, direct in (("bn_fold", state, trainer.predict_bnfold),
                              ("quant", qstate, trainer.predict_quant)):
        fn = trainer.jit_predict(fused=mode)
        assert trainer.jit_predict(fused=mode) is fn
        got = np.asarray(fn(arg, images))
        assert got.shape == (2, SIZE, SIZE) and np.isfinite(got).all()
        np.testing.assert_array_equal(got, direct(arg, images).numpy())


def test_checkpoints_cross_both_ways(ref, tmp_path):
    """A port-written weights.npz loads in the JAX package with equal
    values, and loading returns a new state, leaving the old one as it was."""
    from pldepth_tpu.models.pretrained import load_backbone

    trainer, state = port("float32", ref["float32"]["flat"])
    path = str(tmp_path / "w.npz")
    save_weights_npz(path, state)
    cfg = JConfig(model_name="ff_smoke", input_size=SIZE, compute_dtype="float32")
    jtr = JTrainer(cfg, steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    jstate = jtr.init_state(jax.random.key(5))
    params, stats = load_backbone(path, jstate.params, jstate.batch_stats)
    got = flat_jax(jstate.replace(params=params, batch_stats=stats))
    for k, v in ref["float32"]["flat"].items():
        np.testing.assert_array_equal(got[k], v)
    assert infer_decoder_head_ch(path) == 32

    fresh = trainer.init_state(torch.Generator().manual_seed(9))
    loaded = load_weights_npz(path, fresh)
    assert loaded.model is not fresh.model
    a = trainer.predict(loaded, ref["images"])
    b = trainer.predict(state, ref["images"])
    assert torch.equal(a, b)
    assert not torch.equal(trainer.predict(fresh, ref["images"]), a)


def test_pipeline_writes_every_item_in_order(tmp_path):
    files = [f"d{i}/img.png" for i in range(2)] + ["x.jpg", "x.png"]
    stems = unique_stems(files)
    assert stems["x.jpg"] == "x_jpg" and stems["x.png"] == "x_png"
    chunks = [files[:3], files[3:]]
    seen = []

    def decode(chunk):
        return np.stack([np.full((4, 4), len(seen) + i, np.float32) for i in range(len(chunk))])

    def infer(x):
        seen.append(len(x))
        return torch.as_tensor(x) * 2

    write = depth_writer(str(tmp_path), False, {f: f"s{i}" for i, f in enumerate(files)})
    assert run_pipeline(chunks, decode, infer, write) == 2
    outs = sorted(os.listdir(tmp_path))
    assert outs == [f"s{i}_depth.npy" for i in range(4)]
    assert np.load(tmp_path / "s3_depth.npy").shape == (4, 4)
