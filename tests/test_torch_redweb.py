"""ff_redweb (ResNet-50 encoder + ReDWeb decoder) in the port, on the CPU.

* The full model in f32 at 96^2 against the TF-reference golden
  (tests/golden/full_model_ff_redweb.npz), weights from the golden's names
  through the port's ``synth_weight``: infer rel < 5e-5, train rel < 5e-4
  (tests/test_full_parity.py:31-38; ff_redweb's train bound is wider
  because its eps 1.001e-5 BNs on caffe-scale inputs amplify batch-stat
  reduction noise).
* At reduced depth (one bottleneck per stage, the 1/16 tap after block 0,
  64^2, batch 2), against the JAX encoder and decoder composed here (the
  JAX registry does not expose ``stage_blocks``), with the JAX package's
  initial weights carried across by the weight bridge and perturbed BN
  statistics: the bridge both ways; the inference forward (rel 1e-5); the
  train forward with its BN running statistics (rel 1e-4), the loss (rel
  1e-5) and the gradients of one ListMLE step against the JAX graph run in
  float64 (its BatchNorms rebuilt in float64 here; the model's last cast
  and the loss stay f32): per tensor ||d|| <= 1e-2 ||ref||, over all of
  them 2e-3. The step is ill-conditioned in f32 (eps 1.001e-5 BNs over 8
  values per channel at 1/32 on caffe-scale inputs): measured, the port's
  f32 gradients are within 1.8e-3 per tensor of the float64 ones (2.7e-4
  over all), JAX's own f32 ones 2.7e-2;
  gradients that are zero by construction are checked to be ~0 in both;
  ``partition_params`` on every path of the JAX tree; the BN-folded graph
  against JAX ``fold_variables(..., "ff_redweb")`` (per-scope eps) at f32
  rel 2e-5; the int8 graph: bitwise int8 inputs and exact int32 sums at
  every dense site, the packed weights, and the whole int8 forward.
* ``cli train`` and ``cli predict`` (bn_fold default, ``--quantize int8``)
  end to end on the CPU.
"""

import os
from typing import Any

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from PIL import Image

from pldepth_torch.models import get_pl_depth_net
from pldepth_torch.models.bn_fold import fold_module
from pldepth_torch.models.layers import BatchNorm, TrainPass
from pldepth_torch.models.pldepth_net import ReDWebFullyFledged, partition_params
from pldepth_torch.models.pretrained import (
    flax_from_state_dict,
    flax_key,
    flax_key_to_torch,
    load_flat,
    overlay_synthetic,
    quant_state_dict_from_flax,
)
from pldepth_torch.models.quantize import pack_module, quant_sites, quantize_activation
from pldepth_torch.ops.conv import conv_pads, same_pads
from pldepth_torch.ops.listmle import pl_ranking_loss
from pldepth_torch.ops.quant_conv import im2col_same
from pldepth_torch.ops.quant_matmul import quant_matmul
from pldepth_torch.data.preprocess import normalize_images
from pldepth_tpu.models import decoders as j_decoders
from pldepth_tpu.models import resnet as j_resnet
from pldepth_tpu.models.bn_fold import fold_variables
from pldepth_tpu.models.decoders import ReDWebDecoder as JDecoder
from pldepth_tpu.models.pldepth_net import partition_params as j_partition_params
from pldepth_tpu.models.quantize import quantize_variables as j_quantize_variables
from pldepth_tpu.models.resnet import ResNet50Encoder as JEncoder
from pldepth_tpu.ops.listmle import pl_ranking_loss as j_pl_ranking_loss

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "full_model_ff_redweb.npz")
SMALL = dict(stage_blocks=(1, 1, 1, 1), c4_tap_block=0)
S, B, RPI, K = 64, 2, 16, 5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def _flat(tree):
    return {"/".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


class JSmall(fnn.Module):
    """``pldepth_tpu`` ReDWebFullyFledged at reduced encoder depth."""

    dtype: Any = jnp.float32
    bn_fold: bool = False
    quant: Any = False

    @fnn.compact
    def __call__(self, x, train: bool = False):
        c5, taps = JEncoder(dtype=self.dtype, bn_fold=self.bn_fold, quant=self.quant,
                            name="encoder", **SMALL)(x, train)
        return JDecoder(dtype=self.dtype, bn_fold=self.bn_fold, quant=self.quant,
                        name="decoder")(c5, taps, train)


def _small(dtype=torch.float32, **mode):
    return ReDWebFullyFledged(dtype, **SMALL, **mode).eval()


def _bn64(eps):
    """The JAX package's ``_bn`` (models/resnet.py, models/decoders.py), which
    builds its BatchNorms in float32, with dtype float64."""
    def make(name, train):
        return fnn.BatchNorm(use_running_average=not train, momentum=0.99, epsilon=eps,
                             dtype=jnp.float64, use_fast_variance=False, name=name)
    return make


def _jax_step_f64(params, stats, x, rankings):
    """One train-mode forward, loss and ``jax.grad`` of the JAX graph in
    float64: (loss, prediction, new batch_stats, grads)."""
    f64 = lambda t: jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), t)  # noqa: E731
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_resnet, "_bn", _bn64(1.001e-5))
        mp.setattr(j_decoders, "_bn", _bn64(1e-3))
        jm, s64 = JSmall(dtype=jnp.float64), f64(stats)

        def loss_fn(p):
            pred, upd = jm.apply({"params": p, "batch_stats": s64}, jnp.asarray(x, jnp.float64),
                                 True, mutable=["batch_stats"])
            return j_pl_ranking_loss(pred[..., 0], jnp.asarray(rankings), impl="xla"), (pred, upd)

        (loss, (pred, upd)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            f64(params))
        assert all(g.dtype == jnp.float64 for g in jax.tree.leaves(grads))
        return (float(loss), np.asarray(pred), jax.tree.map(np.asarray, upd),
                jax.tree.map(np.asarray, grads))


# ------------------------------------------------------------ TF golden --

@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    model = get_pl_depth_net("ff_redweb", "float32").make().eval()
    overlay_synthetic(model, g["names"])
    return g, model


def test_golden_names_cover_the_port_model(golden):
    """The 538 names of the golden load with no missing and no unexpected
    key, so the parity below leaves no tensor at its random init."""
    g, model = golden
    assert len(g["names"]) == 538
    assert {flax_key_to_torch(str(n)) for n in g["names"]} == set(model.state_dict())


@pytest.mark.parametrize("mode,tol", [("infer", 5e-5), ("train", 5e-4)])
def test_f32_matches_tf_golden(golden, mode, tol):
    g, model = golden
    with torch.no_grad():
        pred = model(torch.from_numpy(g["x_raw"]), TrainPass() if mode == "train" else None)
    assert pred.shape == (2, 96, 96, 1)
    rel = _rel(pred.numpy(), g[f"ref_{mode}"])
    assert rel < tol, f"{mode} forward diverges from TF: rel {rel:.2e}"


# ------------------------------------------------- reduced depth vs JAX --

@pytest.fixture(scope="module")
def jref():
    """JAX initial weights with perturbed BN statistics, seeded images
    normalized as the trainer does ("caffe"), fixed rankings, and the JAX
    forwards, loss and gradients on them."""
    jm = JSmall()
    variables = jax.jit(jm.init, static_argnums=(2,))(
        jax.random.key(0), jnp.zeros((1, S, S, 3), jnp.float32), False)
    stats = jax.tree.map(  # tests/test_bn_fold.py: init stats would hide fold faults
        lambda v: v + (0.05 * jnp.arange(v.size, dtype=v.dtype).reshape(v.shape)) % 0.3,
        variables["batch_stats"])
    params = variables["params"]
    rng = np.random.default_rng(0)
    images = rng.uniform(size=(B, S, S, 3)).astype(np.float32)
    x = normalize_images(torch.from_numpy(images), "caffe").numpy()
    idx = rng.integers(0, S * S, (B, RPI, K))
    depths = np.sort(rng.uniform(0.1, 1.0, (B, RPI, K)), axis=-1)[..., ::-1]
    rankings = np.stack([idx, depths], -1).astype(np.float32)

    with jax.default_matmul_precision("highest"):
        infer = jax.jit(lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x, False))(
            params, stats, jnp.asarray(x))
    loss, train_pred, upd, grads = _jax_step_f64(params, stats, x, rankings)
    var = {"params": params, "batch_stats": stats}
    flat = _flat(var)
    model = _small()
    loaded, skipped = load_flat(model, flat)
    assert skipped == 0 and loaded == len(model.state_dict())
    return dict(variables=var, flat=flat, x=x, images=images, rankings=rankings,
                loss=loss, train=train_pred, infer=np.asarray(infer),
                new_stats=_flat({"batch_stats": upd["batch_stats"]}),
                grads=_flat({"params": grads}), model=model)


def test_weight_bridge_both_ways(jref):
    back = flax_from_state_dict(jref["model"].state_dict())
    assert set(back) == set(jref["flat"])
    for k, v in jref["flat"].items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_infer_forward_matches_jax(jref):
    with torch.no_grad():
        got = jref["model"](torch.from_numpy(jref["x"])).numpy()
    assert got.shape == (B, S, S, 1)
    assert _rel(got, jref["infer"]) < 1e-5


def _zero_by_construction(key):
    """Gradients that are zero in exact arithmetic: the bias of a conv that
    feeds a batch-statistics BN (every encoder conv, the head's conv0), and
    the head's conv1 / conv2 biases, a constant shift of the output, to
    which ListMLE is invariant."""
    leaf = key.rsplit("/", 2)
    return leaf[-1] == "bias" and "conv" in leaf[-2] and (
        key.startswith("params/encoder/") or key.startswith("params/decoder/output/"))


def test_train_step_matches_jax_grad(jref):
    """Train-mode forward, new BN running statistics, the ListMLE loss and
    every gradient of one step."""
    model = jref["model"]
    train = TrainPass()
    for p in model.parameters():
        p.grad = None
    pred = model(torch.from_numpy(jref["x"]), train)
    loss = pl_ranking_loss(pred, torch.from_numpy(jref["rankings"]), impl="xla")
    loss.backward()
    assert _rel(pred.detach().numpy(), jref["train"]) < 1e-4
    assert abs(loss.item() / jref["loss"] - 1) < 1e-5

    names = {m: n for n, m in model.named_modules()}
    assert len(train.new_stats) == sum(isinstance(m, BatchNorm) for m in model.modules())
    for bn, (mean, var) in train.new_stats.items():
        path = names[bn].replace(".", "/")
        for leaf, got in (("mean", mean), ("var", var)):
            want = jref["new_stats"][f"batch_stats/{path}/{leaf}"]
            assert _rel(got.numpy(), want) < 1e-4, (path, leaf)

    grads = {flax_key(n, p.dim()): p.grad.numpy() for n, p in model.named_parameters()}
    assert set(grads) == set(jref["grads"])
    for key in grads:
        if key.endswith("/kernel"):
            grads[key] = grads[key].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    gmax = max(np.abs(g).max() for g in jref["grads"].values())
    fro = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    live = [k for k in grads if not _zero_by_construction(k)]
    assert len(live) == 182
    for key in grads:
        if _zero_by_construction(key):
            for g in (grads[key], jref["grads"][key]):
                assert np.abs(g).max() <= 1e-5 * gmax, key
        else:
            assert fro(grads[key], jref["grads"][key]) <= 1e-2, key
    assert fro(np.concatenate([grads[k].ravel() for k in live]),
               np.concatenate([jref["grads"][k].ravel() for k in live])) <= 2e-3
    for p in model.parameters():
        p.grad = None


def test_partition_params_matches_jax_on_every_path(jref):
    want = _flat(j_partition_params(jref["variables"]["params"]))
    for freeze in (True, False):
        want = _flat(j_partition_params(jref["variables"]["params"], freeze))
        got = partition_params([f"params/{k}" for k in want], freeze)
        assert {k[len("params/"):]: v for k, v in got.items()} == want
    frozen = {k for k, v in partition_params(list(jref["flat"])).items() if v == "frozen"}
    assert "params/encoder/stage2_block0/proj_conv/kernel" in frozen
    assert not {k for k in frozen if "/bn" in k or "_bn/" in k}


def test_bn_eps_is_per_scope():
    """Encoder BNs take Keras-v1's 1.001e-5, the decoder's 1e-3; the fold
    reads each BN's own."""
    eps = {n: m.eps for n, m in _small().named_modules() if isinstance(m, BatchNorm)}
    assert {v for n, v in eps.items() if n.startswith("encoder.")} == {1.001e-5}
    assert {v for n, v in eps.items() if n.startswith("decoder.")} == {1e-3}


def test_stem_pads_three_not_same():
    """The 7x7 stride-2 stem pads (3, 3); TF SAME would pad (2, 3)."""
    model = _small()
    assert model.encoder.stem_conv.padding == 3
    assert conv_pads(96, 96, 7, 2, 3) == (3, 3, 3, 3)
    assert same_pads(96, 96, 7, 2) == (2, 3, 2, 3)


def test_float_graph_conv_biases():
    """Encoder convs carry biases; the decoder's float convs do not, but
    the output head's."""
    sd = _small().state_dict()
    convs = {k[: -len(".weight")] for k, v in sd.items() if v.dim() == 4}
    with_bias = {c for c in convs if f"{c}.bias" in sd}
    assert {c for c in convs if c.startswith("encoder.")} <= with_bias
    assert {c for c in convs if c.startswith("decoder.")} & with_bias == {
        "decoder.output.conv0", "decoder.output.conv1", "decoder.output.conv2"}


def test_bnfold_matches_jax_per_scope_eps(jref):
    jfold = fold_variables(jref["variables"], "ff_redweb")
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(lambda v, x: JSmall(bn_fold=True).apply(v, x, False))(
            jfold, jnp.asarray(jref["x"])))
    folded = _small(bn_fold=True)
    folded.load_state_dict(fold_module(jref["model"]), assign=True)
    with torch.no_grad():
        got = folded(torch.from_numpy(jref["x"])).numpy()
        plain = jref["model"](torch.from_numpy(jref["x"])).numpy()
    assert _rel(got, want) < 2e-5
    assert _rel(got, plain) < 2e-5


def test_sparse_tail_names_its_roadmap_item(jref):
    """The sparse tail (``pixels=``, window 1 with the 1x1 head): scores at
    the ranked pixels equal the JAX train forward's map there (rel 1e-4);
    the loss from those scores and every gradient of the step are held to
    the JAX graph in float64 as the dense step is (per tensor 1e-2, over
    all 2e-3)."""
    from pldepth_torch.ops.listmle import pl_ranking_loss_from_scores
    from pldepth_torch.ops.sparse_tail import pixels_of

    model = jref["model"]
    rankings = torch.from_numpy(jref["rankings"])
    for p in model.parameters():
        p.grad = None
    train = TrainPass()
    scores = model(torch.from_numpy(jref["x"]), train, pixels=pixels_of(rankings, S))
    loss = pl_ranking_loss_from_scores(scores, rankings, impl="xla")
    loss.backward()
    flat_idx = jref["rankings"][..., 0].astype(np.int64).reshape(B, -1)
    want = np.take_along_axis(jref["train"].reshape(B, -1), flat_idx, axis=1)
    assert scores.shape == (B, RPI * K) and _rel(scores.detach().numpy(), want) < 1e-4
    assert abs(loss.item() / jref["loss"] - 1) < 1e-5
    grads = {flax_key(n, p.dim()): p.grad.numpy() for n, p in model.named_parameters()}
    for key in grads:
        if key.endswith("/kernel"):
            grads[key] = grads[key].transpose(2, 3, 1, 0)  # OIHW -> HWIO
    gmax = max(np.abs(g).max() for g in jref["grads"].values())
    fro = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)  # noqa: E731
    live = [k for k in grads if not _zero_by_construction(k)]
    for key in grads:
        if _zero_by_construction(key):
            assert np.abs(grads[key]).max() <= 1e-5 * gmax, key
        else:
            assert fro(grads[key], jref["grads"][key]) <= 1e-2, key
    assert fro(np.concatenate([grads[k].ravel() for k in live]),
               np.concatenate([jref["grads"][k].ravel() for k in live])) <= 2e-3
    for p in model.parameters():
        p.grad = None


# ------------------------------------------------------------ int8 graph --

@pytest.fixture(scope="module")
def qref(jref):
    """JAX int8 parameters (bf16 graph, calibrated on the seeded batch) in
    the port's int8 model, and the bf16 input of every dense site in the
    port's int8 forward on them."""
    calib = JSmall(dtype=jnp.bfloat16, quant="calib")
    qvars = j_quantize_variables(jref["variables"], "ff_redweb", calib, [jref["x"]])
    qflat = _flat({"params": qvars["params"]})
    model = _small(torch.bfloat16, quant="int8")
    sd = quant_state_dict_from_flax(qflat)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, assign=True)
    seen, hooks = {}, []
    for name, mod in quant_sites(model).items():
        hooks.append(mod.register_forward_pre_hook(
            lambda m, args, name=name: seen.setdefault(name, args[0].detach().clone())))
    with torch.no_grad():
        got = model(torch.from_numpy(jref["x"])).float().numpy()
    for h in hooks:
        h.remove()
    want = np.asarray(jax.jit(lambda v, x: JSmall(dtype=jnp.bfloat16, quant="int8").apply(
        v, x, False))(qvars, jnp.asarray(jref["x"])), np.float32)
    return dict(qflat=qflat, model=model, inputs=seen, out=got, j_out=want)


# encoder: stem, 3 convs per block, 4 projections; decoder: 14 per fusion
# stage and the head's conv0 (conv1 / conv2 stay float)
SMALL_SITES = [name for name in quant_sites(_small(torch.bfloat16, quant="int8"))]


def test_dense_site_count():
    assert len(SMALL_SITES) == 1 + 3 * 4 + 4 + 3 * 14 + 1
    full = quant_sites(get_pl_depth_net("ff_redweb").make(quant="int8"))
    assert len(full) == 96 and all(m.groups == 1 for m in full.values())


@pytest.mark.parametrize("name", SMALL_SITES)
def test_site_q_and_int32_accumulator_exact(qref, name):
    mod = quant_sites(qref["model"])[name]
    k, _, cin, cout = mod.kernel_q.shape
    x = qref["inputs"][name]
    assert x.dtype == torch.bfloat16
    _, inv, _ = mod.derived()
    q = quantize_activation(x, inv)

    @jax.jit
    def j_q(x, a_scale):  # pldepth_tpu/models/quantize.py:109, :140-142
        inv = (1.0 / a_scale).astype(jnp.bfloat16)
        return jnp.clip(jnp.round(x.astype(jnp.bfloat16) * inv), -127, 127).astype(jnp.int8)

    jq = np.asarray(j_q(jnp.asarray(x.float().numpy()), jnp.float32(mod.a_scale.item())))
    np.testing.assert_array_equal(q.numpy(), jq)
    pad = "SAME" if mod.padding is None else [(mod.padding, mod.padding)] * 2
    j_acc = np.asarray(lax.conv_general_dilated(
        jnp.asarray(jq), jnp.asarray(mod.kernel_q.numpy()), (mod.stride, mod.stride), pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=jnp.int32))
    cols = im2col_same(q, k, mod.stride, mod.padding)
    w = mod.kernel_q.reshape(k * k * cin, cout)
    acc = quant_matmul(cols.contiguous(), w.contiguous(), torch.ones(cout), torch.zeros(cout),
                       1.0, out_dtype=torch.float32).reshape(j_acc.shape)
    np.testing.assert_array_equal(acc.numpy(), j_acc.astype(np.float32))


def test_packing_matches_jax(jref, qref):
    """The port's fold + pack of the same weights: kernel_q bitwise,
    w_scale and bias to 1e-6 (the fold's f32 products in another order)."""
    calib = _small(torch.bfloat16, quant="calib")
    packed = pack_module(jref["model"], calib)
    n = 0
    for key, want in qref["qflat"].items():
        site, leaf = key.rsplit("/", 1)
        if f"{site}/kernel_q" not in qref["qflat"] or leaf == "a_scale":
            continue
        got = packed[".".join(site.split("/")[1:] + [leaf])].numpy()
        if leaf == "kernel_q":
            n += 1
            assert (got != want).mean() < 1e-3, site  # a rounding tie may land apart
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6, err_msg=key)
    assert n == len(SMALL_SITES)


def test_int8_forward_tracks_jax_bf16(qref):
    """The whole bf16 int8 forward on the same int8 parameters. The port's
    dequant epilogue is f32 (the TPU kernel's), the JAX default graph's is
    bf16: over 60 chained sites measured rel 6.7e-2 (ff_smoke's 20: 4.3e-2,
    tests/test_torch_quant.py), so the bound is rel 0.1 with pearson 0.995;
    the f32 test below holds the graph tight."""
    got, want = qref["out"], qref["j_out"]
    assert got.shape == want.shape == (B, S, S, 1) and np.isfinite(got).all()
    assert _rel(got, want) <= 0.1
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] >= 0.995


def test_int8_forward_matches_jax_f32(jref):
    """In f32 both dequant epilogues are f32: the int8 graphs agree to
    rounding (tests/test_torch_quant.py's f32 bound)."""
    calib = JSmall(dtype=jnp.float32, quant="calib")
    qvars = j_quantize_variables(jref["variables"], "ff_redweb", calib, [jref["x"]])
    want = np.asarray(jax.jit(lambda v, x: JSmall(quant="int8").apply(v, x, False))(
        qvars, jnp.asarray(jref["x"])))
    model = _small(quant="int8")
    model.load_state_dict(quant_state_dict_from_flax(_flat({"params": qvars["params"]})),
                          assign=True)
    with torch.no_grad():
        got = model(torch.from_numpy(jref["x"])).numpy()
    assert _rel(got, want) <= 1e-5


# -------------------------------------------------------------- commands --

def test_cli_train_and_predict_end_to_end(tmp_path, capsys):
    """``cli train --model_name ff_redweb`` writes weights.npz; ``cli
    predict`` serves them with its default flags (bn_fold for this model)
    and with ``--quantize int8``; the default maps equal predict_bnfold on
    the loaded weights."""
    import json

    from pldepth_torch.cli import main
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.train import Trainer
    from pldepth_torch.train.checkpoint import load_weights_npz

    size = 32
    assert main(["train", "--device", "cpu", "--model_name", "ff_redweb", "--dataset",
                 "synthetic", "--input_size", str(size), "--ds_size", "4", "--batch_size", "2",
                 "--epochs", "1", "--ranking_size", "5", "--rankings_per_image", "8",
                 "--sampling_type", "0", "--freeze_encoder", "true",
                 "--output_dir", str(tmp_path), "--run_name", "r"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["step"] == 2 and np.isfinite(out["loss"]).all()
    weights = out["weights"]
    imgs = tmp_path / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8)).save(imgs / f"i{i}.png")
    maps = {}
    for flags in ([], ["--quantize", "int8"]):
        d = tmp_path / ("o" + "".join(flags))
        assert main(["predict", "--device", "cpu", "--model_name", "ff_redweb", "--input_size",
                     str(size), "--batch_size", "2", "--load_model_path", weights, "--inputs",
                     str(imgs), "--out_dir", str(d), "--save_png", "false", *flags]) == 0
        maps[tuple(flags)] = np.stack([np.load(d / f"i{i}_depth.npy") for i in range(3)])
        assert maps[tuple(flags)].shape == (3, size, size)
        assert np.isfinite(maps[tuple(flags)]).all()
    tr = Trainer(ExperimentConfig(model_name="ff_redweb", input_size=size), device="cpu")
    state = load_weights_npz(weights, tr.init_state())
    x = np.stack([np.asarray(Image.open(imgs / f"i{i}.png"), np.float32) / 255 for i in range(3)])
    np.testing.assert_allclose(maps[()], tr.predict_bnfold(state, x).float().numpy(),
                               rtol=1e-6, atol=1e-6)
    assert np.corrcoef(maps[()].ravel(), maps[("--quantize", "int8")].ravel())[0, 1] > 0.9
