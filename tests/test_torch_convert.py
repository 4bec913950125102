"""The port's Keras weight conversion (pldepth_torch/models/convert.py)
against the JAX package's (pldepth_tpu/models/convert.py), at 64^2: Keras
EfficientNetB0 and ResNet50 backbones (``weights=None``) and full models
give the same flat dict (keys and bytes) through both;
``export_npz_to_keras`` writes an npz back into a Keras graph bitwise
(strict, and non-strict into a bare backbone) and refuses a short npz with
JAX's error; a converted npz loads into the port's model with every tensor
(``load_flat``'s counts) and, through ``--pretrained_path``, the port's f32
forward is within rel 1e-5 of the JAX package's; ``cli convert`` and ``cli
convert --reverse`` (bare backbone and ``--template``) round-trip bitwise.

The reference's own model code (tools/ref_models.py imports it from outside
the repository) is not part of the checkout, so the full models are built
here to the reference's layout, as the collectors read it: ff_effnet's
skip-concat decoder wired after B0's ``top_activation`` as the JAX
decoder is (five conv / BN / ReLU / upsample stages over the expand taps,
then the head), and ff_redweb's decoder as three ``FeatureFusionLayer`` and
one ``AdaptiveOutputLayer`` carrying the reference's attribute names
(conv0, bn0, block_left, ...) at the models' shapes. One Keras model per
family and kind, built once for the module."""

import json

import numpy as np
import pytest
import torch

from pldepth_torch.models import convert as pcv
from pldepth_tpu.models import convert as jcv

tf = pytest.importorskip("tensorflow")

torch.set_num_threads(1)
S = 64
FAMILIES = ("ff_effnet", "ff_redweb")


def _effnet_full():
    """B0 with the skip-concat decoder (pl_hourglass.py:59-98)."""
    L = tf.keras.layers
    b0 = tf.keras.applications.EfficientNetB0(include_top=False, weights=None,
                                              input_shape=(S, S, 3))
    taps = [b0.get_layer(f"block{n}a_expand_activation").output for n in (6, 4, 3)]
    x = b0.get_layer("top_activation").output
    for ch, tap in zip((672, 240, 144, 32), taps + [None]):
        x = L.ReLU()(L.BatchNormalization()(L.Conv2D(ch, 3, padding="same")(x)))
        x = L.UpSampling2D(interpolation="bilinear")(x)
        if tap is not None:
            x = L.Concatenate()([x, tap])
    x = L.ReLU()(L.BatchNormalization()(L.Conv2D(32, 3, padding="same")(x)))
    x = L.Conv2D(1, 3, padding="same")(L.UpSampling2D(interpolation="bilinear")(x))
    return tf.keras.Model(b0.input, x)


def _redweb_full():
    """ResNet-50 with the ReDWeb decoder's layers (redweb.py:225-351) under
    the reference's class and attribute names, each sublayer built at the
    shape of the model's tensor it maps to."""
    from pldepth_torch.models import get_pl_depth_net
    from pldepth_torch.models.pretrained import flax_from_state_dict

    L = tf.keras.layers
    shapes = {k: v.shape for k, v in flax_from_state_dict(
        get_pl_depth_net("ff_redweb", "float32").make().state_dict()).items()}

    def conv(prefix):
        kh, kw, cin, cout = shapes[f"params/decoder/{prefix}/kernel"]
        layer = L.Conv2D(cout, (kh, kw), use_bias=f"params/decoder/{prefix}/bias" in shapes)
        layer.build((None, None, None, cin))
        return layer

    def bn(prefix):
        layer = L.BatchNormalization()
        layer.build((None, None, None, shapes[f"params/decoder/{prefix}/scale"][0]))
        return layer

    class Holder(L.Layer):
        def __init__(self, parts):
            super().__init__()
            for name, layer in parts.items():
                setattr(self, name, layer)

        def build(self, input_shape):  # the parts are built above
            pass

        def call(self, x):
            return x

    class BottleneckConvLayer(Holder):
        pass

    class FeatureFusionLayer(Holder):
        pass

    class AdaptiveOutputLayer(Holder):
        pass

    def pair(prefix):
        return BottleneckConvLayer(
            {**{f"conv{j}": conv(f"{prefix}/u{j // 3}_conv{j % 3}") for j in range(6)},
             **{f"bn{j}": bn(f"{prefix}/u{j // 3}_bn{j % 3}") for j in range(6)}})

    r50 = tf.keras.applications.ResNet50(include_top=False, weights=None,
                                         input_shape=(S, S, 3))
    x = r50.output
    for i in range(3):
        f = f"fusion{i}"
        x = FeatureFusionLayer({"conv0": conv(f"{f}/lateral_conv"), "bn0": bn(f"{f}/lateral_bn"),
                                "conv1": conv(f"{f}/up_conv"), "bn1": bn(f"{f}/up_bn"),
                                "block_left": pair(f"{f}/lateral_block"),
                                "block_down": pair(f"{f}/fuse_block")})(x)
    x = AdaptiveOutputLayer({"conv0": conv("output/conv0"), "bn0": bn("output/bn0"),
                             "conv1": conv("output/conv1"), "conv2": conv("output/conv2")})(x)
    return tf.keras.Model(r50.input, x)


@pytest.fixture(scope="module")
def keras_models():
    shape = (S, S, 3)
    return {
        ("ff_effnet", "backbone"): tf.keras.applications.EfficientNetB0(
            include_top=False, weights=None, input_shape=shape),
        ("ff_redweb", "backbone"): tf.keras.applications.ResNet50(
            include_top=False, weights=None, input_shape=shape),
        ("ff_effnet", "full"): _effnet_full(),
        ("ff_redweb", "full"): _redweb_full(),
    }


def _equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("kind", ["backbone", "full"])
@pytest.mark.parametrize("family", FAMILIES)
def test_converted_dict_equals_jax(keras_models, family, kind):
    km = keras_models[(family, kind)]
    assert pcv._looks_like_full_model(km, family) == jcv._looks_like_full_model(km, family) \
        == (kind == "full")
    if kind == "full":
        got, want = pcv.convert_full_keras_model(km, family), jcv.convert_full_keras_model(
            km, family)
        _equal(pcv.entries_to_arrays(pcv.collect_full_model(km, family)), want)
    elif family == "ff_effnet":
        got, want = pcv.convert_keras_efficientnet(km), jcv.convert_keras_efficientnet(km)
    else:
        got, want = pcv.convert_keras_resnet50(km), jcv.convert_keras_resnet50(km)
    _equal(got, want)
    assert any(k.startswith("params/encoder/stage") for k in got)
    assert any(k.startswith("params/decoder/") for k in got) == (kind == "full")


@pytest.mark.parametrize("family", FAMILIES)
def test_export_roundtrips_bitwise(keras_models, family):
    """Full graph, strict: every variable takes its synth_weight value and
    reads back bitwise; the bare backbone, non-strict, takes the encoder
    part of the same npz; a full graph refuses an encoder-only npz (strict)
    with the JAX package's error. The graphs get their own values back."""
    full, bare = keras_models[(family, "full")], keras_models[(family, "backbone")]
    saved = {m: pcv.entries_to_arrays(pcv.collect_full_model(m, family) if m is full else
                                      pcv.collect_keras_efficientnet(m)
                                      if family == "ff_effnet" else
                                      pcv.collect_keras_resnet50(m)) for m in (full, bare)}
    new = {k: pcv.synth_weight(k, v.shape) for k, v in saved[full].items()}
    try:
        assert pcv.export_npz_to_keras(full, family, new, strict=True) == len(new)
        _equal(pcv.convert_full_keras_model(full, family), new)
        n = pcv.export_npz_to_keras(bare, family, new, strict=False)
        assert n == len(saved[bare]) < len(new)
        back = pcv.entries_to_arrays(pcv.collect_keras_efficientnet(bare)
                                     if family == "ff_effnet"
                                     else pcv.collect_keras_resnet50(bare))
        _equal(back, {k: new[k] for k in back})
        enc = {k: v for k, v in new.items() if "/decoder/" not in k}
        with pytest.raises(ValueError) as got:
            pcv.export_npz_to_keras(full, family, enc, strict=True)
        with pytest.raises(ValueError) as want:
            jcv.export_npz_to_keras(full, family, enc, strict=True)
        assert str(got.value) == str(want.value)
    finally:
        pcv.export_npz_to_keras(full, family, saved[full])
        pcv.export_npz_to_keras(bare, family, saved[bare], strict=False)


def _jax_predict(npz, family, x):
    import jax

    from pldepth_tpu.core.config import ExperimentConfig
    from pldepth_tpu.core.mesh import make_mesh
    from pldepth_tpu.train import Trainer

    cfg = ExperimentConfig(model_name=family, input_size=S, compute_dtype="float32",
                           pretrained_path=npz)
    tr = Trainer(cfg, steps_per_epoch=1, mesh=make_mesh(devices=jax.devices()[:1]))
    return np.asarray(jax.jit(tr.predict)(tr.init_state(), x))


@pytest.mark.parametrize("family", FAMILIES)
def test_converted_npz_loads_into_the_port_model(keras_models, tmp_path, family):
    from pldepth_torch.core.config import ExperimentConfig
    from pldepth_torch.models import get_pl_depth_net
    from pldepth_torch.models.pretrained import flax_key_to_torch, load_flat
    from pldepth_torch.train import Trainer

    km = keras_models[(family, "full")]
    arrays = pcv.convert_full_keras_model(km, family)
    module = get_pl_depth_net(family, "float32").make()
    assert load_flat(module, arrays) == (len(arrays), 0)
    assert {flax_key_to_torch(k) for k in arrays} == set(module.state_dict())
    npz = str(tmp_path / "w.npz")
    np.savez(npz, **arrays)
    tr = Trainer(ExperimentConfig(model_name=family, input_size=S, compute_dtype="float32",
                                  pretrained_path=npz), device="cpu")
    x = np.random.default_rng(0).uniform(size=(2, S, S, 3)).astype(np.float32)
    got = tr.predict(tr.init_state(), x).numpy()
    want = _jax_predict(npz, family, x)
    assert got.shape == want.shape == (2, S, S) and np.isfinite(got).all()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


def _cli(*argv):
    import contextlib
    import io

    from pldepth_torch.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(list(argv)) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_convert_and_reverse_roundtrip(keras_models, tmp_path):
    """Backbone: .h5 -> npz -> --reverse into a built B0 -> npz, bitwise;
    the JAX command's npz is the same file content."""
    h5 = str(tmp_path / "b0.h5")
    keras_models[("ff_effnet", "backbone")].save(h5)
    npz1 = str(tmp_path / "enc.npz")
    assert _cli("convert", "--weights", h5, "--model_name", "ff_effnet",
                "--out", npz1) == {"out": npz1, "model_name": "ff_effnet"}
    want = jcv.convert_keras_efficientnet(keras_models[("ff_effnet", "backbone")])
    with np.load(npz1) as a:
        _equal({k: a[k] for k in a.files}, want)
    h5_back = str(tmp_path / "b0_back.h5")
    out = _cli("convert", "--reverse", "--weights", npz1, "--model_name", "ff_effnet",
               "--out", h5_back, "--input_size", str(S))
    assert out == {"out": h5_back, "model_name": "ff_effnet", "tensors_assigned": len(want)}
    npz2 = str(tmp_path / "enc2.npz")
    _cli("convert", "--weights", h5_back, "--model_name", "ff_effnet", "--out", npz2)
    with np.load(npz2) as b:
        _equal({k: b[k] for k in b.files}, want)


def test_cli_convert_reverse_into_a_template(keras_models, tmp_path):
    """Full model: an npz fills a reference-architecture .h5 (a functional
    Model, the recipe of docs/PARITY.md) and converts back bitwise."""
    plain = keras_models[("ff_effnet", "full")]
    template = str(tmp_path / "ref_effnet.h5")
    plain.save(template)
    arrays = {k: pcv.synth_weight(k, v.shape)
              for k, v in pcv.convert_full_keras_model(plain, "ff_effnet").items()}
    npz = str(tmp_path / "weights.npz")
    np.savez(npz, **arrays)
    h5_out = str(tmp_path / "exported.h5")
    out = _cli("convert", "--reverse", "--weights", npz, "--model_name", "ff_effnet",
               "--out", h5_out, "--template", template)
    assert out["tensors_assigned"] == len(arrays)
    npz2 = str(tmp_path / "weights2.npz")
    _cli("convert", "--weights", h5_out, "--model_name", "ff_effnet", "--out", npz2)
    with np.load(npz2) as b:
        _equal({k: b[k] for k in b.files}, arrays)
