"""Keras -> flat-npz weight conversion, both ways: the port's copy of
``pldepth_tpu/models/convert.py``.

The reference took ImageNet encoders straight from ``keras.applications``
(pl_hourglass.py:48, redweb.py:410) and saved trained models as Keras ``.h5``
(PLDepth.py:180-181, loaded again at test_data_eval.py:70-85). This module
maps those weights onto the JAX package's flat npz layout
("params/encoder/stem_conv/kernel", "batch_stats/decoder/bn0/mean"), which
the port's ``--pretrained_path`` (models/pretrained.py:load_backbone) and
``load_weights_npz`` read, and writes such an npz back into a Keras model.
numpy only at import; TensorFlow is imported by the file entry points.

Name maps:
  EfficientNet  block{S}{letter}_expand_conv -> encoder/stage{S}_block{i}/expand_conv ...
  ResNet50      conv{S}_block{B}_{1,2,3}_conv -> encoder/stage{S}_block{B-1}/conv{1,2,3},
                _0_conv/_0_bn -> proj_conv/proj_bn
  EffNet decoder (positional, graph order after "top_activation"):
                Conv2D[0..4] -> decoder/conv{0..4}, Conv2D[5] -> decoder/head,
                BatchNormalization[0..4] -> decoder/bn{0..4}
  ReDWeb decoder (by layer attribute):
                FeatureFusionLayer[i].{conv0,bn0,conv1,bn1} ->
                  decoder/fusion{i}/{lateral_conv,lateral_bn,up_conv,up_bn},
                .block_left/.block_down conv{j},bn{j} (j=0..5) ->
                  {lateral_block,fuse_block}/u{j//3}_{conv,bn}{j%3},
                AdaptiveOutputLayer.{conv0,bn0,conv1,conv2} ->
                  decoder/output/{conv0,bn0,conv1,conv2}

The collectors return live Keras variables (plus a layout transform tag), so
one name map serves both directions: reading weights out (conversion) and
assigning values in (``assign_entries``, e.g. ``synth_weight`` values for
reproducible cross-framework goldens).
"""

from __future__ import annotations

import string
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from pldepth_torch.models.pretrained import synth_weight  # noqa: F401  (re-exported, as the JAX module defines it)

# (keras variable, transform tag). Transforms map Keras layout -> Flax layout;
# they must be involutions or have a defined inverse for assign_entries.
Entry = Tuple[Any, Optional[str]]


def _apply_transform(arr: np.ndarray, tag: Optional[str]) -> np.ndarray:
    if tag is None:
        return arr
    if tag == "dwconv":  # keras (k,k,C,1) <-> flax (k,k,1,C); self-inverse
        return np.transpose(arr, (0, 1, 3, 2))
    raise ValueError(f"unknown transform {tag}")


def _bn_entries(prefix: str, weights) -> Dict[str, Entry]:
    gamma, beta, mean, var = weights
    return {
        f"params/{prefix}/scale": (gamma, None),
        f"params/{prefix}/bias": (beta, None),
        f"batch_stats/{prefix}/mean": (mean, None),
        f"batch_stats/{prefix}/var": (var, None),
    }


def _conv_entries(prefix: str, weights) -> Dict[str, Entry]:
    out: Dict[str, Entry] = {f"params/{prefix}/kernel": (weights[0], None)}
    if len(weights) > 1:
        out[f"params/{prefix}/bias"] = (weights[1], None)
    return out


def entries_to_arrays(entries: Dict[str, Entry]) -> Dict[str, np.ndarray]:
    return {
        name: _apply_transform(np.asarray(var), tag)
        for name, (var, tag) in entries.items()
    }


def assign_entries(
    entries: Dict[str, Entry], fn: Callable[[str, Tuple[int, ...]], np.ndarray]
) -> None:
    """Assign ``fn(name, flax_shape)`` into every collected Keras variable
    (inverting the layout transform), so a Keras model can be populated with
    values that are reproducible from the *Flax-side* names alone."""
    for name, (var, tag) in entries.items():
        flax_shape = _apply_transform(np.asarray(var), tag).shape
        var.assign(_apply_transform(fn(name, flax_shape), tag))


# --------------------------------------------------------------------------
# Encoders (keras.applications)
# --------------------------------------------------------------------------


def collect_keras_efficientnet(keras_model) -> Dict[str, Entry]:
    """Keras EfficientNetBX(include_top=False) -> name->variable map."""
    out: Dict[str, Entry] = {}
    by_name = {l.name: l for l in keras_model.layers}

    out.update(_conv_entries("encoder/stem_conv", by_name["stem_conv"].weights))
    out.update(_bn_entries("encoder/stem_bn", by_name["stem_bn"].weights))
    out.update(_conv_entries("encoder/top_conv", by_name["top_conv"].weights))
    out.update(_bn_entries("encoder/top_bn", by_name["top_bn"].weights))

    letters = string.ascii_lowercase
    for name, layer in by_name.items():
        if not name.startswith("block"):
            continue
        stage = int(name[5])
        idx = letters.index(name[6])
        me = f"encoder/stage{stage}_block{idx}"
        part = name[8:]  # after "block{S}{l}_"
        if part == "expand_conv":
            out.update(_conv_entries(f"{me}/expand_conv", layer.weights))
        elif part == "expand_bn":
            out.update(_bn_entries(f"{me}/expand_bn", layer.weights))
        elif part == "dwconv":
            out[f"params/{me}/dw_conv/kernel"] = (layer.weights[0], "dwconv")
        elif part == "bn":
            out.update(_bn_entries(f"{me}/dw_bn", layer.weights))
        elif part == "se_reduce":
            out.update(_conv_entries(f"{me}/se/reduce", layer.weights))
        elif part == "se_expand":
            out.update(_conv_entries(f"{me}/se/expand", layer.weights))
        elif part == "project_conv":
            out.update(_conv_entries(f"{me}/project_conv", layer.weights))
        elif part == "project_bn":
            out.update(_bn_entries(f"{me}/project_bn", layer.weights))
    return out


def collect_keras_resnet50(keras_model) -> Dict[str, Entry]:
    """Keras ResNet50(include_top=False) -> name->variable map."""
    out: Dict[str, Entry] = {}
    by_name = {l.name: l for l in keras_model.layers}
    out.update(_conv_entries("encoder/stem_conv", by_name["conv1_conv"].weights))
    out.update(_bn_entries("encoder/stem_bn", by_name["conv1_bn"].weights))

    for name, layer in by_name.items():
        if not name.startswith("conv") or "_block" not in name:
            continue
        stage = int(name[4])  # 2..5
        rest = name.split("_")  # conv2, block1, 1, conv/bn
        if len(rest) != 4 or rest[3] not in ("conv", "bn"):
            continue  # skip _add / _out / _relu layers
        block = int(rest[1][5:]) - 1
        slot, kind = rest[2], rest[3]
        me = f"encoder/stage{stage}_block{block}"
        target = {"0": "proj", "1": "1", "2": "2", "3": "3"}[slot]
        if kind == "conv":
            pref = f"{me}/proj_conv" if target == "proj" else f"{me}/conv{target}"
            out.update(_conv_entries(pref, layer.weights))
        elif kind == "bn":
            pref = f"{me}/proj_bn" if target == "proj" else f"{me}/bn{target}"
            out.update(_bn_entries(pref, layer.weights))
    return out


def convert_keras_efficientnet(keras_model) -> Dict[str, np.ndarray]:
    """Keras EfficientNetBX(include_top=False) -> flat npz dict."""
    return entries_to_arrays(collect_keras_efficientnet(keras_model))


def convert_keras_resnet50(keras_model) -> Dict[str, np.ndarray]:
    """Keras ResNet50(include_top=False) -> flat npz dict."""
    return entries_to_arrays(collect_keras_resnet50(keras_model))


# --------------------------------------------------------------------------
# Reference decoders (full-model import)
# --------------------------------------------------------------------------


def _decoder_layers_after(keras_model, boundary_layer: str):
    """Layers strictly after ``boundary_layer`` in the model's graph order
    (keras_model.layers is topologically sorted for functional models)."""
    names = [l.name for l in keras_model.layers]
    idx = names.index(boundary_layer)
    return keras_model.layers[idx + 1 :]


def collect_effnet_decoder(keras_model) -> Dict[str, Entry]:
    """The reference skip-concat decoder (pl_hourglass.py:59-98).

    The decoder is anonymous functional layers appended after the encoder's
    "top_activation"; the six Conv2D and five BatchNormalization layers map
    positionally (graph order == creation order == stage order)."""
    tail = _decoder_layers_after(keras_model, "top_activation")
    convs = [l for l in tail if type(l).__name__ == "Conv2D"]
    bns = [l for l in tail if type(l).__name__ == "BatchNormalization"]
    if len(convs) != 6 or len(bns) != 5:
        raise ValueError(
            f"not a reference ff_effnet decoder: {len(convs)} convs / "
            f"{len(bns)} bns after top_activation (want 6/5)"
        )
    out: Dict[str, Entry] = {}
    for i in range(5):
        out.update(_conv_entries(f"decoder/conv{i}", convs[i].weights))
        out.update(_bn_entries(f"decoder/bn{i}", bns[i].weights))
    out.update(_conv_entries("decoder/head", convs[5].weights))
    return out


def _bottleneck_pair_entries(prefix: str, block) -> Dict[str, Entry]:
    """Reference BottleneckConvLayer (redweb.py:67-183): two residual units,
    convs conv0..conv5 / bns bn0..bn5 -> u{0,1}_{conv,bn}{0..2}."""
    out: Dict[str, Entry] = {}
    for j in range(6):
        u, slot = divmod(j, 3)
        out.update(
            _conv_entries(f"{prefix}/u{u}_conv{slot}", getattr(block, f"conv{j}").weights)
        )
        out.update(
            _bn_entries(f"{prefix}/u{u}_bn{slot}", getattr(block, f"bn{j}").weights)
        )
    return out


def collect_redweb_decoder(keras_model) -> Dict[str, Entry]:
    """The reference ReDWeb decoder (redweb.py:225-351,423-428): three
    FeatureFusionLayers + AdaptiveOutputLayer, matched by class name and
    mapped through their layer attributes."""
    fusions = [l for l in keras_model.layers if type(l).__name__ == "FeatureFusionLayer"]
    outputs = [l for l in keras_model.layers if type(l).__name__ == "AdaptiveOutputLayer"]
    if len(fusions) != 3 or len(outputs) != 1:
        raise ValueError(
            f"not a reference ff_redweb decoder: {len(fusions)} fusion / "
            f"{len(outputs)} output layers (want 3/1)"
        )
    out: Dict[str, Entry] = {}
    for i, ff in enumerate(fusions):
        base = f"decoder/fusion{i}"
        out.update(_conv_entries(f"{base}/lateral_conv", ff.conv0.weights))
        out.update(_bn_entries(f"{base}/lateral_bn", ff.bn0.weights))
        out.update(_conv_entries(f"{base}/up_conv", ff.conv1.weights))
        out.update(_bn_entries(f"{base}/up_bn", ff.bn1.weights))
        out.update(_bottleneck_pair_entries(f"{base}/lateral_block", ff.block_left))
        out.update(_bottleneck_pair_entries(f"{base}/fuse_block", ff.block_down))
    ao = outputs[0]
    out.update(_conv_entries("decoder/output/conv0", ao.conv0.weights))
    out.update(_bn_entries("decoder/output/bn0", ao.bn0.weights))
    out.update(_conv_entries("decoder/output/conv1", ao.conv1.weights))
    out.update(_conv_entries("decoder/output/conv2", ao.conv2.weights))
    return out


def collect_full_model(keras_model, model_name: str) -> Dict[str, Entry]:
    """Encoder + decoder map for a complete reference-trained model
    (the graphs built by pl_hourglass.py:43-100 / redweb.py:402-434)."""
    if "effnet" in model_name:
        out = collect_keras_efficientnet(keras_model)
        out.update(collect_effnet_decoder(keras_model))
    elif "redweb" in model_name or "resnet" in model_name:
        out = collect_keras_resnet50(keras_model)
        out.update(collect_redweb_decoder(keras_model))
    else:
        raise ValueError(f"unknown model family for {model_name}")
    return out


def convert_full_keras_model(keras_model, model_name: str) -> Dict[str, np.ndarray]:
    """Complete reference model (encoder + decoder + head) -> flat npz dict."""
    return entries_to_arrays(collect_full_model(keras_model, model_name))


def _looks_like_full_model(keras_model, model_name: str) -> bool:
    if "redweb" in model_name or "resnet" in model_name:
        return any(type(l).__name__ == "FeatureFusionLayer" for l in keras_model.layers)
    try:
        tail = _decoder_layers_after(keras_model, "top_activation")
    except ValueError:
        return False
    return any(type(l).__name__ == "Conv2D" for l in tail)


def export_npz_to_keras(
    keras_model, model_name: str, tensors: Dict[str, np.ndarray],
    strict: bool = True,
) -> int:
    """Reverse direction: write Flax-side tensors INTO a live Keras model.

    ``tensors`` is the flat npz layout written by train/checkpoint.py
    ``save_weights_npz`` / ``models/pretrained.py`` ``save_backbone``
    ("params/encoder/stem_conv/kernel", ...). Every collected Keras
    variable gets its value from the matching Flax path with the layout
    transform inverted (the transforms are involutions, see
    ``_apply_transform``), so reference-side tooling can evaluate a
    model trained by this package. Returns the number of tensors assigned.

    ``strict``: raise if any collected Keras variable has no tensor (a
    trained full-model export must be complete); ``strict=False`` assigns
    the intersection (e.g. encoder-only npz into a bare backbone).
    """
    if _looks_like_full_model(keras_model, model_name):
        entries = collect_full_model(keras_model, model_name)
    elif "effnet" in model_name:
        entries = collect_keras_efficientnet(keras_model)
    elif "redweb" in model_name or "resnet" in model_name:
        entries = collect_keras_resnet50(keras_model)
    else:
        raise ValueError(f"unknown model family for {model_name}")
    missing = [n for n in entries if n not in tensors]
    if missing:
        if strict:
            raise ValueError(
                f"reverse export: {len(missing)} Keras variables have no "
                f"tensor in the npz, e.g. {sorted(missing)[:5]}"
            )
        entries = {n: e for n, e in entries.items() if n in tensors}

    def lookup(name: str, flax_shape: Tuple[int, ...]) -> np.ndarray:
        arr = np.asarray(tensors[name], np.float32)
        if arr.shape != flax_shape:
            raise ValueError(
                f"reverse export {name}: npz shape {arr.shape} != "
                f"Keras-side (Flax layout) shape {flax_shape}"
            )
        return arr

    assign_entries(entries, lookup)
    return len(entries)


def export_npz_to_keras_file(
    npz_path: str,
    model_name: str,
    out_h5: str,
    template_h5: Optional[str] = None,
    input_size: int = 448,
    strict: Optional[bool] = None,
) -> Tuple[str, int]:
    """Offline reverse entry: weights npz -> Keras ``.h5`` the reference
    stack can open (test_data_eval.py:70-85 loads exactly such files).

    ``template_h5``: an existing Keras model file with the target
    architecture (e.g. a reference-trained ``.h5``) — its weights are
    replaced wholesale. Without it, a bare ``keras.applications`` backbone
    graph is built for the family (EfficientNetB0-B7 by the ``_b{N}``
    suffix, ResNet-50 for ff_redweb) and populated from the npz's encoder
    tensors — enough for reference-side feature/backbone tooling; full
    decoder export needs the template (the reference decoder graph isn't
    rebuilt here to keep this module reference-code-free; see
    tools/ref_models.py build_reference_model for an offline builder).
    """
    import tensorflow as tf

    with np.load(npz_path) as archive:
        tensors = {k: archive[k] for k in archive.files}
    if template_h5:
        keras_model = tf.keras.models.load_model(template_h5, compile=False)
        n = export_npz_to_keras(
            keras_model, model_name, tensors,
            strict=True if strict is None else strict,
        )
    else:
        if "effnet" in model_name:
            variant = 0
            if "_b" in model_name:
                variant = int(model_name.rsplit("_b", 1)[1] or 0)
            builder = getattr(tf.keras.applications, f"EfficientNetB{variant}")
        else:
            builder = tf.keras.applications.ResNet50
        keras_model = builder(
            include_top=False, weights=None,
            input_shape=(input_size, input_size, 3),
        )
        # encoder-only by construction: the npz may also hold decoder/
        # optimizer tensors that have no home in a bare backbone
        n = export_npz_to_keras(
            keras_model, model_name, tensors,
            strict=False if strict is None else strict,
        )
    keras_model.save(out_h5)
    return out_h5, n


def convert_keras_file(h5_or_dir: str, model_name: str, out_npz: str) -> str:
    """Offline entry: load a Keras model file and write the converted npz.

    Accepts either a bare ``keras.applications`` backbone (ImageNet import)
    or a complete reference-trained model (test_data_eval.py:70-85); the
    decoder is mapped automatically when present. Note: reference ff_redweb
    ``.h5`` files contain custom layers — loading them requires the reference
    classes on the path (tools/ref_models.py installs the import shims).
    """
    import tensorflow as tf

    keras_model = tf.keras.models.load_model(h5_or_dir, compile=False)
    if _looks_like_full_model(keras_model, model_name):
        tensors = convert_full_keras_model(keras_model, model_name)
    elif "effnet" in model_name:
        tensors = convert_keras_efficientnet(keras_model)
    elif "redweb" in model_name or "resnet" in model_name:
        tensors = convert_keras_resnet50(keras_model)
    else:
        raise ValueError(f"unknown model family for {model_name}")
    np.savez(out_npz, **tensors)
    return out_npz
