"""Weight bridge between the JAX package's flattened ``.npz`` layout and the
port's ``state_dict`` (``pldepth_tpu/models/pretrained.py``).

The JAX archives map flattened pytree paths to arrays:
``params/encoder/stage2_block0/dw_conv/kernel`` (conv, HWIO),
``params/.../expand_bn/scale|bias`` and ``batch_stats/.../mean|var``. The
port keeps flax's module names, so a key maps by rule alone:

==========================  ==========================================
flax                        port ``state_dict``
==========================  ==========================================
params/a/b/kernel (4-D)     a.b.weight, HWIO -> OIHW; a depthwise
                            (k, k, 1, C) kernel becomes (C, 1, k, k)
params/a/b/scale            a.b.weight (BatchNorm gamma)
params/a/b/bias             a.b.bias
batch_stats/a/b/mean        a.b.running_mean
batch_stats/a/b/var         a.b.running_var
==========================  ==========================================

``decoder/head`` is flax ``_ConvParams`` (decoders.py:40-57) with the same
kernel/bias names, so it follows the same rule. The int8 serving tree of
``prepare_quant`` maps with :func:`quant_state_dict_from_flax`.
"""

from __future__ import annotations

import logging
import zlib
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
from torch import nn

log = logging.getLogger(__name__)

_PARAM_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def flax_key_to_torch(key: str) -> str:
    """'params/encoder/stem_conv/kernel' -> 'encoder.stem_conv.weight'."""
    coll, *path, leaf = key.split("/")
    table = {"params": _PARAM_LEAF, "batch_stats": _STAT_LEAF}.get(coll)
    if table is None or leaf not in table or not path:
        raise KeyError(f"not a flax parameter path: {key!r}")
    return ".".join(path + [table[leaf]])


def flax_entry_to_torch(key: str, arr: np.ndarray) -> Tuple[str, torch.Tensor]:
    """One flax (key, array) -> (state_dict name, f32 CPU tensor)."""
    name = flax_key_to_torch(key)
    arr = np.asarray(arr, np.float32)
    if key.endswith("/kernel"):
        if arr.ndim != 4:
            raise ValueError(f"conv kernel {key} must be 4-D HWIO, got {arr.shape}")
        arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    return name, torch.from_numpy(np.array(arr, order="C"))


def state_dict_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flattened flax arrays -> port ``state_dict`` tensors (f32, CPU)."""
    return dict(flax_entry_to_torch(k, v) for k, v in flat.items())


def quant_state_dict_from_flax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """A flattened JAX ``prepare_quant`` tree -> the port's ``quant="int8"``
    ``state_dict``. A quantization site's leaves keep their names and the
    JAX layout (``kernel_q`` int8 HWIO, ``w_scale``, ``bias``, ``a_scale``
    f32); every other leaf (squeeze-excite, the head) maps as float weights
    do."""
    sites = {k.rsplit("/", 1)[0] for k in flat if k.endswith("/kernel_q")}
    out = {}
    for key, arr in flat.items():
        site, leaf = key.rsplit("/", 1)
        if site in sites:
            dtype = np.int8 if leaf == "kernel_q" else np.float32
            name = ".".join(site.split("/")[1:] + [leaf])
            out[name] = torch.from_numpy(np.array(arr, dtype=dtype, order="C"))
        else:
            name, t = flax_entry_to_torch(key, arr)
            out[name] = t
    return out


def flax_key(name: str, ndim: int) -> str:
    """A port ``state_dict`` name (of a tensor with ``ndim`` dims) -> its
    flax path."""
    path, leaf = name.rsplit(".", 1)
    path = path.replace(".", "/")
    if leaf == "running_mean":
        return f"batch_stats/{path}/mean"
    if leaf == "running_var":
        return f"batch_stats/{path}/var"
    if leaf == "bias":
        return f"params/{path}/bias"
    if leaf == "weight":
        # a 4-D weight is a conv kernel, any other a BatchNorm gamma
        return f"params/{path}/kernel" if ndim == 4 else f"params/{path}/scale"
    raise KeyError(f"no flax counterpart for state_dict entry {name!r}")


def flax_key_and_array(name: str, t: torch.Tensor) -> Tuple[str, np.ndarray]:
    """One port ``state_dict`` entry -> (flax key, array in flax layout)."""
    key = flax_key(name, t.dim())
    arr = t.detach().to("cpu", torch.float32).numpy()
    if key.endswith("/kernel"):
        arr = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))  # OIHW -> HWIO
    return key, arr


def flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`state_dict_from_flax`."""
    return dict(flax_key_and_array(k, v) for k, v in sd.items())


def flax_shape(name: str, t: torch.Tensor) -> Tuple[int, ...]:
    shape = tuple(t.shape)
    if name.endswith(".weight") and len(shape) == 4:
        return (shape[2], shape[3], shape[1], shape[0])
    return shape


def load_flat(module: nn.Module, flat: Dict[str, np.ndarray]) -> Tuple[int, int]:
    """Copy flattened flax arrays into ``module`` in place. Keys the module
    lacks are skipped; missing ones keep their values; a shape mismatch
    raises, and so does an archive that matches nothing. Returns
    (loaded, skipped)."""
    own = module.state_dict()
    loaded, skipped = 0, 0
    with torch.no_grad():
        for key, arr in flat.items():
            try:
                name, src = flax_entry_to_torch(key, arr)
            except KeyError:
                skipped += 1
                continue
            if name not in own:
                skipped += 1
                continue
            if tuple(src.shape) != tuple(own[name].shape):
                raise ValueError(
                    f"pretrained weight {key}: shape {tuple(np.shape(arr))} != "
                    f"model {flax_shape(name, own[name])}")
            own[name].copy_(src)
            loaded += 1
    log.info("weight import: %d tensors loaded, %d unmatched", loaded, skipped)
    if loaded == 0:
        raise ValueError("no tensors in the archive matched the model")
    return loaded, skipped


def load_backbone(path: str, module: nn.Module) -> nn.Module:
    """Overlay a JAX-layout ``.npz`` onto ``module`` (in place)."""
    with np.load(path) as archive:
        load_flat(module, {k: archive[k] for k in archive.files})
    return module


def save_backbone(path: str, module: nn.Module, prefixes=None) -> int:
    """Write ``module``'s weights as a JAX-layout ``.npz``. ``prefixes``
    (flattened-name prefixes; a bare string is one prefix) restricts the
    archive. Returns the tensor count."""
    if isinstance(prefixes, str):
        prefixes = (prefixes,)
    out = {
        k: v for k, v in flax_from_state_dict(module.state_dict()).items()
        if prefixes is None or k.startswith(tuple(prefixes))
    }
    if not out:
        raise ValueError(f"save_backbone: no tensors matched prefixes {prefixes}")
    np.savez(path, **out)
    return len(out)


def synth_weight(name: str, shape: Tuple[int, ...]) -> np.ndarray:
    """Deterministic pseudo-random weight keyed by (flax path, flax shape);
    a copy of ``pldepth_tpu/models/convert.py:synth_weight``, the values the
    cross-framework goldens (tests/golden/full_model_*.npz) were made with."""
    seed = zlib.crc32(f"{name}:{'x'.join(map(str, shape))}".encode())
    rng = np.random.default_rng(seed)
    leaf = name.rsplit("/", 1)[-1]
    if leaf == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    if leaf == "scale":
        return rng.uniform(0.8, 1.2, shape).astype(np.float32)
    if leaf in ("bias", "mean"):
        return rng.normal(0.0, 0.05, shape).astype(np.float32)
    fan_in = int(np.prod(shape[:-1]))
    fan_out = int(shape[-1]) * (int(np.prod(shape[:-2])) if len(shape) > 2 else 1)
    std = float(np.sqrt(2.0 / (fan_in + fan_out)))
    return rng.normal(0.0, std, shape).astype(np.float32)


def overlay_synthetic(module: nn.Module, names: Iterable[str]) -> nn.Module:
    """Set every flax path in ``names`` to its :func:`synth_weight` value
    (in place). Unknown names raise."""
    names = [str(n) for n in names]
    own = module.state_dict()
    unknown = [n for n in names if flax_key_to_torch(n) not in own]
    if unknown:
        raise ValueError(f"synthetic overlay: {len(unknown)} unknown paths, "
                         f"e.g. {unknown[:5]}")
    flat = {}
    for n in names:
        t = own[flax_key_to_torch(n)]
        flat[n] = synth_weight(n, flax_shape(flax_key_to_torch(n), t))
    load_flat(module, flat)
    return module
