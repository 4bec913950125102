"""Ahead-of-time serving export (``pldepth_tpu/serve/export.py``) with
``torch.export`` in place of ``jax.export``.

One artifact file holds the depth forward with its weights, and a serving
process runs it without the model code or the checkpoint format:
:func:`load_exported` imports only torch and json.

File format, the JAX package's: ``b"PLDEPTH_EXPORT\\x00"``, a 4-byte
little-endian length, that many bytes of JSON metadata (``version``,
``model_name``, ``input_size``, ``batch_size`` (None: any batch),
``platforms``, ``input_range`` "[0,1]", ``bn_fold``), then the payload: here
a ``torch.export.save`` archive of an ``ExportedProgram`` (a zip), where a
JAX artifact holds serialized StableHLO, which this loader refuses.

The graph takes (B, S, S, 3) f32 images in [0, 1] and returns (B, S, S)
depth: the model's normalisation, then ``predict`` or, with ``bn_fold``,
``predict_bnfold``'s BN-folded forward. It is the float graph of convs
and elementwise ops: the hand-written kernels (K2, K4) are ctypes calls
that ``torch.export`` cannot trace, as the JAX package exports the XLA
graph and never its Pallas encoder, and :func:`export_predict` checks that
every op of the exported graph is an ATen op. One program serves every
platform in the metadata: :func:`load_exported` moves it to the device it
is asked for.
"""

from __future__ import annotations

import io
import json
import logging
import os
from typing import Callable, Sequence, Tuple

import torch
from torch.export.passes import move_to_device_pass

log = logging.getLogger(__name__)

_HEADER = b"PLDEPTH_EXPORT\x00"
_VERSION = 1
_ZIP = b"PK\x03\x04"  # a torch.export.save archive
PLATFORMS = ("cuda", "cpu")
MAX_BATCH = 4096  # the largest batch a polymorphic artifact takes


class _Predict(torch.nn.Module):
    """[0, 1] images -> (B, S, S) depth through ``model`` after ``normalize``."""

    def __init__(self, model: torch.nn.Module, normalize: Callable):
        super().__init__()
        self.model, self.normalize = model, normalize

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.model(self.normalize(images))[..., 0]


def _check_aten_only(ep) -> None:
    """Every op the exported graph calls is an ATen op: no custom op (and
    so none of ops/_build.py's kernel libraries) is baked in."""
    for node in ep.graph.nodes:
        target = node.target
        if node.op == "call_function" and isinstance(target, torch._ops.OpOverload):
            if target.namespace not in ("aten", "prims"):
                raise RuntimeError(f"exported graph calls {target}: only ATen ops may be "
                                   "exported (the hand-written kernels cannot be)")


def export_predict(trainer, state, batch_size: int, path: str,
                   platforms: Sequence[str] = PLATFORMS, bn_fold: bool = False) -> str:
    """Write ``trainer.predict`` (``predict_bnfold`` with ``bn_fold``) on
    ``state``'s weights to ``path`` as an artifact. ``batch_size <= 0``
    exports a batch-polymorphic program (any batch from 1 to
    ``MAX_BATCH``); a fixed-batch one refuses every other batch."""
    from pldepth_torch.data.preprocess import normalize_images

    platforms = tuple(platforms)
    unknown = sorted(set(platforms) - set(PLATFORMS))
    if unknown or not platforms:
        raise ValueError(f"unknown platform(s) {unknown or list(platforms)}: "
                         f"export serves {list(PLATFORMS)}")
    cfg = trainer.cfg
    size = cfg.input_size
    model = trainer._folded_model(state.model) if bn_fold else state.model
    preprocess = trainer.model.preprocess
    wrapper = _Predict(model, lambda x: normalize_images(x, preprocess)).eval()
    fixed = bool(batch_size and batch_size > 0)
    example = torch.zeros((batch_size if fixed else 2, size, size, 3), dtype=torch.float32,
                          device=trainer.device)
    # a polymorphic batch is traced at 2: torch specialises on sizes 0 and 1
    shapes = None if fixed else ({0: torch.export.Dim("b", min=1, max=MAX_BATCH)},)
    with torch.no_grad():
        ep = torch.export.export(wrapper, (example,), dynamic_shapes=shapes)
    _check_aten_only(ep)
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    blob = buf.getvalue()
    meta = {
        "version": _VERSION,
        "model_name": cfg.model_name,
        "input_size": size,
        # None = batch-polymorphic: any leading dim at call time
        "batch_size": batch_size if fixed else None,
        "platforms": list(platforms),
        "input_range": "[0,1]",  # float32; divide raw uint8 pixels by 255
        "bn_fold": bool(bn_fold),
    }
    meta_b = json.dumps(meta).encode()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(len(meta_b).to_bytes(4, "little"))
        f.write(meta_b)
        f.write(blob)
    log.info("exported %s (%d bytes, platforms=%s)", path, len(blob), list(platforms))
    return path


def load_exported(path: str, device=None) -> Tuple[Callable, dict]:
    """Load an artifact onto ``device`` (default ``cuda``; its type must be
    one of the artifact's platforms). Returns (callable, meta); the
    callable maps an f32 image batch (tensor or array) of the exported
    shape to the (B, S, S) depth tensor on that device."""
    with open(path, "rb") as f:
        if f.read(len(_HEADER)) != _HEADER:
            raise ValueError(f"{path} is not a pldepth export")
        n = int.from_bytes(f.read(4), "little")
        meta = json.loads(f.read(n).decode())
        blob = f.read()
    if not blob.startswith(_ZIP):
        raise ValueError(
            f"{path} holds no torch.export program: it is a JAX (jax.export "
            f"StableHLO) artifact for {meta.get('platforms')}; export it with "
            "pldepth_torch's `cli export` to serve it here")
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, not {dev.type}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to load "
                           "the artifact on the CPU")
    module = move_to_device_pass(torch.export.load(io.BytesIO(blob)), dev).module()

    def call(images) -> torch.Tensor:
        with torch.no_grad():
            return module(torch.as_tensor(images, dtype=torch.float32).to(dev))

    return call, meta
