"""Checkpoints (``pldepth_tpu/train/checkpoint.py``).

* Weights only, in the JAX package's ``.npz`` layout, numpy only: a
  ``weights.npz`` the JAX package wrote serves in the port unchanged, and
  one the port writes loads in the JAX package.
* Full train state for resume: :class:`CheckpointManager` writes the
  model's ``state_dict`` (params and BN statistics), the optimizer state,
  ``step`` and ``seed`` with ``torch.save``, one file per global step, in
  place of Orbax. Saves are synchronous (written and renamed into place
  before ``save`` returns), so a run that exits right after one loses
  nothing; ``best_val.json`` keeps the best validation loss across
  ``--resume`` (``maybe_save_best``, Keras save_best_only semantics).

Under a process group (core/mesh.py) the ranks hold the same state: rank 0
writes, every rank waits at a barrier until the file is in place, and every
rank restores from the same directory.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import re
from typing import List, Optional

import numpy as np
import torch

from pldepth_torch.core import mesh as mesh_lib
from pldepth_torch.models.pretrained import load_backbone, save_backbone

log = logging.getLogger(__name__)
_CKPT = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.mesh = mesh_lib.current()
        if self.mesh.rank == 0:
            os.makedirs(self.directory, exist_ok=True)
        self.mesh.barrier()
        self.keep = max(1, keep)
        self._best_path = os.path.join(self.directory, "best_val.json")
        self.best_val = float("inf")
        if os.path.exists(self._best_path):
            try:
                with open(self._best_path) as f:
                    self.best_val = float(json.load(f)["best_val"])
            except Exception:  # a marker cut mid-write: tracking starts afresh
                log.warning("unreadable %s; best-val tracking resets", self._best_path)

    def steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(self.directory)) if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def save(self, step: int, state, metrics: Optional[dict] = None) -> None:
        if self.mesh.rank == 0:
            self._write(step, state, metrics)
        self.mesh.barrier()

    def _write(self, step: int, state, metrics: Optional[dict]) -> None:
        payload = {
            "step": int(state.step), "seed": int(state.seed),
            "model": state.model.state_dict(),
            "opt": state.opt.state_dict() if state.opt is not None else None,
            "metrics": dict(metrics or {}),
        }
        tmp = self._path(step) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(step))  # a reader never sees a partial file
        for old in self.steps()[:-self.keep]:
            os.unlink(self._path(old))

    def maybe_save_best(self, step: int, state, val_loss: float) -> bool:
        """save_best_only semantics on val_loss (tracking_utils.py:27-30)."""
        if val_loss < self.best_val:
            self.best_val = val_loss
            if self.mesh.rank == 0:
                with open(self._best_path, "w") as f:
                    json.dump({"best_val": float(val_loss), "step": int(step)}, f)
            self.save(step, state, metrics={"val_loss": val_loss})
            return True
        return False

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, state_template, step: Optional[int] = None):
        """A new state: a copy of the template's model with the saved
        tensors, the saved optimizer state, step and seed (tensors land on
        the template model's device)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        from pldepth_torch.train.optim import AmsGradState

        device = next(state_template.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device, weights_only=True)
        model = copy.deepcopy(state_template.model)
        model.load_state_dict(payload["model"])
        opt = payload["opt"]
        return state_template.replace(
            step=payload["step"], seed=payload["seed"], model=model,
            opt=AmsGradState.from_state_dict(opt) if opt is not None else None)


def save_weights_npz(path: str, state) -> None:
    """Write ``state.model``'s params and batch stats as flax-layout npz
    (rank 0 under a process group; every rank returns once it is written)."""
    mesh = mesh_lib.current()
    if mesh.rank == 0:
        save_backbone(path, state.model)
    mesh.barrier()


def load_weights_npz(path: str, state):
    """A new state whose model is a copy of ``state.model`` with the
    archive's weights loaded (the given state is left as it was)."""
    model = copy.deepcopy(state.model)
    load_backbone(path, model)
    return state.replace(model=model)


def infer_decoder_head_ch(path: str, default: int = 32) -> int:
    """The decoder width a weights npz was trained with (conv4's out
    channels); ``default`` if the archive has no ``decoder/conv4`` or cannot
    be read (a truncated npz raises zipfile.BadZipFile)."""
    try:
        with np.load(path) as archive:
            key = "params/decoder/conv4/kernel"
            if key in archive:
                return int(archive[key].shape[-1])
    except Exception:
        pass
    return default
