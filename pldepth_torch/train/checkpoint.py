"""Weights-only checkpoints in the JAX package's ``.npz`` layout
(``pldepth_tpu/train/checkpoint.py:save_weights_npz`` and friends), numpy
only: a ``weights.npz`` the JAX package wrote serves in the port unchanged,
and one the port writes loads in the JAX package. Full train-state
save/resume comes with the training slice.
"""

from __future__ import annotations

import copy

import numpy as np

from pldepth_torch.models.pretrained import load_backbone, save_backbone


def save_weights_npz(path: str, state) -> None:
    """Write ``state.model``'s params and batch stats as flax-layout npz."""
    save_backbone(path, state.model)


def load_weights_npz(path: str, state):
    """A new state whose model is a copy of ``state.model`` with the
    archive's weights loaded (the given state is left as it was)."""
    model = copy.deepcopy(state.model)
    load_backbone(path, model)
    return state.replace(model=model)


def infer_decoder_head_ch(path: str, default: int = 32) -> int:
    """The decoder width a weights npz was trained with (conv4's out
    channels); ``default`` if the archive has no ``decoder/conv4``."""
    try:
        with np.load(path) as archive:
            key = "params/decoder/conv4/kernel"
            if key in archive:
                return int(archive[key].shape[-1])
    except (OSError, ValueError):
        pass
    return default
