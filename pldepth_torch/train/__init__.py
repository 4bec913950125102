"""Trainer (serving subset) and weights-only checkpoints."""

from pldepth_torch.train.trainer import Trainer, TrainState

__all__ = ["Trainer", "TrainState"]
