"""The program's state built around the benchmark's weights."""

from __future__ import annotations

from typing import Dict

import torch


def state_with(trainer, weights: Dict[str, torch.Tensor], dev: torch.device):
    """A ``TrainState`` of ``trainer``'s model that holds ``weights``: what
    ``Trainer.init_state`` builds (the module on the card in eval mode, the
    configuration's frozen leaves, a fresh optimizer state, replicated over
    the process group), without the random initialisation that these
    weights would overwrite."""
    from pldepth_torch.models.pldepth_net import freeze_params
    from pldepth_torch.train.trainer import TrainState, trainable_params

    with torch.device(dev):
        module = trainer.model.make()
    module.load_state_dict(weights, strict=True)
    module.eval()
    freeze_params(module, trainer.cfg.freeze_encoder)
    return trainer.replicate(TrainState(step=0, model=module,
                                        opt=trainer.optimizer.init(trainable_params(module)),
                                        seed=trainer.cfg.seed))
