"""Hyperparameter search spaces: a copy of
``pldepth_tpu/sweep/search_spaces.py``.

The reference sweep configurations (pldepth/hyperopt/hyperparams.py:21-116:
bayes sweeps over lr, lr_multi, ranking_size, rankings_per_image, epochs and
batch_size targeting test_err; TPE dicts at :4-19) as declarative spaces for
the local random / grid / TPE driver or a wandb sweep.
"""

from __future__ import annotations

from typing import Any, Dict

# Each entry: param -> {"values": [...]} or {"min": lo, "max": hi, "log": bool}
SEARCH_SPACES: Dict[str, Dict[str, Any]] = {
    # base training sweep (reference sweep_config_i/t/pr)
    "base": {
        "initial_lr": {"min": 1e-4, "max": 0.3, "log": True},
        "lr_multi": {"values": [0.1, 0.25, 0.5]},
        "ranking_size": {"values": [3, 5, 7, 10, 25]},
        "rankings_per_image": {"values": [50, 100, 200]},
        "batch_size": {"values": [4, 6, 8]},
        "epochs": {"values": [10, 20, 30]},
    },
    # large-list study (sweeps explored K up to 500, hyperparams.py:44)
    "large_rankings": {
        "initial_lr": {"min": 1e-4, "max": 0.1, "log": True},
        "ranking_size": {"values": [25, 50, 100, 250, 500]},
        "rankings_per_image": {"values": [10, 25, 50]},
    },
    # active-learning sweep (activ_sweep/activ_sweep2)
    "active": {
        "initial_lr": {"min": 1e-5, "max": 0.01, "log": True},
        "ranking_size": {"values": [4, 6, 8]},
        "sampling_type": {"values": [0, 1, 3]},
    },
}
