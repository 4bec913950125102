"""Hyperparameter sweeps (``pldepth_tpu/sweep``)."""
from pldepth_torch.sweep.search_spaces import SEARCH_SPACES
from pldepth_torch.sweep.sweep import run_sweep

__all__ = ["SEARCH_SPACES", "run_sweep"]
