"""Active learning (``pldepth_tpu/active``): edge-disagreement acquisition
and the round loop."""

from pldepth_torch.active.acquisition import (
    acquire_pixels,
    oracle_label,
    tile_hausdorff,
)
from pldepth_torch.active.loop import active_learning_round, run_active_loop

__all__ = [
    "acquire_pixels",
    "active_learning_round",
    "oracle_label",
    "run_active_loop",
    "tile_hausdorff",
]
