"""On-device ranking samplers and the ordinal depth relation."""

from pldepth_torch.sampling.relations import depth_relation
from pldepth_torch.sampling.samplers import (
    SAMPLERS,
    get_sampler,
    rank_candidates,
    sample_rankings_batch,
)

__all__ = ["SAMPLERS", "depth_relation", "get_sampler", "rank_candidates",
           "sample_rankings_batch"]
