"""Model factory, encoder/decoder modules, weight bridge, fused encoder plan."""

from pldepth_torch.models.pldepth_net import (
    MODEL_REGISTRY,
    PLDepthModel,
    get_model_type_by_name,
    get_pl_depth_net,
)

__all__ = ["MODEL_REGISTRY", "PLDepthModel", "get_model_type_by_name", "get_pl_depth_net"]
