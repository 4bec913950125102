"""Run logging and profiling."""
from pldepth_torch.obs.logging import MetricLogger
from pldepth_torch.obs.profiling import profile_trace, step_timer

__all__ = ["MetricLogger", "profile_trace", "step_timer"]
