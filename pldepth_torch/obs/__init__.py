"""Run logging, profiling and the program's spans (obs/spans.py)."""
from pldepth_torch.obs.logging import MetricLogger
from pldepth_torch.obs.profiling import profile_trace

__all__ = ["MetricLogger", "profile_trace"]
