"""Device milliseconds a step inside NCCL kernels on rank 0, from the
traced steps."""

from benchmark.harness.trace import device_seconds


def read(run):
    tr = run.get("trace")
    if not tr or not tr.get("steps"):
        return None
    s, n = device_seconds(tr, r"(?i)nccl")
    return s / tr["steps"] * 1e3 if n else None
