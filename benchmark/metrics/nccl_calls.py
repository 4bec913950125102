"""NCCL kernel launches a step on rank 0, from the traced steps."""

from benchmark.harness.trace import device_seconds


def read(run):
    tr = run.get("trace")
    if not tr or not tr.get("steps"):
        return None
    _, n = device_seconds(tr, r"(?i)nccl")
    return n / tr["steps"] if n else None
