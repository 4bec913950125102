"""K1's share of its roofline: the least time of the fused ranking loss's
forward and backward (benchmark/harness/costs.py, this rank's lists) over
the traced steps, over K1's device time in the trace (rank 0's)."""

from benchmark.harness.trace import device_seconds


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    secs, _ = device_seconds(tr, r"k1_(fwd|bwd)_")
    _, launches = device_seconds(tr, r"k1_fwd_")
    if not secs or not launches:
        return None
    return run["costs"]["k1_least_s_per_step"] * launches / secs * 100.0
