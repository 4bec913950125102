"""K4's share of its roofline: the least time of one forward's dense int8
sites (benchmark/harness/costs.py) times the forwards in the trace (K4
launches over the sites a forward), over K4's device time in the trace."""

from benchmark.harness.trace import device_seconds


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    secs, launches = device_seconds(tr, r"k4_kernel")
    if not secs:
        return None
    forwards = launches / run["costs"]["k4_sites"]
    return run["costs"]["k4_least_s_per_forward"] * forwards / secs * 100.0
