"""The share of the traced window in which no device operation ran (the
union of kernel, copy and fill intervals), averaged over the cell's cards."""


def read(run):
    tr = run.get("trace")
    if not tr:
        return None
    return (1.0 - tr["busy_s_mean"] / tr["window_s_mean"]) * 100.0
