"""Depth maps a second through ``run_pipeline``: every image completed in
the window over the time from its start to the last completion."""


def read(run):
    return run["images"] / run["window_s"]
