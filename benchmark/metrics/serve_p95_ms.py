"""The 95th percentile, over every image completed in the window, of the
time from handing its chunk to ``decode`` until ``write`` receives its
map (every image of a chunk shares its chunk's time)."""

import numpy as np


def read(run):
    lat = run.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 95)) * 1e3
