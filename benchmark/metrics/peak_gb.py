"""Peak device memory allocated over the window, GB, on the fullest card."""


def read(run):
    return run["peak_bytes"] / 1e9
