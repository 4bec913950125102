"""Seconds from process start until the window opens: loading, building
or finding the kernels, weights, data, calibration and warm-up."""


def read(run):
    return run.get("setup_s")
