"""A serving window's share of the peak: its served images' least device
time over the window, each image's dense int8 convolutions at the int8
peak (1,979 TOP/s) and its other convolutions at the bf16 peak (989
TFLOP/s)."""


def read(run):
    return run["costs"]["least_s_per_image"] * run["images"] / run["window_s"] * 100.0
