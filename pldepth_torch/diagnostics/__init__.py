"""Diagnostics (``pldepth_tpu/diagnostics``): the chi^2 sampling diagnostic."""
