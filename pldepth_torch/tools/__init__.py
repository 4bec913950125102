"""Tools of the port, run as modules (``python -m pldepth_torch.tools.<name>``)."""
