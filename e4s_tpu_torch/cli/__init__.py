"""Command-line entry points of the port (``python -m e4s_tpu_torch.cli.<name>``)."""
