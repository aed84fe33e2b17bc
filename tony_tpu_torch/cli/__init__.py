"""Command-line entry points of the port (``python -m tony_tpu_torch.cli.<name>``)."""
