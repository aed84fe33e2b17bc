"""Runnable examples of the port (``python -m tony_tpu_torch.examples.<name>``)."""
