"""Runnable examples of the port (``python -m nmch_tpu_torch.examples.<name>``)."""
