"""Runnable examples of the port (``python3 -m agp_tpu_torch.examples.<name>``)."""
