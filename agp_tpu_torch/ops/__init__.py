"""ops of the PyTorch port (see agp_tpu/ops)."""
