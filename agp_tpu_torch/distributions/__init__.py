"""distributions of the PyTorch port (see agp_tpu/distributions)."""
