"""training of the PyTorch port (see agp_tpu/training)."""
