"""inference of the PyTorch port (see agp_tpu/inference)."""
