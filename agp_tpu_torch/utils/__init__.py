"""utils of the PyTorch port (see agp_tpu/utils)."""
