"""models of the PyTorch port (see agp_tpu/models)."""
