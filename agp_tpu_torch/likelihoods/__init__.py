"""likelihoods of the PyTorch port (see agp_tpu/likelihoods)."""
