"""The kernels of the port's benchmark path: the counterparts of the Pallas
kernels that the JAX package keeps in its TPU benchmarks
(``benchmarks/fused_variants.py``, ``benchmarks/gather_modes.py``).  No
training path calls them; ``agp_tpu_torch.bench`` times them."""
