"""Global numeric configuration of the PyTorch port.

The dtype-scaled jitter table of ``agp_tpu/config.py``: the jitter added
to every kernel-matrix Cholesky, keyed by the working dtype.
"""
from __future__ import annotations

import torch

_JITTER = {
    torch.float64: 1e-4,
    torch.float32: 1e-3,
    torch.float16: 1e-2,
    torch.bfloat16: 1e-2,
}


def jitter(dtype: torch.dtype) -> float:
    """Return the numerical jitter used for the given dtype."""
    return _JITTER.get(dtype, 1e-3)
