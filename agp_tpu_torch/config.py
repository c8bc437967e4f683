"""Global configuration of the PyTorch port.

* The dtype-scaled jitter table of ``agp_tpu/config.py``: the jitter added
  to every kernel-matrix Cholesky, keyed by the working dtype.
* The default device: where ``SVGP.create`` puts inducing points given
  without a device (a numpy array, a list).  It is the CUDA card unless
  the caller chooses the CPU with ``set_default_device("cpu")``; with no
  card and no such choice, such an input raises.  A tensor stays where it
  is, and the other entry points put inputs without a device on the
  model's device.
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


_DEFAULT_DEVICE = ["cuda"]


def set_default_device(device) -> torch.device:
    """Set where inputs without a device go ("cuda" or "cpu"); returns the
    previous choice."""
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"the default device is 'cuda' or 'cpu', got {device}")
    previous = torch.device(_DEFAULT_DEVICE[0])
    _DEFAULT_DEVICE[0] = device
    return previous


def default_device() -> torch.device:
    """The device for inputs without one; raises when it is CUDA and no
    card is available."""
    device = torch.device(_DEFAULT_DEVICE[0])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "agp_tpu_torch puts inputs without a device (numpy arrays, lists) on the CUDA card, "
            "and torch.cuda.is_available() is false: pass CPU tensors, or call "
            "agp_tpu_torch.config.set_default_device('cpu')"
        )
    return device
