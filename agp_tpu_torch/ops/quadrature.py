"""Gauss-Hermite quadrature for Gaussian expectations: the counterpart of
``agp_tpu/ops/quadrature.py``.  The node table is computed once on the host
with numpy and copied once to each device and dtype; the expectation is
one [..., n] broadcast and one reduction."""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .cuda_kernels import check_not_capturing


@lru_cache(maxsize=None)
def gauss_hermite(n: int):
    """Physicists' Gauss-Hermite nodes and weights rescaled so that
    ``sum(w * g(x))`` approximates ``E[g(X)]`` for X ~ N(0, 1)."""
    x, w = np.polynomial.hermite.hermgauss(n)
    return np.sqrt(2.0) * x, w / np.sqrt(np.pi)


@lru_cache(maxsize=None)
def _device_table(n: int, dtype: torch.dtype, device: torch.device):
    """``gauss_hermite(n)`` as tensors of ``dtype`` on ``device``, copied
    there once: a step then makes no host-to-device copy, which would
    wait for the host and cannot be captured into a CUDA graph."""
    check_not_capturing(f"the {n}-node Gauss-Hermite table")
    x, w = gauss_hermite(n)
    return torch.as_tensor(x, dtype=dtype, device=device), torch.as_tensor(w, dtype=dtype, device=device)


def nodes(mu: torch.Tensor, var: torch.Tensor, n: int):
    """The n nodes mu + sd x [..., n] of N(mu, var) elementwise and their
    weights [n], in mu's dtype and on its device."""
    x, w = _device_table(n, mu.dtype, mu.device)
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    return mu[..., None] + sd[..., None] * x, w


def expectation(fn, mu: torch.Tensor, var: torch.Tensor, n: int = 100) -> torch.Tensor:
    """E_{f ~ N(mu, var)}[fn(f)] elementwise over mu/var of any shape."""
    f, w = nodes(mu, var, n)
    return torch.sum(w * fn(f), dim=-1)


def mean_and_var(fn, mu: torch.Tensor, var: torch.Tensor, n: int = 100):
    """(E[fn(f)], V[fn(f)]) under f ~ N(mu, var), on shared nodes."""
    f, w = nodes(mu, var, n)
    vals = fn(f)
    m = torch.sum(w * vals, dim=-1)
    m2 = torch.sum(w * vals**2, dim=-1)
    return m, m2 - m**2
