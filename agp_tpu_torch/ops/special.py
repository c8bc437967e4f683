"""Special functions used by the augmentation math (elementwise, overflow-safe
in float32); the counterpart of ``agp_tpu/ops/special.py``."""
from __future__ import annotations

import torch

LOG2 = 0.6931471805599453

# the counterparts of the reference's re-exports of jax.scipy.special
digamma = torch.special.digamma
gammaln = torch.special.gammaln


def logcosh(c: torch.Tensor) -> torch.Tensor:
    """Numerically safe log(cosh(c))."""
    c = torch.abs(c)
    return c + torch.log1p(torch.exp(-2.0 * c)) - LOG2


def safe_expcosh(mu: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """exp(mu)/cosh(c) computed in log space so it never overflows."""
    return torch.exp(mu - logcosh(c))


def sqrt_expec_square(mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """sqrt(E[f^2]) = sqrt(mu^2 + var)."""
    return torch.sqrt(mu**2 + var)


def xlogx(x: torch.Tensor) -> torch.Tensor:
    """x*log(x) with 0*log(0) = 0."""
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))
