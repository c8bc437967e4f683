"""Special functions used by the augmentation math (elementwise, overflow-safe
in float32); the counterpart of ``agp_tpu/ops/special.py``."""
from __future__ import annotations

import math

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


def sqrt_expec_square_diff(mu: torch.Tensor, var: torch.Tensor, y) -> torch.Tensor:
    """sqrt(E[(f - y)^2]) = sqrt((mu - y)^2 + var)."""
    return torch.sqrt((mu - y) ** 2 + var)


def xlogx(x: torch.Tensor) -> torch.Tensor:
    """x*log(x) with 0*log(0) = 0."""
    pos = x > 0
    return torch.where(pos, x * torch.log(torch.where(pos, x, torch.ones_like(x))), torch.zeros_like(x))


def log_besselk_half(n_half: int, x: torch.Tensor) -> torch.Tensor:
    """log K_p(x) for the half-integer order p = n_half + 1/2 (n_half >= 0),
    by the closed form K_{n+1/2}(x) = sqrt(pi/(2x)) e^-x
    sum_{k<=n} (n+k)!/(k!(n-k)!) (2x)^-k.  K_{-p} = K_p: pass |p|."""
    if n_half < 0:
        raise ValueError("use abs(order) - K_{-p} = K_p")
    base = 0.5 * (math.log(math.pi) - LOG2 - torch.log(x)) - x
    if n_half == 0:
        return base
    coeffs = [
        math.factorial(n_half + k) / (math.factorial(k) * math.factorial(n_half - k))
        for k in range(n_half + 1)
    ]
    inv2x = 1.0 / (2.0 * x)
    poly = coeffs[0]
    p = torch.ones_like(x)
    for k in range(1, n_half + 1):
        p = p * inv2x
        poly = poly + coeffs[k] * p
    return base + torch.log(poly)


def besselk_half(n_half: int, x: torch.Tensor) -> torch.Tensor:
    """K_p(x) for the half-integer order p = n_half + 1/2."""
    return torch.exp(log_besselk_half(n_half, x))
