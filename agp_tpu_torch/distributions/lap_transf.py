"""Sampling a distribution known only through its Laplace transform: the
counterpart of ``agp_tpu/distributions/lap_transf.py``.

Backs the generic likelihood's (``make_augmented_likelihood``) Gibbs path:
the auxiliary's conditional is the tilted q(omega) proportional to
exp(-s0 omega) p(omega), where only the Laplace transform
phi(s) = E[exp(-s omega)] of p is known.  The density is (1) inverted on a
fixed log-spaced grid by the Gaver-Stehfest algorithm (real arithmetic, so
any torch-traceable phi works), (2) tilted and normalized per element on
the grid, (3) drawn from by the inverse CDF (one search a draw).  The grid
and the inversion run in float64 whatever the caller's dtype: Stehfest's
alternating weights reach ~1e6 at N=14 and cancel, which float32 does not
survive.  The draws are cast back to the caller's dtype.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

LN2 = math.log(2.0)

# elements tilted at once in ``sample``: [chunk, grid] float64 work tensors
# (512 MiB each at the default grid)
SAMPLE_CHUNK = 1 << 15


@lru_cache(maxsize=None)
def stehfest_coeffs(N: int = 14):
    """The Gaver-Stehfest weights V_1 .. V_N (N even), float64 numpy."""
    if N % 2:
        raise ValueError("the Stehfest order N must be even")
    V = np.zeros(N)
    for k in range(1, N + 1):
        s = 0.0
        for j in range((k + 1) // 2, min(k, N // 2) + 1):
            num = j ** (N // 2) * math.factorial(2 * j)
            den = (
                math.factorial(N // 2 - j)
                * math.factorial(j)
                * math.factorial(j - 1)
                * math.factorial(k - j)
                * math.factorial(2 * j - k)
            )
            s += num / den
        V[k - 1] = (-1) ** (k + N // 2) * s
    return V


def invert_laplace(phi, t: torch.Tensor, N: int = 14) -> torch.Tensor:
    """The density p(t) [T] from its Laplace transform ``phi`` by
    Gaver-Stehfest, in t's dtype; negative values (the inversion's ripple)
    are clipped to 0."""
    V = torch.as_tensor(stehfest_coeffs(N), dtype=t.dtype, device=t.device)
    k = torch.arange(1, N + 1, dtype=t.dtype, device=t.device)
    s = k[None, :] * LN2 / t[:, None]  # [T, N]
    return torch.clamp((LN2 / t) * torch.sum(V[None, :] * phi(s), dim=1), min=0.0)


class LaplaceTransformDistribution:
    """The distribution of phi(s) = E[exp(-s omega)], on a log-spaced grid
    of ``grid_size`` points from 1e-6 to ``t_max``."""

    def __init__(self, phi, t_max: float = 50.0, grid_size: int = 2048):
        self.phi = phi
        self.t_max = t_max
        self.grid_size = grid_size

    def grid(self, dtype=torch.float64, device=None) -> torch.Tensor:
        """The log-spaced grid: it resolves both the spike near 0 and the
        tail."""
        return torch.logspace(-6, math.log10(self.t_max), self.grid_size, dtype=dtype, device=device)

    def tilted_mean(self, s0: torch.Tensor) -> torch.Tensor:
        """E_q[omega] for q proportional to e^{-s0 omega} p(omega):
        -(d/ds) log phi at s0, by automatic differentiation."""
        dphi = torch.func.grad(lambda s: torch.sum(self.phi(s)))(s0)
        return -dphi / self.phi(s0)

    def sample(self, generator, s0, shape=None, u=None) -> torch.Tensor:
        """omega ~ q proportional to e^{-s0 omega} p(omega), elementwise over
        s0, in s0's dtype and of ``shape`` (default s0's).  The uniforms are
        ``u`` ([s0.numel()], float64), or are drawn with ``generator`` (on
        s0's device); the grid cell drawn is the first whose CDF reaches
        u.  The elements are tilted SAMPLE_CHUNK at a time."""
        shape = s0.shape if shape is None else shape
        t = self.grid(device=s0.device)
        p = invert_laplace(self.phi, t)  # the base density on the grid
        # cell masses: density x cell width (the grid is log-spaced)
        log_mass = torch.log(torch.clamp(p * torch.gradient(t)[0], min=1e-300))
        flat = s0.reshape(-1).to(torch.float64)
        if u is None:
            u = torch.rand(flat.shape, generator=generator, dtype=torch.float64, device=s0.device)
        idx = torch.empty(flat.shape, dtype=torch.int64, device=s0.device)
        for lo in range(0, flat.numel(), SAMPLE_CHUNK):
            hi = min(lo + SAMPLE_CHUNK, flat.numel())
            logw = log_mass[None, :] - flat[lo:hi, None] * t[None, :]
            logw = logw - torch.logsumexp(logw, dim=1, keepdim=True)
            cdf = torch.cumsum(torch.exp(logw), dim=1)
            # the count of cells whose CDF is below u: the cumulative sums
            # do not decrease
            idx[lo:hi] = torch.searchsorted(cdf, u[lo:hi, None]).squeeze(1)
        return t[torch.clamp(idx, max=t.shape[0] - 1)].reshape(shape).to(s0.dtype)
