"""Kernel (covariance-function) library of the port: the squared-exponential
and Matern 1/2, 3/2, 5/2 kernels, the counterpart of the matching parts of
``agp_tpu/kernels.py``.

Kernels are frozen dataclasses whose tensor fields are the hyperparameters.
A model holds one kernel whose fields carry a leading latent axis [L, ...]
(``replicate``); ``batch_gram`` and friends loop over that axis.
"""
from __future__ import annotations

import dataclasses

import torch

from .ops.linalg import _highest_precision
from .utils.tensors import Params


def _scalar(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(v, dtype=torch.get_default_dtype())


@_highest_precision
def sq_dist(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distance by |x|^2 + |z|^2 - 2 x z^T, the
    cross term at full FP32 (the sum cancels), clamped at 0."""
    xx = torch.sum(X * X, dim=-1)
    zz = torch.sum(Z * Z, dim=-1)
    d2 = xx[:, None] + zz[None, :] - 2.0 * (X @ Z.T)
    return torch.clamp(d2, min=0.0)


@dataclasses.dataclass(frozen=True)
class Kernel(Params):
    """Base kernel.  Subclasses implement ``gram`` and ``diag``."""

    def gram(self, X: torch.Tensor, Z: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class StationaryKernel(Kernel):
    """Stationary kernel with a scalar or ARD ([D]) lengthscale and an output
    variance."""

    lengthscale: torch.Tensor = 1.0
    variance: torch.Tensor = 1.0

    def __post_init__(self):
        object.__setattr__(self, "lengthscale", _scalar(self.lengthscale))
        object.__setattr__(self, "variance", _scalar(self.variance))

    def _from_r2(self, r2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r2 = sq_dist(X / self.lengthscale, Z / self.lengthscale)
        return self.variance * self._from_r2(r2)

    def diag(self, X):
        return torch.broadcast_to(self.variance, (X.shape[0],)).to(X.dtype)


@dataclasses.dataclass(frozen=True)
class SqExponentialKernel(StationaryKernel):
    """k(x, z) = v * exp(-|x - z|^2 / (2 l^2)) (a.k.a. RBF)."""

    def _from_r2(self, r2):
        return torch.exp(-0.5 * r2)


RBFKernel = SqExponentialKernel


@dataclasses.dataclass(frozen=True)
class Matern12Kernel(StationaryKernel):
    """k = v * exp(-r) (exponential / Ornstein-Uhlenbeck)."""

    def _from_r2(self, r2):
        return torch.exp(-torch.sqrt(torch.clamp(r2, min=1e-36)))


@dataclasses.dataclass(frozen=True)
class Matern32Kernel(StationaryKernel):
    """k = v * (1 + r) exp(-r), r = sqrt(3) |x - z| / l."""

    def _from_r2(self, r2):
        r = torch.sqrt(torch.clamp(3.0 * r2, min=1e-36))
        return (1.0 + r) * torch.exp(-r)


@dataclasses.dataclass(frozen=True)
class Matern52Kernel(StationaryKernel):
    """k = v * (1 + r + r^2/3) exp(-r), r = sqrt(5) |x - z| / l."""

    def _from_r2(self, r2):
        r = torch.sqrt(torch.clamp(5.0 * r2, min=1e-36))
        return (1.0 + r + r**2 / 3.0) * torch.exp(-r)


# gram kind of the fused statistics kernels for each kernel class (the
# counterpart of the reference's _PALLAS_KINDS, matched by exact type)
FUSED_KINDS = {
    SqExponentialKernel: "rbf",
    Matern12Kernel: "matern12",
    Matern32Kernel: "matern32",
    Matern52Kernel: "matern52",
}


def fused_kind(kernel: Kernel):
    """The fused kernels' gram kind of ``kernel``, or None."""
    return FUSED_KINDS.get(type(kernel))


def to_unconstrained(kernel: Kernel) -> Kernel:
    """The kernel in the space the hyperparameter optimiser works in: the
    log of every (positive) leaf, lengthscales and variance alike.  Inverse
    of :func:`from_unconstrained`."""
    return kernel.map(torch.log)


def from_unconstrained(kernel: Kernel) -> Kernel:
    return kernel.map(torch.exp)


def replicate(kernel: Kernel, n_latent: int) -> Kernel:
    """Stack a kernel's fields with a leading latent axis [L, ...]."""
    return kernel.map(lambda p: torch.broadcast_to(p, (n_latent,) + p.shape).clone())


def latent(kernel: Kernel, l: int) -> Kernel:
    """The kernel of latent ``l`` of a replicated kernel."""
    return kernel.map(lambda p: p[l])


def batch_gram(kernel: Kernel, X, Z=None) -> torch.Tensor:
    """[L, N, M] Gram stack from a replicated kernel ([L]-leading fields)."""
    L = kernel.variance.shape[0]
    if Z is None:
        return torch.stack([latent(kernel, l).gram(X, X) for l in range(L)])
    if Z.ndim == 3:  # per-latent inducing sets
        return torch.stack([latent(kernel, l).gram(X, Z[l]) for l in range(L)])
    return torch.stack([latent(kernel, l).gram(X, Z) for l in range(L)])


def batch_gram_zz(kernel: Kernel, Z) -> torch.Tensor:
    """[L, M, M] Gram of per-latent inducing sets Z [L, M, D]."""
    return torch.stack([latent(kernel, l).gram(Z[l], Z[l]) for l in range(Z.shape[0])])


def batch_diag(kernel: Kernel, X) -> torch.Tensor:
    L = kernel.variance.shape[0]
    return torch.stack([latent(kernel, l).diag(X) for l in range(L)])


def lengthscale_2d(kernel: Kernel, D: int) -> torch.Tensor:
    """[L, D] per-latent lengthscales of a replicated stationary kernel
    (scalar [L] or ARD [L, D] fields), as the multi-latent fused kernels
    take them."""
    ls = kernel.lengthscale
    L = ls.shape[0]
    return torch.broadcast_to(ls.reshape(L, -1), (L, D))
