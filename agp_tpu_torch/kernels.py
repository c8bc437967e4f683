"""Kernel (covariance-function) library of the port: the counterpart of
``agp_tpu/kernels.py``.  Sixteen kernels, six input transforms, sums and
products of kernels and a kernel over transformed inputs.

Kernels and transforms are frozen dataclasses.  A field annotated
``torch.Tensor`` is a hyperparameter (numbers become tensors of torch's
default dtype); every other field (a polynomial degree, selected
dimensions, a callable) is static configuration.  A model holds one kernel
whose tensors carry a leading latent axis [L, ...] (``replicate``);
``batch_gram`` and friends loop over that axis.

Every dot product that the reference runs at ``Precision.HIGHEST`` runs at
full FP32 here (``ops/linalg._highest_precision``): the distance's cross
term, the linear, polynomial, exponentiated and neural-network kernels and
the linear input transform.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Tuple

import torch

from .ops.linalg import _highest_precision
from .utils.tensors import Params, path_leaves


@_highest_precision
def sq_dist(X: torch.Tensor, Z: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distance by |x|^2 + |z|^2 - 2 x z^T, the
    cross term at full FP32 (the sum cancels), clamped at 0."""
    xx = torch.sum(X * X, dim=-1)
    zz = torch.sum(Z * Z, dim=-1)
    d2 = xx[:, None] + zz[None, :] - 2.0 * (X @ Z.T)
    return torch.clamp(d2, min=0.0)


def _as_params(obj):
    """Fields annotated ``torch.Tensor`` given as numbers become tensors of
    torch's default dtype."""
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.type == "torch.Tensor" and v is not None and not isinstance(v, torch.Tensor):
            object.__setattr__(obj, f.name, torch.as_tensor(v, dtype=torch.get_default_dtype()))


def _bcast(v, n, dtype):
    return torch.broadcast_to(v, (n,)).to(dtype)


@dataclasses.dataclass(frozen=True)
class Kernel(Params):
    """Base kernel.  Subclasses implement ``gram`` and ``diag``.

    Tensor fields are positive by default and optimised in log space.  A
    subclass lists sign-indefinite fields in ``FREE_PARAMS`` (optimised as
    they are) and fields in (0, 1) in ``UNIT_PARAMS`` (optimised through a
    logit); see :func:`to_unconstrained`."""

    FREE_PARAMS = frozenset()  # no annotation: a class attribute, not a field
    UNIT_PARAMS = frozenset()

    def __post_init__(self):
        _as_params(self)

    def gram(self, X: torch.Tensor, Z: torch.Tensor | None = None) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __add__(self, other: "Kernel") -> "Kernel":
        return SumKernel(left=self, right=other)

    def __mul__(self, other):
        """A kernel times a kernel is their product; times a number, the
        kernel with its variance scaled (its type kept)."""
        if isinstance(other, Kernel):
            return ProductKernel(left=self, right=other)
        return self.replace(variance=self.variance * other)

    __rmul__ = __mul__


@dataclasses.dataclass(frozen=True)
class StationaryKernel(Kernel):
    """Stationary kernel with a scalar or ARD ([D]) lengthscale and an output
    variance."""

    lengthscale: torch.Tensor = 1.0
    variance: torch.Tensor = 1.0

    def _from_r2(self, r2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r2 = sq_dist(X / self.lengthscale, Z / self.lengthscale)
        return self.variance * self._from_r2(r2)

    def diag(self, X):
        return _bcast(self.variance, X.shape[0], X.dtype)


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


@dataclasses.dataclass(frozen=True)
class RationalQuadraticKernel(StationaryKernel):
    """k = v * (1 + r^2 / (2 alpha))^-alpha, r = |x - z| / l."""

    alpha: torch.Tensor = 2.0

    def _from_r2(self, r2):
        return (1.0 + r2 / (2.0 * self.alpha)) ** (-self.alpha)


@dataclasses.dataclass(frozen=True)
class CosineKernel(StationaryKernel):
    """k = v * prod_d cos(2 pi (x_d - z_d) / l_d): the per-dimension product
    form, which is PSD (a cosine of the Euclidean norm would not be)."""

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        diff = X[:, None, :] - Z[None, :, :]
        return self.variance * torch.prod(torch.cos(2.0 * math.pi * diff / self.lengthscale), dim=-1)


@dataclasses.dataclass(frozen=True)
class PeriodicKernel(StationaryKernel):
    """k = v * exp(-2 sum_d sin^2(pi (x_d - z_d) / p) / l_d^2)."""

    period: torch.Tensor = 1.0

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        diff = X[:, None, :] - Z[None, :, :]  # [N, M, D]
        s = torch.sin(math.pi * diff / self.period) / self.lengthscale
        return self.variance * torch.exp(-2.0 * torch.sum(s * s, dim=-1))


@dataclasses.dataclass(frozen=True)
class LinearKernel(Kernel):
    """k = v x.z + bias."""

    variance: torch.Tensor = 1.0
    bias: torch.Tensor = 1e-12

    @_highest_precision
    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        return self.variance * (X @ Z.T) + self.bias

    def diag(self, X):
        return self.variance * torch.sum(X * X, dim=-1) + self.bias


@dataclasses.dataclass(frozen=True)
class PolynomialKernel(Kernel):
    """k = v (x.z + bias)^degree, the degree static."""

    variance: torch.Tensor = 1.0
    bias: torch.Tensor = 1.0
    degree: int = 2

    @_highest_precision
    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        return self.variance * (X @ Z.T + self.bias) ** self.degree

    def diag(self, X):
        return self.variance * (torch.sum(X * X, dim=-1) + self.bias) ** self.degree


@dataclasses.dataclass(frozen=True)
class ConstantKernel(Kernel):
    """k = v."""

    variance: torch.Tensor = 1.0

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        return torch.broadcast_to(self.variance, (X.shape[0], Z.shape[0])).to(X.dtype)

    def diag(self, X):
        return _bcast(self.variance, X.shape[0], X.dtype)


@dataclasses.dataclass(frozen=True)
class WhiteKernel(Kernel):
    """k = v [x is z]: v I when the gram is of one tensor with itself
    (``Z`` None or the same object as ``X``), zeros between two tensors."""

    variance: torch.Tensor = 1.0

    def gram(self, X, Z=None):
        if Z is None or Z is X:
            return self.variance * torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
        return torch.zeros((X.shape[0], Z.shape[0]), dtype=X.dtype, device=X.device)

    def diag(self, X):
        return _bcast(self.variance, X.shape[0], X.dtype)


@dataclasses.dataclass(frozen=True)
class ExponentiatedKernel(Kernel):
    """k = v exp(x.z / l^2), the exponentiated dot product."""

    lengthscale: torch.Tensor = 1.0
    variance: torch.Tensor = 1.0

    @_highest_precision
    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        Xs, Zs = X / self.lengthscale, Z / self.lengthscale
        return self.variance * torch.exp(Xs @ Zs.T)

    def diag(self, X):
        Xs = X / self.lengthscale
        return self.variance * torch.exp(torch.sum(Xs * Xs, dim=-1))


@dataclasses.dataclass(frozen=True)
class PiecewisePolynomialKernel(StationaryKernel):
    """Compactly supported (Wendland) piecewise polynomial of static degree
    q in {0, 1, 2, 3}: k = v (1 - r)_+^(j + q) P_q(r) with
    j = floor(D / 2) + q + 1 (GPML table 4.1), computed dense."""

    degree: int = 0

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r = torch.sqrt(torch.clamp(sq_dist(X / self.lengthscale, Z / self.lengthscale), min=1e-36))
        D = X.shape[-1]
        j = D // 2 + self.degree + 1
        base = torch.clamp(1.0 - r, min=0.0)
        if self.degree == 0:
            poly, o = torch.ones_like(r), 0
        elif self.degree == 1:
            poly, o = (j + 1.0) * r + 1.0, 1
        elif self.degree == 2:
            poly = ((j**2 + 4.0 * j + 3.0) * r * r + (3.0 * j + 6.0) * r + 3.0) / 3.0
            o = 2
        elif self.degree == 3:
            poly = (
                (j**3 + 9.0 * j**2 + 23.0 * j + 15.0) * r**3
                + (6.0 * j**2 + 36.0 * j + 45.0) * r * r
                + (15.0 * j + 45.0) * r
                + 15.0
            ) / 15.0
            o = 3
        else:
            raise ValueError("degree must be in {0,1,2,3}")
        return self.variance * base ** (j + o) * poly


@dataclasses.dataclass(frozen=True)
class FBMKernel(Kernel):
    """Fractional Brownian motion, k = v/2 (|x|^2h + |z|^2h - |x - z|^2h),
    Hurst index h in (0, 1), optimised through a logit (``UNIT_PARAMS``) so
    that no step takes it past 1."""

    UNIT_PARAMS = frozenset({"hurst"})

    hurst: torch.Tensor = 0.5
    variance: torch.Tensor = 1.0

    def _pow2h(self, sq):
        return torch.clamp(sq, min=1e-36) ** self.hurst

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xx = torch.sum(X * X, dim=-1)
        zz = torch.sum(Z * Z, dim=-1)
        return 0.5 * self.variance * (self._pow2h(xx)[:, None] + self._pow2h(zz)[None, :] - self._pow2h(sq_dist(X, Z)))

    def diag(self, X):
        return self.variance * self._pow2h(torch.sum(X * X, dim=-1))


@dataclasses.dataclass(frozen=True)
class GaborKernel(Kernel):
    """k = v exp(-r^2 / (2 l^2)) prod_d cos(2 pi (x_d - z_d) / p_d): a
    squared-exponential envelope times a per-dimension cosine carrier."""

    lengthscale: torch.Tensor = 1.0
    period: torch.Tensor = 1.0
    variance: torch.Tensor = 1.0

    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        r2 = sq_dist(X / self.lengthscale, Z / self.lengthscale)
        diff = X[:, None, :] - Z[None, :, :]
        carrier = torch.prod(torch.cos(2.0 * math.pi * diff / self.period), dim=-1)
        return self.variance * torch.exp(-0.5 * r2) * carrier

    def diag(self, X):
        return _bcast(self.variance, X.shape[0], X.dtype)


@dataclasses.dataclass(frozen=True)
class NeuralNetworkKernel(Kernel):
    """The infinite erf network, k = v (2/pi) asin(2 xt.zt /
    sqrt((1 + 2 xt.xt)(1 + 2 zt.zt))) with xt = (1, x) (GPML eq. 4.29)."""

    variance: torch.Tensor = 1.0

    def _aug(self, X):
        # 1 + 2 xt.xt with xt = (1, x)
        return 3.0 + 2.0 * torch.sum(X * X, dim=-1)

    @_highest_precision
    def gram(self, X, Z=None):
        Z = X if Z is None else Z
        xz = 1.0 + X @ Z.T
        denom = torch.sqrt(self._aug(X)[:, None] * self._aug(Z)[None, :])
        arg = torch.clamp(2.0 * xz / denom, -1.0 + 1e-12, 1.0 - 1e-12)
        return self.variance * (2.0 / math.pi) * torch.asin(arg)

    def diag(self, X):
        a = 1.0 + torch.sum(X * X, dim=-1)
        arg = torch.clamp(2.0 * a / self._aug(X), -1.0, 1.0)
        return self.variance * (2.0 / math.pi) * torch.asin(arg)


# ------------------------------------------------------------ input transforms
@dataclasses.dataclass(frozen=True)
class Transform(Params):
    """An input transform t: R^D -> R^Q applied before a kernel.  Tensor
    fields follow the kernels' convention (positive unless listed in
    ``FREE_PARAMS``)."""

    FREE_PARAMS = frozenset()
    UNIT_PARAMS = frozenset()

    def __post_init__(self):
        _as_params(self)

    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ScaleTransform(Transform):
    """x -> s x with a positive scalar s."""

    s: torch.Tensor = 1.0

    def __call__(self, X):
        return X * self.s


@dataclasses.dataclass(frozen=True)
class ARDTransform(Transform):
    """x -> v .* x with a positive per-dimension vector v."""

    v: torch.Tensor = dataclasses.field(default_factory=lambda: torch.ones(1))

    def __call__(self, X):
        return X * self.v


@dataclasses.dataclass(frozen=True)
class LinearTransform(Transform):
    """x -> A x (rows of X times A^T); A is sign-indefinite (``FREE_PARAMS``)."""

    FREE_PARAMS = frozenset({"A"})

    A: torch.Tensor = dataclasses.field(default_factory=lambda: torch.eye(1))

    @_highest_precision
    def __call__(self, X):
        return X @ self.A.T


@dataclasses.dataclass(frozen=True)
class SelectTransform(Transform):
    """x -> x[dims], a static feature subset."""

    dims: Tuple[int, ...] = (0,)

    def __call__(self, X):
        return X[..., list(self.dims)]


@dataclasses.dataclass(frozen=True)
class FunctionTransform(Transform):
    """x -> fn(x) for a static row-wise callable on torch tensors."""

    fn: Callable = None

    def __call__(self, X):
        return self.fn(X)


@dataclasses.dataclass(frozen=True)
class ChainTransform(Transform):
    """The composition t_n(... t_1(x)), applied left to right."""

    transforms: Tuple[Transform, ...] = ()

    def __call__(self, X):
        for t in self.transforms:
            X = t(X)
        return X


@dataclasses.dataclass(frozen=True)
class TransformedKernel(Kernel):
    """k(t(x), t(z)): any kernel over transformed inputs."""

    inner: Kernel = None
    transform: Transform = None

    def gram(self, X, Z=None):
        tX = self.transform(X)
        tZ = tX if Z is None else self.transform(Z)
        return self.inner.gram(tX, tZ)

    def diag(self, X):
        return self.inner.diag(self.transform(X))


def with_transform(kernel: Kernel, transform: Transform) -> TransformedKernel:
    """The kernel over transformed inputs (KernelFunctions' ``k ∘ t``)."""
    return TransformedKernel(inner=kernel, transform=transform)


@dataclasses.dataclass(frozen=True)
class SumKernel(Kernel):
    left: Kernel = None
    right: Kernel = None

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) + self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) + self.right.diag(X)


@dataclasses.dataclass(frozen=True)
class ProductKernel(Kernel):
    left: Kernel = None
    right: Kernel = None

    def gram(self, X, Z=None):
        return self.left.gram(X, Z) * self.right.gram(X, Z)

    def diag(self, X):
        return self.left.diag(X) * self.right.diag(X)


# the concrete kernels (what a model takes)
KERNELS = (
    SqExponentialKernel, Matern12Kernel, Matern32Kernel, Matern52Kernel, RationalQuadraticKernel, CosineKernel,
    PeriodicKernel, LinearKernel, PolynomialKernel, ConstantKernel, WhiteKernel, ExponentiatedKernel,
    PiecewisePolynomialKernel, FBMKernel, GaborKernel, NeuralNetworkKernel, TransformedKernel, SumKernel,
    ProductKernel,
)

# gram kind of the fused statistics kernels for each kernel class (the
# counterpart of the reference's _PALLAS_KINDS, matched by exact type: a
# sum, a transformed kernel or any other kernel takes the plain kappa)
FUSED_KINDS = {
    SqExponentialKernel: "rbf",
    Matern12Kernel: "matern12",
    Matern32Kernel: "matern32",
    Matern52Kernel: "matern52",
}


def fused_kind(kernel: Kernel):
    """The fused kernels' gram kind of ``kernel``, or None."""
    return FUSED_KINDS.get(type(kernel))


# ------------------------------------------- positive/free parameter mapping
def _map_params(node, f_pos, f_unit, mode="pos"):
    """``node`` with f_pos on its positive tensors, f_unit on its
    ``UNIT_PARAMS`` ones, its ``FREE_PARAMS`` ones as they are, walking
    kernels, transforms and tuples of them; static fields untouched."""
    if isinstance(node, (Kernel, Transform)):
        free, unit = type(node).FREE_PARAMS, type(node).UNIT_PARAMS
        return node.replace(**{
            f.name: _map_params(getattr(node, f.name), f_pos, f_unit,
                                "free" if f.name in free else "unit" if f.name in unit else "pos")
            for f in dataclasses.fields(node)
        })
    if isinstance(node, tuple):
        return tuple(_map_params(v, f_pos, f_unit, mode) for v in node)
    if not isinstance(node, torch.Tensor) or mode == "free":
        return node
    return f_unit(node) if mode == "unit" else f_pos(node)


def to_unconstrained(kernel: Kernel) -> Kernel:
    """The kernel in the space the hyperparameter optimiser works in: log on
    positive leaves, logit on ``UNIT_PARAMS`` leaves, identity on
    ``FREE_PARAMS`` leaves.  Inverse of :func:`from_unconstrained`."""
    return _map_params(kernel, torch.log, lambda h: torch.log(h) - torch.log1p(-h))


def from_unconstrained(kernel: Kernel) -> Kernel:
    return _map_params(kernel, torch.exp, torch.sigmoid)


# -------------------------------------------------------------- latent axis
def replicate(kernel: Kernel, n_latent: int) -> Kernel:
    """Stack a kernel's tensors with a leading latent axis [L, ...]."""
    return kernel.map(lambda p: torch.broadcast_to(p, (n_latent,) + p.shape).clone())


def latent(kernel: Kernel, l: int) -> Kernel:
    """The kernel of latent ``l`` of a replicated kernel."""
    return kernel.map(lambda p: p[l])


def n_latent(kernel: Kernel) -> int:
    """The latent count of a replicated kernel: its first tensor's leading
    extent, in path order."""
    return next(iter(path_leaves(kernel).values())).shape[0]


def batch_gram(kernel: Kernel, X, Z=None) -> torch.Tensor:
    """[L, N, M] Gram stack from a replicated kernel ([L]-leading tensors).
    ``Z`` None (or ``X`` itself) is the gram of X with itself."""
    L = n_latent(kernel)
    if Z is None:
        return torch.stack([latent(kernel, l).gram(X, X) for l in range(L)])
    if Z.ndim == 3:  # per-latent inducing sets
        return torch.stack([latent(kernel, l).gram(X, Z[l]) for l in range(L)])
    return torch.stack([latent(kernel, l).gram(X, Z) for l in range(L)])


def batch_gram_zz(kernel: Kernel, Z) -> torch.Tensor:
    """[L, M, M] Gram of per-latent inducing sets Z [L, M, D], each of one
    tensor with itself (``WhiteKernel`` adds its variance there)."""
    out = []
    for l in range(Z.shape[0]):
        z = Z[l]
        out.append(latent(kernel, l).gram(z, z))
    return torch.stack(out)


def batch_diag(kernel: Kernel, X) -> torch.Tensor:
    return torch.stack([latent(kernel, l).diag(X) for l in range(n_latent(kernel))])


def lengthscale_2d(kernel: Kernel, D: int) -> torch.Tensor:
    """[L, D] per-latent lengthscales of a replicated stationary kernel
    (scalar [L] or ARD [L, D] fields), as the multi-latent fused kernels
    take them."""
    ls = kernel.lengthscale
    L = ls.shape[0]
    return torch.broadcast_to(ls.reshape(L, -1), (L, D))
