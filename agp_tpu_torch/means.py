"""Prior mean functions: the counterpart of ``agp_tpu/means.py``.

A mean's tensor fields (``leaves()``) are what the hyperparameter step
updates, unconstrained: ``ConstantMean.c``, ``EmpiricalMean.v``,
``AffineMean.w`` and ``b`` (each with a leading [L] axis once replicated
over the latents); ``ZeroMean`` has none."""
from __future__ import annotations

import dataclasses

import torch

from .utils.tensors import Params


@dataclasses.dataclass(frozen=True)
class PriorMean(Params):
    def __call__(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class ZeroMean(PriorMean):
    def __call__(self, X):
        return torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)


@dataclasses.dataclass(frozen=True)
class ConstantMean(PriorMean):
    c: torch.Tensor = 0.0

    def __post_init__(self):
        if not isinstance(self.c, torch.Tensor):
            object.__setattr__(self, "c", torch.as_tensor(self.c, dtype=torch.get_default_dtype()))

    def __call__(self, X):
        return torch.broadcast_to(self.c, (X.shape[0],)).to(X.dtype)


def _tensor(v):
    return v if isinstance(v, torch.Tensor) else torch.as_tensor(v, dtype=torch.get_default_dtype())


@dataclasses.dataclass(frozen=True)
class EmpiricalMean(PriorMean):
    """One free mean value per (inducing) point: v [n]."""

    v: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(1))

    def __post_init__(self):
        object.__setattr__(self, "v", _tensor(self.v))

    def __call__(self, X):
        return torch.broadcast_to(self.v, (X.shape[0],)).to(X.dtype)


@dataclasses.dataclass(frozen=True)
class AffineMean(PriorMean):
    """m(x) = x.w + b."""

    w: torch.Tensor = dataclasses.field(default_factory=lambda: torch.zeros(1))
    b: torch.Tensor = 0.0

    def __post_init__(self):
        object.__setattr__(self, "w", _tensor(self.w))
        object.__setattr__(self, "b", _tensor(self.b))

    def __call__(self, X):
        return X @ self.w + self.b


def as_mean(mean) -> PriorMean:
    """Coerce a scalar (a ConstantMean), a vector (an EmpiricalMean) or a
    PriorMean into a PriorMean."""
    if isinstance(mean, PriorMean):
        return mean
    t = _tensor(mean)
    return ConstantMean(c=t) if t.ndim == 0 else EmpiricalMean(v=t)


def replicate(mean: PriorMean, n_latent: int) -> PriorMean:
    return mean.map(lambda p: torch.broadcast_to(p, (n_latent,) + p.shape).clone())


def batch_call(mean: PriorMean, X, n_latent: int | None = None) -> torch.Tensor:
    """[L, N] prior mean stack from a replicated mean; X is [N, D] or a
    per-latent [L, N, D].  ZeroMean has no fields to carry the latent axis,
    so ``n_latent`` (or a per-latent X) supplies it in that case."""
    leaves = [getattr(mean, f.name) for f in dataclasses.fields(mean)]
    leaves = [v for v in leaves if isinstance(v, torch.Tensor)]
    if leaves:
        L = leaves[0].shape[0]
        means = [mean.map(lambda p: p[l]) for l in range(L)]
        if X.ndim == 3:
            return torch.stack([m(x) for m, x in zip(means, X)])
        return torch.stack([m(X) for m in means])
    if X.ndim == 3:
        return torch.stack([mean(x) for x in X])
    out = mean(X)
    L = 1 if n_latent is None else n_latent
    return torch.broadcast_to(out, (L,) + out.shape)
