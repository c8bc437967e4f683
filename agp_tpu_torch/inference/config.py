"""Inference-engine configurations: the counterpart of ``Analytic``,
``AnalyticVI``, ``AnalyticSVI``, the numerical engines (``QuadratureVI``,
``QuadratureSVI``, ``MCIntegrationVI``, ``MCIntegrationSVI``,
``NumericalVI``, ``NumericalSVI``), ``GibbsSampling`` and ``HMCSampling``
in ``agp_tpu/inference/config.py``.  Everything here is static
configuration; the dynamic parts (rho, the step counter, the optimiser
state, the local variables) live in the TrainState."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..utils.opt import robbins_monro, sgd

SAMPLING_MODES = ("gather", "slice", "block")


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    stochastic: bool = False
    batchsize: int = 0

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Analytic(InferenceConfig):
    """Exact conjugate solve for ``GP``."""

    stochastic: bool = False
    batchsize: int = 0


@dataclasses.dataclass(frozen=True)
class AnalyticVI(InferenceConfig):
    """Blockwise CAVI with closed-form natural-gradient updates.

    minibatch_sampling: "gather" draws b iid row indices; "slice" takes a
    contiguous window at a random offset; "block" (or "block:<n>") draws
    b/n random aligned n-row tiles (default n=64, halved until it divides
    b), a block bootstrap over pre-shuffled rows, falling back to "gather"
    when b is not a multiple of n."""

    stochastic: bool = False
    batchsize: int = 0
    optimiser: Optional[Any] = None
    minibatch_sampling: str = "gather"

    def __post_init__(self):
        if self.minibatch_sampling.split(":", 1)[0] not in SAMPLING_MODES:
            raise ValueError(
                f"minibatch_sampling must be one of {SAMPLING_MODES} "
                f"(or 'block:<n>'), got {self.minibatch_sampling!r}"
            )

    @property
    def name(self):
        return "AnalyticVI"


def AnalyticSVI(batchsize: int, optimiser=None, minibatch_sampling: str = "gather") -> AnalyticVI:
    """Stochastic AnalyticVI on minibatches with Robbins-Monro steps."""
    if optimiser is None:
        optimiser = robbins_monro()
    return AnalyticVI(
        stochastic=True,
        batchsize=batchsize,
        optimiser=optimiser,
        minibatch_sampling=minibatch_sampling,
    )


@dataclasses.dataclass(frozen=True)
class QuadratureVI(InferenceConfig):
    """Numerical VI with Gauss-Hermite expectations of the log-likelihood's
    derivatives (``inference/numerical_vi.py``).  ``clipping`` > 0 clips
    them to [-clipping, clipping] (0: off); ``natural`` preconditions the
    gradients into the natural geometry; the optimiser (default
    ``sgd(1e-5, 0.9)``) steps mu and Sigma."""

    stochastic: bool = False
    batchsize: int = 0
    n_points: int = 100
    clipping: float = 0.0
    natural: bool = True
    optimiser: Optional[Any] = None

    def __post_init__(self):
        if self.optimiser is None:
            object.__setattr__(self, "optimiser", sgd(1e-5, momentum=0.9))

    @property
    def name(self):
        return "QuadratureVI"


def QuadratureSVI(batchsize: int, n_points: int = 100, optimiser=None, **kw) -> QuadratureVI:
    """Stochastic QuadratureVI on minibatches of ``batchsize`` rows."""
    return QuadratureVI(stochastic=True, batchsize=batchsize, n_points=n_points, optimiser=optimiser, **kw)


@dataclasses.dataclass(frozen=True)
class MCIntegrationVI(InferenceConfig):
    """Numerical VI with Monte Carlo expectations over ``n_mc`` draws a
    step (``inference/numerical_vi.py``); the fields as ``QuadratureVI``'s,
    the optimiser ``sgd(1e-3, 0.9)`` by default."""

    stochastic: bool = False
    batchsize: int = 0
    n_mc: int = 1000
    clipping: float = 0.0
    natural: bool = True
    optimiser: Optional[Any] = None

    def __post_init__(self):
        if self.optimiser is None:
            object.__setattr__(self, "optimiser", sgd(1e-3, momentum=0.9))

    @property
    def name(self):
        return "MCIntegrationVI"


def MCIntegrationSVI(batchsize: int, n_mc: int = 200, optimiser=None, **kw) -> MCIntegrationVI:
    """Stochastic MCIntegrationVI on minibatches of ``batchsize`` rows."""
    return MCIntegrationVI(stochastic=True, batchsize=batchsize, n_mc=n_mc, optimiser=optimiser, **kw)


NUMERICAL = ("QuadratureVI", "MCIntegrationVI")


def NumericalVI(integration_technique: str = "quad", **kw):
    """QuadratureVI ("quad") or MCIntegrationVI ("mc")."""
    if integration_technique == "quad":
        return QuadratureVI(**kw)
    if integration_technique == "mc":
        return MCIntegrationVI(**kw)
    raise ValueError("integration_technique must be 'quad' or 'mc'")


def NumericalSVI(batchsize: int, integration_technique: str = "quad", **kw):
    """QuadratureSVI ("quad") or MCIntegrationSVI ("mc")."""
    if integration_technique == "quad":
        return QuadratureSVI(batchsize, **kw)
    if integration_technique == "mc":
        return MCIntegrationSVI(batchsize, **kw)
    raise ValueError("integration_technique must be 'quad' or 'mc'")


GIBBS_SOLVERS = ("auto", "chol", "cg")


@dataclasses.dataclass(frozen=True)
class GibbsSampling(InferenceConfig):
    """Blocked Gibbs sampling over (omega, f).

    solver: the global resample's algorithm.  "chol": the exact Cholesky
    of 2 diag(theta) + K^-1 each sweep (the reference's algorithm); "cg":
    the whitened perturb-and-solve, batched conjugate gradients (exact up
    to CG's 1e-5 relative residual); "auto": "chol" (the port carries no
    device gate)."""

    stochastic: bool = False
    batchsize: int = 0
    n_burnin: int = 100
    thinning: int = 1
    solver: str = "auto"

    def __post_init__(self):
        if self.solver not in GIBBS_SOLVERS:
            raise ValueError(f"solver must be one of {GIBBS_SOLVERS}, got {self.solver!r}")

    @property
    def name(self):
        return "GibbsSampling"


@dataclasses.dataclass(frozen=True)
class HMCSampling(InferenceConfig):
    """Hamiltonian sampling of f on the whitened latents.

    algorithm="nuts" (default): bounded-depth iterative multinomial NUTS
    with the generalized no-U-turn criterion; algorithm="hmc": fixed-length
    leapfrog.  Both adapt the step size by dual averaging during burn-in."""

    stochastic: bool = False
    batchsize: int = 0
    n_burnin: int = 100
    thinning: int = 1
    step_size: float = 0.1
    n_leapfrog: int = 16  # hmc only
    max_depth: int = 8  # nuts only
    algorithm: str = "nuts"

    @property
    def name(self):
        return "HMCSampling"
