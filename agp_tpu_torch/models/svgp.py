"""SVGP: sparse variational Gaussian process over an inducing set Z, and
VGP, the full variational GP over its training inputs: the counterparts of
``SVGP`` and ``VGP`` in ``agp_tpu/models/svgp.py``.

The latent GPs live on a stacked axis ([L, M, D] inducing points).  The
port takes every kernel of ``kernels.KERNELS`` (sums, products and
kernels over transformed inputs too), the single-latent likelihoods of ``fused_cavi_stats`` (logistic,
Gaussian with fixed noise, Student-t, Laplace, Matern-3/2 noise, Bayesian
SVM, Poisson, negative binomial), the logistic-softmax and heteroscedastic
likelihoods, the softmax and any likelihood that
``make_augmented_likelihood`` builds, the analytic and the numerical
engines, every prior mean of ``means.py``, and the reference's
hyperparameter learning: by default Adam(0.01) on the unconstrained kernel
parameters and the prior mean's parameters, optionally a
``Zoptimiser`` on the inducing points (``training/autotuning.py``), or
fixed hyperparameters (``optimiser=None``).  A VGP takes the same
kernels, likelihoods and means, with full-batch (not stochastic) steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..inference.config import InferenceConfig
from ..kernels import KERNELS
from ..likelihoods.base import Likelihood
from ..likelihoods.classification import BayesianSVM, LogisticLikelihood
from ..likelihoods.event import NegBinomialLikelihood, PoissonLikelihood
from ..likelihoods.heteroscedastic import HeteroscedasticLikelihood
from ..likelihoods.generic import GenericAugmentedLikelihood
from ..likelihoods.multiclass import LogisticSoftMaxLikelihood, SoftMaxLikelihood
from ..likelihoods.regression import (
    GaussianLikelihood,
    LaplaceLikelihood,
    Matern32Likelihood,
    StudentTLikelihood,
)
from ..means import AffineMean, ConstantMean, EmpiricalMean, PriorMean, ZeroMean, as_mean
from ..utils.opt import GradientTransformation, adam
from ..utils.tensors import Params
from .base import as_2d, check_card_dtype, check_implemented, match_dtype, model_repr, prepare_components

_PORTED_KERNELS = KERNELS
_PORTED_LIKELIHOODS = (
    LogisticLikelihood,
    GaussianLikelihood,
    StudentTLikelihood,
    LaplaceLikelihood,
    Matern32Likelihood,
    BayesianSVM,
    PoissonLikelihood,
    NegBinomialLikelihood,
    LogisticSoftMaxLikelihood,
    HeteroscedasticLikelihood,
    SoftMaxLikelihood,
    GenericAugmentedLikelihood,
)
_PORTED_MEANS = (ZeroMean, ConstantMean, EmpiricalMean, AffineMean)


def _check_ported(kernel, likelihood, mean, optimiser, Zoptimiser=None, Aoptimiser=None):
    """Raises ``NotImplementedError`` for a component or an optimiser that
    the port does not have."""
    for opt, what in ((optimiser, "optimiser"), (Zoptimiser, "Zoptimiser"), (Aoptimiser, "Aoptimiser")):
        if opt is not None and not isinstance(opt, GradientTransformation):
            raise NotImplementedError(
                f"{what} {opt!r} is not ported: pass None, 'default' (optimiser only) or a "
                "GradientTransformation of agp_tpu_torch.utils.opt (adam)"
            )
    for obj, ported, what in (
        (kernel, _PORTED_KERNELS, "kernel"),
        (likelihood, _PORTED_LIKELIHOODS, "likelihood"),
        (ZeroMean() if mean is None else as_mean(mean), _PORTED_MEANS, "mean"),
    ):
        if not isinstance(obj, ported):
            raise NotImplementedError(
                f"{type(obj).__name__} is not ported yet; the {what}s of "
                f"this port are {[c.__name__ for c in ported]}"
            )


def _place(kernel, likelihood, mean, n_latent, like):
    """The kernel and the mean replicated over the latents, and all three
    on ``like``'s device and dtype."""
    kernel, mean = prepare_components(kernel, likelihood, mean, n_latent)
    to = dict(device=like.device, dtype=like.dtype)
    return kernel.to(**to), likelihood.to(**to), mean.to(**to)


@dataclasses.dataclass(frozen=True, repr=False)
class SVGP(Params):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    Z: torch.Tensor  # [L, M, D]
    inference: InferenceConfig
    n_latent: int
    atfrequency: int = 1
    optimiser: Optional[Any] = None
    Zoptimiser: Optional[Any] = None

    is_sparse = True
    is_multioutput = False
    is_online = False

    @classmethod
    def create(
        cls,
        kernel,
        likelihood,
        inference,
        Z,
        mean=None,
        optimiser="default",
        Zoptimiser=None,
        atfrequency: int = 1,
    ):
        """Data-free constructor; data is given to ``train``.  The kernel's,
        the likelihood's and the mean's parameters are placed on Z's device
        and dtype.  Z given without a device (numpy, a list) goes to
        ``config.default_device()``: the CUDA card unless the CPU was
        chosen.  A Z on a CUDA device that is neither float32 nor float64
        raises ``TypeError``; a float64 model there takes kernels 4-7's
        float64 form (the split pairs: the fused kernels 1-3 are
        float32-only).

        ``optimiser`` learns the kernel's (log) and the mean's parameters
        every ``atfrequency`` CAVI steps: "default" is the reference's
        ``adam(0.01)``, None keeps them fixed, or a
        ``utils.opt.GradientTransformation``.  ``Zoptimiser`` (None, or a
        ``GradientTransformation``) learns the inducing points too.  Any
        other optimiser (an optax one, say) raises ``NotImplementedError``."""
        if optimiser == "default":
            optimiser = adam(0.01)
        _check_ported(kernel, likelihood, mean, optimiser, Zoptimiser)
        check_implemented(likelihood, inference)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        Z = as_2d(Z)
        check_card_dtype(Z.device, Z.dtype)
        kernel, likelihood, mean = _place(kernel, likelihood, mean, n_latent, Z)
        if Z.ndim == 2:
            Z = Z.expand((n_latent,) + Z.shape).clone()
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            Z=Z,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zoptimiser=Zoptimiser,
        )

    @property
    def n_inducing(self):
        return self.Z.shape[1]

    __repr__ = model_repr


@dataclasses.dataclass(frozen=True, repr=False)
class VGP(Params):
    """Full variational GP: the sparse model's CAVI with Z = X, the dense
    natural-gradient branch.  It carries its training data; ``train(vgp)``
    takes no X and y."""

    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    train_x: torch.Tensor  # [N, D]
    train_y: torch.Tensor
    inference: InferenceConfig
    n_latent: int
    atfrequency: int = 1
    optimiser: Optional[Any] = None

    is_sparse = False
    is_multioutput = False
    is_online = False

    @classmethod
    def create(cls, X, y, kernel, likelihood, inference, mean=None, optimiser="default", atfrequency: int = 1):
        """Builds the model on (X, y), the labels treated by the likelihood.
        X without a device goes to ``config.default_device()``, y to X's
        device; the kernel's, the likelihood's and the mean's parameters
        are placed on X's device and dtype.  Stochastic inference raises
        ``ValueError`` (a VGP uses all its data each step: use SVGP), X
        on a CUDA device that is neither float32 nor float64 ``TypeError``
        (a VGP runs no kernel of the port); ``optimiser``
        as ``SVGP.create`` takes it."""
        if optimiser == "default":
            optimiser = adam(0.01)
        _check_ported(kernel, likelihood, mean, optimiser)
        check_implemented(likelihood, inference)
        if inference.stochastic:
            raise ValueError("VGP does not support stochastic inference; use SVGP")
        X = as_2d(X)
        check_card_dtype(X.device, X.dtype)
        y, likelihood = likelihood.treat_labels(y)
        y = match_dtype(y.to(X.device), X)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, likelihood, mean = _place(kernel, likelihood, mean, n_latent, X)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            train_x=X,
            train_y=y,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
        )

    @property
    def Z(self):
        """The training inputs as the "inducing set" [L, N, D] of the shared
        prediction path (a view)."""
        return self.train_x.expand((self.n_latent,) + self.train_x.shape)

    @property
    def n_inducing(self):
        return self.train_x.shape[0]

    __repr__ = model_repr
