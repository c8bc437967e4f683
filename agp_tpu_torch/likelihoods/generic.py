"""The generic augmented-likelihood factory: the counterpart of
``agp_tpu/likelihoods/generic.py`` (the reference's ``@augmodel``).

A likelihood class is built from the septuple (C, g, alpha, beta, gamma,
phi, dphi) describing densities of the form

    p(y | f) = C exp(g(y) f) phi(alpha(y) - beta(y) f + gamma(y) f^2)

with phi a Laplace transform.  Closed-form CAVI updates for any such
likelihood:

    c^2   = alpha(y) - beta(y) mu + gamma(y) (mu^2 + var)
    theta = -phi'(c^2) / phi(c^2)
    grad_e_mu    = g(y) + theta beta(y)
    grad_e_sigma = theta gamma(y)
    E[log p]     = n log C + g.mu - (theta.alpha - theta.(beta mu)
                                     + theta.(gamma (mu^2 + var)))
    AugKL        = -c^2.theta - sum log phi(c^2)

The callables take and return torch tensors; dphi defaults to the
derivative of phi by automatic differentiation.  A generic likelihood is
none of the fused statistics pass's eight, so a sparse model's CAVI step
takes the single-latent split pair (kernels 6 and 7 on the card).  Gibbs
draws the auxiliary from its Laplace transform
(``distributions/lap_transf.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from ..distributions.lap_transf import LaplaceTransformDistribution
from ..ops.quadrature import expectation
from .base import SingleLatentLikelihood
from .classification import _treat_binary

LTYPES = ("Regression", "Classification", "Event")


@dataclasses.dataclass(frozen=True)
class GenericAugmentedLikelihood(SingleLatentLikelihood):
    """The base of every class ``make_augmented_likelihood`` builds."""


def _ad_derivative(phi):
    """phi' elementwise by autograd: the gradient of the summed phi (phi is
    elementwise), taken off the caller's graph (the E-step's theta is not
    differentiated)."""

    def dphi(r):
        with torch.enable_grad():
            r = r.detach().requires_grad_(True)
            return torch.autograd.grad(torch.sum(phi(r)), r)[0]

    return dphi


def make_augmented_likelihood(
    name: str,
    ltype: str,
    C: Callable[[], float] | float,
    g: Callable,
    alpha: Callable,
    beta: Callable,
    gamma: Callable,
    phi: Callable,
    dphi: Optional[Callable] = None,
):
    """A likelihood class from the (C, g, alpha, beta, gamma, phi, dphi)
    septuple.  ``ltype`` is "Regression", "Classification" (labels +-1, or
    {0, 1} mapped to them) or "Event"."""
    if ltype not in LTYPES:
        raise ValueError("ltype must be Regression, Classification or Event")
    C_val = C if callable(C) else (lambda: C)
    if dphi is None:
        dphi = _ad_derivative(phi)

    def log_C():
        c = C_val()
        return torch.log(c) if isinstance(c, torch.Tensor) else math.log(c)

    class GenericAugmented(GenericAugmentedLikelihood):
        @classmethod
        def create(cls):
            return cls()

        @classmethod
        def implemented(cls):
            return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling"})

        def treat_labels(self, y):
            if ltype == "Classification":
                return _treat_binary(y), self
            return torch.as_tensor(y), self

        def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
            return {
                "c2": torch.ones((batchsize,), dtype=dtype, device=device),
                "theta": torch.ones((batchsize,), dtype=dtype, device=device),
            }

        def _local_updates(self, y, mu, var, local):
            c2 = alpha(y) - beta(y) * mu + gamma(y) * (mu**2 + var)
            theta = -dphi(c2) / phi(c2)
            return self, {**local, "c2": c2, "theta": theta}

        def _grad_e_mu(self, y, local):
            return g(y) + local["theta"] * beta(y)

        def _grad_e_sigma(self, y, local):
            return local["theta"] * gamma(y)

        def _expec_loglik(self, y, mu, var, local):
            theta = local["theta"]
            tot = y.shape[0] * log_C() + torch.sum(g(y) * mu)
            return tot - torch.sum(
                theta * alpha(y) - theta * (beta(y) * mu) + theta * (gamma(y) * (mu**2 + var))
            )

        def aug_kl(self, local, y):
            c2, theta = local["c2"], local["theta"]
            return -torch.sum(c2 * theta) - torch.sum(torch.log(phi(c2)))

        def log_prob(self, y, f):
            return log_C() + g(y) * f + torch.log(phi(alpha(y) - beta(y) * f + gamma(y) * f**2))

        def compute_proba(self, mu, var):
            if ltype == "Regression":
                return mu, torch.clamp(var, min=0.0)
            return expectation(lambda x: torch.exp(self.log_prob(torch.ones_like(x), x)), mu, var)

        def predict_y(self, mu):
            if ltype == "Classification":
                return torch.sign(mu)
            return mu

        def _sample_local(self, generator, y, f, local):
            # omega | f is the prior (Laplace transform phi) tilted by
            # s0 = alpha(y) - beta(y) f + gamma(y) f^2
            s0 = alpha(y) - beta(y) * f + gamma(y) * f**2
            omega = LaplaceTransformDistribution(phi).sample(generator, s0)
            return {**local, "c2": s0, "theta": omega}

    GenericAugmented.__name__ = f"{name}Likelihood"
    GenericAugmented.__qualname__ = GenericAugmented.__name__
    return GenericAugmented
