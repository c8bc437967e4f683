"""Regression likelihoods: Gaussian, Student-t, Laplace and Matern-3/2
noise, the counterparts of ``agp_tpu/likelihoods/regression.py``.

Each parameter is a 0-d tensor on the model's device.  The Gaussian
learns its noise when it has an ``opt_noise`` rule.  Each draws its
augmentation for Gibbs sampling (``_sample_local``).  Not ported yet: the
pointwise derivatives (``grad_log_prob``, ``hess_log_prob``) of numerical
VI.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..distributions.gig import sample_gig
from ..ops.kl import gig_entropy, inverse_gamma_kl
from ..ops.special import LOG2, digamma, gammaln
from ..utils.opt import GradientTransformation, adam, ascent_update
from .base import SingleLatentLikelihood, tensor_fields

LOG2PI = 1.8378770664093453


def _rows(value, batchsize, dtype, device):
    """[batchsize] copies of a 0-d tensor, made on the device."""
    return torch.ones((batchsize,), dtype=dtype, device=device) * value


@dataclasses.dataclass(frozen=True)
class GaussianLikelihood(SingleLatentLikelihood):
    """Conjugate Gaussian noise of variance ``sigma2``; theta = 1/sigma2.

    With an ``opt_noise`` rule (``create(opt_noise=True)``: ``adam(0.05)``)
    the E-step also takes one ascent step on log sigma2 along
    ((sum (y - mu)^2 + sum var) / sigma2 - n) / 2, the rows with w = 0 left
    out of the sums; the rule's state is the local variable
    "state_sigma2".  sigma2 stays a 0-d tensor on the device."""

    sigma2: torch.Tensor = 1e-3
    opt_noise: Optional[Any] = None

    # noise learning sums over the batch, so the row mask reaches the E-step
    _weighted_params = True

    def __post_init__(self):
        tensor_fields(self, "sigma2")

    @classmethod
    def create(cls, sigma2: float = 1e-3, opt_noise=False):
        if isinstance(opt_noise, bool):
            opt_noise = adam(0.05) if opt_noise else None
        if opt_noise is not None and not isinstance(opt_noise, GradientTransformation):
            raise NotImplementedError(
                f"opt_noise {opt_noise!r} is not ported: pass True (adam(0.05)), False, None or a "
                "GradientTransformation of agp_tpu_torch.utils.opt"
            )
        return cls(sigma2=sigma2, opt_noise=opt_noise)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "Analytic", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        local = {"theta": _rows(1.0 / self.sigma2, batchsize, dtype, device)}
        if self.opt_noise is not None:
            local["state_sigma2"] = self.opt_noise.init(torch.zeros((), dtype=dtype, device=device))
        return local

    def _local_updates(self, y, mu, var, local, w=None):
        lik = self
        if self.opt_noise is not None:
            if w is None:
                n = y.shape[0]
                ssq, svar = torch.sum((y - mu) ** 2), torch.sum(var)
            else:
                n = torch.sum(w)
                ssq, svar = torch.sum(w * (y - mu) ** 2), torch.sum(w * var)
            grad = ((ssq + svar) / self.sigma2 - n) / 2.0
            opt_state, delta = ascent_update(self.opt_noise, local["state_sigma2"], torch.log(self.sigma2), grad)
            lik = self.replace(sigma2=torch.exp(torch.log(self.sigma2) + delta))
            local = {**local, "state_sigma2": opt_state}
        return lik, {**local, "theta": torch.ones_like(local["theta"]) / lik.sigma2}

    def _grad_e_mu(self, y, local):
        return y / self.sigma2

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        return -0.5 * (
            n * (LOG2PI + torch.log(self.sigma2))
            + (torch.sum((y - mu) ** 2) + torch.sum(var)) / self.sigma2
        )

    def aug_kl(self, local, y):
        return torch.zeros((), dtype=self.sigma2.dtype, device=self.sigma2.device)

    def _sample_local(self, generator, y, f, local):
        return local  # no auxiliary variable

    def compute_proba(self, mu, var):
        return mu, var + self.sigma2

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        return -0.5 * (LOG2PI + torch.log(self.sigma2) + (y - f) ** 2 / self.sigma2)


@dataclasses.dataclass(frozen=True)
class StudentTLikelihood(SingleLatentLikelihood):
    """Student-t noise, augmented by omega ~ InverseGamma(nu/2, nu/2) so that
    p(y | f, omega) = N(y | f, sigma^2 omega).

    Local updates: c = (E[(y - f)^2] + sigma^2 nu)/2, theta = alpha/c with
    alpha = (nu + 1)/2.  ``log_prob`` is the reference's density."""

    nu: torch.Tensor = 3.0
    sigma: torch.Tensor = 1.0

    def __post_init__(self):
        tensor_fields(self, "nu", "sigma")

    @classmethod
    def create(cls, nu: float, sigma: float = 1.0):
        if nu <= 0.5:
            raise ValueError("nu should be greater than 0.5")
        return cls(nu=nu, sigma=sigma)

    @property
    def alpha(self):
        return (self.nu + 1.0) / 2.0

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.zeros((batchsize,), dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        c = ((mu - y) ** 2 + var + self.sigma**2 * self.nu) / 2.0
        return self, {**local, "c": c, "theta": self.alpha / c}

    def _grad_e_mu(self, y, local):
        return local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta, c = local["theta"], local["c"]
        tot = -n * torch.log(2.0 * math.pi * self.sigma**2) / 2.0
        tot = tot - torch.sum(torch.log(c) - digamma(self.alpha))
        return tot - 0.5 * torch.sum(theta * ((mu - y) ** 2 + var))

    def aug_kl(self, local, y):
        alpha_p = self.nu / 2.0
        return inverse_gamma_kl(self.alpha, local["c"], alpha_p, alpha_p * self.sigma**2)

    def _sample_local(self, generator, y, f, local):
        # omega ~ InverseGamma(alpha, ((f - y)^2 + sigma^2 nu) / 2), theta = 1/omega
        b = ((f - y) ** 2 + self.sigma**2 * self.nu) / 2.0
        g = torch._standard_gamma(self.alpha.expand(f.shape).contiguous(), generator=generator)
        omega = b / g
        return {**local, "c": omega, "theta": 1.0 / omega}

    def compute_proba(self, mu, var):
        return mu, torch.clamp(var, min=0.0) + self.nu * self.sigma**2 / (self.nu - 2.0)

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        return (
            gammaln(self.alpha)
            - 0.5 * torch.log(self.nu * math.pi)
            - gammaln(self.nu / 2.0)
            - self.alpha * torch.log1p(((y - f) / self.sigma) ** 2)
        )


@dataclasses.dataclass(frozen=True)
class LaplaceLikelihood(SingleLatentLikelihood):
    """Laplace noise of scale ``beta``, augmented by omega ~ Exp(1/(2 beta^2))
    with q(omega) = GIG(a, b^2, 1/2), a = 1/beta^2.

    Local updates: b = sqrt(E[(y - f)^2]), theta = sqrt(a)/b."""

    beta: torch.Tensor = 1.0

    def __post_init__(self):
        tensor_fields(self, "beta")

    @classmethod
    def create(cls, beta: float = 1.0):
        return cls(beta=beta)

    @property
    def a(self):
        return self.beta ** (-2.0)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "b": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.zeros((batchsize,), dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        b = torch.sqrt((mu - y) ** 2 + var)
        return self, {**local, "b": b, "theta": torch.sqrt(self.a) / b}

    def _grad_e_mu(self, y, local):
        return local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta = local["theta"]
        tot = -n * LOG2PI / 2.0 + torch.sum(torch.log(theta)).detach() / 2.0
        return tot - 0.5 * torch.sum(theta * ((mu - y) ** 2 + var))

    def aug_kl(self, local, y):
        b = local["b"]
        b2 = b**2
        ent = gig_entropy(self.a, b2, 0.5)
        # E_q[log p(omega)] for p = Exp(1/(2 beta^2))
        expec_exp = torch.sum(
            -torch.log(2.0 * self.beta**2)
            - (self.a * b + b2 * torch.sqrt(self.a)) / (self.a * b2 * self.beta**2) / 2.0
        )
        return ent - expec_exp

    def _sample_local(self, generator, y, f, local):
        # omega ~ GIG(1/beta^2, (f - y)^2, 1/2), kept in b; theta = 1/omega
        omega = sample_gig(generator, self.a, (f - y) ** 2, 0.5)
        return {**local, "b": omega, "theta": 1.0 / omega}

    def compute_proba(self, mu, var):
        return mu, torch.clamp(var, min=0.0) + 2.0 * self.beta**2

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        return -torch.abs(y - f) / self.beta - torch.log(2.0 * self.beta)

    def grad_log_prob(self, y, f):
        return torch.sign(y - f) / self.beta

    def hess_log_prob(self, y, f):
        return torch.zeros_like(f)


@dataclasses.dataclass(frozen=True)
class Matern32Likelihood(SingleLatentLikelihood):
    """Matern-3/2 noise p(y|f) = sqrt(3)/(4 rho) (1 + u) e^-u,
    u = sqrt(3)|y - f|/rho, as a Gaussian variance mixture with
    q(v) = GIG(3/rho^2, c^2, 3/2).

    Local updates: c = sqrt(E[(y - f)^2]),
    theta = E[1/v]/2 = 3 / (2 sqrt(3) c rho + 2 rho^2); grad_e_mu = 2 theta y,
    grad_e_sigma = theta.  ``aug_kl`` is the reference's closed form, whose
    E[log v] terms cancel against ``expec_loglik``'s."""

    rho: torch.Tensor = 1.0

    def __post_init__(self):
        tensor_fields(self, "rho")

    @classmethod
    def create(cls, rho: float = 1.0):
        return cls(rho=rho)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.zeros((batchsize,), dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        c = torch.sqrt((mu - y) ** 2 + var)
        theta = 3.0 / (2.0 * math.sqrt(3.0) * c * self.rho + 2.0 * self.rho**2)
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return 2.0 * local["theta"] * y

    def _grad_e_sigma(self, y, local):
        return local["theta"]

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        return -n * LOG2PI / 2.0 - torch.sum(local["theta"] * ((mu - y) ** 2 + var))

    def aug_kl(self, local, y):
        c = torch.clamp(local["c"], min=1e-10)
        theta = local["theta"]
        a = 3.0 / self.rho**2
        z = torch.sqrt(a) * c
        # log(2 K_{3/2}(z)) = log 2 + 0.5 log(pi/(2z)) - z + log1p(1/z)
        log_2k32 = LOG2 + 0.5 * (math.log(math.pi) - LOG2 - torch.log(z)) - z + torch.log1p(1.0 / z)
        per_point = (
            0.75 * (torch.log(a) - 2.0 * torch.log(c)) - log_2k32 - c**2 * theta - 2.0 * torch.log(a / 2.0)
        )
        return torch.sum(per_point)

    def _sample_local(self, generator, y, f, local):
        # exact blocked Gibbs: v | f ~ GIG(3/rho^2, (y - f)^2, 3/2); theta = 1/(2v)
        a = torch.full_like(f, 3.0) / self.rho**2
        v = sample_gig(generator, a, (f - y) ** 2, 1.5)
        return {**local, "c": torch.abs(f - y), "theta": 1.0 / (2.0 * v)}

    def compute_proba(self, mu, var):
        return mu, torch.clamp(var, min=0.0) + 4.0 * self.rho**2 / 3.0

    def predict_y(self, mu):
        return mu

    def log_prob(self, y, f):
        u = math.sqrt(3.0) * torch.abs(y - f) / self.rho
        return torch.log(math.sqrt(3.0) / (4.0 * self.rho)) + torch.log1p(u) - u

    def grad_log_prob(self, y, f):
        return 3.0 * (y - f) / (self.rho * (torch.abs(f - y) * math.sqrt(3.0) + self.rho))

    def hess_log_prob(self, y, f):
        return -3.0 / (self.rho + math.sqrt(3.0) * torch.abs(f - y)) ** 2
