"""Binary classification: the logistic likelihood with its Polya-Gamma
augmentation and the Bayesian SVM, the counterparts of ``LogisticLikelihood``
and ``BayesianSVM`` in ``agp_tpu/likelihoods/classification.py``.  Labels
are +-1 ({0, 1} maps to {-1, +1})."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributions.polyagamma import sample_pg1
from ..ops.kl import polya_gamma_kl
from ..ops.quadrature import expectation
from ..ops.special import log_besselk_half, sqrt_expec_square
from .base import SingleLatentLikelihood

LOG2 = 0.6931471805599453


def _treat_binary(y):
    """Labels as float64 +-1 on the host; a tensor keeps its device."""
    device = y.device if isinstance(y, torch.Tensor) else None
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    uniq = set(np.unique(y).tolist())
    if uniq <= {-1, 1}:
        out = y.astype(np.float64)
    elif uniq <= {0, 1}:
        out = (2.0 * y - 1.0).astype(np.float64)
    else:
        raise ValueError("binary labels must be in {-1, 1} or {0, 1}")
    return torch.as_tensor(out, device=device)


@dataclasses.dataclass(frozen=True)
class LogisticLikelihood(SingleLatentLikelihood):
    """Bernoulli likelihood with logistic link, augmented by omega ~ PG(1, 0):
    p(y | f, omega) = exp(yf/2 - (yf)^2 omega / 2) / 2.

    Local updates: c = sqrt(E[f^2]), theta = E[omega] = tanh(c/2) / (2c).
    Natural-gradient inputs: grad_e_mu = y/2, grad_e_sigma = theta/2.
    Gibbs: omega | f ~ PG(1, |f|), kept as theta."""

    @classmethod
    def create(cls):
        return cls()

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "QuadratureVI", "GibbsSampling", "HMCSampling"})

    def treat_labels(self, y):
        return _treat_binary(y), self

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.full((batchsize,), 0.25, dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        c = sqrt_expec_square(mu, var)
        theta = torch.tanh(c / 2.0) / (2.0 * c)
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return y / 2.0

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta = local["theta"]
        return -n * LOG2 / 2.0 + 0.5 * (
            torch.sum(mu * y) - torch.sum(theta * var) - torch.sum(theta * mu**2)
        )

    def aug_kl(self, local, y):
        return polya_gamma_kl(torch.ones_like(local["c"]), local["c"], local["theta"])

    def _sample_local(self, generator, y, f, local):
        return {**local, "theta": sample_pg1(generator, torch.abs(f))}

    def compute_proba(self, mu, var):
        return expectation(torch.sigmoid, mu, var)

    def predict_y(self, mu):
        return torch.sign(mu)

    def log_prob(self, y, f):
        """log sigma(y f)."""
        return -torch.logaddexp(torch.zeros_like(f), -y * f)

    def grad_log_prob(self, y, f):
        return y * torch.sigmoid(-y * f)

    def hess_log_prob(self, y, f):
        s = torch.sigmoid(y * f)
        return -s * (1.0 - s)


@dataclasses.dataclass(frozen=True)
class BayesianSVM(SingleLatentLikelihood):
    """Bayesian SVM: p(y | f) proportional to exp(-2 max(1 - yf, 0)),
    augmented with an improper omega prior; q(omega) is a GIG.

    Local updates: c = (1 - y mu)^2 + var, theta = 1/sqrt(c).
    Natural-gradient inputs: grad_e_mu = y (theta + 1), grad_e_sigma =
    theta/2."""

    @classmethod
    def create(cls):
        return cls()

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI"})

    def treat_labels(self, y):
        return _treat_binary(y), self

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.ones((batchsize,), dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        c = (1.0 - y * mu) ** 2 + var
        return self, {**local, "c": c, "theta": 1.0 / torch.sqrt(c)}

    def _grad_e_mu(self, y, local):
        return y * (local["theta"] + 1.0)

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        theta = local["theta"]
        tot = -n * LOG2 / 2.0 + torch.sum(mu * y)
        return tot - (0.5 * torch.sum(theta * var) + 0.5 * torch.sum(theta * (1.0 - y * mu) ** 2))

    def aug_kl(self, local, y):
        # the GIG entropy at p = 1/2 in the reference's a -> 0 limit form,
        # outside the gradient as the reference takes it
        c = local["c"]
        sc = torch.sqrt(c)
        val = torch.sum(torch.log(c)) / 2.0 + torch.sum(LOG2 + log_besselk_half(0, sc)) - torch.sum(sc) / 2.0
        return val.detach()

    def compute_proba(self, mu, var):
        def svmlik(f):
            pos = torch.exp(-2.0 * torch.clamp(1.0 - f, min=0.0))
            neg = torch.exp(-2.0 * torch.clamp(1.0 + f, min=0.0))
            return pos / (pos + neg)

        return expectation(svmlik, mu, var)

    def predict_y(self, mu):
        return torch.sign(mu)

    def log_prob(self, y, f):
        # pseudo-likelihood, normalized over y in {-1, +1}
        pos = -2.0 * torch.clamp(1.0 - y * f, min=0.0)
        neg = -2.0 * torch.clamp(1.0 + y * f, min=0.0)
        return pos - torch.logaddexp(pos, neg)
