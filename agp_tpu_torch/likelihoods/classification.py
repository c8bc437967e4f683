"""Binary classification: the logistic likelihood with its Polya-Gamma
augmentation, the counterpart of ``LogisticLikelihood`` in
``agp_tpu/likelihoods/classification.py``.  Labels are +-1 ({0, 1} maps to
{-1, +1})."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.kl import polya_gamma_kl
from ..ops.quadrature import expectation
from ..ops.special import sqrt_expec_square
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
    Natural-gradient inputs: grad_e_mu = y/2, grad_e_sigma = theta/2."""

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

    def compute_proba(self, mu, var):
        return expectation(torch.sigmoid, mu, var)

    def predict_y(self, mu):
        return torch.sign(mu)
