"""Count likelihoods: Poisson and negative binomial, the counterparts of
``agp_tpu/likelihoods/event.py`` (with its documented deviations from the
original package: theta = E[omega], the squared term in the negative
binomial's expected log-likelihood).  Gibbs: omega | f ~ PG(y + n, |f|)
after n | f ~ Poisson(lam sigma(f)) (Poisson), omega | f ~ PG(y + r, |f|)
(negative binomial)."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..distributions.polyagamma import sample_pg
from ..ops.kl import poisson_kl, polya_gamma_kl
from ..ops.quadrature import expectation, mean_and_var
from ..ops.special import LOG2, gammaln, safe_expcosh, sqrt_expec_square
from ..utils.batch_sums import batch_sum
from .base import SingleLatentLikelihood, tensor_fields


def _treat_counts(y, name):
    """Count labels validated on the host and returned as float64; a tensor
    keeps its device."""
    device = y.device if isinstance(y, torch.Tensor) else None
    y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
    if np.any(y < 0) or np.any(y != np.round(y)):
        raise ValueError(f"{name} labels must be non-negative integers")
    return torch.as_tensor(y.astype(np.float64), device=device)


@dataclasses.dataclass(frozen=True)
class PoissonLikelihood(SingleLatentLikelihood):
    """p(y | f) = Poisson(y | lam sigma(f)), augmented by a latent Poisson
    count n and omega ~ PG(y + n, f).

    Local updates:
      c     = sqrt(E[f^2])
      gamma = E[n] = lam exp(-mu/2) / (2 cosh(c/2))
      theta = E[omega] = (y + gamma) tanh(c/2) / (2c)
      lam  <- sum(y) / sum(E[sigma(f)])   (closed form, over the batch)

    ``lam`` is a 0-d tensor on the model's device, never read on the host.
    """

    lam: torch.Tensor = 1.0

    def __post_init__(self):
        tensor_fields(self, "lam")

    @classmethod
    def create(cls, lam: float = 1.0):
        return cls(lam=lam)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def treat_labels(self, y):
        return _treat_counts(y, "Poisson"), self

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.zeros((batchsize,), dtype=dtype, device=device),
            "gamma": torch.ones((batchsize,), dtype=dtype, device=device),
        }

    _weighted_params = True  # the rate's update sums over the batch

    def _local_updates(self, y, mu, var, local, w=None):
        c = sqrt_expec_square(mu, var)
        gamma = self.lam * safe_expcosh(-mu / 2.0, c / 2.0) / 2.0
        theta = (y + gamma) * torch.tanh(c / 2.0) / (2.0 * c)
        es = expectation(torch.sigmoid, mu, var)
        if w is None:
            sum_y, sum_es = batch_sum(torch.sum(y), torch.sum(es))
        else:  # rows with w = 0 stay out of the sums
            sum_y, sum_es = batch_sum(torch.sum(w * y), torch.sum(w * es))
        return self.replace(lam=sum_y / sum_es), {**local, "c": c, "gamma": gamma, "theta": theta}

    def _grad_e_mu(self, y, local):
        return (y - local["gamma"]) / 2.0

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        theta, gamma = local["theta"], local["gamma"]
        tot = 0.5 * (torch.sum(mu * (y - gamma)) - torch.sum(theta * mu**2) - torch.sum(theta * var))
        const = torch.sum(y) * torch.log(self.lam) - torch.sum(gammaln(y + 1.0)) - LOG2 * torch.sum(y + gamma)
        return tot + const.detach()

    def aug_kl(self, local, y):
        return poisson_kl(local["gamma"], self.lam) + polya_gamma_kl(y + local["gamma"], local["c"], local["theta"])

    def _sample_local(self, generator, y, f, local):
        gamma = torch.poisson(self.lam * torch.sigmoid(f), generator=generator)
        return {**local, "gamma": gamma, "theta": sample_pg(generator, y + gamma, torch.abs(f))}

    def compute_proba(self, mu, var):
        return mean_and_var(lambda f: self.lam * torch.sigmoid(f), mu, var)

    def predict_y(self, mu):
        return self.lam * torch.sigmoid(mu)

    def log_prob(self, y, f):
        rate = self.lam * torch.sigmoid(f)
        return y * torch.log(rate) - rate - gammaln(y + 1.0)


@dataclasses.dataclass(frozen=True)
class NegBinomialLikelihood(SingleLatentLikelihood):
    """Negative binomial with logistic link and a fixed failure count r:
    p(y | f) = C(y+r-1, y) sigma(f)^y (1 - sigma(f))^r, augmented by
    omega ~ PG(y + r, f).

    Local updates: c = sqrt(E[f^2]), theta = E[omega] = (r + y) tanh(c/2)/(2c)."""

    r: torch.Tensor = 10.0

    def __post_init__(self):
        tensor_fields(self, "r")

    @classmethod
    def create(cls, r: float):
        return cls(r=r)

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def treat_labels(self, y):
        return _treat_counts(y, "NegBinomial"), self

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        return {
            "c": torch.ones((batchsize,), dtype=dtype, device=device),
            "theta": torch.zeros((batchsize,), dtype=dtype, device=device),
        }

    def _local_updates(self, y, mu, var, local):
        c = sqrt_expec_square(mu, var)
        theta = (self.r + y) * torch.tanh(c / 2.0) / (2.0 * c)
        return self, {**local, "c": c, "theta": theta}

    def _grad_e_mu(self, y, local):
        return (y - self.r) / 2.0

    def _grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def _expec_loglik(self, y, mu, var, local):
        theta = local["theta"]
        logconst = gammaln(y + self.r) - gammaln(y + 1.0) - gammaln(self.r)
        tot = torch.sum(logconst).detach() - LOG2 * torch.sum(y + self.r)
        return tot + 0.5 * (torch.sum(mu * (y - self.r)) - torch.sum(theta * mu**2) - torch.sum(theta * var))

    def aug_kl(self, local, y):
        return polya_gamma_kl(y + self.r, local["c"], local["theta"])

    def _sample_local(self, generator, y, f, local):
        return {**local, "theta": sample_pg(generator, y + self.r, torch.abs(f))}

    def compute_proba(self, mu, var):
        # E[y | f] = r p/(1 - p) with p = sigma(f), i.e. r e^f
        return mean_and_var(lambda f: self.r * torch.exp(f), mu, var)

    def predict_y(self, mu):
        return self.r * torch.exp(mu)

    def log_prob(self, y, f):
        logconst = gammaln(y + self.r) - gammaln(y + 1.0) - gammaln(self.r)
        return logconst + y * torch.nn.functional.logsigmoid(f) + self.r * torch.nn.functional.logsigmoid(-f)
