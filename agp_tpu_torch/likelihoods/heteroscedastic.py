"""Heteroscedastic Gaussian likelihood driven by a second latent GP: the
counterpart of ``agp_tpu/likelihoods/heteroscedastic.py``.

p(y | f, g) = N(y | f, (lambda sigma(g))^-1): the noise precision is a
scaled-logistic transform of a second GP g, augmented by a latent Poisson
count n and omega ~ PG(n + 1/2, g).  mu/var arrive stacked [2, B]
(index 0 = f, index 1 = g); Gibbs draws take f: [..., 2, B].
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..distributions.polyagamma import sample_pg
from ..ops.kl import poisson_kl_expected, polya_gamma_kl
from ..ops.special import safe_expcosh, sqrt_expec_square
from .base import Likelihood

LOG2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class HeteroscedasticLikelihood(Likelihood):
    """``lam``, the largest noise precision, is a 0-d tensor that the
    E-step updates in closed form; it lives on the model's device and is
    never read on the host.  A number is taken in float64, as the reference
    takes it; ``SVGP.create`` casts it to the model's dtype."""

    lam: torch.Tensor = 1.0

    def __post_init__(self):
        if not isinstance(self.lam, torch.Tensor):
            object.__setattr__(self, "lam", torch.as_tensor(float(self.lam), dtype=torch.float64))

    @classmethod
    def create(cls, lam: float = 1.0):
        return cls(lam=lam)

    @property
    def n_latent(self):
        return 2

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        names = ("c", "phi", "gamma", "theta", "sigg")
        return {k: torch.ones((batchsize,), dtype=dtype, device=device) for k in names}

    def local_updates(self, y, mu, var, local, w=None):
        """The coupled E-step with the old lambda, then lambda's closed-form
        update from the batch sums; rows with w = 0 are left out of those
        sums."""
        mu_f, mu_g = mu[0], mu[1]
        var_f, var_g = var[0], var[1]
        phi = ((mu_f - y) ** 2 + var_f) / 2.0  # E[(f - y)^2] / 2
        c = sqrt_expec_square(mu_g, var_g)  # sqrt(E[g^2])
        sigg = safe_expcosh(-mu_g / 2.0, c / 2.0) / 2.0  # ~ E[sigma(-g)]
        gamma = self.lam * phi * sigg  # E[n]
        theta = (0.5 + gamma) * torch.tanh(c / 2.0) / (2.0 * c)  # E[omega]
        if w is None:
            n = y.shape[0]
            s = torch.sum(phi * (1.0 - sigg))
        else:
            n = torch.sum(w)
            s = torch.sum(w * phi * (1.0 - sigg))
        lik = self.replace(lam=torch.maximum(n / (2.0 * s), self.lam))
        return lik, {"c": c, "phi": phi, "gamma": gamma, "theta": theta, "sigg": sigg}

    def grad_e_mu(self, y, local):
        g_f = y * self.lam * local["sigg"] / 2.0
        g_g = (0.5 - local["gamma"]) / 2.0
        return torch.stack(torch.broadcast_tensors(g_f, g_g), dim=-2)

    def grad_e_sigma(self, y, local):
        s_f = self.lam * local["sigg"] / 2.0
        s_g = local["theta"] / 2.0
        return torch.stack(torch.broadcast_tensors(s_f, s_g), dim=-2)

    def expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        mu_f, mu_g = mu[0], mu[1]
        var_f, var_g = var[0], var[1]
        gamma, theta = local["gamma"], local["theta"]
        tot = n * (torch.log(self.lam) / 2.0) - n * (math.log(2.0) + LOG2PI / 2.0)
        tot = tot + 0.5 * (
            torch.sum(mu_g * (0.5 - gamma)) - torch.sum(theta * mu_g**2) - torch.sum(theta * var_g)
        )
        # the Poisson KL folded into the expected log-likelihood
        rate0 = self.lam * ((y - mu_f) ** 2 + var_f) / 2.0
        return tot - poisson_kl_expected(gamma, rate0, torch.log(rate0))

    def aug_kl(self, local, y):
        return polya_gamma_kl(0.5 + local["gamma"], local["c"], local["theta"])

    def sample_local(self, generator, y, f, local):
        """n ~ Po(lambda sigma(g) (f - y)^2 / 2), omega ~ PG(n + 1/2, |g|)."""
        ff, gg = f[..., 0, :], f[..., 1, :]
        gamma = torch.poisson(self.lam * torch.sigmoid(gg) * (ff - y) ** 2 / 2.0, generator=generator)
        return {**local, "gamma": gamma, "theta": sample_pg(generator, gamma + 0.5, torch.abs(gg))}

    def compute_proba(self, mu, var):
        """Predictive mean mu_f and variance var_f + E[noise]."""
        noise = 1.0 / (self.lam * torch.sigmoid(mu[1]))
        return mu[0], var[0] + noise

    def predict_y(self, mu):
        return mu[0]

    def log_prob(self, y, f):
        """f: [2, ...]."""
        prec = self.lam * torch.sigmoid(f[1])
        return 0.5 * (torch.log(prec) - LOG2PI - prec * (y - f[0]) ** 2)
