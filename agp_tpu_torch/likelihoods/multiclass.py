"""Multiclass classification with the logistic-softmax likelihood and its
triple (Gamma, Poisson, Polya-Gamma) augmentation, and with the plain
softmax, which has none: the counterpart of ``MultiClassLikelihood``,
``LogisticSoftMaxLikelihood`` and ``SoftMaxLikelihood`` in
``agp_tpu/likelihoods/multiclass.py``.

K classes are K latent GPs.  Labels are one-hot encoded on the host, once,
by ``treat_labels``; the per-class local variables are laid out [K, B].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..distributions.polyagamma import sample_pg
from ..ops.kl import gamma_entropy_improper, poisson_kl_expected, polya_gamma_kl
from ..ops.special import digamma, safe_expcosh, sqrt_expec_square
from .base import Likelihood

LOG2 = 0.6931471805599453


@dataclasses.dataclass(frozen=True)
class MultiClassLikelihood(Likelihood):
    """Shared shell: label <-> index mapping and one-hot encoding."""

    n_class: int = 2
    class_mapping: Optional[Tuple] = None

    @classmethod
    def create(cls, num_class_or_labels):
        """K classes from their count, or from the labels (their sorted
        unique values become the class mapping)."""
        if isinstance(num_class_or_labels, int):
            return cls(n_class=num_class_or_labels)
        labels = tuple(np.unique(np.asarray(num_class_or_labels)).tolist())
        return cls(n_class=len(labels), class_mapping=labels)

    @property
    def n_latent(self):
        return self.n_class

    def treat_labels(self, y):
        """One-hot [N, K] float64 labels, made on the host; a tensor's
        result goes back to its device.  Without a class mapping one is
        inferred: 0..K-1, 1..K, or the sorted unique labels."""
        device = y.device if isinstance(y, torch.Tensor) else None
        y = y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        if y.ndim != 1:
            raise ValueError("multiclass targets should be a vector of labels")
        lik = self
        if self.class_mapping is None:
            uniq = sorted(np.unique(y).tolist())
            if len(uniq) > self.n_class:
                raise ValueError(f"{len(uniq)} unique labels found but n_class={self.n_class}")
            if set(uniq) <= set(range(self.n_class)):
                mapping = tuple(range(self.n_class))
            elif set(uniq) <= set(range(1, self.n_class + 1)):
                mapping = tuple(range(1, self.n_class + 1))
            else:
                mapping = tuple(uniq)
            lik = self.replace(class_mapping=mapping)
        idx = {v: i for i, v in enumerate(lik.class_mapping)}
        onehot = np.zeros((y.shape[0], lik.n_class))
        onehot[np.arange(y.shape[0]), [idx[v] for v in y.tolist()]] = 1.0
        return torch.as_tensor(onehot, device=device), lik

    def labels_from_indices(self, indices):
        mapping = self.class_mapping or tuple(range(self.n_class))
        idx = indices.cpu().numpy() if isinstance(indices, torch.Tensor) else np.asarray(indices)
        return np.asarray([mapping[i] for i in idx])

    def predict_y(self, mu):
        """mu [K, N] -> index of the largest latent mean."""
        return torch.argmax(mu, dim=0)


@dataclasses.dataclass(frozen=True)
class LogisticSoftMaxLikelihood(MultiClassLikelihood):
    """p(y=k | f) = sigma(f_k) / sum_j sigma(f_j), made conjugate by a triple
    (Gamma, Poisson, Polya-Gamma) augmentation.

    Local updates, with y one-hot [B, K]:
      c_k   = sqrt(E[f_k^2])
      repeat 2x (inner fixed point):
        gamma_k = exp(psi(alpha)) exp(-mu_k/2) / (2 beta cosh(c_k/2))
        alpha   = 1 + sum_k gamma_k
      theta_k = (y_k + gamma_k) tanh(c_k/2) / (2 c_k)
    """

    @classmethod
    def implemented(cls):
        return frozenset({"AnalyticVI", "MCIntegrationVI", "GibbsSampling", "HMCSampling"})

    def init_local_vars(self, batchsize, dtype=torch.float32, device=None):
        K = self.n_class
        kw = dict(dtype=dtype, device=device)
        return {
            "c": torch.ones((K, batchsize), **kw),
            "alpha": torch.full((batchsize,), float(K), **kw),
            "beta": torch.full((batchsize,), float(K), **kw),
            "theta": torch.full((K, batchsize), 0.5, **kw),
            "gamma": torch.full((K, batchsize), 0.5, **kw),
        }

    def local_updates(self, y, mu, var, local, w=None):
        # w unused: every E-step quantity is per row (the gamma/alpha fixed
        # point couples classes, not rows)
        yT = y.T  # [K, B]
        c = sqrt_expec_square(mu, var)
        alpha, beta = local["alpha"], local["beta"]
        expcosh = safe_expcosh(-mu / 2.0, c / 2.0)
        for _ in range(2):
            gamma = torch.exp(digamma(alpha))[None, :] * expcosh / (2.0 * beta[None, :])
            alpha = 1.0 + torch.sum(gamma, dim=0)
        theta = (yT + gamma) * torch.tanh(c / 2.0) / (2.0 * c)
        return self, {**local, "c": c, "alpha": alpha, "gamma": gamma, "theta": theta}

    def grad_e_mu(self, y, local):
        return (y.T - local["gamma"]) / 2.0

    def grad_e_sigma(self, y, local):
        return local["theta"] / 2.0

    def expec_loglik(self, y, mu, var, local):
        n = y.shape[0]
        yT = y.T
        theta, gamma = local["theta"], local["gamma"]
        tot = -n * LOG2
        tot = tot - torch.sum(gamma + yT) * LOG2
        return tot + 0.5 * torch.sum(mu * (yT - gamma) - theta * mu**2 - theta * var)

    def aug_kl(self, local, y):
        yT = y.T
        alpha, beta = local["alpha"], local["beta"]
        pg = polya_gamma_kl(yT + local["gamma"], local["c"], local["theta"])
        po = poisson_kl_expected(
            local["gamma"], (alpha / beta)[None, :], (digamma(alpha) - torch.log(beta))[None, :]
        )
        return pg + po + gamma_entropy_improper(alpha, beta)

    def sample_local(self, generator, y, f, local):
        """gamma_k ~ Po(alpha sigma(-f_k)), alpha ~ Ga(1 + sum_k gamma_k) / beta,
        omega_k ~ PG(y_k + gamma_k, |f_k|); f: [..., K, B]."""
        rate = local["alpha"].unsqueeze(-2) * torch.sigmoid(-f)
        gamma = torch.poisson(rate, generator=generator)
        alpha = torch._standard_gamma(1.0 + torch.sum(gamma, dim=-2), generator=generator) / local["beta"]
        omega = sample_pg(generator, y.T + gamma, torch.abs(f))
        return {**local, "gamma": gamma, "alpha": alpha, "theta": omega}

    def link(self, f):
        """[K, ...] latent values -> class probabilities (normalized logistic)."""
        s = torch.sigmoid(f)
        return s / torch.sum(s, dim=0, keepdim=True)

    def compute_proba(self, mu, var, n_samples: int = 200, generator=None):
        """[N, K] class probabilities: the Monte Carlo mean of ``link`` over
        ``n_samples`` draws of the latent predictive N(mu, var), drawn with
        ``generator`` (on mu's device); the plug-in ``link(mu)`` when
        ``n_samples`` is 0 or no generator is given."""
        if n_samples == 0 or generator is None:
            return self.link(mu).T
        return _mc_proba(self.link, mu, var, n_samples, generator)

    def log_prob(self, y, f):
        """y one-hot [K] or [K, B]; f [K] or [K, B]."""
        logp = torch.nn.functional.logsigmoid(f) - torch.log(torch.sum(torch.sigmoid(f), dim=0, keepdim=True))
        return torch.sum(y * logp, dim=0)


def _mc_proba(link, mu, var, n_samples, generator):
    """[N, K] class probabilities: the Monte Carlo mean of ``link`` over
    ``n_samples`` draws of N(mu, var) ([K, N]) made with ``generator``."""
    eps = torch.randn((n_samples,) + tuple(mu.shape), generator=generator, dtype=mu.dtype, device=mu.device)
    f = mu[None] + torch.sqrt(torch.clamp(var, min=0.0))[None] * eps
    return torch.mean(link(f.transpose(0, 1)), dim=1).T


@dataclasses.dataclass(frozen=True)
class SoftMaxLikelihood(MultiClassLikelihood):
    """p(y=k | f) = exp(f_k) / sum_j exp(f_j).  No augmentation exists:
    Monte Carlo VI (``MCIntegrationVI``) or Hamiltonian sampling only."""

    @classmethod
    def implemented(cls):
        return frozenset({"MCIntegrationVI", "HMCSampling"})

    def link(self, f):
        """[K, ...] latent values -> class probabilities."""
        return torch.softmax(f, dim=0)

    def compute_proba(self, mu, var, n_samples: int = 200, generator=None):
        """[N, K] class probabilities: the Monte Carlo mean of ``link`` over
        ``n_samples`` draws of the latent predictive N(mu, var), drawn with
        ``generator`` (on mu's device); the plug-in ``link(mu)`` when
        ``n_samples`` is 0 or no generator is given."""
        if n_samples == 0 or generator is None:
            return self.link(mu).T
        return _mc_proba(self.link, mu, var, n_samples, generator)

    def log_prob(self, y, f):
        """y one-hot [K] or [K, B]; f [K] or [K, B]."""
        return torch.sum(y * torch.log_softmax(f, dim=0), dim=0)

    def mc_grad_hess(self, y, f):
        """(d log p / d f, the diagonal of d^2 log p / d f^2) of ``log_prob``
        in closed form, f [..., K, B] and y [K, B]: (y - p s, -p (1 - p) s)
        with p = softmax(f) over K and s = sum_k y_k (1 for a one-hot y)."""
        p = torch.softmax(f, dim=-2)
        s = torch.sum(y, dim=-2, keepdim=True)
        return y - p * s, -p * (1.0 - p) * s
