"""Likelihood protocol: the counterpart of ``agp_tpu/likelihoods/base.py``.

A likelihood is a frozen dataclass whose tensor fields are its parameters.
Its methods are pure: ``local_updates`` returns a new (likelihood,
local_vars) pair.  Latent values arrive stacked as mu/var of shape [L, B];
local variables are a dict of [B]- or [L, B]-shaped tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ..utils.tensors import Params

LocalVars = Dict[str, torch.Tensor]


def tensor_fields(obj, *names):
    """Store each named field of a frozen dataclass that was given as a
    number as a 0-d float64 tensor, as the reference takes it;
    ``SVGP.create`` moves it to the model's device and dtype."""
    for name in names:
        v = getattr(obj, name)
        if not isinstance(v, torch.Tensor):
            object.__setattr__(obj, name, torch.as_tensor(float(v), dtype=torch.float64))


@dataclasses.dataclass(frozen=True)
class Likelihood(Params):
    @property
    def n_latent(self) -> int:
        return 1

    @classmethod
    def implemented(cls) -> frozenset:
        """Names of the compatible inference engines."""
        return frozenset()

    def treat_labels(self, y) -> Tuple[torch.Tensor, "Likelihood"]:
        """Validate/transform raw labels (host side, before training)."""
        return torch.as_tensor(y), self

    def init_local_vars(self, batchsize: int, dtype=torch.float32, device=None) -> LocalVars:
        raise NotImplementedError

    def local_updates(self, y, mu, var, local: LocalVars, w=None):
        """Closed-form E-step q(omega) update; mu/var: [L, B].  ``w`` ([B] of
        0/1) marks padded rows for likelihoods whose E-step updates a
        parameter from cross-batch sums."""
        raise NotImplementedError

    def grad_e_mu(self, y, local: LocalVars) -> torch.Tensor:
        """[L, B] coefficient of mu in dE[log p]/dmu."""
        raise NotImplementedError

    def grad_e_sigma(self, y, local: LocalVars) -> torch.Tensor:
        """[L, B] theta/2-style coefficient."""
        raise NotImplementedError

    def expec_loglik(self, y, mu, var, local: LocalVars) -> torch.Tensor:
        """E_q[log p(y | f, omega)] summed over the batch."""
        raise NotImplementedError

    def aug_kl(self, local: LocalVars, y) -> torch.Tensor:
        """KL(q(omega) || p(omega)) summed over the batch."""
        raise NotImplementedError

    def sample_local(self, generator, y, f, local: LocalVars) -> LocalVars:
        """Gibbs draw of omega | f, drawn with ``generator``.  f: [..., L, B]
        (leading axes: independent chains); the local variables it draws
        come out [..., B] or [..., L, B]."""
        raise NotImplementedError

    def compute_proba(self, mu, var):
        """Push the latent predictive N(mu, var) through the likelihood."""
        raise NotImplementedError

    def predict_y(self, mu):
        raise NotImplementedError

    def log_prob(self, y, f):
        """log p(y | f) elementwise; f [...] for a single-latent likelihood,
        [L, ...] for a multi-latent one."""
        raise NotImplementedError

    def grad_log_prob(self, y, f):
        """d log p / d f elementwise, by automatic differentiation of the
        summed ``log_prob`` (the fallback where there is no closed form)."""
        return torch.func.grad(lambda ff: torch.sum(self.log_prob(y, ff)))(f)

    def hess_log_prob(self, y, f):
        """d^2 log p / d f^2 elementwise (the diagonal), by automatic
        differentiation: the gradient of the summed elementwise gradient,
        which is the diagonal because ``log_prob`` is elementwise in f."""
        return torch.func.grad(lambda ff: torch.sum(self.grad_log_prob(y, ff)))(f)


@dataclasses.dataclass(frozen=True)
class SingleLatentLikelihood(Likelihood):
    """Adapter: subclasses implement the single-latent contract on [B]
    vectors (methods prefixed with ``_``); this class lifts them to the
    stacked [1, B] layout the inference engines use (leading chain axes
    kept: [..., B] -> [..., 1, B]).  The row mask ``w``
    goes down only to a likelihood whose E-step updates a parameter from
    cross-batch sums (the Poisson rate): it sets ``_weighted_params`` and
    takes ``w`` as a keyword.  For the others the mask does not matter
    inside the E-step (per-row work); the engine zero-weights their
    gradients downstream."""

    _weighted_params = False

    def _local_updates(self, y, mu, var, local):
        raise NotImplementedError

    def _grad_e_mu(self, y, local):
        raise NotImplementedError

    def _grad_e_sigma(self, y, local):
        raise NotImplementedError

    def _expec_loglik(self, y, mu, var, local):
        raise NotImplementedError

    def _sample_local(self, generator, y, f, local):
        raise NotImplementedError

    def local_updates(self, y, mu, var, local, w=None):
        if w is not None and self._weighted_params:
            return self._local_updates(y, mu[0], var[0], local, w=w)
        return self._local_updates(y, mu[0], var[0], local)

    def grad_e_mu(self, y, local):
        return self._grad_e_mu(y, local).unsqueeze(-2)

    def grad_e_sigma(self, y, local):
        return self._grad_e_sigma(y, local).unsqueeze(-2)

    def expec_loglik(self, y, mu, var, local):
        return self._expec_loglik(y, mu[0], var[0], local)

    def sample_local(self, generator, y, f, local):
        return self._sample_local(generator, y, f[..., 0, :], local)
