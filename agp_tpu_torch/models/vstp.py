"""VStP: the variational Student-t process, the counterpart of
``agp_tpu/models/vstp.py``.

Prior is a Student-t process, augmented by an inverse-Gamma scale mixture:
f | s ~ N(mu0, s K), s ~ IG(nu/2, nu/2), giving closed-form per-iteration
prior-scale updates.  The CAVI-optimal q(s) is

  q(s) = IG(alpha, beta),  alpha = (nu + N)/2,
                           beta  = (nu + (mu-mu0)^T K^-1 (mu-mu0)
                                       + tr(K^-1 Sigma)) / 2
  chi  = E_q[1/s] = alpha / beta

(q(s) prop. IG(s; nu/2, nu/2) * s^{-N/2} exp(-(quad+tr)/(2s))).  We store
l2 = beta.

Parity note vs the Julia package's models/VStP.jl:91-108: it computes
l2 = (nu + N + quad + tr)/2 and chi = (nu+N)/(nu+l2) -- which is NOT E[1/s]
(it double-counts nu+N inside l2) -- and then never applies chi in its
Zygote-era CAVI path anyway (chi only survives in the legacy ForwardDiff
hyper-gradient, autotuning.jl:295), i.e. its VStP trains like a VGP.  We
use the correct IG posterior moments and apply the scale where the
derivation requires it: the effective prior precision is chi K^-1 in the
natural-gradient update and the Gaussian KL.  At the prior optimum
(mu = mu0, Sigma = K) this gives chi = 1 exactly (tested).

A dense model over its training inputs, as the VGP is
(``inference/analytic_vi.py``'s dense branch): no CUDA kernel of the port
runs.  The predictions ignore chi, as the reference's do.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..inference.config import InferenceConfig
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean, batch_call
from ..ops import linalg
from ..utils.opt import adam
from ..utils.tensors import Params
from .base import as_2d, check_card_dtype, check_implemented, match_dtype, model_repr
from .svgp import _check_ported, _place


@dataclasses.dataclass(frozen=True, repr=False)
class VStP(Params):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    nu: torch.Tensor  # the prior's degrees of freedom, []
    train_x: torch.Tensor  # [N, D]
    train_y: torch.Tensor
    inference: InferenceConfig
    n_latent: int
    atfrequency: int = 1
    optimiser: Optional[Any] = None

    is_sparse = False
    is_multioutput = False
    is_online = False
    is_tprior = True

    @classmethod
    def create(
        cls,
        X,
        y,
        kernel,
        likelihood,
        inference,
        nu: float,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
    ):
        """Builds the model on (X, y) as ``VGP.create`` does, with the
        prior's degrees of freedom ``nu`` (> 1, else ``ValueError``).  X
        without a device goes to ``config.default_device()``; a model on a
        CUDA device that is neither float32 nor float64 raises
        ``TypeError`` (a VStP runs no kernel of the port).  Stochastic
        inference raises ``ValueError``: the reference's VStP takes it at
        ``create`` and then fails at its first step, whose minibatch meets
        the N x N prior."""
        if optimiser == "default":
            optimiser = adam(0.01)
        _check_ported(kernel, likelihood, mean, optimiser)
        check_implemented(likelihood, inference)
        if nu <= 1:
            raise ValueError("nu should be bigger than 1")
        if inference.stochastic:
            raise ValueError("VStP does not support stochastic inference: its prior is over all N training inputs")
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
            nu=torch.tensor(float(nu), dtype=X.dtype, device=X.device),
            train_x=X,
            train_y=y,
            inference=inference,
            n_latent=n_latent,
            atfrequency=atfrequency,
            optimiser=optimiser,
        )

    @property
    def Z(self):
        """The training inputs as the "inducing set" [L, N, D] (a view)."""
        return self.train_x.expand((self.n_latent,) + self.train_x.shape)

    @property
    def n_inducing(self):
        return self.train_x.shape[0]

    __repr__ = model_repr


@linalg._highest_precision
def local_prior_updates(model: VStP, state, x):
    """The closed-form IG scale update of every latent GP at once:
    l2 = (nu + quad + tr) / 2 with quad = (mu - mu0)^T K^-1 (mu - mu0) and
    tr = sum(K^-1 o Sigma), and chi = (nu + N) / (2 l2), N the rows of x;
    returns the state with ``prior_state`` = {"l2", "chi"} [L]."""
    mu0 = batch_call(model.mean, x, model.n_latent)
    v = torch.linalg.solve_triangular(state.kmat["L_K"], (state.mu - mu0).unsqueeze(-1), upper=False)
    quad = torch.sum(v * v, dim=(-2, -1))
    tr = torch.sum(state.kmat["K_inv"] * state.Sigma, dim=(-2, -1))
    l2 = (model.nu + quad + tr) / 2.0
    chi = (model.nu + x.shape[0]) / (2.0 * l2)
    return state.replace(prior_state={"l2": l2, "chi": chi})
