"""Predictions of a trained sparse model: the counterpart of ``predict_f``
(diagonal variance), ``predict_y`` and ``proba_y`` in
``agp_tpu/training/predictions.py``.

  mu*  = k*^T K^-1 mu
  A    = K^-1 (I - Sigma K^-1)
  var* = k** + jitter - diag(k* A k*^T)

At full FP32: the chain k* K^-1 (I - Sigma K^-1) k*^T cancels internally.
"""
from __future__ import annotations

import torch

from ..config import jitter
from ..kernels import batch_diag, batch_gram
from ..likelihoods.multiclass import MultiClassLikelihood
from ..models.base import as_2d
from ..ops import linalg


@linalg._highest_precision
def _predict_f_var(model, state, X_test, diag: bool = True):
    """Latent predictive mean and (diag=True) variance, [L, n]."""
    k_star = batch_gram(model.kernel, X_test, model.Z)  # [L, n, M]
    K_inv = state.kmat["K_inv"]
    alpha = (K_inv @ state.mu.unsqueeze(-1)).squeeze(-1)  # [L, M]
    mu_f = (k_star @ alpha.unsqueeze(-1)).squeeze(-1)
    if not diag:
        return mu_f, None
    eye = torch.eye(K_inv.shape[-1], dtype=K_inv.dtype, device=K_inv.device)
    A = K_inv @ (eye - state.Sigma @ K_inv)
    k_ss = batch_diag(model.kernel, X_test) + jitter(mu_f.dtype)
    var_f = k_ss - linalg.diag_ABt(k_star @ A, k_star)
    return mu_f, torch.clamp(var_f, min=0.0)


def predict_f(model, state, X_test, cov: bool = False, diag: bool = True):
    """Latent GP predictive: mu, or (mu, var) with cov=True; the latent axis
    is squeezed for single-latent models.  Only the diagonal variance is
    ported."""
    if cov and not diag:
        raise NotImplementedError("full-covariance prediction is not ported yet")
    X_test = as_2d(X_test, like=model.Z)
    mu_f, var_f = _predict_f_var(model, state, X_test, diag=cov)
    if model.n_latent == 1:
        mu_f = mu_f[0]
        var_f = None if var_f is None else var_f[0]
    return (mu_f, var_f) if cov else mu_f


def predict_y(model, state, X_test):
    """Label-space point prediction: the sign of the latent mean for the
    logistic likelihood, the index of the largest latent mean for a
    multiclass one, the mean of f for the heteroscedastic one."""
    mu_f, _ = _predict_f_var(model, state, as_2d(X_test, like=model.Z), diag=False)
    return model.likelihood.predict_y(mu_f[0] if model.n_latent == 1 else mu_f)


def proba_y(model, state, X_test, generator=None, n_samples: int = 200):
    """Predictive distribution of y.  Single latent: the latent predictive
    pushed through the likelihood by 100-node Gauss-Hermite quadrature.
    Multiclass: [n, K] probabilities, the mean over ``n_samples`` draws of
    the latent predictive made with ``generator`` (on X_test's device; seed
    42 when None), or the plug-in probabilities when ``n_samples`` is 0.
    Heteroscedastic: (mean, variance) of y."""
    X_test = as_2d(X_test, like=model.Z)
    mu_f, var_f = _predict_f_var(model, state, X_test, diag=True)
    lik = model.likelihood
    if lik.n_latent == 1:
        return lik.compute_proba(mu_f[0], var_f[0])
    if isinstance(lik, MultiClassLikelihood):
        if generator is None:
            generator = torch.Generator(device=X_test.device).manual_seed(42)
        return lik.compute_proba(mu_f, var_f, n_samples=n_samples, generator=generator)
    return lik.compute_proba(mu_f, var_f)
