"""Predictions of a trained model: the counterpart of ``predict_f``,
``predict_y``, ``proba_y`` and ``sample_f`` in
``agp_tpu/training/predictions.py``.

Variational models (SVGP, and VGP over its training inputs):

  mu*  = k*^T K^-1 mu
  A    = K^-1 (I - Sigma K^-1)
  var* = k** + jitter - diag(k* A k*^T)   (or the full covariance)

The exact GP: mu* = k*^T alpha and var* = k** - |L^-1 k*|^2 from the
Cholesky factor L of K + sigma^2 I.

At full FP32, TF32 off: the chain k* K^-1 (I - Sigma K^-1) k*^T cancels
internally.  ``chunk_size`` evaluates a test set in slices of that many
rows, each of the same shape (the last padded with copies of its last row
and cut back), so a large test set never holds its whole cross-gram.
"""
from __future__ import annotations

import torch

from ..config import jitter
from ..kernels import batch_diag, batch_gram
from ..likelihoods.multiclass import MultiClassLikelihood
from ..models.base import as_2d
from ..models.gp import GP
from ..ops import linalg


@linalg._highest_precision
def _predict_f_var(model, state, X_test, diag: bool = True, full_cov: bool = False):
    """Latent predictive mean and variance (diag=True) or covariance
    (full_cov=True) of a variational model, [L, n] and [L, n(, n)]."""
    k_star = batch_gram(model.kernel, X_test, model.Z)  # [L, n, M]
    K_inv = state.kmat["K_inv"]
    alpha = (K_inv @ state.mu.unsqueeze(-1)).squeeze(-1)  # [L, M]
    mu_f = (k_star @ alpha.unsqueeze(-1)).squeeze(-1)
    if not diag and not full_cov:
        return mu_f, None
    eye = torch.eye(K_inv.shape[-1], dtype=K_inv.dtype, device=K_inv.device)
    A = K_inv @ (eye - state.Sigma @ K_inv)
    if full_cov:
        n = X_test.shape[0]
        k_ss = batch_gram(model.kernel, X_test, X_test)
        cov = k_ss + jitter(mu_f.dtype) * torch.eye(n, dtype=mu_f.dtype, device=mu_f.device)
        return mu_f, cov - (k_star @ A) @ k_star.mT
    k_ss = batch_diag(model.kernel, X_test) + jitter(mu_f.dtype)
    var_f = k_ss - linalg.diag_ABt(k_star @ A, k_star)
    return mu_f, torch.clamp(var_f, min=0.0)


@linalg._highest_precision
def _predict_f_gp(model: GP, state, X_test, diag: bool = True, mean_only: bool = False):
    """The exact GP's latent predictive mean and variance (diag=True) or
    covariance, [1, n] and [1, n(, n)]."""
    k_star = batch_gram(model.kernel, X_test, model.train_x)[0]  # [n, N]
    mu_f = k_star @ state.alpha
    if mean_only:
        return mu_f[None], None
    v = torch.linalg.solve_triangular(state.chol_Sigma, k_star.T, upper=False)
    if diag:
        k_ss = batch_diag(model.kernel, X_test)[0] + jitter(mu_f.dtype)
        var_f = k_ss - torch.sum(v * v, dim=0)
        return mu_f[None], torch.clamp(var_f, min=0.0)[None]
    k_ss = batch_gram(model.kernel, X_test, X_test)[0]
    return mu_f[None], (k_ss - v.T @ v)[None]


def _latent(model, state, X_test, diag=True, full_cov=False, mean_only=False):
    """(mean [L, n], variance or covariance or None) of either model kind."""
    if isinstance(model, GP):
        return _predict_f_gp(model, state, X_test, diag=diag and not full_cov, mean_only=mean_only)
    return _predict_f_var(model, state, X_test, diag=diag and not mean_only, full_cov=full_cov)


def _chunk_map(call, X_test, chunk_size: int, axis: int):
    """``call`` over [chunk_size]-row slices of X_test (the last padded
    with copies of its last row, so every call has the same shape, and
    cut back), the outputs (a tensor or a tuple of them) concatenated along
    ``axis``, the test-point axis (a nested tuple leaf by leaf)."""
    n = X_test.shape[0]
    outs = []
    for s in range(0, n, chunk_size):
        xc = X_test[s:s + chunk_size]
        c = xc.shape[0]
        if c < chunk_size:
            xc = torch.cat([xc, xc[-1:].expand(chunk_size - c, xc.shape[1])])
        out = call(xc)
        if c < chunk_size:
            out = _map(lambda a: a.narrow(axis, 0, c), out)
        outs.append(out)
    if len(outs) == 1:
        return outs[0]
    return _concat(outs, axis)


def _concat(outs, axis):
    """The chunks' outputs (tensors, or tuples of them, nested: a
    multi-output model's per-task results) concatenated leaf by leaf."""
    if isinstance(outs[0], tuple):
        return tuple(_concat(parts, axis) for parts in zip(*outs))
    return None if outs[0] is None else torch.cat(outs, dim=axis)


def _map(fn, out):
    if isinstance(out, tuple):
        return tuple(_map(fn, a) for a in out)
    return None if out is None else fn(out)


def predict_f(model, state, X_test, cov: bool = False, diag: bool = True, chunk_size=None):
    """Latent GP predictive: mu, or (mu, var) with cov=True, or (mu, the
    [n, n] covariance) with cov=True and diag=False; the latent axis is
    squeezed for single-latent models.  ``chunk_size`` evaluates the test
    set in slices of that many rows (not with the full covariance, whose
    chunks are coupled: ``ValueError``)."""
    X_test = as_2d(X_test, like=_like(model))

    def call(xc):
        mu_f, var_f = _latent(model, state, xc, diag=cov, full_cov=cov and not diag)
        if model.n_latent == 1:
            mu_f = mu_f[0]
            var_f = None if var_f is None else var_f[0]
        return (mu_f, var_f) if cov else mu_f

    if chunk_size is not None and X_test.shape[0] > chunk_size:
        if cov and not diag:
            raise ValueError(
                "chunk_size is incompatible with full-covariance prediction "
                "(the [n, n] output couples chunks); use diag=True"
            )
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def predict_y(model, state, X_test, chunk_size=None):
    """Label-space point prediction: the sign of the latent mean for the
    logistic likelihood, the index of the largest latent mean for a
    multiclass one, the mean of f for the heteroscedastic one, the latent
    mean for the regression ones.  ``chunk_size`` as ``predict_f``."""
    X_test = as_2d(X_test, like=_like(model))

    def call(xc):
        mu_f, _ = _latent(model, state, xc, mean_only=True)
        return model.likelihood.predict_y(mu_f[0] if model.n_latent == 1 else mu_f)

    if chunk_size is not None and X_test.shape[0] > chunk_size:
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def proba_y(model, state, X_test, generator=None, n_samples: int = 200, chunk_size=None):
    """Predictive distribution of y.  Single latent: the latent predictive
    pushed through the likelihood by 100-node Gauss-Hermite quadrature.
    Multiclass: [n, K] probabilities, the mean over ``n_samples`` draws of
    the latent predictive made with ``generator`` (on X_test's device; seed
    42 when None), or the plug-in probabilities when ``n_samples`` is 0.
    Heteroscedastic: (mean, variance) of y.  ``chunk_size`` as
    ``predict_f`` (each multiclass chunk then draws from the same
    generator in turn)."""
    X_test = as_2d(X_test, like=_like(model))
    lik = model.likelihood
    multiclass = isinstance(lik, MultiClassLikelihood)
    if generator is None and multiclass:
        generator = torch.Generator(device=X_test.device).manual_seed(42)

    def call(xc):
        mu_f, var_f = _latent(model, state, xc, diag=True)
        if lik.n_latent == 1:
            return lik.compute_proba(mu_f[0], var_f[0])
        if multiclass:
            return lik.compute_proba(mu_f, var_f, n_samples=n_samples, generator=generator)
        return lik.compute_proba(mu_f, var_f)

    if chunk_size is not None and X_test.shape[0] > chunk_size:
        # multiclass probabilities are [n, K]; the rest carry n last
        return _chunk_map(call, X_test, int(chunk_size), axis=0 if multiclass else -1)
    return call(X_test)


@linalg._highest_precision
def sample_f(model, state, X_test, n_samples: int = 1, generator=None):
    """Joint samples of the latent predictive, f* ~ N(mu*, Sigma*) with the
    full covariance (plus the dtype's jitter on its diagonal):
    [n_samples, L, n], the latent axis squeezed for single-latent models.
    ``generator`` (on X_test's device; seed 0 when None) draws them."""
    X_test = as_2d(X_test, like=_like(model))
    if generator is None:
        generator = torch.Generator(device=X_test.device).manual_seed(0)
    mu_f, cov = _latent(model, state, X_test, full_cov=True, diag=False)
    n = X_test.shape[0]
    L_c = linalg.cholesky_or_nan(cov + jitter(mu_f.dtype) * torch.eye(n, dtype=mu_f.dtype, device=mu_f.device))
    eps = torch.randn((n_samples,) + tuple(mu_f.shape), generator=generator, dtype=mu_f.dtype, device=mu_f.device)
    samples = mu_f[None] + (L_c[None] @ eps.unsqueeze(-1)).squeeze(-1)
    return samples[:, 0] if model.n_latent == 1 else samples


def _like(model):
    """The tensor whose device and dtype test inputs without a device take."""
    return model.train_x if isinstance(model, GP) else model.Z
