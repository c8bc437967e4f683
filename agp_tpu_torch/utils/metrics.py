"""Evaluation metrics for trained models: the counterpart of
``agp_tpu/utils/metrics.py`` (standard GP benchmarking utilities, not in
the reference).  Each returns a 0-d tensor on its inputs' device."""
from __future__ import annotations

import torch

from ..models.base import to_tensor
from ..ops.quadrature import nodes


def _pair(y_true, y_pred):
    """Both as tensors, an array without a device placed like the other."""
    if isinstance(y_pred, torch.Tensor):
        return to_tensor(y_true, like=y_pred), y_pred
    y_true = to_tensor(y_true)
    return y_true, to_tensor(y_pred, like=y_true)


def rmse(y_true, y_pred):
    y_true, y_pred = _pair(y_true, y_pred)
    return torch.sqrt(torch.mean((y_true - y_pred) ** 2))


def accuracy(y_true, y_pred):
    y_true, y_pred = _pair(y_true, y_pred)
    return torch.mean((y_true == y_pred).to(torch.get_default_dtype()))


def negative_log_predictive_density(model, state, X_test, y_test, n_points: int = 100):
    """Mean NLPD, -1/n sum log E_{f* ~ N(mu*, var*)}[p(y | f*)], the held-out
    GP metric, by Gauss-Hermite quadrature on ``ops.quadrature``'s nodes."""
    from ..training.predictions import predict_f

    mu, var = predict_f(model, state, X_test, cov=True)
    lik = model.likelihood
    y2, _ = lik.treat_labels(to_tensor(y_test, like=mu))
    if model.n_latent > 1:
        raise NotImplementedError("NLPD for multi-latent models: use proba_y")
    f, w = nodes(mu, var, n_points)  # [n, q]
    lp = lik.log_prob(y2.to(device=mu.device, dtype=mu.dtype)[:, None], f)
    return -torch.mean(torch.logsumexp(lp + torch.log(w)[None, :], dim=1))


def coverage(y_true, mu, var, level: float = 0.95):
    """Empirical coverage of the central predictive interval at ``level``."""
    mu = to_tensor(mu)
    var, y = to_tensor(var, like=mu), to_tensor(y_true, like=mu)
    z = torch.special.ndtri(torch.as_tensor(0.5 + level / 2.0, dtype=mu.dtype, device=mu.device))
    sd = torch.sqrt(torch.clamp(var, min=0.0))
    lo, hi = mu - z * sd, mu + z * sd
    return torch.mean(((y >= lo) & (y <= hi)).to(mu.dtype))
