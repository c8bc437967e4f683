"""Plotting helpers (matplotlib): predictive-ribbon plots, the counterpart
of ``agp_tpu/utils/plotting.py`` (the reference's RecipesBase recipes):
mean line and k-sigma ribbon per latent or output, training scatter
overlay.  matplotlib is imported when a plot is made, so the library never
needs it.  The predictions run where the model lives; tensors come to the
host by ``.detach().cpu()``."""
from __future__ import annotations

import numpy as np
import torch


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _first(X):
    return X[:, 0] if X.ndim > 1 else X


def plot_gp(model, state, X_test, X_train=None, y_train=None, sigmas: float = 2.0, ax=None):
    """1-D ribbon plot of the predictive distribution (a classifier's
    probability alone)."""
    import matplotlib.pyplot as plt

    from ..training.predictions import proba_y

    out = proba_y(model, state, X_test)
    Xh = _np(X_test)
    order = np.argsort(_first(Xh))
    if isinstance(out, tuple):
        mu, var = _np(out[0]), _np(out[1])
    else:  # classification probability
        mu, var = _np(out), None
    if ax is None:
        _, ax = plt.subplots()
    xs = _first(Xh)[order]
    ax.plot(xs, mu[order], label="predictive mean")
    if var is not None:
        sd = np.sqrt(np.maximum(var[order], 0.0))
        ax.fill_between(xs, mu[order] - sigmas * sd, mu[order] + sigmas * sd, alpha=0.3, label=f"+-{sigmas} sigma")
    if X_train is not None and y_train is not None:
        ax.scatter(_first(_np(X_train)), _np(y_train), s=8, c="k", alpha=0.5, label="data")
    ax.legend()
    return ax


def plot_multilatent(model, state, X_test, sigmas: float = 2.0, ax=None):
    """One ribbon per latent GP f_1..f_K (multiclass, heteroscedastic
    models)."""
    import matplotlib.pyplot as plt

    from ..training.predictions import predict_f

    mu, var = predict_f(model, state, X_test, cov=True)
    xs_full = _first(_np(X_test))
    order = np.argsort(xs_full)
    mu, var = np.atleast_2d(_np(mu)), np.atleast_2d(_np(var))
    if ax is None:
        _, ax = plt.subplots()
    xs = xs_full[order]
    for k in range(mu.shape[0]):
        sd = np.sqrt(np.maximum(var[k][order], 0.0))
        m = mu[k][order]
        (line,) = ax.plot(xs, m, label=f"f{k + 1}")
        ax.fill_between(xs, m - sigmas * sd, m + sigmas * sd, alpha=0.3, color=line.get_color())
    ax.legend()
    return ax


def plot_mo_gp(model, state, X_test, X_train=None, ys_train=None, sigmas: float = 2.0, axes=None):
    """Multi-output ribbon plot: one subplot per task, one ribbon per latent
    row of the task, optional training scatter.  Returns the axes."""
    import matplotlib.pyplot as plt

    from ..models.multioutput import mo_predict_f

    mu_r, var_r = mo_predict_f(model, state, X_test)
    mu_r, var_r = _np(mu_r), _np(var_r)
    xs_full = _first(_np(X_test))
    order = np.argsort(xs_full)
    xs = xs_full[order]
    if axes is None:
        _, axes = plt.subplots(model.n_tasks, 1, sharex=True, squeeze=False)
        axes = axes[:, 0]
    for t, (s, e) in enumerate(model.row_slices()):
        ax = axes[t]
        if X_train is not None and ys_train is not None:
            ax.scatter(_first(_np(X_train)), _np(ys_train[t]), s=8, c="k", alpha=0.5, label="data")
        for j in range(s, e):
            sd = np.sqrt(np.maximum(var_r[j][order], 0.0))
            m = mu_r[j][order]
            (line,) = ax.plot(xs, m, label=f"f{j - s + 1}")
            ax.fill_between(xs, m - sigmas * sd, m + sigmas * sd, alpha=0.3, color=line.get_color())
        ax.set_title(f"Task {t + 1}")
        ax.legend()
    return axes
