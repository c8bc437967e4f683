"""Autoregressive prediction: roll a GP forward by feeding its own
predictions back as lagged inputs, the counterpart of
``agp_tpu/training/ar_predict.py``.

The model was trained on lag-vector inputs x_t = [y_{t-L}, ..., y_{t-1}].
The reference's ``lax.scan`` over the horizon becomes a loop whose window
shifts on the device: a step is one ``predict_f`` and a concatenation, with
no host read.  ``sample_ar``'s trajectories share each step's
``predict_f`` as the rows of one window (the reference's ``vmap``: the
diagonal predictive is row-wise).
"""
from __future__ import annotations

import torch

from ..models.base import to_tensor
from .predictions import _like, predict_f


def _window(model, x_init):
    """The most recent observations [lag] on the model's device, in its
    dtype."""
    return to_tensor(x_init, like=_like(model)).reshape(-1).to(_like(model).dtype)


def _first_latent(a, n_latent):
    """The first latent's [n] of ``predict_f``'s output."""
    return a if n_latent == 1 else a[0]


def predict_ar(model, state, x_init, n_steps: int):
    """Deterministic rollout of the predictive mean: x_init [lag] the most
    recent observations (oldest first); returns [n_steps] predictions."""
    window = _window(model, x_init)
    preds = []
    for _ in range(n_steps):
        mu = _first_latent(predict_f(model, state, window[None, :]), model.n_latent)
        preds.append(mu)
        window = torch.cat([window[1:], mu])
    return torch.cat(preds)


def sample_ar(model, state, x_init, n_steps: int, n_samples: int = 16, generator=None, eps=None):
    """Stochastic rollout: at each step draw y ~ N(mu*, var*) and feed the
    draw back, for ``n_samples`` trajectories at once; returns
    [n_samples, n_steps].  The standard normals are ``eps`` ([n_samples,
    n_steps]) or are drawn with ``generator`` (on the model's device;
    seed 0 when None)."""
    window = _window(model, x_init)
    like = _like(model)
    if eps is None:
        if generator is None:
            generator = torch.Generator(device=like.device).manual_seed(0)
        eps = torch.randn((n_samples, n_steps), generator=generator, dtype=like.dtype, device=like.device)
    windows = window.expand(n_samples, window.shape[0])
    traj = []
    for t in range(n_steps):
        mu, var = predict_f(model, state, windows, cov=True)
        mu, var = _first_latent(mu, model.n_latent), _first_latent(var, model.n_latent)
        y = mu + torch.sqrt(torch.clamp(var, min=0.0)) * eps[:, t]
        traj.append(y)
        windows = torch.cat([windows[:, 1:], y[:, None]], dim=1)
    return torch.stack(traj, dim=1)
