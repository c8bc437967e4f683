"""Stein variational gradient descent over the GP latents: the
counterpart of ``agp_tpu/inference/svgd.py``.

Particles live in the whitened space v (f = mu0 + L_K v), the target
log p(v) = sum log p(y | f(v)) - |v|^2 / 2, with one [P, P] RBF kernel
between particles whose bandwidth is the median heuristic:

  phi(v_i) = (1/P) sum_j [ k(v_j, v_i) grad log p(v_j) + grad_{v_j} k(v_j, v_i) ]
"""
from __future__ import annotations

import math

import torch

from ..means import batch_call
from .hmc import _latents, make_log_joint, value_and_grad


def _median(x):
    """The median of all entries, the two middle values averaged for an
    even count, as ``jnp.median`` takes it (``torch.median`` returns the
    lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


def _svgd_run(model, v0, n_steps: int, step_size: float):
    """``n_steps`` SVGD updates of the particles from v0 [P, L, N];
    deterministic given v0.  Returns f [P, L, N]."""
    from ..models.mcgp import prior_chol

    L_K = prior_chol(model)
    mu0 = batch_call(model.mean, model.train_x, model.n_latent)
    vg = value_and_grad(make_log_joint(model, L_K, mu0))
    v, P = v0, v0.shape[0]
    for _ in range(n_steps):
        g = vg(v)[1]
        flat, gflat = v.reshape(P, -1), g.reshape(P, -1)
        sq = torch.sum(flat**2, dim=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * flat @ flat.T
        h = torch.clamp(_median(d2) / math.log(P + 1.0), min=1e-6)  # the median heuristic
        Kp = torch.exp(-d2 / h)
        attract = Kp @ gflat
        repulse = (torch.sum(Kp, dim=1, keepdim=True) * flat - Kp @ flat) * (2.0 / h)
        v = v + step_size * ((attract + repulse) / P).reshape(v.shape)
    return _latents(L_K, mu0, v)


def svgd_sample(model, n_particles: int = 128, n_steps: int = 500, step_size: float = 0.05, generator=None):
    """Latent particles f [P, L, N] approximating the posterior, from
    v ~ N(0, I) drawn with ``generator`` (on the model's device; seed 0
    when None)."""
    from ..models.mcgp import _default_generator

    generator = _default_generator(model, generator)
    X = model.train_x
    v0 = torch.randn((n_particles, model.n_latent, X.shape[0]), generator=generator, dtype=X.dtype, device=X.device)
    return _svgd_run(model, v0, n_steps, step_size)
