"""Sequential Monte Carlo (likelihood tempering) for the GP latents: the
counterpart of ``agp_tpu/inference/smc.py``.

Particles live in the whitened space v (f = mu0 + L_K v, prior N(0, I)).
The likelihood is tempered, p_t(v) = N(v) p(y | f(v))^beta_t, along a
fixed ladder of ``n_temps`` temperatures; each temperature reweights,
resamples systematically (cumulative weights and ``torch.searchsorted``)
and rejuvenates with a few MALA steps.  The particles are a leading
tensor axis.

Particle-parallel (``mesh``, the reference's ``particle_sharding``): the
particles are split over the mesh's data axis, each process holding a
contiguous block.  Every process holds the same generator and draws the
whole [P, L, N] normals and [P] uniforms, keeping its block, so that a
world of n draws what a world of 1 draws (O(P L N) a step, against the
likelihood's O(P L N^2)).  The collectives are the reference's: an
all-gather of the [P] log-weights (the logsumexp, log Z and the
systematic resampling's global indices), then one of the particles, from
which each process takes those its slots draw.
"""
from __future__ import annotations

import math

import torch

from ..means import batch_call
from .hmc import _latents, make_log_lik


def systematic_resample(log_w, n: int, u0):
    """Indices of ``n`` systematic draws from the weights softmax(log_w) at
    offset ``u0`` (a 0-d tensor, U[0, 1)): the left-sided search of the
    points (u0 + i) / n in the cumulative weights, as the reference's
    ``jnp.searchsorted``.  An index may equal len(log_w) when rounding
    leaves the last cumulative weight below 1; the caller clamps it, as
    JAX's gather clamps."""
    cum = torch.cumsum(torch.softmax(log_w, dim=0), dim=0)
    pts = (u0 + torch.arange(n, dtype=cum.dtype, device=cum.device)) / n
    return torch.searchsorted(cum, pts)


def smc_sample(model, n_particles: int = 256, n_temps: int = 20, n_mala: int = 5, mala_step: float = 0.05,
               generator=None, mesh=None):
    """Returns posterior samples of the latents f [P, L, N] and the
    estimate of log p(y) (the log marginal likelihood).  ``generator`` on
    the model's device (seed 0 when None).  With ``mesh`` (a
    ``parallel.mesh.Mesh``) the particles are split over its data axis:
    the result is this process's block [P / n, L, N] and log Z, the same
    on every process (:func:`gather_particles` collects all P); P must
    divide by the axis's size.  Every process must call it alike."""
    from ..models.mcgp import _default_generator, prior_chol

    generator = _default_generator(model, generator)
    axis = None if mesh is None or mesh.data.size == 1 else mesh.data
    if axis is not None and n_particles % axis.size:
        raise ValueError(f"{n_particles} particles do not split over a data axis of {axis.size} processes")
    lo, hi = (0, n_particles) if axis is None else axis.block(n_particles)

    def gathered(t):
        return t if axis is None else torch.cat(axis.all_gather(t))
    L_K = prior_chol(model)
    mu0 = batch_call(model.mean, model.train_x, model.n_latent)
    L, N = mu0.shape
    kw = dict(dtype=mu0.dtype, device=mu0.device)
    log_lik = make_log_lik(model, L_K, mu0)

    def tempered(v, beta):
        with torch.enable_grad():
            v = v.detach().requires_grad_(True)
            ll = log_lik(v)
            (g,) = torch.autograd.grad(ll.sum(), v)
        v = v.detach()
        return -0.5 * torch.sum(v**2, dim=(1, 2)) + beta * ll.detach(), -v + beta * g

    betas = torch.linspace(0.0, 1.0, n_temps + 1, dtype=torch.float64)[1:].tolist()
    shape = (n_particles, L, N)
    v = torch.randn(shape, generator=generator, **kw)[lo:hi]
    log_z = torch.zeros((), **kw)
    prev = 0.0
    eps = mala_step
    for beta in betas:
        with torch.no_grad():
            log_w = gathered((beta - prev) * log_lik(v))
        log_z = log_z + torch.logsumexp(log_w, dim=0) - math.log(n_particles)
        idx = systematic_resample(log_w, n_particles, torch.rand((), generator=generator, **kw))
        v = gathered(v)[torch.clamp(idx[lo:hi], max=n_particles - 1)]
        lp, grad = tempered(v, beta)
        for _ in range(n_mala):
            noise = torch.randn(shape, generator=generator, **kw)[lo:hi]
            prop = v + 0.5 * eps**2 * grad + eps * noise
            lp_p, grad_p = tempered(prop, beta)
            fwd = -torch.sum((prop - v - 0.5 * eps**2 * grad) ** 2, dim=(1, 2)) / (2 * eps**2)
            bwd = -torch.sum((v - prop - 0.5 * eps**2 * grad_p) ** 2, dim=(1, 2)) / (2 * eps**2)
            u = torch.log(torch.rand((n_particles,), generator=generator, **kw))[lo:hi]
            acc = u < lp_p - lp + bwd - fwd
            v = torch.where(acc[:, None, None], prop, v)
            lp = torch.where(acc, lp_p, lp)
            grad = torch.where(acc[:, None, None], grad_p, grad)
        prev = beta
    return _latents(L_K, mu0, v), log_z


def gather_particles(mesh, f):
    """All P particles of :func:`smc_sample` on a mesh ([P, L, N]): the
    processes' blocks all-gathered over its data axis in its order; ``f``
    itself on an axis of one process.  Every process must call it."""
    if mesh is None or mesh.data.size == 1:
        return f
    return torch.cat(mesh.data.all_gather(f.contiguous()))
