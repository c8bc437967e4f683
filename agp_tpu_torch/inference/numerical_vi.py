"""Numerical VI: Opper-Archambeau gradients of E[log p(y|f)] by
Gauss-Hermite quadrature or Monte Carlo integration, the counterpart of
``agp_tpu/inference/numerical_vi.py``.

Gradient equations:
  full:   d_eta1 = E[dlogp] - K^-1 (mu - mu0)
          d_eta2 = Diag(E[d2logp]/2) - (K^-1 - Sigma^-1)/2
  sparse: d_eta1 = rho kappa^T E[dlogp] - K^-1 (mu - mu0)
          d_eta2 = rho kappa^T Diag(E[d2logp]/2) kappa - (K^-1 - Sigma^-1)/2
  natural preconditioning: d_eta1 <- K d_eta1; d_eta2 <- 2 Sigma d_eta2 Sigma
  update: mu += opt(d_eta1); Sigma += alpha opt(d_eta2), alpha halved from
  1 while Sigma + alpha dSigma has no Cholesky factor (27 rungs at most).

A sparse model's moments come from ``analytic_vi.latent_moments`` (on the
card kernel 6, ``fused_kappa``, for one latent; kernel 4,
``fused_kappa_moments_batched``, for several) and its two contractions
from the same statistics kernels as the CAVI step's split pair:
``cuda_kernels.cavi_stats`` (kernel 7) with (rho E[dlogp],
rho E[d2logp]/2) for one latent, ``cavi_stats_batched`` (kernel 5) for
several.  The rest ([L, M, M] algebra, the Cholesky rungs) is plain
PyTorch at full FP32.  A dense model (VGP) runs no kernel of the port.
The Monte Carlo draws are an argument (``eps``, [S, L, B]), or are drawn
from an explicit generator.
"""
from __future__ import annotations

import functools

import torch

from ..ops import cuda_kernels, linalg, quadrature
from ..ops.kl import gaussian_kl
from ..training.state import TrainState
from ..utils.opt import ascent_update
from ..utils.tensors import host_read
from .analytic_vi import latent_moments, prior_mean_stack

# the PSD step's rungs: alpha = 2^-k, k = 0 .. PSD_RUNGS - 1 (the
# reference halves alpha while it is above 1e-8)
PSD_RUNGS = 27


def _clip(t, clipping):
    return torch.clamp(t, -clipping, clipping) if clipping else t


# ------------------------------------------------------- expectation grads
def quad_grads(lik, y, mu, var, n_points: int, clipping: float):
    """(E[dlogp], E[d2logp]) [L, B] by Gauss-Hermite quadrature on
    ``n_points`` nodes (single-latent likelihoods); mu/var [L, B], y [B]."""
    nodes, w = quadrature.nodes(mu, var, n_points)
    yb = y.reshape(1, -1, 1).expand(nodes.shape)
    Ed = torch.sum(w * lik.grad_log_prob(yb, nodes), dim=-1)
    Ed2 = torch.sum(w * lik.hess_log_prob(yb, nodes), dim=-1)
    return _clip(Ed, clipping), _clip(Ed2, clipping)


def _ad_grad_hess(lik, yT, f):
    """d log p / d f and the diagonal of its Hessian for a multi-latent
    likelihood by automatic differentiation, f [S, L, B]: the gradient of
    the summed log_prob per draw, and one jvp per latent axis."""
    L = f.shape[1]

    def glp(fs):
        return torch.func.grad(lambda t: torch.sum(lik.log_prob(yT, t)))(fs)

    def hdiag(fs):
        def col(e):
            return torch.func.jvp(glp, (fs,), (e[:, None] * torch.ones_like(fs),))[1]

        return torch.einsum("llb->lb", torch.func.vmap(col)(torch.eye(L, dtype=f.dtype, device=f.device)))

    return torch.func.vmap(glp)(f), torch.func.vmap(hdiag)(f)


def mc_grads(lik, y, mu, var, eps, clipping: float):
    """(E[dlogp], E[diag d2logp]) [L, B] as the mean over the draws
    f = mu + sd eps, eps [S, L, B].  A multi-latent likelihood takes y
    one-hot [B, K] and its closed form ``mc_grad_hess`` where it has one
    (softmax), else automatic differentiation."""
    f = mu[None] + torch.sqrt(torch.clamp(var, min=0.0))[None] * eps
    if lik.n_latent == 1:
        yb = y.expand(f.shape)
        g, h = lik.grad_log_prob(yb, f), lik.hess_log_prob(yb, f)
    elif hasattr(lik, "mc_grad_hess"):
        g, h = lik.mc_grad_hess(y.T, f)
    else:
        g, h = _ad_grad_hess(lik, y.T, f)
    return _clip(torch.mean(g, dim=0), clipping), _clip(torch.mean(h, dim=0), clipping)


def draw_normals(inf, mu_f, generator):
    """The standard normals eps [n_mc, L, B] of one Monte Carlo step."""
    return torch.randn((inf.n_mc,) + tuple(mu_f.shape), generator=generator, dtype=mu_f.dtype,
                       device=mu_f.device)


# ------------------------------------------------------------------ PSD step
def psd_apply(S, dS, lazy: bool = False):
    """(S + alpha sym(dS), rungs) for the first alpha = 2^-k (k < PSD_RUNGS)
    at which it has a Cholesky factor, each matrix of [L, n, n] on its own;
    S where no rung has one.  ``rungs`` [L] is the k each matrix took
    (PSD_RUNGS: none).  All rungs factor as one batch and a device-side
    select picks the rung, with no host read.  ``lazy`` (the dense models'
    [L, N, N]) factors rung 0 alone and the batch only when a matrix
    failed there: one host read a call."""
    dS = linalg.symmetrize(dS)

    def factors(A):
        L, info = torch.linalg.cholesky_ex(A)
        return (info == 0) & torch.isfinite(L).all(-1).all(-1)

    if lazy:
        ok0 = factors(S + dS)
        if host_read(ok0.all()):
            return S + dS, torch.zeros(S.shape[:-2], dtype=torch.int64, device=S.device)
    alphas = 2.0 ** -torch.arange(PSD_RUNGS, dtype=S.dtype, device=S.device)
    ok = factors(S.unsqueeze(0) + alphas.reshape((-1,) + (1,) * S.ndim) * dS.unsqueeze(0))  # [R, L]
    found = ok.any(0)
    first = torch.where(found, ok.to(torch.int32).argmax(0), PSD_RUNGS).to(torch.int64)
    alpha = alphas[torch.clamp(first, max=PSD_RUNGS - 1)]
    return torch.where(found[..., None, None], S + alpha[..., None, None] * dS, S), first


# ------------------------------------------------------------------- update
@linalg._highest_precision
def variational_update(model, state: TrainState, x, y, eps=None, generator=None):
    """One numerical VI step on the batch (x, y); returns (model, state).
    A Monte Carlo engine takes its draws ``eps`` [n_mc, L, B], or draws
    them with ``generator`` (on x's device)."""
    inf = model.inference
    kmat = state.kmat
    mu_f, var_f, kappa = latent_moments(model, state, x, kmat)
    lik = model.likelihood
    if inf.name == "QuadratureVI":
        Ed, Ed2 = quad_grads(lik, y, mu_f, var_f, inf.n_points, inf.clipping)
    else:
        eps = draw_normals(inf, mu_f, generator) if eps is None else eps
        Ed, Ed2 = mc_grads(lik, y, mu_f, var_f, eps, inf.clipping)

    K_inv = kmat["K_inv"]
    mu, Sigma = state.mu, state.Sigma
    Kinv_dmu = (K_inv @ (mu - prior_mean_stack(model, x)).unsqueeze(-1)).squeeze(-1)
    Sigma_inv = linalg.chol_inv(linalg.cholesky_or_nan(linalg.symmetrize(Sigma)))
    if model.is_sparse:
        g, theta = (state.rho * Ed).contiguous(), (state.rho * Ed2 / 2.0).contiguous()
        if model.n_latent == 1:
            s1, S2 = cuda_kernels.cavi_stats(kappa[0].contiguous(), g[0], theta[0])
            s1, S2 = s1[None], S2[None]
        else:
            s1, S2 = cuda_kernels.cavi_stats_batched(kappa, g, theta)
        d1 = s1 - Kinv_dmu
        d2 = S2 - (K_inv - Sigma_inv) / 2.0
    else:
        d1 = Ed - Kinv_dmu
        d2 = torch.diag_embed(Ed2 / 2.0) - (K_inv - Sigma_inv) / 2.0

    if inf.natural:
        L_K = kmat["L_K"]
        d1 = ((L_K @ L_K.mT) @ d1.unsqueeze(-1)).squeeze(-1)
        d2 = 2.0 * (Sigma @ d2 @ Sigma)

    opt_state, (u1, u2) = ascent_update(inf.optimiser, state.opt_state, (mu, Sigma), (d1, d2))
    new_mu = mu + u1
    new_Sigma, _ = psd_apply(Sigma, u2, lazy=not model.is_sparse)
    eta1, eta2 = linalg.moments_to_nat(new_mu, new_Sigma)
    return model, state.replace(mu=new_mu, Sigma=new_Sigma, eta1=eta1, eta2=eta2, opt_state=opt_state)


# --------------------------------------------------------------------- ELBO
def default_elbo_draws(inf, mu_f):
    """The ELBO's fixed Monte Carlo draws: a generator of seed 7 on mu_f's
    device (the reference's PRNGKey(7)), drawn once for each shape, dtype
    and device (``_elbo_draws``); the caller only reads them."""
    return _elbo_draws(inf.n_mc, tuple(mu_f.shape), mu_f.dtype, mu_f.device)


@functools.lru_cache(maxsize=None)
def _elbo_draws(n_mc, shape, dtype, device):
    """The normals [n_mc, *shape] of a generator of seed 7.  Never evicted:
    a captured hyperparameter step (``training/graphs.py``) reads them by
    their address, and no capture takes a generator it does not hold, so
    they are drawn in the eager iteration before it."""
    cuda_kernels.check_not_capturing("the ELBO's Monte Carlo draws")
    return torch.randn((n_mc,) + shape, generator=torch.Generator(device=device).manual_seed(7), dtype=dtype,
                       device=device)


def expec_loglik(model, state, x, y, kmat=None, eps=None):
    """E_q[log p(y | f)] summed over the batch: by quadrature, or over the
    Monte Carlo draws ``eps`` (default ``default_elbo_draws``)."""
    inf = model.inference
    kmat = state.kmat if kmat is None else kmat
    mu_f, var_f, _ = latent_moments(model, state, x, kmat)
    lik = model.likelihood
    if inf.name == "QuadratureVI":
        nodes, w = quadrature.nodes(mu_f, var_f, inf.n_points)
        lp = lik.log_prob(y.reshape(1, -1, 1).expand(nodes.shape), nodes)
        return torch.sum(w * lp)
    eps = default_elbo_draws(inf, mu_f) if eps is None else eps
    f = mu_f[None] + torch.sqrt(torch.clamp(var_f, min=0.0))[None] * eps  # [S, L, B]
    if lik.n_latent == 1:
        lp = lik.log_prob(y.expand(f.shape), f)
        return torch.sum(torch.mean(lp, dim=0))
    lp = lik.log_prob(y.T[:, None, :], f.transpose(0, 1))  # [S, B]: the latent axis first
    return torch.sum(torch.mean(lp, dim=0))


@linalg._highest_precision
def elbo(model, state, x, y, kmat=None, eps=None):
    """rho E_q[log p(y | f)] - the Gaussian KL, on the batch (x, y), with
    the prior's matrices ``kmat`` (default ``state.kmat``): the objective
    the hyperparameter step differentiates."""
    kmat = state.kmat if kmat is None else kmat
    tot = state.rho * expec_loglik(model, state, x, y, kmat, eps)
    mu0 = prior_mean_stack(model, x)
    kl = torch.stack([
        gaussian_kl(state.mu[l], mu0[l], state.Sigma[l], kmat["L_K"][l]) for l in range(model.n_latent)
    ])
    return tot - torch.sum(kl)
