"""Blocked Gibbs sampling with augmented variables: the counterpart of
``agp_tpu/inference/gibbs.py``.

One sweep:
  omega ~ p(omega | f)                        (the likelihood's sample_local)
  Sigma = (2 diag(grad_e_sigma) + K^-1)^-1
  f | omega ~ N(Sigma (grad_e_mu + K^-1 mu0), Sigma)

Every chain and latent is a leading tensor axis: f is [C, L, N], so one
batched factorization ("chol") or one batched conjugate-gradient solve
("cg") serves all chains.  K^-1 and L_K are [L, N, N], shared by the
chains.  The Gaussian noise of the global resample is drawn by
``gibbs_step`` and handed to ``_global_resample_chol`` /
``_global_resample_cg``, which hold the algebra alone.  The dense algebra
runs at full FP32 or FP64 (TF32 off): cuSOLVER and cuBLAS on the card,
no kernel of the port, as no Pallas kernel runs in the reference's sweep.
"""
from __future__ import annotations

import torch

from ..means import batch_call
from ..ops import linalg
from ..utils.tensors import host_read

# JAX's cg stopping rule, as the reference calls it: |r| <= tol |b|, at
# most min(N, CG_MAXITER) iterations from x0 = 0; "any system active" is
# read on the host once every CG_CHECK_EVERY iterations
CG_TOL, CG_MAXITER, CG_CHECK_EVERY = 1e-5, 128, 8


def solver_of(model) -> str:
    """The global resample's solver: "cg" or "chol" as asked; "auto" is
    "chol", which is what the reference picks off a TPU."""
    solver = getattr(model.inference, "solver", "auto")
    return "cg" if solver == "cg" else "chol"


@linalg._highest_precision
def _global_resample_chol(gmu, gs, K_inv, mu0, eps):
    """f = m + L_A^-T eps with A = 2 diag(gs) + K^-1 = L_A L_A^T and
    m = A^-1 (gmu + K^-1 mu0): a draw of N(A^-1 b, A^-1).  gmu, gs, eps:
    [C, L, N]; K_inv [L, N, N]; mu0 [L, N].  A failed factorization gives
    NaN, as the reference's does; nothing is read back to the host."""
    A = K_inv + torch.diag_embed(2.0 * gs)
    L_A = linalg.cholesky_or_nan(linalg.symmetrize(A))
    rhs = gmu + (K_inv @ mu0.unsqueeze(-1)).squeeze(-1)
    m = linalg.chol_solve(L_A, rhs)
    delta = torch.linalg.solve_triangular(L_A.mT, eps.unsqueeze(-1), upper=True).squeeze(-1)
    return m + delta


@linalg._highest_precision
def _global_resample_cg(gmu, gs, K_inv, L_K, mu0, xi1, xi2):
    """The whitened perturb-and-solve.  With D = 2 diag(gs) and
    b = gmu + K^-1 mu0, the target is f ~ N(Q^-1 b, Q^-1), Q = D + K^-1.
    With f = L_K h: A h = L_K^T b + n, A = L_K^T D L_K + I, and
    n = L_K^T sqrt(D) xi1 + xi2 ~ N(0, A) exactly; then f = L_K h.

    The [C, L] systems run as one batched CG in JAX's form (x0 = 0, stop
    when r.r <= tol^2 b.b, at most min(N, 128) iterations); a converged
    system is frozen by a mask, and "any system active" is read on the
    host once every CG_CHECK_EVERY iterations.  The chains are the
    columns of one [L, N, C] block, so each matvec reads L_K once.
    ``_global_resample_cg.iterations`` adds up the iterations run."""
    N = gmu.shape[-1]
    D = 2.0 * gs
    b = gmu + (K_inv @ mu0.unsqueeze(-1)).squeeze(-1)
    cols = lambda t: t.permute(1, 2, 0)  # [C, L, N] -> [L, N, C]
    Dc = cols(D)
    rhs = L_K.mT @ cols(b + torch.sqrt(torch.clamp(D, min=0.0)) * xi1) + cols(xi2)

    def A(h):
        return L_K.mT @ (Dc * (L_K @ h)) + h

    x = torch.zeros_like(rhs)
    r, p = rhs, rhs
    gamma = torch.sum(r * r, dim=1)  # [L, C]
    atol2 = CG_TOL**2 * torch.sum(rhs * rhs, dim=1)
    active = gamma > atol2
    for k in range(min(N, CG_MAXITER)):
        if k % CG_CHECK_EVERY == 0 and not host_read(active.any()):
            break
        _global_resample_cg.iterations += 1
        Ap = A(p)
        alpha = (gamma / torch.sum(p * Ap, dim=1)).unsqueeze(1)
        keep = active.unsqueeze(1)
        x = torch.where(keep, x + alpha * p, x)
        r = torch.where(keep, r - alpha * Ap, r)
        gamma_new = torch.sum(r * r, dim=1)
        p = torch.where(keep, r + (gamma_new / gamma).unsqueeze(1) * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        active = active & (gamma > atol2)
    return (L_K @ x).permute(2, 0, 1)


_global_resample_cg.iterations = 0


def gibbs_step(model, kmat, mu0, generator, f, local_vars):
    """One blocked Gibbs sweep over every chain.  f: [C, L, N]; kmat holds
    "L_K" and "K_inv" ([L, N, N]).  Returns (f, local_vars)."""
    lik = model.likelihood
    local_vars = lik.sample_local(generator, model.train_y, f, local_vars)
    shape = f.shape
    gmu = lik.grad_e_mu(model.train_y, local_vars).expand(shape)
    gs = lik.grad_e_sigma(model.train_y, local_vars).expand(shape)
    randn = lambda: torch.randn(shape, generator=generator, dtype=f.dtype, device=f.device)
    if solver_of(model) == "cg":
        f_new = _global_resample_cg(gmu, gs, kmat["K_inv"], kmat["L_K"], mu0, randn(), randn())
    else:
        f_new = _global_resample_chol(gmu, gs, kmat["K_inv"], mu0, randn())
    return f_new, local_vars


def run_chain(model, kmat, generator, n_samples: int, n_burnin: int, thinning: int, local_vars, n_chains: int = 1,
              f0=None):
    """Runs n_burnin + n_samples * thinning sweeps of ``n_chains`` chains
    from f = 0 (or f0, [C, L, N]) and keeps the reference's
    ``all_f[n_burnin + thinning - 1 :: thinning]``, written into a
    preallocated [n_samples, C, L, N] tensor.  Returns (kept, f,
    local_vars)."""
    L, N = model.n_latent, model.train_x.shape[0]
    X = model.train_x
    mu0 = batch_call(model.mean, X, L)
    f = torch.zeros((n_chains, L, N), dtype=X.dtype, device=X.device) if f0 is None else f0
    kept = torch.empty((n_samples, n_chains, L, N), dtype=X.dtype, device=X.device)
    first = n_burnin + thinning - 1
    for t in range(n_burnin + n_samples * thinning):
        f, local_vars = gibbs_step(model, kmat, mu0, generator, f, local_vars)
        if t >= first and (t - first) % thinning == 0:
            kept[(t - first) // thinning] = f
    return kept, f, local_vars
