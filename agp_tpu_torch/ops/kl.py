"""The KL terms of the ported likelihoods' ELBOs: the counterpart of the
matching functions of ``agp_tpu/ops/kl.py``."""
from __future__ import annotations

import torch

from .linalg import chol_logdet, chol_solve, cholesky_or_nan, invquad, symmetrize
from .special import LOG2, digamma, gammaln, log_besselk_half, logcosh, xlogx


def gaussian_kl(mu, mu0, Sigma, L_K):
    """KL(N(mu, Sigma) || N(mu0, K)), K given by its lower Cholesky factor:
    1/2 (logdet K - logdet Sigma + tr(K^-1 Sigma) + (mu-mu0)^T K^-1 (mu-mu0) - M)
    for one latent ([M], [M, M])."""
    M = mu.shape[-1]
    L_S = cholesky_or_nan(symmetrize(Sigma))  # no host read
    trace = torch.diagonal(chol_solve(L_K, Sigma), dim1=-2, dim2=-1).sum(-1)
    quad = invquad(L_K, mu - mu0)
    return 0.5 * (chol_logdet(L_K) - chol_logdet(L_S) + trace + quad - M)


def gamma_kl(alpha, beta, alpha_p, beta_p):
    """KL(Ga(alpha, beta) || Ga(alpha_p, beta_p)), summed; the inverse-Gamma
    KL has the same form."""
    return torch.sum(
        (alpha - alpha_p) * digamma(alpha)
        - gammaln(alpha)
        + gammaln(alpha_p)
        + alpha_p * (torch.log(beta) - torch.log(beta_p))
        + alpha * (beta_p - beta) / beta
    )


inverse_gamma_kl = gamma_kl


def poisson_kl(lam, lam0):
    """KL(Po(lam) || Po(lam0)) with a scalar rate lam0, summed."""
    lam = torch.ravel(lam)
    n = lam.shape[0]
    return lam0 * n - (1.0 + torch.log(lam0)) * torch.sum(lam) + torch.sum(xlogx(lam))


def polya_gamma_kl(b, c, theta):
    """KL(PG(b, c) || PG(b, 0)) with theta = E[omega], summed."""
    return torch.sum(b * logcosh(c / 2.0)) - torch.sum(c**2 * theta) / 2.0


def poisson_kl_expected(lam, lam0, psi):
    """KL(Po(lam) || Po(lam0)) where lam0 is itself random with
    E[lam0] = lam0 and E[log lam0] = psi, summed."""
    return torch.sum(lam0) - torch.sum(lam) + torch.sum(xlogx(lam)) - torch.sum(lam * psi)


def gamma_entropy_improper(alpha, beta):
    """-E_q[log q(n)] + E_q[log 1_{[0,inf)}] for q = Ga(alpha, beta): the
    "KL" against the improper flat prior of the logistic-softmax
    augmentation, with sum(log beta) as the reference takes it."""
    return (
        -torch.sum(alpha)
        + torch.sum(torch.log(beta))
        - torch.sum(gammaln(alpha))
        - torch.sum((1.0 - alpha) * digamma(alpha))
    )


def gig_entropy(a, b, p: float):
    """Entropy of GIG(a, b, p) summed over elements, without the d/dp K_p
    term, as the reference takes it; half-integer |p| only."""
    n_half = int(round(abs(p) - 0.5))
    sqrt_ab = torch.sqrt(a * b)
    lk_p = log_besselk_half(n_half, sqrt_ab)
    # K_{p+1} and K_{p-1} for p = n_half + 1/2: orders n_half+3/2 and n_half-1/2
    k_plus = torch.exp(log_besselk_half(n_half + 1, sqrt_ab) - lk_p)
    k_minus = torch.exp(log_besselk_half(abs(n_half - 1) if n_half >= 1 else 0, sqrt_ab) - lk_p)
    term1 = (torch.sum(torch.log(a)) - torch.sum(torch.log(b))) / 2.0
    term2 = torch.sum(LOG2 + lk_p)
    term3 = torch.sum(sqrt_ab * (k_plus + k_minus)) / 2.0
    return term1 + term2 + term3
