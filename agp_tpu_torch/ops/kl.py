"""The KL terms of the ported likelihoods' ELBOs: the counterpart of the
matching functions of ``agp_tpu/ops/kl.py``."""
from __future__ import annotations

import torch

from .linalg import chol_logdet, chol_solve, invquad, symmetrize
from .special import digamma, gammaln, logcosh, xlogx


def gaussian_kl(mu, mu0, Sigma, L_K):
    """KL(N(mu, Sigma) || N(mu0, K)), K given by its lower Cholesky factor:
    1/2 (logdet K - logdet Sigma + tr(K^-1 Sigma) + (mu-mu0)^T K^-1 (mu-mu0) - M)
    for one latent ([M], [M, M])."""
    M = mu.shape[-1]
    L_S = torch.linalg.cholesky(symmetrize(Sigma))
    trace = torch.diagonal(chol_solve(L_K, Sigma), dim1=-2, dim2=-1).sum(-1)
    quad = invquad(L_K, mu - mu0)
    return 0.5 * (chol_logdet(L_K) - chol_logdet(L_S) + trace + quad - M)


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
