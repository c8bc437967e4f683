"""Dense linear-algebra primitives of the CAVI step: the counterpart of
``agp_tpu/ops/linalg.py``.

Everything here is [M, M]-scale work (factorizations, triangular solves,
inverses, eta <-> moments) and runs at full FP32 (or FP64): TF32 keeps about
three decimal digits, which ill-conditioned kernel matrices do not survive.

The two jitter ladders, which the reference runs as ``lax.while_loop``s, are
one batched ``torch.linalg.cholesky_ex`` over all rungs followed by a
device-side selection of the first rung that factorized.  No value is read
back to the host, so a training step holds no device sync.  With
``lazy_rungs`` (the dense models' [L, N, N] matrices) rung 0 is factored
alone and the batch of all rungs runs only when it failed: one host read
a call, against the batch's R-fold factorizations and copies at N^3.
The warm (Newton-Schulz) conversions read their branch predicate once
on the host and run that branch alone.  Functions take optional leading batch dimensions ``[..., M, M]``.
"""
from __future__ import annotations

import functools

import torch

from ..config import jitter
from ..utils.tensors import host_read


def _highest_precision(fn):
    """Run ``fn`` with TF32 matmuls disabled (the analogue of the reference's
    ``jax.default_matmul_precision("highest")``); the previous setting is
    restored on exit."""

    @functools.wraps(fn)
    def wrapped(*a, **kw):
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return fn(*a, **kw)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    return wrapped


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    return torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def _ladder_cholesky(A: torch.Tensor, jitters: torch.Tensor, lazy_rungs: bool = False) -> torch.Tensor:
    """Cholesky of ``A + j I`` for the first rung ``j`` of ``jitters``
    ([R, ...], one ladder per matrix of A) whose factorization succeeds.

    All R factorizations run as one batch; the selection is a gather, so the
    call stays on the device.  When no rung succeeds the result is NaN, as
    the reference's factorization of the last rung is.

    Under autograd (A requires grad) the ladder runs on a detached copy and
    only the chosen rung is factored again, differentiably, as the
    reference differentiates only its chosen rung: a failed rung's factor
    holds NaN, and its backward would put NaN into A's gradient even with a
    zero cotangent.  The jitter itself is a constant.  No host read either
    way, unless ``lazy_rungs``: then rung 0 is factored alone (the chosen
    rung, differentiably, when it succeeds for every matrix), one host
    read decides, and the batch above runs only when it failed."""
    if lazy_rungs:
        j0 = jitters[0].detach()
        L, info = torch.linalg.cholesky_ex(A + j0[..., None, None] * _eye_like(A))
        if bool(((info == 0) & torch.isfinite(L).all(-1).all(-1)).all()):
            return L
    R = jitters.shape[0]
    differentiable = torch.is_grad_enabled() and A.requires_grad
    eye = _eye_like(A)
    with torch.no_grad():
        Aj = A.detach().unsqueeze(0) + jitters.detach()[..., None, None] * eye
        L, info = torch.linalg.cholesky_ex(Aj)
        ok = (info == 0) & torch.isfinite(L).all(-1).all(-1)  # [R, ...]
        first = torch.where(
            ok.any(0), ok.to(torch.int32).argmax(0), torch.full_like(info[0], R - 1)
        ).to(torch.int64)
    if differentiable:
        j = torch.take_along_dim(jitters.detach(), first[None], dim=0)[0]
        L = torch.linalg.cholesky_ex(A + j[..., None, None] * eye).L
    else:
        L = torch.take_along_dim(L, first.reshape((1,) + first.shape + (1, 1)), dim=0)[0]
    return torch.where(ok.any(0)[..., None, None], L, torch.full_like(L, float("nan")))


@_highest_precision
def safe_cholesky(K: torch.Tensor, jitt: float | None = None, lazy_rungs: bool = False) -> torch.Tensor:
    """Lower Cholesky factor of ``K + jitt*I`` with an adaptive jitter ladder:
    if the factorization fails, the jitter is multiplied by 10, up to 4
    times (5 rungs, the first being the dtype-scaled jitter)."""
    if jitt is None:
        jitt = jitter(K.dtype)
    j = torch.full(K.shape[:-2], jitt, dtype=K.dtype, device=K.device)
    rungs = [j]
    for _ in range(4):
        rungs.append(rungs[-1] * 10.0)
    return _ladder_cholesky(K, torch.stack(rungs), lazy_rungs)


@_highest_precision
def psd_safe_cholesky(A: torch.Tensor, base=None, lazy_rungs: bool = False) -> torch.Tensor:
    """Cholesky of a matrix that is PD by construction but can round slightly
    indefinite.  The ladder starts at ZERO (exact whenever the plain
    factorization succeeds) and escalates ``base * 10^k``, k = 0..4.  The
    default base is norm-relative: max(jitter(dtype), 3e-7 * mean |diag|)."""
    if base is None:
        mean_diag = torch.diagonal(A, dim1=-2, dim2=-1).abs().mean(-1)
        base = torch.clamp(3e-7 * mean_diag, min=jitter(A.dtype))
    base = torch.as_tensor(base, dtype=A.dtype, device=A.device).expand(A.shape[:-2])
    # rungs made on the device: a host-built table would cost a copy and a
    # sync on every call
    rungs = [base * 0.0, base] + [base * 10.0**k for k in range(1, 5)]
    return _ladder_cholesky(A, torch.stack(rungs), lazy_rungs)


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of A, NaN where the factorization fails (as
    the reference's ``jnp.linalg.cholesky`` returns it), with no host read;
    differentiable."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")))


@_highest_precision
def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A x = B`` given the lower Cholesky factor ``L`` of ``A``."""
    vec = B.ndim == L.ndim - 1
    if vec:
        B = B.unsqueeze(-1)
    y = torch.linalg.solve_triangular(L, B, upper=False)
    x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x.squeeze(-1) if vec else x


@_highest_precision
def chol_inv(L: torch.Tensor) -> torch.Tensor:
    """Inverse of ``A`` from its lower Cholesky factor, symmetrized."""
    return symmetrize(chol_solve(L, _eye_like(L).expand(L.shape)))


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|A| from the lower Cholesky factor of A."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)


@_highest_precision
def invquad(L: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x^T A^-1 x given the lower Cholesky factor of A (a vector x, or the
    sum over the columns of a matrix x)."""
    vec = x.ndim == 1
    v = torch.linalg.solve_triangular(L, x.unsqueeze(-1) if vec else x, upper=False)
    return torch.sum(v * v)


def symmetrize(A: torch.Tensor) -> torch.Tensor:
    return 0.5 * (A + A.mT)


def diag_ABt(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """diag(A @ B^T) without forming the product."""
    return torch.sum(A * B, dim=-1)


@_highest_precision
def nat_to_moments(eta1: torch.Tensor, eta2: torch.Tensor, lazy_rungs: bool = False):
    """(mu, Sigma) from the natural parameters: Sigma = -1/2 eta2^-1,
    mu = Sigma eta1, with the zero-first jitter ladder on -eta2."""
    L = psd_safe_cholesky(-symmetrize(eta2), lazy_rungs=lazy_rungs)
    Sigma = symmetrize(0.5 * chol_solve(L, _eye_like(eta2).expand(eta2.shape)))
    mu = (Sigma @ eta1.unsqueeze(-1)).squeeze(-1)
    return mu, Sigma


@_highest_precision
def moments_to_nat(mu: torch.Tensor, Sigma: torch.Tensor):
    """The inverse of :func:`nat_to_moments`: eta1 = Sigma^-1 mu,
    eta2 = -1/2 Sigma^-1, by the Cholesky factor of the symmetrized Sigma
    (NaN where it fails, as the reference's)."""
    Sigma_inv = chol_inv(cholesky_or_nan(symmetrize(Sigma)))
    return (Sigma_inv @ mu.unsqueeze(-1)).squeeze(-1), -0.5 * Sigma_inv


# the zero-first ladder is the default of nat_to_moments, so the reference's
# safe variant (agp_tpu/ops/linalg.py:307-316) is the same function
nat_to_moments_safe = nat_to_moments


def _warm_residual_ok(A: torch.Tensor, Sigma_prev: torch.Tensor, rho_max: float, batched: bool) -> bool:
    """The warm conversions' one branch predicate, read once on the host:
    the residual ||I - A Sigma_prev||_F (over the whole call, or its largest
    over the leading latent axis when ``batched``) is finite and below
    ``rho_max``.  A NaN residual takes the exact path."""
    R0 = _eye_like(A) - A @ Sigma_prev
    if batched:
        rho0 = torch.sqrt(torch.sum(R0 * R0, dim=(-2, -1))).max()
    else:
        rho0 = torch.sqrt(torch.sum(R0 * R0))
    return bool(host_read(~(rho0 >= rho_max) & torch.isfinite(rho0)))


def _schulz_inverse(A: torch.Tensor, X: torch.Tensor, iters: int) -> torch.Tensor:
    """``iters`` Newton-Schulz steps X <- X (2I - A X) toward A^-1 from X."""
    two_eye = 2.0 * _eye_like(A)
    for _ in range(iters):
        X = X @ (two_eye - A @ X)
    return symmetrize(X)


def _cholesky_inverse(A: torch.Tensor) -> torch.Tensor:
    """A^-1 by the zero-first ladder on A / 2, times 1/2."""
    L = psd_safe_cholesky(0.5 * A)
    return symmetrize(0.5 * chol_solve(L, _eye_like(A).expand(A.shape)))


@_highest_precision
def nat_to_moments_warm(
    eta1: torch.Tensor,
    eta2: torch.Tensor,
    Sigma_prev: torch.Tensor,
    schulz_iters: int = 4,
    rho_max: float = 0.35,
):
    """Matmul-only variant of :func:`nat_to_moments`: Newton-Schulz
    X <- X (2I - A X) on A = -2 eta2, warm-started at ``Sigma_prev``, or the
    exact Cholesky path when the warm start is far (residual
    ||I - A Sigma_prev||_F >= rho_max, or not finite).

    As the reference's ``lax.cond``, only the chosen branch runs: its
    predicate is read once on the host (``utils.tensors.host_read``), so
    this conversion is not for a step that must hold no host sync."""
    A = -2.0 * symmetrize(eta2)
    if _warm_residual_ok(A, Sigma_prev, rho_max, batched=False):
        Sigma = _schulz_inverse(A, Sigma_prev, schulz_iters)
    else:
        Sigma = _cholesky_inverse(A)
    return (Sigma @ eta1.unsqueeze(-1)).squeeze(-1), Sigma


@_highest_precision
def nat_to_moments_warm_batched(
    eta1: torch.Tensor,
    eta2: torch.Tensor,
    Sigma_prev: torch.Tensor,
    schulz_iters: int = 4,
    rho_max: float = 0.35,
    safe: bool = True,
):
    """[L, ...] :func:`nat_to_moments_warm` with ONE predicate shared over
    the latent axis (the worst latent's residual), as the reference's: one
    latent far from its warm start sends every latent down the exact path.
    ``safe`` takes the zero-first jitter ladder for the exact path, else a
    plain Cholesky (NaN where it fails)."""
    A = -2.0 * symmetrize(eta2)
    if _warm_residual_ok(A, Sigma_prev, rho_max, batched=True):
        Sigma = _schulz_inverse(A, Sigma_prev, schulz_iters)
    elif safe:
        Sigma = _cholesky_inverse(A)
    else:
        L = cholesky_or_nan(0.5 * A)
        Sigma = symmetrize(0.5 * chol_solve(L, _eye_like(A).expand(A.shape)))
    return (Sigma @ eta1.unsqueeze(-1)).squeeze(-1), Sigma
