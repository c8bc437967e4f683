"""The port's ops/linalg.py against agp_tpu.ops.linalg, float64.

Tolerance: rtol 1e-10 (atol 1e-12 for entries near zero).  Both sides run
the same algorithms in float64; they differ only in the order of LAPACK/BLAS
reductions, ~1e-15 relative for these well-conditioned M=16 matrices."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agp_tpu.ops import linalg as jl
from agp_tpu_torch.ops import linalg as tl

RTOL, ATOL = 1e-10, 1e-12
M = 16


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def spd(seed, m=M, shift=1.0):
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(m, m))
    return G @ G.T / m + shift * np.eye(m)


def t(a):
    return torch.as_tensor(a)


def test_safe_cholesky_plain():
    K = spd(0)
    close(tl.safe_cholesky(t(K)), jl.safe_cholesky(jnp.asarray(K)))


def test_safe_cholesky_ladder_rung_fires():
    """A rank-deficient gram pushed indefinite by -5e-4: the first rung
    (jitter 1e-4) fails and the second (1e-3) factorizes."""
    rng = np.random.default_rng(1)
    G = rng.normal(size=(M, 4))
    K = G @ G.T - 5e-4 * np.eye(M)
    assert int(torch.linalg.cholesky_ex(t(K) + 1e-4 * torch.eye(M, dtype=torch.float64))[1]) != 0
    port = tl.safe_cholesky(t(K))
    assert torch.isfinite(port).all()
    close(port, jl.safe_cholesky(jnp.asarray(K)))
    np.testing.assert_allclose((port @ port.T).numpy(), K + 1e-3 * np.eye(M), rtol=0, atol=1e-12)


def test_safe_cholesky_batched_rungs_per_matrix():
    """Each matrix of a batch climbs its own ladder."""
    rng = np.random.default_rng(2)
    G = rng.normal(size=(M, 4))
    Ks = np.stack([spd(3), G @ G.T - 5e-4 * np.eye(M)])
    port = tl.safe_cholesky(t(Ks))
    for k in range(2):
        close(port[k], jl.safe_cholesky(jnp.asarray(Ks[k])))


def test_psd_safe_cholesky_zero_rung_and_ladder():
    A = spd(4)
    close(tl.psd_safe_cholesky(t(A)), jl.psd_safe_cholesky(jnp.asarray(A)))
    rng = np.random.default_rng(5)
    G = rng.normal(size=(M, 3))
    A_bad = G @ G.T - 1e-6 * np.eye(M)  # the zero rung fails
    assert int(torch.linalg.cholesky_ex(t(A_bad))[1]) != 0
    close(tl.psd_safe_cholesky(t(A_bad)), jl.psd_safe_cholesky(jnp.asarray(A_bad)))


def test_solves_inverse_logdet_invquad():
    A = spd(6)
    rng = np.random.default_rng(7)
    Bm, v = rng.normal(size=(M, 3)), rng.normal(size=M)
    L_t, L_j = t(np.linalg.cholesky(A)), jnp.asarray(np.linalg.cholesky(A))
    close(tl.chol_solve(L_t, t(Bm)), jl.chol_solve(L_j, jnp.asarray(Bm)))
    close(tl.chol_solve(L_t, t(v)), jl.chol_solve(L_j, jnp.asarray(v)))
    close(tl.chol_inv(L_t), jl.chol_inv(L_j))
    close(tl.chol_logdet(L_t), jl.chol_logdet(L_j))
    close(tl.invquad(L_t, t(v)), jl.invquad(L_j, jnp.asarray(v)))
    close(tl.invquad(L_t, t(Bm)), jl.invquad(L_j, jnp.asarray(Bm)))


def test_symmetrize_diag_abt():
    rng = np.random.default_rng(8)
    A, B = rng.normal(size=(M, M)), rng.normal(size=(M, M))
    close(tl.symmetrize(t(A)), jl.symmetrize(jnp.asarray(A)))
    close(tl.diag_ABt(t(A), t(B)), jl.diag_ABt(jnp.asarray(A), jnp.asarray(B)))


def natural_params(seed):
    Sigma = spd(seed, shift=0.5)
    mu = np.random.default_rng(seed + 100).normal(size=M)
    P = np.linalg.inv(Sigma)
    return P @ mu, -0.5 * P, Sigma


def test_nat_to_moments():
    eta1, eta2, Sigma = natural_params(9)
    mu_t, S_t = tl.nat_to_moments(t(eta1), t(eta2))
    mu_j, S_j = jl.nat_to_moments(jnp.asarray(eta1), jnp.asarray(eta2))
    close(mu_t, mu_j)
    close(S_t, S_j)
    np.testing.assert_allclose(S_t.numpy(), Sigma, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("branch", ["schulz", "cholesky"])
def test_nat_to_moments_warm_both_branches(branch):
    """A warm start close to the answer takes the Newton-Schulz branch; one
    far from it (residual >= 0.35) takes the exact Cholesky branch."""
    eta1, eta2, Sigma = natural_params(10)
    rng = np.random.default_rng(11)
    E = rng.normal(size=(M, M))
    scale = 1e-3 if branch == "schulz" else 0.5
    prev = Sigma + scale * (E + E.T) / 2
    A = -2.0 * eta2
    rho0 = np.linalg.norm(np.eye(M) - A @ prev)
    assert (rho0 < 0.35) == (branch == "schulz")
    mu_t, S_t = tl.nat_to_moments_warm(t(eta1), t(eta2), t(prev))
    mu_j, S_j = jl.nat_to_moments_warm(jnp.asarray(eta1), jnp.asarray(eta2), jnp.asarray(prev))
    close(mu_t, mu_j)
    close(S_t, S_j)


def warm_inputs(n_latent, scales, seed=20):
    """[L, M] eta1, [L, M, M] eta2 and warm starts Sigma + scale sym(E) per
    latent (scale 1e-3: residual far below 0.35; 0.5: far above)."""
    rng = np.random.default_rng(seed)
    eta1, eta2, prev = [], [], []
    for l in range(n_latent):
        e1, e2, Sigma = natural_params(seed + l)
        E = rng.normal(size=(M, M))
        eta1.append(e1)
        eta2.append(e2)
        prev.append(Sigma + scales[l] * (E + E.T) / 2)
    return np.stack(eta1), np.stack(eta2), np.stack(prev)


def count_branches(monkeypatch):
    """Counts the calls of the warm conversions' two branches."""
    calls = {"schulz": 0, "cholesky": 0}
    schulz, chol = tl._schulz_inverse, tl._cholesky_inverse

    def counted_schulz(*a):
        calls["schulz"] += 1
        return schulz(*a)

    def counted_chol(*a):
        calls["cholesky"] += 1
        return chol(*a)

    monkeypatch.setattr(tl, "_schulz_inverse", counted_schulz)
    monkeypatch.setattr(tl, "_cholesky_inverse", counted_chol)
    return calls


@pytest.mark.parametrize("branch", ["schulz", "cholesky"])
def test_nat_to_moments_warm_runs_one_branch(branch, monkeypatch):
    """The unbatched warm conversion runs only the branch its predicate
    chooses (no Cholesky on the Schulz branch, no Schulz product on the
    Cholesky one), deciding by one counted host read."""
    from agp_tpu_torch.utils.tensors import host_read

    calls = count_branches(monkeypatch)
    eta1, eta2, prev = warm_inputs(1, [1e-3 if branch == "schulz" else 0.5])
    reads = host_read.reads
    tl.nat_to_moments_warm(t(eta1[0]), t(eta2[0]), t(prev[0]))
    assert host_read.reads - reads == 1
    assert calls == {"schulz": int(branch == "schulz"), "cholesky": int(branch == "cholesky")}


@pytest.mark.parametrize("scales,branch", [
    ((1e-3, 1e-3, 1e-3), "schulz"),
    ((1e-3, 0.5, 1e-3), "cholesky"),  # one latent far: every latent takes the exact path
    ((0.5, 0.5, 0.5), "cholesky"),
])
@pytest.mark.parametrize("safe", [True, False])
def test_nat_to_moments_warm_batched(scales, branch, safe, monkeypatch):
    """The batched warm conversion equals the reference's
    (``nat_to_moments_warm_batched``) on each branch, and its predicate,
    shared over the latent axis, sends every latent down one branch: one
    Schulz call or one ladder call (``safe``) for the whole stack."""
    calls = count_branches(monkeypatch)
    eta1, eta2, prev = warm_inputs(3, scales)
    mu_t, S_t = tl.nat_to_moments_warm_batched(t(eta1), t(eta2), t(prev), safe=safe)
    mu_j, S_j = jl.nat_to_moments_warm_batched(jnp.asarray(eta1), jnp.asarray(eta2), jnp.asarray(prev), safe=safe)
    close(mu_t, mu_j)
    close(S_t, S_j)
    assert calls["schulz"] == int(branch == "schulz")
    assert calls["cholesky"] == int(branch == "cholesky" and safe)


def test_nat_to_moments_safe_matches_reference():
    """nat_to_moments_safe (the port's nat_to_moments under the reference's
    name) against the reference's on a stack of latents."""
    eta1, eta2, _ = warm_inputs(2, (0.0, 0.0))
    mu_t, S_t = tl.nat_to_moments_safe(t(eta1), t(eta2))
    for l in range(2):
        mu_j, S_j = jl.nat_to_moments_safe(jnp.asarray(eta1[l]), jnp.asarray(eta2[l]))
        close(mu_t[l], mu_j)
        close(S_t[l], S_j)
