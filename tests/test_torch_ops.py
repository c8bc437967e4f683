"""The port's special functions, quadrature, KL terms, logistic likelihood
and Robbins-Monro rule against the JAX package, float64."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import agp_tpu as agp
from agp_tpu.ops import kl as jkl
from agp_tpu.ops import quadrature as jq
from agp_tpu.ops import special as js
from agp_tpu.utils.opt import robbins_monro as jax_robbins_monro
from agp_tpu_torch.likelihoods.classification import LogisticLikelihood, _treat_binary
from agp_tpu_torch.ops import kl as tkl
from agp_tpu_torch.ops import quadrature as tq
from agp_tpu_torch.ops import special as ts
from agp_tpu_torch.utils.opt import ascent_update, robbins_monro

# same formulas in float64: only rounding order differs
RTOL, ATOL = 1e-12, 1e-14


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol)


def test_special_functions():
    rng = np.random.default_rng(0)
    c = rng.normal(size=50) * 30
    mu, var = rng.normal(size=50), rng.uniform(0.1, 2.0, size=50)
    close(ts.logcosh(torch.as_tensor(c)), js.logcosh(jnp.asarray(c)))
    close(ts.safe_expcosh(torch.as_tensor(mu), torch.as_tensor(c)), js.safe_expcosh(jnp.asarray(mu), jnp.asarray(c)))
    close(ts.sqrt_expec_square(torch.as_tensor(mu), torch.as_tensor(var)),
          js.sqrt_expec_square(jnp.asarray(mu), jnp.asarray(var)))


def test_digamma_gammaln_xlogx():
    """The re-exports of the special-function library and xlogx (0 log 0 = 0)."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(1.0, 40.0, size=40), [1.0, 2.5, 1e3]])
    close(ts.digamma(torch.as_tensor(x)), js.digamma(jnp.asarray(x)))
    close(ts.gammaln(torch.as_tensor(x)), js.gammaln(jnp.asarray(x)))
    z = np.concatenate([[0.0], x])
    close(ts.xlogx(torch.as_tensor(z)), js.xlogx(jnp.asarray(z)))


def test_quadrature_expectation():
    rng = np.random.default_rng(1)
    mu, var = rng.normal(size=30), rng.uniform(0.0, 3.0, size=30)
    port = tq.expectation(torch.sigmoid, torch.as_tensor(mu), torch.as_tensor(var))
    close(port, jq.expectation(jax.nn.sigmoid, jnp.asarray(mu), jnp.asarray(var)))


def test_kl_terms():
    rng = np.random.default_rng(2)
    M = 10
    G = rng.normal(size=(M, M))
    K = G @ G.T / M + np.eye(M)
    S = np.linalg.inv(K + np.diag(rng.uniform(0.5, 2.0, M)))
    mu, mu0 = rng.normal(size=M), rng.normal(size=M) * 0.1
    L = np.linalg.cholesky(K)
    port = tkl.gaussian_kl(*(torch.as_tensor(a) for a in (mu, mu0, S, L)))
    # a sum of O(10) terms: absolute agreement to 1e-12
    close(port, jkl.gaussian_kl(*(jnp.asarray(a) for a in (mu, mu0, S, L))), atol=1e-12)
    b, c, th = np.ones(40), rng.uniform(0.1, 3.0, 40), rng.uniform(0.05, 0.25, 40)
    close(tkl.polya_gamma_kl(*(torch.as_tensor(a) for a in (b, c, th))),
          jkl.polya_gamma_kl(*(jnp.asarray(a) for a in (b, c, th))))


def test_poisson_and_gamma_kl_terms():
    """The two extra terms of the logistic-softmax ELBO: sums of O(100)
    terms, absolute agreement to 1e-11."""
    rng = np.random.default_rng(6)
    lam = np.concatenate([[0.0], rng.uniform(0.01, 3.0, size=(39,))]).reshape(4, 10)
    lam0, psi = rng.uniform(0.5, 2.0, size=(1, 10)), rng.normal(size=(1, 10))
    close(tkl.poisson_kl_expected(*(torch.as_tensor(a) for a in (lam, lam0, psi))),
          jkl.poisson_kl_expected(*(jnp.asarray(a) for a in (lam, lam0, psi))), atol=1e-11)
    alpha, beta = rng.uniform(1.0, 8.0, size=30), rng.uniform(1.0, 8.0, size=30)
    close(tkl.gamma_entropy_improper(torch.as_tensor(alpha), torch.as_tensor(beta)),
          jkl.gamma_entropy_improper(jnp.asarray(alpha), jnp.asarray(beta)), atol=1e-11)


def test_slice_c_special_functions():
    """log_besselk_half (the Bayesian SVM's ELBO and gig_entropy) at the
    half-integer orders 1/2 ... 7/2 (closed-form polynomials: rtol 1e-12)."""
    x = np.random.default_rng(7).uniform(0.05, 30.0, size=50)
    for n_half in range(4):
        close(ts.log_besselk_half(n_half, torch.as_tensor(x)), js.log_besselk_half(n_half, jnp.asarray(x)))


def test_quadrature_mean_and_var():
    rng = np.random.default_rng(8)
    mu, var = rng.normal(size=30), rng.uniform(0.0, 3.0, size=30)
    port = tq.mean_and_var(lambda f: 3.0 * torch.sigmoid(f), torch.as_tensor(mu), torch.as_tensor(var))
    ref = jq.mean_and_var(lambda f: 3.0 * jax.nn.sigmoid(f), jnp.asarray(mu), jnp.asarray(var))
    for p, r in zip(port, ref):
        close(p, r)


def test_slice_c_kl_terms():
    """gamma_kl (= inverse_gamma_kl), poisson_kl and gig_entropy at
    p = 1/2 and 3/2: sums of O(40) terms, absolute agreement to 1e-11."""
    rng = np.random.default_rng(9)
    a, b = rng.uniform(0.5, 6.0, size=40), rng.uniform(0.5, 6.0, size=40)
    ap, bp = rng.uniform(0.5, 6.0, size=40), rng.uniform(0.5, 6.0, size=40)
    T, J = (lambda *v: [torch.as_tensor(u) for u in v]), (lambda *v: [jnp.asarray(u) for u in v])
    close(tkl.gamma_kl(*T(a, b, ap, bp)), jkl.gamma_kl(*J(a, b, ap, bp)), atol=1e-11)
    close(tkl.inverse_gamma_kl(*T(a, b, ap, bp)), jkl.inverse_gamma_kl(*J(a, b, ap, bp)), atol=1e-11)
    lam = np.concatenate([[0.0], rng.uniform(0.01, 5.0, size=39)])
    close(tkl.poisson_kl(*T(lam, np.array(2.5))), jkl.poisson_kl(*J(lam, np.array(2.5))), atol=1e-11)
    for p in (0.5, 1.5):
        close(tkl.gig_entropy(*T(a, b), p), jkl.gig_entropy(*J(a, b), p), atol=1e-11)


def test_logistic_likelihood_contract():
    rng = np.random.default_rng(3)
    B = 64
    y = np.where(rng.normal(size=B) > 0, 1.0, -1.0)
    mu, var = rng.normal(size=(1, B)), rng.uniform(0.1, 2.0, size=(1, B))
    lj, lt = agp.LogisticLikelihood.create(), LogisticLikelihood.create()
    loc_j = lj.init_local_vars(B, jnp.float64)
    loc_t = lt.init_local_vars(B, torch.float64)
    close(loc_t["theta"], loc_j["theta"])
    _, loc_j = lj.local_updates(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), loc_j)
    _, loc_t = lt.local_updates(torch.as_tensor(y), torch.as_tensor(mu), torch.as_tensor(var), loc_t)
    for k in ("c", "theta"):
        close(loc_t[k], loc_j[k])
    close(lt.grad_e_mu(torch.as_tensor(y), loc_t), lj.grad_e_mu(jnp.asarray(y), loc_j))
    close(lt.grad_e_sigma(torch.as_tensor(y), loc_t), lj.grad_e_sigma(jnp.asarray(y), loc_j))
    close(lt.expec_loglik(torch.as_tensor(y), torch.as_tensor(mu), torch.as_tensor(var), loc_t),
          lj.expec_loglik(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), loc_j), atol=1e-11)
    close(lt.aug_kl(loc_t, torch.as_tensor(y)), lj.aug_kl(loc_j, jnp.asarray(y)), atol=1e-11)
    close(lt.compute_proba(torch.as_tensor(mu[0]), torch.as_tensor(var[0])),
          lj.compute_proba(jnp.asarray(mu[0]), jnp.asarray(var[0])))
    np.testing.assert_array_equal(_treat_binary(np.array([0, 1, 1])).numpy(), [-1.0, 1.0, 1.0])
    np.testing.assert_array_equal(
        _treat_binary(np.array([0, 1, 1])).numpy(), np.asarray(lj.treat_labels(np.array([0, 1, 1]))[0])
    )


def test_robbins_monro_matches_reference():
    """The scale is float32 on both sides.  XLA's and PyTorch's float32 pow
    differ by at most 2 ulp (rtol 3e-7); the step counter is exact."""
    opt_t, opt_j = robbins_monro(), jax_robbins_monro()
    params = (torch.zeros(3, dtype=torch.float64), torch.zeros((3, 3), dtype=torch.float64))
    grads = (torch.ones(3, dtype=torch.float64), torch.full((3, 3), 2.0, dtype=torch.float64))
    st = opt_t.init(params)
    sj = opt_j.init(tuple(jnp.asarray(p.numpy()) for p in params))
    for _ in range(60):
        st, (u1, u2) = ascent_update(opt_t, st, params, grads)
        upd, sj = opt_j.update(tuple(-jnp.asarray(g.numpy()) for g in grads), sj)
        close(u1, upd[0], rtol=3e-7, atol=0)
        close(u2, upd[1], rtol=3e-7, atol=0)
        assert int(st) == int(sj)
    assert u1.dtype == torch.float64
