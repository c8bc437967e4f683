"""The port's generic augmented likelihood and its Laplace-transform sampler
(Slice F) against the JAX package, float64 at a small size: the
Gaver-Stehfest weights, the inversion and the tilted mean; draws fed the
reference's uniforms equal the reference's; the draws' moments; each
septuple likelihood's methods at rtol 1e-10; 10 CAVI steps of the Laplace
and logistic septuples at rtol 1e-8 on the reference's draws, the logistic
septuple against the port's built-in logistic at 1e-10; the Laplace
septuple's VGP against the built-in Laplace; quadrature through the AD
fallbacks; and Gibbs sampling of an MCGP through the sampler."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.distributions import lap_transf as jlt
from agp_tpu.inference import numerical_vi as jnv
from agp_tpu_torch.distributions import lap_transf as tlt
from agp_tpu_torch.inference import numerical_vi as tnv
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import (  # noqa: F401  (one_torch_thread: a fixture)
    check_steps, close, cls_data, jax_svgp, logistic_data, one_torch_thread, replay_steps, t64,
)

N, D, M, B, STEPS = 64, 2, 8, 16, 10


# the septuples: (ltype, C, g, alpha, beta, gamma, phi) as functions of a
# namespace ``xp`` (jnp or torch) and its clamp
def septuple(name, xp):
    clamp = (lambda r: jnp.maximum(r, 1e-12)) if xp is jnp else (lambda r: torch.clamp(r, min=1e-12))
    if name == "laplace":
        # p(y|f) = 1/2 exp(-|y - f|): Laplace(beta=1)
        return ("Regression", 0.5, lambda y: xp.zeros_like(y), lambda y: y**2, lambda y: 2.0 * y,
                lambda y: xp.ones_like(y), lambda r: xp.exp(-xp.sqrt(clamp(r))))
    # p(y|f) = sigma(y f) = 1/2 exp(y f / 2) sech(|f| / 2): omega = PG(1, 0) / 2
    return ("Classification", 0.5, lambda y: y / 2.0, lambda y: xp.zeros_like(y), lambda y: xp.zeros_like(y),
            lambda y: xp.ones_like(y), lambda r: 1.0 / xp.cosh(xp.sqrt(r) / 2.0))


def generic(name, pkg, xp):
    ltype, C, g, alpha, beta, gamma, phi = septuple(name, xp)
    return pkg.make_augmented_likelihood(f"Gen{name}", ltype, C=C, g=g, alpha=alpha, beta=beta, gamma=gamma,
                                         phi=phi).create()


def data(name, n=N, seed=0):
    """(X, labels): logistic data, or y = sin(x_0) + 0.5 x_1 + 0.1 Laplace
    noise."""
    if name == "logistic":
        return logistic_data(n, D, seed)
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D))
    return X, np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.laplace(size=n)


# ----------------------------------------------------------- the sampler
def sech_phi(xp):
    return septuple("logistic", xp)[-1]


def test_stehfest_weights_and_inversion():
    """The Stehfest weights equal the reference's (N = 10, 14); the grids
    agree to 4e-15 (pow's last bits differ); the inverted density of
    sech(sqrt(s)/2) as the sampler weighs it, the cell masses p dt, within
    2e-9 of their sum (the weights reach 1.7e8 at N=14 and cancel, so the
    inversion carries the two packages' rounding of phi ~1e7-fold); the
    tilted mean -phi'/phi at rtol 1e-12 and within 0.5 % of tanh(c/2)/(4c)."""
    for n in (10, 14):
        np.testing.assert_array_equal(tlt.stehfest_coeffs(n), jlt.stehfest_coeffs(n))
    dist_t, dist_j = tlt.LaplaceTransformDistribution(sech_phi(torch)), jlt.LaplaceTransformDistribution(sech_phi(jnp))
    t = dist_t.grid()
    close(t, dist_j.grid(), rtol=4e-15, atol=0)
    p_t, p_j = tlt.invert_laplace(dist_t.phi, t), jlt.invert_laplace(dist_j.phi, jnp.asarray(t.numpy()))
    dt = torch.gradient(t)[0]
    close(p_t * dt, np.array(p_j) * dt.numpy(), rtol=0, atol=2e-9 * float(torch.sum(p_t * dt)))
    c = np.linspace(0.2, 3.0, 8)
    m_t = dist_t.tilted_mean(t64(c**2))
    close(m_t, dist_j.tilted_mean(jnp.asarray(c**2)), rtol=1e-12)
    close(m_t, np.tanh(c / 2) / (4 * c), rtol=5e-3)


def test_sample_with_reference_uniforms_equals_reference():
    """Draws at 500 tilts s0 = c^2 (c in [0, 3]), float64 and float32 s0,
    fed the reference's own uniforms: the same grid cell as the
    reference's draw, every one (the draws equal to 4e-15, the grids' own
    rounding; neighbouring cells are 0.9 % apart), the draws cast to s0's
    dtype."""
    rng = np.random.default_rng(0)
    s0 = rng.uniform(0.0, 3.0, size=(20, 25)) ** 2
    key = jax.random.PRNGKey(5)
    dist_t, dist_j = tlt.LaplaceTransformDistribution(sech_phi(torch)), jlt.LaplaceTransformDistribution(sech_phi(jnp))
    d_j = np.array(dist_j.sample(key, jnp.asarray(s0)))
    u = t64(jax.random.uniform(key, (s0.size,), dtype=jnp.float64))
    d_t = dist_t.sample(None, t64(s0), u=u)
    assert d_t.shape == s0.shape and d_t.dtype == torch.float64
    cell_t = torch.searchsorted(dist_t.grid(), d_t.reshape(-1))
    cell_j = np.searchsorted(np.array(dist_j.grid()), d_j.reshape(-1))
    np.testing.assert_array_equal(cell_t.numpy(), cell_j)
    close(d_t, d_j, rtol=4e-15, atol=0)
    d32 = dist_t.sample(None, t64(s0).float(), u=u)
    assert d32.dtype == torch.float32
    close(d32, d_j.astype(np.float32), rtol=1e-7, atol=0)


def test_sample_moments():
    """8,192 draws from a generator at one tilt c = 0.5: their mean within
    6 standard errors of the grid's own tilted mean (sum t w on the same
    grid), and that within 1 % of tanh(c/2)/(4c) (PG(1, c)/2's mean)."""
    c, n = 0.5, 8192
    dist = tlt.LaplaceTransformDistribution(sech_phi(torch))
    d = dist.sample(torch.Generator().manual_seed(0), torch.full((n,), c * c, dtype=torch.float64))
    t = dist.grid()
    w = tlt.invert_laplace(dist.phi, t) * torch.gradient(t)[0] * torch.exp(-c * c * t)
    grid_mean = float(torch.sum(t * w) / torch.sum(w))
    se = float(d.std()) / np.sqrt(n)
    assert abs(float(d.mean()) - grid_mean) <= 6 * se, (float(d.mean()), grid_mean, se)
    assert abs(grid_mean / (np.tanh(c / 2) / (4 * c)) - 1) < 0.01


# ------------------------------------------------------- the likelihood
@pytest.mark.parametrize("name", ["laplace", "logistic"])
def test_generic_likelihood_methods_match_jax(name):
    """local_updates (c2, theta by the AD derivative of phi), grad_e_mu,
    grad_e_sigma, expec_loglik, aug_kl, log_prob, compute_proba,
    predict_y, treat_labels and the engine set against the reference's
    generic likelihood of the same septuple, rtol 1e-10."""
    rng = np.random.default_rng(1)
    _, y_raw = data(name, B)
    lj, lt = generic(name, agp, jnp), generic(name, agt, torch)
    assert type(lt).implemented() == type(lj).implemented() == {"AnalyticVI", "QuadratureVI", "GibbsSampling"}
    assert type(lt).__name__ == type(lj).__name__ == f"Gen{name}Likelihood"
    yj, _ = lj.treat_labels(y_raw)
    yt, _ = lt.treat_labels(y_raw)
    close(yt, yj, rtol=0, atol=0)
    yj, yt = jnp.asarray(yj, jnp.float64), yt.double()
    mu, var = rng.normal(size=(1, B)), rng.uniform(0.05, 0.5, size=(1, B))
    mj, vj, mt, vt = jnp.asarray(mu), jnp.asarray(var), t64(mu), t64(var)
    def methods(lik, y, m, v, local):
        """Every method's output, the reference's under one jit."""
        _, loc = lik.local_updates(y, m, v, local)
        proba = lik.compute_proba(m[0], v[0])
        return dict(c2=loc["c2"], theta=loc["theta"], grad_e_mu=lik.grad_e_mu(y, loc),
                    grad_e_sigma=lik.grad_e_sigma(y, loc), expec_loglik=lik.expec_loglik(y, m, v, loc),
                    aug_kl=lik.aug_kl(loc, y), log_prob=lik.log_prob(y, m[0]),
                    compute_proba=proba if isinstance(proba, tuple) else (proba,), predict_y=lik.predict_y(m[0]))

    out_j = jax.jit(lambda *a: methods(lj, *a, lj.init_local_vars(B, jnp.float64)))(yj, mj, vj)
    out_t = methods(lt, yt, mt, vt, lt.init_local_vars(B, torch.float64))
    kw = dict(rtol=1e-10, atol=1e-12)
    for k, ref in out_j.items():
        for a, b in zip(out_t[k], ref) if k == "compute_proba" else ((out_t[k], ref),):
            close(a, b, msg=k, **kw)
    if name == "logistic":
        # the quadrature engine's expectations through the AD fallbacks.
        # (The Laplace septuple's second derivative of -sqrt(y^2 - 2 y f +
        # f^2) is 0 up to a cancellation of order eps y^2 / r^(3/2), which
        # each package rounds its own way: nothing to compare there.)
        ej = jax.jit(lambda *a: jnv.quad_grads(lj, *a, 20, 0.0))(yj, mj, vj)
        for a, b in zip(tnv.quad_grads(lt, yt, mt, vt, 20, 0.0), ej):
            close(a, b, msg="quad_grads", **kw)


@pytest.mark.parametrize("name", ["laplace", "logistic"])
def test_generic_cavi_steps_match_jax(name):
    """10 slice-sampled AnalyticSVI steps (M=8, B=16) of an SVGP with the
    septuple likelihood from identical states on the reference's draws:
    eta, mu, Sigma and the local variables after every step at rtol 1e-8;
    the sparse step takes the split pair (kernels 6 and 7's plain
    versions here)."""
    X, y = data(name)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B, sampling="slice", lengthscale=1.0, likelihood=generic(name, agp, jnp))
    check_steps(replay_steps(mj, sj, Xj, yj, STEPS, likelihood=generic(name, agt, torch)))


def test_generic_logistic_matches_builtin():
    """The logistic septuple's E-step is the built-in logistic's exactly
    (theta gamma = tanh(c/2)/(4c), g + theta beta = y/2): 10 AnalyticSVI
    steps of each on the same draws (the built-in through the fused pass's
    plain version, the septuple through the split pair) agree at rtol
    1e-10 in mu and Sigma."""
    X, y = data("logistic")
    Xt = t64(X)
    draws = torch.randint(0, N - B + 1, (STEPS,), generator=torch.Generator().manual_seed(0))
    out = []
    for lik in (generic("logistic", agt, torch), agt.LogisticLikelihood.create()):
        model = agt.SVGP.create(agt.SqExponentialKernel(), lik, agt.AnalyticSVI(B, minibatch_sampling="slice"),
                                Xt[:M], optimiser=None)
        yt, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        _, state = vi_steps(model, agt.init_state(model, Xt, yt), Xt, yt.double(), STEPS, draws=draws)
        out.append(state)
    close(out[0].mu, out[1].mu, rtol=1e-10, atol=1e-12)
    close(out[0].Sigma, out[1].Sigma, rtol=1e-10, atol=1e-12)


def test_generic_laplace_vgp_matches_builtin():
    """The reference's check (tests/test_engines.py): a VGP with the Laplace
    septuple and one with LaplaceLikelihood(1), 30 full-batch iterations on
    30 points: mu within 2e-2; and the septuple through the port's train
    with QuadratureVI, finite."""
    X, y = data("laplace", 30, seed=3)
    Xt = t64(X)
    mus = []
    for lik in (generic("laplace", agt, torch), agt.LaplaceLikelihood.create(1.0)):
        m = agt.VGP.create(Xt, y, agt.SqExponentialKernel(), lik, agt.AnalyticVI(), optimiser=None)
        mus.append(agt.train(m, iterations=30)[1].mu)
    assert float((mus[0] - mus[1]).abs().max()) < 2e-2
    m = agt.VGP.create(Xt, y, agt.SqExponentialKernel(), generic("laplace", agt, torch),
                       agt.QuadratureVI(n_points=20, optimiser=agt.sgd(1e-3, 0.9)))
    _, s = agt.train(m, iterations=5)
    assert torch.isfinite(s.mu).all() and torch.isfinite(s.Sigma).all()


def test_generic_gibbs_through_mcgp(one_torch_thread):
    """An MCGP with the logistic septuple sampled by Gibbs (the auxiliary
    from the Laplace-transform sampler) on the N=40 logistic data: finite
    samples, the local c2 the tilt f^2, and the posterior mean's
    correlation with the built-in logistic's Gibbs mean above 0.98."""
    X, _, y = cls_data()
    means = []
    for lik in (generic("logistic", agt, torch), agt.LogisticLikelihood.create()):
        mc = agt.MCGP.create(t64(X), y, agt.SqExponentialKernel(), lik, agt.GibbsSampling(n_burnin=50))
        s = agt.sample(mc, 300, generator=torch.Generator().manual_seed(1))
        assert s.shape == (300, 1, 40) and torch.isfinite(s).all()
        means.append(s.mean(0)[0])
    assert np.corrcoef(means[0].numpy(), means[1].numpy())[0, 1] > 0.98
    lik = generic("logistic", agt, torch)
    f = torch.randn(3, 40, dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    local = lik._sample_local(torch.Generator().manual_seed(3), t64(y), f, lik.init_local_vars(40, torch.float64))
    close(local["c2"], f**2, rtol=0, atol=0)
    assert local["theta"].shape == (3, 40) and bool((local["theta"] > 0).all())
