"""The port's Student-t process (VStP) against the JAX package's, float64,
the same inputs made with numpy and carried across by ``interop``:
``local_prior_updates`` from a mid-training state at 1e-10, 10 CAVI steps
(Student-t(4) and logistic likelihoods) at 1e-8, the ELBO and its
hyperparameter gradients against ``jax.grad`` at 1e-8, 10 iterations of
``train`` with the default Adam at 1e-7, the predictions (which ignore chi)
at 1e-10; the reference's own checks; the refusals and ``interop``'s two
degrees of freedom."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu.training.train as jtrain
import agp_tpu_torch as agt
from agp_tpu.models.vstp import local_prior_updates as jax_prior_updates
from agp_tpu_torch.models.vstp import local_prior_updates
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import (
    adam_close, close, grand_tour_data, jax_vstp, locals_close, one_torch_thread, port_vstp, reg_data, t64,
)

N, STEPS = 40, 10
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def robust_data(n=N, seed=0):
    """tpu_acceptance.py's vstp_student_t_robust_rmse rule made with numpy:
    X uniform on [-2, 2]^2, f = sin(2 x_0) + 0.5 x_1, y = f + 0.05 eps with
    +8 on every 29th point."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    y = f + 0.05 * rng.normal(size=n)
    y[::29] += 8.0
    return X, f, y


def case(name):
    X, f, y = robust_data()
    if name == "logistic":
        return agp.LogisticLikelihood.create(), X, np.sign(f)
    return agp.StudentTLikelihood.create(4.0), X, y


@pytest.mark.parametrize("name", ["studentt", "logistic"])
def test_vstp_cavi_steps_match_jax(name):
    """eta, mu, Sigma, chi and l2, every local variable after each of 10
    full-batch CAVI steps at rtol 1e-8 (atol 1e-12); chi moves off 1."""
    lik, X, y = case(name)
    mj, sj = jax_vstp(X, y, lik)
    mt, st = port_vstp(mj, sj, y)
    assert set(st.prior_state) == {"l2", "chi"}
    step = jax.jit(jtrain._vi_step_body)
    for i in range(STEPS):
        mj, sj = step(mj, sj, mj.train_x, mj.train_y)
        mt, st = vi_steps(mt, st, mt.train_x, mt.train_y, 1)
        for field in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, field), getattr(sj, field), msg=f"step {i}: {field}")
        for key in ("l2", "chi"):
            close(st.prior_state[key], sj.prior_state[key], msg=f"step {i}: {key}")
        locals_close(st.local_vars, sj.local_vars, 1e-8, msg=f"step {i}: ")
    assert abs(float(st.prior_state["chi"][0]) - 1.0) > 1e-3


@pytest.fixture(scope="module")
def robust():
    """The robust VStP (Student-t(4), nu 5) with the default Adam(0.01),
    trained 10 iterations by both packages from the same model, each
    iteration recorded by a callback."""
    X, f, y = robust_data()
    mj = agp.VStP.create(jnp.asarray(X), y, agp.SqExponentialKernel(), agp.StudentTLikelihood.create(4.0),
                         agp.AnalyticVI(), nu=5.0)
    mt = agt.VStP.create(t64(X), y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                         nu=5.0)
    logs = [], []

    def cb(log):
        return lambda m, s, i: log.append((i, s.mu, s.prior_state["chi"], s.hyper_state, m.kernel))

    mj, sj = agp.train(mj, iterations=STEPS, callback=cb(logs[0]))
    mt, st = agt.train(mt, iterations=STEPS, callback=cb(logs[1]))
    return mj, sj, mt, st, logs, X, y


def test_vstp_train_with_adam_matches_jax(robust):
    """After every iteration (before its hyperparameter step): mu, chi, the
    kernel and its Adam state at rtol 1e-7; at the end Sigma and K^-1."""
    mj, sj, mt, st, (log_j, log_t), _, _ = robust
    assert [r[0] for r in log_t] == [r[0] for r in log_j] == list(range(1, STEPS + 1))
    for (i, mu_j, chi_j, h_j, k_j), (_, mu_t, chi_t, h_t, k_t) in zip(log_j, log_t):
        close(mu_t, mu_j, rtol=1e-7, msg=f"iteration {i}: mu")
        close(chi_t, chi_j, rtol=1e-7, msg=f"iteration {i}: chi")
        close(k_t.lengthscale, k_j.lengthscale, rtol=1e-7, msg=f"iteration {i}: lengthscale")
        close(k_t.variance, k_j.variance, rtol=1e-7, msg=f"iteration {i}: variance")
        adam_close(h_t["kernel"], h_j["kernel"], 1e-7, msg=f"iteration {i}: ")
    close(st.Sigma, sj.Sigma, rtol=1e-7)
    close(st.kmat["K_inv"], sj.kmat["K_inv"], rtol=1e-7, atol=1e-10)
    assert abs(float(mt.kernel.lengthscale[0]) - 1.0) > 1e-3


def test_local_prior_updates_match_jax(robust):
    """From the JAX package's trained state carried across:
    local_prior_updates at rtol 1e-10, with a constant prior mean too."""
    mj, sj, _, _, _, X, y = robust
    for c in (None, 0.4):
        if c is not None:
            mj = mj.replace(mean=agp.ConstantMean(c=jnp.full((1,), c)))
        mt, st = port_vstp(mj, sj, y)
        if c is not None:
            mt = mt.replace(mean=agt.ConstantMean(c=torch.full((1,), c, dtype=torch.float64)))
        out_j = jax_prior_updates(mj, sj, jnp.asarray(X))
        out_t = local_prior_updates(mt, st, t64(X))
        for key in ("l2", "chi"):
            close(out_t.prior_state[key], out_j.prior_state[key], rtol=1e-10, msg=key)


def test_vstp_elbo_gradients_and_predictions_match_jax(robust):
    """On the trained VStP carried across: the ELBO (its KL with L_K /
    sqrt(chi)) at rtol 1e-10, the hyperparameter gradients against
    jax.grad of the reference's neg_elbo at 1e-8, and predict_f (mean,
    variance, full covariance), predict_y and proba_y on 30 held-out points
    at 1e-10 (atol 1e-10): the predictions ignore chi, as the reference's
    do."""
    from agp_tpu.inference.analytic_vi import compute_kmat
    from agp_tpu.inference.objective import objective
    from agp_tpu.kernels import from_unconstrained, to_unconstrained
    from agp_tpu_torch.training.autotuning import hyper_gradients

    mj, sj, _, _, _, X, y = robust
    mt, st = port_vstp(mj, sj, y, optimiser="default")
    np.testing.assert_allclose(float(agt.elbo(mt, st)), float(agp.elbo(mj, sj)), rtol=1e-10)

    def neg(log_k):
        m2 = mj.replace(kernel=from_unconstrained(log_k))
        return -objective(m2, sj, mj.train_x, mj.train_y, kmat=compute_kmat(m2, mj.train_x))

    g = jax.jit(jax.grad(neg))(to_unconstrained(mj.kernel))
    _, g_k, _, _ = hyper_gradients(mt, st, mt.train_x, mt.train_y)
    close(g_k["lengthscale"], g.lengthscale, rtol=1e-8)
    close(g_k["variance"], g.variance, rtol=1e-8)
    Xh = np.random.default_rng(1).uniform(-2, 2, size=(30, 2))
    Xj, Xt = jnp.asarray(Xh), t64(Xh)
    kw = dict(rtol=1e-10, atol=1e-10)  # the variance k** - k*^T A k* cancels to ~3e-11
    close(agt.predict_f(mt, st, Xt), agp.predict_f(mj, sj, Xj), **kw)
    for diag in (True, False):
        for a, b in zip(agt.predict_f(mt, st, Xt, cov=True, diag=diag), agp.predict_f(mj, sj, Xj, cov=True, diag=diag)):
            close(a, b, **kw)
    close(agt.predict_y(mt, st, Xt), agp.predict_y(mj, sj, Xj), **kw)
    for a, b in zip(agt.proba_y(mt, st, Xt), agp.proba_y(mj, sj, Xj)):
        close(a, b, **kw)


def test_vstp_reference_checks():
    """tests/test_engines.py:105-115 (20 iterations on reg_data: chi > 0,
    mean |mu - f| < 1) and :188-204 (chi = 1 within 5e-3 at the prior:
    mu = mu0, Sigma = K) through the port."""
    X, f, y = reg_data()
    X = t64(X)
    model = agt.VStP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                            nu=5.0, optimiser=None)
    trained, state = agt.train(model, iterations=20)
    assert float(state.prior_state["chi"][0]) > 0
    assert float(torch.mean(torch.abs(agt.predict_f(trained, state, X) - t64(f)))) < 1.0
    state = agt.init_state(model)
    L_K = state.kmat["L_K"]
    state = state.replace(mu=torch.zeros_like(state.mu), Sigma=L_K @ L_K.mT)
    chi = local_prior_updates(model, state, X).prior_state["chi"]
    np.testing.assert_allclose(chi.numpy(), 1.0, atol=5e-3)


def test_grand_tour_vstp_section():
    """examples/grand_tour.py's section 4 through the port's public API: a
    VStP (Student-t(4), nu 4), 20 iterations, a finite ELBO."""
    X, _, yr = grand_tour_data()
    vt = agt.VStP.create(t64(X), yr, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                         nu=4.0, optimiser=None)
    vt, vts = agt.train(vt, iterations=20)
    assert np.isfinite(float(agt.elbo(vt, vts)))


def test_vstp_refusals():
    """nu <= 1 raises ValueError, as the reference does; so does stochastic
    inference (the reference's create takes it and its first step fails
    on the shapes, a TypeError)."""
    X, _, y = robust_data(12)
    for nu in (1.0, 0.5):
        with pytest.raises(ValueError, match="nu"):
            agt.VStP.create(t64(X), y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                            agt.AnalyticVI(), nu=nu)
    with pytest.raises(ValueError, match="stochastic"):
        agt.VStP.create(t64(X), y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticSVI(4),
                        nu=5.0)


def test_interop_keeps_the_two_degrees_of_freedom():
    """A VStP with a Student-t likelihood has two nu: the prior's crosses as
    "prior_nu", the likelihood's as "nu"; set to different values, each
    lands in its own field and the steps still match the reference's."""
    X, _, y = robust_data()
    mj, sj = jax_vstp(X, y, agp.StudentTLikelihood.create(3.0), nu=7.0)
    mt, st = port_vstp(mj, sj, y)
    assert float(mt.nu) == 7.0 and float(mt.likelihood.nu) == 3.0
    step = jax.jit(jtrain._vi_step_body)
    for _ in range(3):
        mj, sj = step(mj, sj, mj.train_x, mj.train_y)
        mt, st = vi_steps(mt, st, mt.train_x, mt.train_y, 1)
    close(st.prior_state["chi"], sj.prior_state["chi"])
    close(st.mu, sj.mu)
