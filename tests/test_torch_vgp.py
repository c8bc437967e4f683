"""The port's dense VGP against the JAX package's, float64: 10 full-batch
CAVI steps from identical states for each of the ten ported likelihoods
(the eight single-latent ones, logistic-softmax at K=3, heteroscedastic),
after every step; 10 iterations of ``train`` with the default Adam(0.01)
(Student-t noise with the Matern-5/2 kernel, the reference's robust
regression); the ELBO and the predictions of a trained VGP carried across;
the dense kernel matrices (no L_inv); and the dense ladder's lazy rungs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu.training.train as jtrain
import agp_tpu_torch as agt
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu_torch.ops import linalg
from agp_tpu_torch.training.train import vi_steps
from chip_smoke import single_latent_lik
from torch_helpers import (
    adam_close, close, close_tree, het_data, jax_single_latent, lik_params_close, locals_close, multiclass_data,
    port_likelihood, single_latent_data, state_arrays,
)

N, D, STEPS = 80, 2, 10
SINGLE = ("logistic", "gaussian", "studentt", "laplace", "matern32", "bayesiansvm", "poisson", "negbinomial")
LIKS = SINGLE + ("multiclass", "het")


def jax_case(name, n=N, seed=0):
    """(JAX likelihood, X, raw labels) of likelihood ``name``."""
    if name == "multiclass":
        X, y = multiclass_data(n, D, 3, seed=seed)
        return agp.LogisticSoftMaxLikelihood.create(3), X, y
    if name == "het":
        X, y = het_data(n, D, seed=seed)
        return agp.HeteroscedasticLikelihood.create(), X, y
    X, _, y = single_latent_data(name, n, D, seed=seed)
    return jax_single_latent(name), X, y


def jax_vgp(lik, X, y, kernel="SqExponentialKernel", **create):
    """A JAX VGP (float64, lengthscale 1) and its initial state."""
    m = agp.VGP.create(jnp.asarray(X), y, getattr(agp, kernel)(lengthscale=jnp.asarray(1.0), variance=jnp.asarray(1.0)),
                       lik, agp.AnalyticVI(), **{"optimiser": None, **create})
    return m, jax_init_state(m)


def port_vgp(mj, sj, y_raw, optimiser=None):
    """The port's copy of a JAX VGP and its state (``interop``)."""
    lik, params = port_likelihood(mj.likelihood)
    X = torch.as_tensor(np.array(mj.train_x))
    template = agt.VGP.create(X, y_raw, getattr(agt, type(mj.kernel).__name__)(), lik, agt.AnalyticVI(),
                              optimiser=optimiser)
    mt = model_from_numpy(dict(train_x=np.array(mj.train_x), train_y=np.array(mj.train_y),
                               lengthscale=np.array(mj.kernel.lengthscale), variance=np.array(mj.kernel.variance),
                               **params), template)
    return mt, state_from_numpy(state_arrays(sj), "cpu", torch.float64)


@pytest.mark.parametrize("name", LIKS)
def test_vgp_cavi_steps_match_jax(name):
    """eta, mu, Sigma, every local variable and the likelihood's parameters
    after each of 10 full-batch CAVI steps at rtol 1e-8 (atol 1e-12); the
    dense kmat holds L_K and K_inv and no L_inv, as the reference's."""
    lik, X, y = jax_case(name)
    mj, sj = jax_vgp(lik, X, y)
    mt, st = port_vgp(mj, sj, y)
    assert set(st.kmat) == set(sj.kmat) == {"L_K", "K_inv"}
    K_inv = np.array(sj.kmat["K_inv"])
    close(agt.init_state(mt).kmat["K_inv"], K_inv, rtol=0, atol=1e-10 * np.abs(K_inv).max(), msg="K_inv")
    step = jax.jit(jtrain._vi_step_body)
    for i in range(STEPS):
        mj, sj = step(mj, sj, mj.train_x, mj.train_y)
        mt, st = vi_steps(mt, st, mt.train_x, mt.train_y, 1)
        for field in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, field), getattr(sj, field), msg=f"step {i}: {field}")
        locals_close(st.local_vars, sj.local_vars, 1e-8, msg=f"step {i}: ")
        if name != "multiclass":
            lik_params_close(mt.likelihood, mj.likelihood)
        assert int(st.step) == int(sj.step) == i + 1


@pytest.fixture(scope="module")
def robust():
    """The reference's robust regression (VGP + Matern-5/2 + Student-t(4))
    with the default Adam(0.01), trained 10 iterations by both packages
    from the same model, each iteration recorded by a callback."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(N, D))
    y = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=N)
    y[::29] += 8.0
    mj = agp.VGP.create(jnp.asarray(X), y, agp.Matern52Kernel(), agp.StudentTLikelihood.create(4.0),
                        agp.AnalyticVI())
    mt = agt.VGP.create(torch.as_tensor(X), y, agt.Matern52Kernel(), agt.StudentTLikelihood.create(4.0),
                        agt.AnalyticVI())
    logs = [], []

    def cb(log):
        return lambda m, s, i: log.append((i, s.mu, s.hyper_state, m.kernel))

    mj, sj = agp.train(mj, iterations=STEPS, callback=cb(logs[0]))
    mt, st = agt.train(mt, iterations=STEPS, callback=cb(logs[1]))
    return mj, sj, mt, st, logs, X


def test_vgp_train_with_adam_matches_jax(robust):
    """After every iteration (the callback runs before that iteration's
    hyperparameter step): mu, the kernel and its Adam state at rtol 1e-7;
    at the end also Sigma and the refreshed K_inv."""
    mj, sj, mt, st, (log_j, log_t), _ = robust
    assert [r[0] for r in log_t] == [r[0] for r in log_j] == list(range(1, STEPS + 1))
    for (i, mu_j, h_j, k_j), (_, mu_t, h_t, k_t) in zip(log_j, log_t):
        close(mu_t, mu_j, rtol=1e-7, msg=f"iteration {i}: mu")
        close(k_t.lengthscale, k_j.lengthscale, rtol=1e-7, msg=f"iteration {i}: lengthscale")
        close(k_t.variance, k_j.variance, rtol=1e-7, msg=f"iteration {i}: variance")
        adam_close(h_t["kernel"], h_j["kernel"], 1e-7, msg=f"iteration {i}: ")
    close(st.Sigma, sj.Sigma, rtol=1e-7)
    close(st.kmat["K_inv"], sj.kmat["K_inv"], rtol=1e-7, atol=1e-10)
    assert abs(float(mt.kernel.lengthscale[0]) - 1.0) > 1e-3


def test_vgp_elbo_and_predictions_match_jax(robust):
    """On the JAX package's trained VGP carried across: the ELBO, predict_f
    (mean, diagonal variance, full covariance), predict_y and proba_y on 50
    held-out points at rtol 1e-8."""
    mj, sj, _, _, _, X = robust
    mt, st = port_vgp(mj, sj, np.array(mj.train_y), optimiser="default")
    np.testing.assert_allclose(float(agt.elbo(mt, st)), float(agp.elbo(mj, sj)), rtol=1e-8)
    Xh = np.random.default_rng(1).uniform(-2, 2, size=(50, D))
    Xj, Xt = jnp.asarray(Xh), torch.as_tensor(Xh)
    close(agt.predict_f(mt, st, Xt), agp.predict_f(mj, sj, Xj), msg="mean")
    for diag in (True, False):
        for a, b in zip(agt.predict_f(mt, st, Xt, cov=True, diag=diag), agp.predict_f(mj, sj, Xj, cov=True, diag=diag)):
            close(a, b, atol=1e-11, msg=f"diag={diag}")
    close(agt.predict_y(mt, st, Xt), agp.predict_y(mj, sj, Xj), msg="predict_y")
    close_tree(agt.proba_y(mt, st, Xt), agp.proba_y(mj, sj, Xj))


def test_vgp_refuses_stochastic_inference():
    """A VGP uses all its data every step, as the reference's refuses
    AnalyticSVI."""
    X = np.zeros((8, 2))
    with pytest.raises(ValueError, match="stochastic"):
        agt.VGP.create(torch.as_tensor(X), np.ones(8), agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                       agt.AnalyticSVI(4))


@pytest.mark.parametrize("fail", [False, True])
def test_lazy_rungs_equal_the_batch(fail):
    """The dense ladder (rung 0 alone, the batch only when it fails) gives
    the batched ladder's factor, on a matrix that factors at rung 0 and on
    one that needs a later rung; and its gradient is the chosen rung's
    (finite), as the batch's."""
    rng = np.random.default_rng(0)
    A = rng.normal(size=(30, 30))
    K = A @ A.T / 30 + (0.0 if fail else 1.0) * np.eye(30)
    if fail:
        w, V = np.linalg.eigh(K)
        K = (V * np.where(w < 0.05, -1e-5, w)) @ V.T
    assert int(torch.linalg.cholesky_ex(torch.as_tensor(K)).info) != 0 if fail else True
    for lazy in (False, True):
        Kt = torch.as_tensor(K).requires_grad_(True)
        L = linalg.psd_safe_cholesky(Kt, lazy_rungs=lazy)
        (g,) = torch.autograd.grad(L.sum(), Kt)
        if not lazy:
            L_batch, g_batch = L.detach(), g
    close(L, L_batch, rtol=1e-12, atol=1e-14)
    close(g, g_batch, rtol=1e-10, atol=1e-12)
    assert torch.isfinite(g).all()


def test_vgp_launches_no_kernel_on_the_cpu_path():
    """A single-latent VGP's step never reaches the sparse kernels' plain
    versions (the dense path has no kappa): the split pair's functions are
    never called."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    calls = []
    saved = {n: getattr(ck, n) for n in ("fused_kappa", "cavi_stats", "fused_cavi_stats")}
    try:
        for n, fn in saved.items():
            setattr(ck, n, lambda *a, _n=n, _fn=fn, **k: calls.append(_n) or _fn(*a, **k))
        lt = single_latent_lik(agt, "logistic")
        X, _, y = single_latent_data("logistic", 40, D)
        m = agt.VGP.create(torch.as_tensor(X), y, agt.SqExponentialKernel(), lt, agt.AnalyticVI())
        agt.train(m, iterations=4)
    finally:
        for n, fn in saved.items():
            setattr(ck, n, fn)
    assert calls == []
