"""The port's exact GP against the JAX package's, float64: 10 iterations of
``train`` with the noise learnt (Adam(0.05) on log sigma^2) and the
default Adam(0.01) on the kernel and the mean, after every iteration;
then, on the JAX package's trained model and state carried across,
log p(y), the diagonal and full-covariance ``predict_f``, ``predict_y``
and ``proba_y``; a failed factorization's NaN.  And an SVGP whose
Gaussian likelihood learns its noise: 10 steps of the split pair (the
fused pass refuses a learnt noise, as the reference's does), and 10 steps
on a row-weighted batch."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu.inference import analytic_vi as jav
from agp_tpu_torch.inference import analytic_vi as tav
from torch_helpers import (
    adam_close, check_steps, close, jax_rm_scales, jax_svgp, lik_params_close, locals_close, port_from_jax,
    replay_rule, replay_steps, state_arrays,
)

N, D, ITERS = 120, 2, 10


def toy(n=N, seed=0):
    """benchmarks/tpu_acceptance.py's regression toy: X ~ U[-2, 2]^2,
    f = sin(2 x_0) + 0.5 x_1, y = f + 0.1 eps."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, D))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    return X, f, f + 0.1 * rng.normal(size=n)


def means(kind):
    if kind == "zero":
        return None, None
    return agp.ConstantMean(c=jnp.asarray(0.3)), agt.ConstantMean(c=torch.tensor(0.3, dtype=torch.float64))


def record(log):
    """A callback keeping what each iteration leaves, as numpy."""

    def cb(model, state, i):
        k = model.kernel
        log.append(dict(i=i, alpha=np.array(state.alpha), sigma2=np.array(model.likelihood.sigma2),
                        lengthscale=np.array(k.lengthscale), variance=np.array(k.variance),
                        noise=state.local_vars["state_sigma2"], hyper=state.hyper_state,
                        c=None if getattr(model.mean, "c", None) is None else np.array(model.mean.c)))

    return cb


def port_leaves(log):
    """torch leaves of a port record, as the JAX record holds them."""
    return [{k: (v.numpy().copy() if isinstance(v, torch.Tensor) else v) for k, v in r.items()} for r in log]


@pytest.mark.parametrize("mean", ["zero", "constant"])
def test_gp_train_matches_jax(mean):
    """10 iterations (7 hyperparameter steps, 11 analytic refreshes) equal
    to the JAX package's after every iteration at rtol 1e-7: alpha, sigma^2
    and its Adam state, the kernel, the mean and their Adam states; at the
    end also chol_Sigma."""
    X, _, y = toy()
    mj, mt = means(mean)
    gj = agp.GP.create(jnp.asarray(X), jnp.asarray(y), agp.SqExponentialKernel(), mean=mj)
    gt = agt.GP.create(torch.as_tensor(X), torch.as_tensor(y), agt.SqExponentialKernel(), mean=mt)
    log_j, log_t = [], []
    gj, sj = agp.train(gj, iterations=ITERS, callback=record(log_j))
    gt, st = agt.train(gt, iterations=ITERS, callback=record(log_t))
    assert [r["i"] for r in log_t] == [r["i"] for r in log_j] == list(range(1, ITERS + 1))
    for rj, rt in zip(log_j, port_leaves(log_t)):
        msg = f"iteration {rj['i']}: "
        for key in ("alpha", "sigma2", "lengthscale", "variance", "c"):
            if rj[key] is not None:
                close(rt[key], rj[key], rtol=1e-7, msg=msg + key)
        adam_close(rt["noise"], rj["noise"], 1e-7, msg=msg + "noise ")
        for group in ("kernel", "mean"):
            adam_close(rt["hyper"][group], rj["hyper"][group], 1e-7, msg=f"{msg}{group} ")
    close(st.alpha, sj.alpha, rtol=1e-7)
    close(st.chol_Sigma, sj.chol_Sigma, rtol=1e-7, atol=1e-12)
    close(gt.likelihood.sigma2, gj.likelihood.sigma2, rtol=1e-7)
    assert int(st.local_vars["state_sigma2"]["count"]) == ITERS + 1
    # the noise moved toward the data's 0.01 and log p(y) rose
    assert float(gt.likelihood.sigma2) < 0.1


def carried(gj, sj):
    """The port's copy of a JAX GP and its state (``interop``)."""
    template = agt.GP.create(torch.zeros((2, D), dtype=torch.float64), torch.zeros(2, dtype=torch.float64),
                             agt.SqExponentialKernel())
    params = dict(train_x=np.array(gj.train_x), train_y=np.array(gj.train_y),
                  lengthscale=np.array(gj.kernel.lengthscale), variance=np.array(gj.kernel.variance),
                  sigma2=np.array(gj.likelihood.sigma2))
    return model_from_numpy(params, template), state_from_numpy(state_arrays(sj), "cpu", torch.float64)


@pytest.fixture(scope="module")
def trained():
    X, f, y = toy()
    gj = agp.GP.create(jnp.asarray(X), jnp.asarray(y), agp.SqExponentialKernel())
    gj, sj = agp.train(gj, iterations=ITERS)
    gt, st = carried(gj, sj)
    Xh = np.random.default_rng(1).uniform(-2, 2, size=(60, D))
    return gj, sj, gt, st, Xh


def test_gp_carried_state_and_log_py(trained):
    """The carried model and state hold the JAX package's leaves exactly,
    and log p(y) (``elbo`` of a GP) equals the reference's at rtol 1e-8."""
    gj, sj, gt, st, _ = trained
    close(gt.train_x, gj.train_x, rtol=0, atol=0)
    close(st.chol_Sigma, sj.chol_Sigma, rtol=0, atol=0)
    adam_close(st.local_vars["state_sigma2"], sj.local_vars["state_sigma2"], 0)
    np.testing.assert_allclose(float(agt.elbo(gt, st)), float(agp.elbo(gj, sj)), rtol=1e-8)


def test_gp_predictions_match_jax(trained):
    """predict_f (mean, diagonal variance, full covariance), predict_y and
    proba_y on 60 held-out points at rtol 1e-8 (atol 1e-12)."""
    gj, sj, gt, st, Xh = trained
    Xj, Xt = jnp.asarray(Xh), torch.as_tensor(Xh)
    close(agt.predict_f(gt, st, Xt), agp.predict_f(gj, sj, Xj), msg="mean")
    for diag in (True, False):
        mu_t, v_t = agt.predict_f(gt, st, Xt, cov=True, diag=diag)
        mu_j, v_j = agp.predict_f(gj, sj, Xj, cov=True, diag=diag)
        close(mu_t, mu_j, msg=f"mean diag={diag}")
        close(v_t, v_j, msg=f"var diag={diag}")
    close(agt.predict_y(gt, st, Xt), agp.predict_y(gj, sj, Xj), msg="predict_y")
    for a, b in zip(agt.proba_y(gt, st, Xt), agp.proba_y(gj, sj, Xj)):
        close(a, b, msg="proba_y")


def test_gp_cholesky_failure_is_nan():
    """A Sigma that does not factor gives NaN, as jnp.linalg.cholesky does,
    and raises nothing (cholesky_ex, no host read)."""
    from agp_tpu_torch.ops.linalg import cholesky_or_nan

    A = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)
    assert torch.isnan(cholesky_or_nan(A)).all()
    L_ref = np.array(jnp.linalg.cholesky(jnp.asarray(A.numpy())))
    assert np.isnan(L_ref[np.tril_indices(2)]).all()
    close(cholesky_or_nan(A.T @ A + torch.eye(2, dtype=torch.float64)),
          np.linalg.cholesky(A.numpy().T @ A.numpy() + np.eye(2)), rtol=1e-14)


def svgp_noise_case(n=1024, m=32, b=128):
    """An SVGP (JAX, float64) with a Gaussian likelihood that learns its
    noise, M=32 inducing points from the toy's rows, slice sampling."""
    X, _, y = toy(n)
    lik = agp.GaussianLikelihood.create(0.1, opt_noise=True)
    return jax_svgp(X, y, m, b, sampling="slice", lengthscale=1.0, likelihood=lik)


def test_svgp_noise_learning_matches_jax():
    """10 stochastic CAVI steps on the JAX package's draws: eta, mu, Sigma,
    theta, sigma^2 and its Adam state at rtol 1e-8 after every step.  The
    port refuses the fused pass for a learnt noise (``_fused_lik_spec``),
    so the step takes the split pair, as the reference's does."""
    mj, sj, Xj, yj = svgp_noise_case()
    lik = port_from_jax(mj, sj, Xj, yj)[0].likelihood
    assert tav._fused_lik_spec(lik) is None
    assert tav._fused_lik_spec(lik.replace(opt_noise=None))[0] == "gaussian"
    runs = replay_steps(mj, sj, Xj, yj, 10)
    check_steps(runs)
    assert float(runs["port"][0].likelihood.sigma2) != 0.1


def test_svgp_noise_learning_row_weighted():
    """10 CAVI steps on one batch whose every fourth row is masked out
    (w = 0): the noise's gradient leaves those rows out of its sums.  eta,
    mu, Sigma, the local variables and sigma^2 at rtol 1e-8 after every
    step."""
    mj, sj, Xj, yj = svgp_noise_case()
    B = mj.inference.batchsize
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(10)))
    w = (np.arange(B) % 4 != 0).astype(np.float64)
    xb, yb = Xj[:B], yj[:B]
    step = jax.jit(lambda m, s: jav.variational_update(m, s, xb, yb, w=jnp.asarray(w)))
    for i in range(10):
        mj, sj = step(mj, sj)
        mt, st = tav.variational_update(mt, st, Xt[:B], yt[:B], w=torch.as_tensor(w))
        for field in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, field), getattr(sj, field), msg=f"step {i}: {field}")
        locals_close(st.local_vars, sj.local_vars, 1e-8, msg=f"step {i}: ")
        lik_params_close(mt.likelihood, mj.likelihood)
