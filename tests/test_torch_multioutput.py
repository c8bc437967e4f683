"""The port's multi-output models (MOSVGP, MOVGP) against the JAX package's,
float64, the same inputs made with numpy and carried across by ``interop``:
the step's pieces at 1e-10, 10 CAVI steps at 1e-8 (Q=2 over Gaussian +
logistic tasks full batch and stochastic on the reference's iid indices,
with A fixed and with Adam on A; Q=1; logistic + Laplace; a MOVGP),
``mo_elbo`` and its hyperparameter gradients against ``jax.grad``,
``mo_train`` with Adam(0.01) and atfrequency 3 at 1e-7, the predictions at
1e-10; the numpy LMC twin of ``tests/test_movgp.py``; the reference's own
checks at their sizes; the refusals and the step's host reads."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.config import jitter as jax_jitter
from agp_tpu.models import multioutput as jmo
from agp_tpu.training.autotuning import init_hyper_state
from agp_tpu_torch.models import multioutput as tmo
from agp_tpu_torch.utils.tensors import host_read
from test_movgp import _mo_setup, numpy_movgp_gaussian_cavi
from tests.testingtools import generate_f
from torch_helpers import (
    adam_close, close, close_tree, jax_mo, jax_mo_draws, jax_mo_treat, jax_rm_scales, mo_close, one_torch_thread, port_mo,
    grand_tour_data, reg_data, replay_rule, t64, toy,
)

N, M, B, STEPS = 60, 12, 20, 10
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def data():
    """The reference's mixed-task rule (tpu_acceptance.py's
    mo_mixed_likelihoods_finite): X uniform on [-2, 2]^2, a Gaussian task
    on f + 0.1 eps and a logistic one on sign(f - 0.2)."""
    X, f = toy(N)
    return X, f, (f + 0.1 * np.random.default_rng(1).normal(size=N), np.sign(f - 0.2))


def gl_liks():
    return [agp.GaussianLikelihood.create(0.1), agp.LogisticLikelihood.create()]


def start(mj, X, ys):
    """(JAX model with treated labels, its initial state, X and ys as JAX
    arrays), as mo_train starts."""
    mj, ysj = jax_mo_treat(mj, ys)
    Xj = jnp.asarray(X)
    return mj, jmo.mo_init_state(mj, Xj, ysj), Xj, ysj


def as_torch(Xj, ysj):
    return t64(Xj), tuple(t64(y) for y in ysj)


def reference_A(model, seed=0):
    """``model`` with the A that the reference's create draws from
    PRNGKey(seed) at its shape: the port draws its own from a torch
    generator, so a check of the reference's that depends on its starting
    A takes the reference's."""
    A = np.array(jax.random.normal(jax.random.PRNGKey(seed), tuple(model.A.shape)))
    return model.replace(A=t64(A / np.linalg.norm(A, axis=1, keepdims=True)))


# case: (likelihoods, Q, batch, Aoptimiser, MOVGP)
CASES = {
    "q2_full_fixedA": (gl_liks, 2, None, None, False),
    "q2_full_adamA": (gl_liks, 2, None, "adam", False),
    "q2_stochastic_fixedA": (gl_liks, 2, B, None, False),
    "q2_stochastic_adamA": (gl_liks, 2, B, "adam", False),
    "q1": (gl_liks, 1, None, "adam", False),
    "logistic_laplace": (lambda: [agp.LogisticLikelihood.create(), agp.LaplaceLikelihood.create()], 2, None, "adam",
                         False),
    "movgp": (gl_liks, 2, None, "adam", True),
}


def case_models(name, data):
    """The JAX model of ``CASES[name]`` with its state and data, and the
    port's copy (stochastic: the reference's Robbins-Monro scales
    replayed)."""
    liks, Q, batch, aopt, movgp = CASES[name]
    X, _, ys = data
    if name == "logistic_laplace":
        ys = (np.sign(ys[0]), ys[0])
    mj = jax_mo(X, liks(), M, Q, batch=batch, movgp=movgp, Aoptimiser=optax.adam(0.01) if aopt else None)
    mj, sj, Xj, ysj = start(mj, X, ys)
    inference = agt.AnalyticSVI(batch, optimiser=replay_rule(jax_rm_scales(STEPS))) if batch else None
    mt, st = port_mo(mj, sj, Aoptimiser=agt.adam(0.01) if aopt else None, inference=inference)
    return mj, sj, Xj, ysj, mt, st


def port_step(mt, st, Xt, yt, idx=None):
    if idx is not None:
        ix = torch.as_tensor(idx)
        Xt, yt = Xt[ix], tuple(y[ix] for y in yt)
    mt, st = tmo.mo_variational_update(mt, st, Xt, yt)
    return mt, st.replace(step=st.step + 1)


@pytest.mark.parametrize("name", CASES)
def test_mo_cavi_steps_match_jax(name, data):
    """eta, mu, Sigma, A, each task's local variables and parameters and A's
    Adam state after each of 10 CAVI steps at rtol 1e-8 (atol 1e-12; the
    MOVGP's eta, mu and Sigma within 1e-8 of their largest entry, as
    ``mo_close`` says why); a stochastic step on the reference's own iid
    indices."""
    mj, sj, Xj, ysj, mt, st = case_models(name, data)
    Xt, yt = as_torch(Xj, ysj)
    idx = jax_mo_draws(mj, sj, N, STEPS) if mj.inference.stochastic else [None] * STEPS
    step = jax.jit(jmo._mo_step_body)
    for i in range(STEPS):
        mj, sj = step(mj, sj, Xj, ysj)
        mt, st = port_step(mt, st, Xt, yt, idx[i])
        mo_close(mt, st, mj, sj, 1e-8, msg=f"{name} step {i}: ", normwise=name == "movgp")
        assert int(st.step) == int(sj.step) == i + 1


@pytest.fixture(scope="module")
def mid(data):
    """A Q=2 model 5 full-batch steps in (A with Adam), carried across,
    with the latent moments and row gradients of its next batch."""
    X, _, ys = data
    mj, sj, Xj, ysj = start(jax_mo(X, gl_liks(), M, 2, Aoptimiser=optax.adam(0.01)), X, ys)
    step = jax.jit(jmo._mo_step_body)
    for _ in range(5):
        mj, sj = step(mj, sj, Xj, ysj)
    return mj, sj, Xj, ysj


@pytest.mark.parametrize("aopt", ["adam", "sgd"])
def test_mo_pieces_match_jax(aopt, mid):
    """From a mid-training state: mo_mean_var_f, the tasks' E-steps,
    mo_grad_rows, mo_grad_latents and mo_update_A (Adam(0.01), or
    sgd(0.05)) at rtol 1e-10."""
    from agp_tpu.inference.analytic_vi import latent_moments

    mj, sj, Xj, ysj = mid
    jopt, topt = (optax.adam(0.01), agt.adam(0.01)) if aopt == "adam" else (optax.sgd(0.05), agt.sgd(0.05))
    mj = mj.replace(Aoptimiser=jopt)
    sj = sj.replace(A_state=jopt.init(mj.A))
    mt, st = port_mo(mj, sj, Aoptimiser=topt)
    Xt, yt = as_torch(Xj, ysj)
    mu_j, var_j, _ = latent_moments(mj, sj, Xj, sj.kmat)
    mu_t, var_t, _ = agt.inference.analytic_vi.latent_moments(mt, st, Xt, st.kmat)
    kw = dict(rtol=1e-10, atol=1e-13)
    close(mu_t, mu_j, **kw)
    close(var_t, var_j, **kw)
    for a, b in zip(tmo.mo_mean_var_f(mt, mu_t, var_t), jmo.mo_mean_var_f(mj, mu_j, var_j)):
        close(a, b, **kw)
    mf_j, vf_j = jmo.mo_mean_var_f(mj, mu_j, var_j)
    liks_j, loc_j = jmo.mo_local_updates(mj, ysj, mf_j, vf_j, sj.local_vars)
    liks_t, loc_t = tmo.mo_local_updates(mt, yt, *tmo.mo_mean_var_f(mt, mu_t, var_t), st.local_vars)
    for vt, vj in zip(loc_t, loc_j):
        for k in vj:
            close(vt[k], vj[k], msg=k, **kw)
    grads_j = jmo.mo_grad_rows(mj.replace(likelihoods=liks_j), ysj, loc_j)
    grads_t = tmo.mo_grad_rows(mt.replace(likelihoods=liks_t), yt, loc_t)
    for a, b in zip(grads_t, grads_j):
        close(a, b, **kw)
    for a, b in zip(tmo.mo_grad_latents(mt, *grads_t, mu_t), jmo.mo_grad_latents(mj, *grads_j, mu_j)):
        close(a, b, **kw)
    m2j, s2j = jmo.mo_update_A(mj, sj, ysj, mu_j, var_j, loc_j, grads=grads_j)
    m2t, s2t = tmo.mo_update_A(mt, st, yt, mu_t, var_t, loc_t, grads=grads_t)
    close(m2t.A, m2j.A, **kw)
    np.testing.assert_allclose(np.linalg.norm(m2t.A.numpy(), axis=1), 1.0, rtol=1e-14)
    assert not np.allclose(m2t.A.numpy(), mt.A.numpy())


def test_mo_row_mask_matches_jax(mid):
    """One step with the row mask w (the last 7 rows weighted 0, as a
    sharded multi-output training pads a batch) against the reference's
    mo_variational_update with the same w at rtol 1e-10: the masked rows
    drop out of the statistics and of A's gradient."""
    mj, sj, Xj, ysj = mid
    mt, st = port_mo(mj, sj, Aoptimiser=agt.adam(0.01))
    Xt, yt = as_torch(Xj, ysj)
    w = np.ones(N)
    w[-7:] = 0.0
    m2j, s2j = jax.jit(jmo.mo_variational_update)(mj, sj, Xj, ysj, jnp.asarray(w))
    m2t, s2t = tmo.mo_variational_update(mt, st, Xt, yt, w=t64(w))
    mo_close(m2t, s2t, m2j, s2j, 1e-10)
    m3t, _ = tmo.mo_variational_update(mt, st, Xt, yt)
    assert not torch.allclose(m3t.A, m2t.A)


def jax_neg_mo_elbo(mj, sj, Xj, ysj):
    """The reference's -mo_elbo as a function of (log kernel, mean, Z), the
    kernel matrices made from them, as its hyper_step differentiates it."""
    from agp_tpu.inference.analytic_vi import compute_kmat
    from agp_tpu.kernels import from_unconstrained

    def neg(log_k, mean, Z):
        m2 = mj.replace(kernel=from_unconstrained(log_k), mean=mean, Z=Z)
        return -jmo.mo_elbo(m2, sj, Xj, ysj, kmat=compute_kmat(m2, Xj))

    return neg


def test_mo_elbo_and_hyper_gradients_match_jax(mid):
    """mo_elbo at rtol 1e-10, and the hyperparameter step's gradients of
    -mo_elbo (the kernel's log parameters, a constant mean's c and Z)
    against jax.grad at 1e-8; one hyper_step's kernel and Z at 1e-8."""
    from agp_tpu.kernels import to_unconstrained
    from agp_tpu.training.autotuning import hyper_step as jax_hyper_step
    from agp_tpu_torch.training.autotuning import hyper_gradients

    mj, sj, Xj, ysj = mid
    mj = mj.replace(mean=agp.ConstantMean(c=jnp.full((2,), 0.3)), optimiser=optax.adam(0.01),
                    Zoptimiser=optax.adam(0.01))
    sj = sj.replace(hyper_state=init_hyper_state(mj))
    mt, st = port_mo(mj, sj, optimiser=agt.adam(0.01))
    mt = mt.replace(mean=agt.ConstantMean(c=torch.full((2,), 0.3, dtype=torch.float64)), Zoptimiser=agt.adam(0.01))
    st = st.replace(hyper_state=agt.training.autotuning.init_hyper_state(mt))
    Xt, yt = as_torch(Xj, ysj)
    np.testing.assert_allclose(float(tmo.mo_elbo(mt, st, Xt, yt)), float(jmo.mo_elbo(mj, sj, Xj, ysj)), rtol=1e-10)
    g_k, g_m, g_z = jax.jit(jax.grad(jax_neg_mo_elbo(mj, sj, Xj, ysj), argnums=(0, 1, 2)))(
        to_unconstrained(mj.kernel), mj.mean, mj.Z)
    _, gt_k, gt_m, gt_z = hyper_gradients(mt, st, Xt, yt)
    close(gt_k["lengthscale"], g_k.lengthscale, rtol=1e-8, msg="d lengthscale")
    close(gt_k["variance"], g_k.variance, rtol=1e-8, msg="d variance")
    close(gt_m["c"], g_m.c, rtol=1e-8, msg="d mean")
    close(gt_z, g_z, rtol=1e-8, atol=1e-10, msg="d Z")
    m2j, _ = jax.jit(jax_hyper_step)(mj, sj, Xj, ysj)
    m2t, _ = agt.hyper_step(mt, st, Xt, yt)
    close(m2t.kernel.lengthscale, m2j.kernel.lengthscale, rtol=1e-8)
    close(m2t.Z, m2j.Z, rtol=1e-8)


def test_mo_train_with_adam_matches_jax(data):
    """10 iterations of mo_train with Adam(0.01) on the kernel every 3rd
    iteration and the default Adam on A, both packages from the same model:
    after each iteration (before its hyperparameter step) mu, A and the
    kernel at rtol 1e-7, the kernel's Adam state at the end; the
    lengthscale moved."""
    X, _, ys = data
    mj = jax_mo(X, gl_liks(), M, 2, optimiser=optax.adam(0.01), Aoptimiser=optax.adam(0.01), atfrequency=3)
    mj0, sj0, _, _ = start(mj, X, ys)
    mt, _ = port_mo(mj0, sj0, optimiser=agt.adam(0.01), Aoptimiser=agt.adam(0.01))
    logs = [], []

    def cb(log):
        return lambda m, s, i: log.append((i, s.mu, m.A, m.kernel.lengthscale))

    mj, sj = agp.mo_train(mj, X, ys, iterations=STEPS, callback=cb(logs[0]))
    mt, st = agt.mo_train(mt, t64(X), ys, iterations=STEPS, callback=cb(logs[1]))
    assert [r[0] for r in logs[1]] == [r[0] for r in logs[0]] == list(range(1, STEPS + 1))
    for (i, mu_j, A_j, ls_j), (_, mu_t, A_t, ls_t) in zip(*logs):
        close(mu_t, mu_j, rtol=1e-7, msg=f"iteration {i}: mu")
        close(A_t, A_j, rtol=1e-7, msg=f"iteration {i}: A")
        close(ls_t, ls_j, rtol=1e-7, msg=f"iteration {i}: lengthscale")
    adam_close(st.hyper_state["kernel"], sj.hyper_state["kernel"], 1e-7)
    close(st.kmat["K_inv"], sj.kmat["K_inv"], rtol=1e-7, atol=1e-9)
    assert abs(float(mt.kernel.lengthscale[0]) - 1.0) > 1e-3


@pytest.fixture(scope="module")
def trained(data):
    """The JAX package's Q=2 model trained 20 full-batch steps, carried
    across."""
    X, _, ys = data
    mj, sj = agp.mo_train(jax_mo(X, gl_liks(), M, 2, Aoptimiser=optax.adam(0.01)), X, ys, iterations=20)
    mt, st = port_mo(mj, sj, Aoptimiser=agt.adam(0.01))
    return mj, sj, mt, st


@pytest.mark.parametrize("chunk", [None, 7])
def test_mo_predictions_match_jax(chunk, trained):
    """mo_predict_f (diagonal, and the full task covariances whose diagonal
    is the diagonal one), mo_predict_y and mo_proba_y per task on 25
    held-out points at rtol 1e-10, whole and in chunks of 7 rows; a
    one-row task gets [n] slices."""
    mj, sj, mt, st = trained
    Xh = np.random.default_rng(2).uniform(-2, 2, size=(25, 2))
    Xj, Xt = jnp.asarray(Xh), t64(Xh)
    kw = dict(rtol=1e-10, atol=1e-13)
    mu_t, var_t = agt.mo_predict_f(mt, st, Xt, chunk_size=chunk)
    mu_j, var_j = agp.mo_predict_f(mj, sj, Xj)
    close(mu_t, mu_j, **kw)
    close(var_t, var_j, **kw)
    mu_f, cov_f = agt.mo_predict_f(mt, st, Xt, diag=False)
    close_tree((mu_f, cov_f), tuple(agp.mo_predict_f(mj, sj, Xj, diag=False)), **kw)
    close(torch.diagonal(cov_f, dim1=-2, dim2=-1), var_t, rtol=1e-10, atol=1e-12)
    pred_t, pred_j = agt.mo_predict_y(mt, st, Xt, chunk_size=chunk), agp.mo_predict_y(mj, sj, Xj)
    assert len(pred_t) == 2 and pred_t[0].shape == (25,)
    close_tree(pred_t, tuple(pred_j), **kw)
    proba_t, proba_j = agt.mo_proba_y(mt, st, Xt, chunk_size=chunk), agp.mo_proba_y(mj, sj, Xj)
    close_tree(proba_t[0], tuple(proba_j[0]), **kw)
    close(proba_t[1], proba_j[1], **kw)
    if chunk is not None:
        with pytest.raises(ValueError, match="chunk_size"):
            agt.mo_predict_f(mt, st, Xt, diag=False, chunk_size=chunk)


@pytest.mark.parametrize("a_lr", [None, 0.05])
def test_movgp_matches_numpy_lmc_twin(a_lr):
    """tests/test_movgp.py's independent numpy LMC CAVI (Gaussian tasks,
    Z = X), with A fixed (10 iterations) and with sgd(0.05) on A (8): mu,
    Sigma and A at the reference test's tolerances, rows unit-norm."""
    X, ys = _mo_setup(seed=7 if a_lr is None else 11)
    X = np.asarray(X)
    sigma2 = 0.05
    model = agt.MOVGP.create(t64(X), [agt.GaussianLikelihood.create(sigma2)] * 2, agt.SqExponentialKernel(),
                             agt.AnalyticVI(), n_latent=2, optimiser=None,
                             Aoptimiser=None if a_lr is None else agt.sgd(a_lr),
                             generator=torch.Generator().manual_seed(5))
    iters = 10 if a_lr is None else 8
    mu_np, Sigma_np, A_np = numpy_movgp_gaussian_cavi(X, ys, model.A.numpy().astype(np.float64), sigma2, iters,
                                                      float(jax_jitter(jnp.float64)), a_lr=a_lr)
    model, state = agt.mo_train(model, t64(X), ys, iterations=iters)
    np.testing.assert_allclose(state.mu.numpy(), mu_np, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(state.Sigma.numpy(), Sigma_np, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(model.A.numpy(), A_np, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(model.A.numpy(), axis=1), 1.0, rtol=1e-12)


def test_movgp_per_task_predictions():
    """tests/test_movgp.py's per-task check through the port, from its A
    (PRNGKey(6)): a MOVGP over Gaussian + logistic tasks, 60 iterations: RMSE < 0.3, accuracy and
    proba_y's accuracy > 0.85, p in [0, 1], the Gaussian task's proba mean
    equal to its prediction; the full covariance's diagonal is the
    variance."""
    kern = agp.SqExponentialKernel()
    X, f1 = generate_f(60, 2, kern, key=jax.random.PRNGKey(31))
    _, f2 = generate_f(60, 2, kern, key=jax.random.PRNGKey(32), X=X)
    X, y_reg = t64(X), np.asarray(f1)
    y_cls = np.sign(np.asarray(f1) + 0.3 * np.asarray(f2))
    model = agt.MOVGP.create(X, [agt.GaussianLikelihood.create(0.01), agt.LogisticLikelihood.create()],
                             agt.SqExponentialKernel(), agt.AnalyticVI(), n_latent=2, optimiser=None)
    model, state = agt.mo_train(reference_A(model, 6), X, [y_reg, y_cls], iterations=60)
    pred = agt.mo_predict_y(model, state, X)
    assert len(pred) == 2
    assert float(torch.sqrt(torch.mean((pred[0] - t64(y_reg)) ** 2))) < 0.3
    assert float((pred[1] == t64(y_cls)).double().mean()) > 0.85
    (mu_t, var_t), p_cls = agt.mo_proba_y(model, state, X)
    assert bool((var_t > 0).all())
    close(mu_t, pred[0], rtol=0)
    assert bool(((p_cls >= 0) & (p_cls <= 1)).all())
    assert float(((p_cls > 0.5) == (t64(y_cls) > 0)).double().mean()) > 0.85
    _, var_d = agt.mo_predict_f(model, state, X[:7])
    _, cov_f = agt.mo_predict_f(model, state, X[:7], diag=False)
    close(torch.diagonal(cov_f, dim1=-2, dim2=-1), var_d, rtol=1e-6, atol=1e-10)


def test_mo_reference_checks():
    """tests/test_engines.py:117-186 and :206-226 through the port, at their
    sizes with the reference's default A and the second's iterations cut
    (120 -> 60): the kernel's
    lengthscale recovered from 3 toward 0.4 and the ELBO above the frozen
    control's; mixed logistic + Laplace tasks with a callback every
    iteration, one small hyperparameter step raising mo_elbo and moving
    the lengthscale; mo_predict_f's shapes, variances > 0, a finite
    mo_elbo and unit-norm rows of A."""
    kern = agp.SqExponentialKernel(lengthscale=jnp.asarray(0.4))
    X, f = generate_f(60, 1, kern, key=jax.random.PRNGKey(3))
    y = np.asarray(f + 0.05 * jax.random.normal(jax.random.PRNGKey(4), f.shape, dtype=f.dtype))
    X = t64(X)
    ys = (y, np.asarray(-0.5 * f))

    def build(optimiser):
        return agt.MOSVGP.create(agt.SqExponentialKernel(lengthscale=3.0), [agt.GaussianLikelihood.create(0.05)] * 2,
                                 agt.AnalyticVI(), X[:20], n_latent=2, optimiser=optimiser, atfrequency=1)

    m_opt, s_opt = agt.mo_train(reference_A(build(agt.adam(0.1))), X, ys, iterations=60)
    m_frz, s_frz = agt.mo_train(reference_A(build(None)), X, ys, iterations=60)
    assert bool((m_opt.kernel.lengthscale < 2.0).all()), m_opt.kernel.lengthscale
    yt = tuple(t64(a) for a in ys)
    assert float(agt.mo_elbo(m_opt, s_opt, X, yt)) > float(agt.mo_elbo(m_frz, s_frz, X, yt)) + 1.0

    Xr, fr, yr = reg_data()
    Xr = t64(Xr)
    model = agt.MOSVGP.create(agt.SqExponentialKernel(lengthscale=2.0),
                              [agt.LogisticLikelihood.create(), agt.LaplaceLikelihood.create()], agt.AnalyticVI(),
                              Xr[:10], n_latent=2, optimiser=None, atfrequency=2)
    seen = []
    model, state = agt.mo_train(reference_A(model), Xr, (np.sign(fr), yr), iterations=60,
                                callback=lambda m, s, i: seen.append(i))
    assert seen == list(range(1, 61))
    ysr = tuple(lik.treat_labels(t)[0].double() for lik, t in zip(model.likelihoods, (np.sign(fr), yr)))
    e0 = float(agt.mo_elbo(model, state, Xr, ysr))
    model = model.replace(optimiser=agt.sgd(1e-4))
    state = state.replace(hyper_state=agt.training.autotuning.init_hyper_state(model))
    model, state = agt.hyper_step(model, state, Xr, ysr)
    assert float(agt.mo_elbo(model, state, Xr, ysr)) > e0
    assert not np.allclose(model.kernel.lengthscale.numpy(), 2.0)
    mu_r, var_r = agt.mo_predict_f(model, state, Xr)
    assert mu_r.shape == (2, 30) and bool((var_r > 0).all())
    assert np.isfinite(float(agt.mo_elbo(model, state, Xr, ysr)))
    np.testing.assert_allclose(np.linalg.norm(model.A.numpy(), axis=1), 1.0, atol=1e-8)


def test_grand_tour_multioutput_section():
    """examples/grand_tour.py's section 7 through the port's public API:
    MOSVGP over logistic + Laplace tasks with Adam(0.01) every 3rd
    iteration, 20 iterations: the lengthscale moved, two tasks predicted."""
    X, f, yr = grand_tour_data()
    X = t64(X)
    mo = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.LogisticLikelihood.create(), agt.LaplaceLikelihood.create()],
                           agt.AnalyticVI(), X[:12], n_latent=2, optimiser=agt.adam(0.01), atfrequency=3)
    mo, mos = agt.mo_train(reference_A(mo), X, (np.sign(f), yr), iterations=20)
    py = agt.mo_predict_y(mo, mos, X)
    assert len(py) == 2 and py[0].shape == py[1].shape == (120,)
    assert not np.allclose(mo.kernel.lengthscale.numpy(), 1.0)


def test_mo_step_reads_nothing_from_the_host(data):
    """A stochastic multi-output step with Adam on A and mo_train's loop
    read the device back 0 times (utils.tensors.host_read)."""
    X, _, ys = data
    model = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1),
                                                          agt.LogisticLikelihood.create()],
                              agt.AnalyticSVI(B), t64(X[:M]), n_latent=2, optimiser=None)
    reads = host_read.reads
    model, state = agt.mo_train(model, t64(X), ys, iterations=5)
    assert host_read.reads == reads
    assert torch.isfinite(state.mu).all()


def test_mo_refusals(data):
    """An inference that is not AnalyticVI raises ValueError, as the
    reference's create does; train() on a multi-output model raises the
    reference's TypeError; draws of the wrong shape raise ValueError."""
    X, _, ys = data
    Z = t64(X[:M])
    with pytest.raises(ValueError, match="AnalyticVI"):
        agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.LogisticLikelihood.create()], agt.QuadratureVI(), Z, 1)
    model = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1),
                                                          agt.LogisticLikelihood.create()],
                              agt.AnalyticSVI(B), Z, n_latent=2)
    with pytest.raises(TypeError, match="mo_train"):
        agt.train(model, t64(X), ys[0])
    with pytest.raises(ValueError, match="draws"):
        agt.mo_train(model, t64(X), ys, iterations=2, draws=torch.zeros((2, B + 1), dtype=torch.int64))


def test_mo_interop_and_placement(trained):
    """interop carries A and each task's parameters; a default A has unit
    rows and comes from the generator (seeded: the same A twice); ``to``
    moves every task's likelihood with the model."""
    mj, _, mt, _ = trained
    close(mt.A, mj.A, rtol=0)
    assert mt.rows_per_task == mj.rows_per_task == (1, 1) and mt.row_slices() == [(0, 1), (1, 2)]
    close(mt.likelihoods[0].sigma2, mj.likelihoods[0].sigma2, rtol=0)
    a1, a2 = (agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.LogisticLikelihood.create()] * 3, agt.AnalyticVI(),
                                t64(np.zeros((4, 2))), n_latent=2, generator=torch.Generator().manual_seed(3)).A
              for _ in range(2))
    assert a1.shape == (3, 2) and torch.equal(a1, a2)
    np.testing.assert_allclose(np.linalg.norm(a1.numpy(), axis=1), 1.0, rtol=1e-12)
    m32 = mt.to(dtype=torch.float32)
    assert m32.A.dtype == m32.likelihoods[0].sigma2.dtype == m32.Z.dtype == torch.float32
