"""The port's heteroscedastic path against the JAX package, float64:
HeteroscedasticLikelihood (with and without a row mask), the plain version
of fused_cavi_stats_het with the lambda epilogue, and the whole
stochastic-CAVI slice (SVGP + SqExponentialKernel + slice sampling, fixed
hyperparameters) at N=2048, D=4, M=24, B=256, from identical states
(``interop``) on the JAX package's own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference.analytic_vi import compute_kmat, latent_moments
from agp_tpu.inference.analytic_vi import variational_update as jax_variational_update
from agp_tpu.ops import pallas_kernels as pk
from agp_tpu.training.state import TrainState
from agp_tpu.training.train import _precomputed_draws, _vi_steps
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import het_data, jax_rm_scales, jax_svgp, port_from_jax, replay_rule

N, D, M, B, STEPS = 2048, 4, 24, 256, 10
RHO, LAM = 3.0, 1.7

KINDS = {
    "rbf": agp.SqExponentialKernel,
    "matern12": agp.Matern12Kernel,
    "matern32": agp.Matern32Kernel,
    "matern52": agp.Matern52Kernel,
}


def close(port, ref, rtol=1e-8, atol=1e-12, msg=""):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def T(a):
    return torch.as_tensor(np.array(a))


# ----------------------------------------------------- (a) the likelihood
@pytest.mark.parametrize("masked", [False, True])
def test_likelihood_methods_match_reference(masked):
    """local_updates (lambda's update honours the row mask w), grad_e_*,
    expec_loglik and aug_kl on the same inputs, rtol 1e-10: the same
    formulas in float64 (sums also with atol 1e-10)."""
    rng = np.random.default_rng(0)
    b = 64
    # small residuals and variances: lambda's update moves it up from LAM
    y, var = rng.normal(size=b), rng.uniform(0.01, 0.1, size=(2, b))
    mu = np.stack([y + 0.1 * rng.normal(size=b), rng.normal(size=b)])
    w = (rng.uniform(size=b) > 0.3).astype(float) if masked else None
    lj, lt = agp.HeteroscedasticLikelihood.create(LAM), agt.HeteroscedasticLikelihood.create(LAM).to(dtype=torch.float64)
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else T(w)
    lj2, loc_j = lj.local_updates(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), lj.init_local_vars(b, jnp.float64), w=wj)
    lt2, loc_t = lt.local_updates(T(y), T(mu), T(var), lt.init_local_vars(b, torch.float64), w=wt)
    for name in ("c", "phi", "gamma", "theta", "sigg"):
        close(loc_t[name], loc_j[name], rtol=1e-10, msg=name)
    close(lt2.lam, lj2.lam, rtol=1e-10, msg="lam")
    assert float(lt2.lam) > LAM
    close(lt2.grad_e_mu(T(y), loc_t), lj2.grad_e_mu(jnp.asarray(y), loc_j), rtol=1e-10)
    close(lt2.grad_e_sigma(T(y), loc_t), lj2.grad_e_sigma(jnp.asarray(y), loc_j), rtol=1e-10)
    close(lt2.expec_loglik(T(y), T(mu), T(var), loc_t),
          lj2.expec_loglik(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), loc_j), rtol=1e-10, atol=1e-10)
    close(lt2.aug_kl(loc_t, T(y)), lj2.aug_kl(loc_j, jnp.asarray(y)), rtol=1e-10, atol=1e-10)


def test_proba_predict_log_prob_match_reference():
    rng = np.random.default_rng(1)
    mu, var, y = rng.normal(size=(2, 40)), rng.uniform(0.1, 2.0, size=(2, 40)), rng.normal(size=40)
    lj, lt = agp.HeteroscedasticLikelihood.create(LAM), agt.HeteroscedasticLikelihood.create(LAM).to(dtype=torch.float64)
    for port, ref in zip(lt.compute_proba(T(mu), T(var)), lj.compute_proba(jnp.asarray(mu), jnp.asarray(var))):
        close(port, ref, rtol=1e-12)
    close(lt.predict_y(T(mu)), lj.predict_y(jnp.asarray(mu)), rtol=0, atol=0)
    close(lt.log_prob(T(y), T(mu)), lj.log_prob(jnp.asarray(y), jnp.asarray(mu)), rtol=1e-12)


def test_lambda_lives_on_the_model_device_and_dtype():
    Z = torch.zeros((4, 2), dtype=torch.float64)
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.HeteroscedasticLikelihood.create(2.0),
                            agt.AnalyticSVI(8), Z, optimiser=None)
    assert model.likelihood.lam.dtype == torch.float64 and model.likelihood.lam.ndim == 0
    assert model.n_latent == 2 and model.Z.shape == (2, 4, 2)
    assert tav._fused_het_spec(model) == "rbf" and tav._fused_mc_spec(model) is None


# ------------------------------------------------ (b), (c) the plain kernel
def kernel_inputs(kind="rbf", seed=0, b=300, jitt=1e-4):
    """Numpy inputs with per-latent ARD lengthscales, and the JAX model and
    kmat they come from (float64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, D))
    Z = rng.normal(size=(2, M, D))
    ls = rng.uniform(0.8, 1.6, size=(2, D))
    var = rng.uniform(0.8, 1.5, size=2)
    A = rng.normal(size=(2, M, M))
    model = agp.SVGP.create(
        KINDS[kind](lengthscale=jnp.ones(D)), agp.HeteroscedasticLikelihood.create(LAM), agp.AnalyticVI(),
        Z=jnp.asarray(Z[0]), optimiser=None,
    )
    model = model.replace(Z=jnp.asarray(Z), kernel=model.kernel.replace(lengthscale=jnp.asarray(ls),
                                                                       variance=jnp.asarray(var)))
    kmat = compute_kmat(model, jnp.asarray(X))
    a = dict(
        X=X, y=np.sin(X[:, 0]) + 0.3 * rng.normal(size=b), Z=Z, ls=ls, var=var,
        mu=rng.normal(size=(2, M)), Sigma=A @ A.transpose(0, 2, 1) / M + np.eye(M),
        L_invT=np.swapaxes(np.array(kmat["L_inv"]), -1, -2), jitt=jitt,
    )
    return a, model, kmat


def port_call(a, fn=ck.fused_cavi_stats_het, dtype=torch.float64, kind="rbf"):
    t = {k: torch.as_tensor(a[k], dtype=dtype) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma", "ls", "var")}
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], a["jitt"], RHO, LAM,
              kind=kind)


NAMES = ("s1", "S2", "c", "phi", "gamma", "theta", "sigg")


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_unfused_jax_math(kind):
    """Plain version (f64, B=300) against the JAX package's unfused path:
    latent_moments + HeteroscedasticLikelihood.local_updates (old lambda)
    + the statistic einsums, with f's gradients taken without lambda as the
    kernel leaves them.  rtol 1e-8: float64; K^-1 formed two ways."""
    a, model, kmat = kernel_inputs(kind)
    state = TrainState(mu=jnp.asarray(a["mu"]), Sigma=jnp.asarray(a["Sigma"]))
    mf, vf, kappa = latent_moments(model, state, jnp.asarray(a["X"]), kmat)
    y = jnp.asarray(a["y"])
    _, local = model.likelihood.local_updates(y, mf, vf, model.likelihood.init_local_vars(300, jnp.float64))
    unit = model.likelihood.replace(lam=jnp.asarray(1.0))
    gmu, gs = unit.grad_e_mu(y, local), unit.grad_e_sigma(y, local)
    ref = dict(
        s1=jnp.einsum("lbm,lb->lm", kappa, RHO * gmu), S2=jnp.einsum("lbm,lb,lbn->lmn", kappa, RHO * gs, kappa),
        **{k: local[k] for k in NAMES[2:]},
    )
    out = dict(zip(NAMES, port_call(a, kind=kind)))
    for name, r in ref.items():
        close(out[name], r, atol=1e-10, msg=name)


def test_plain_matches_pallas_kernel_interpret():
    """Plain version against the Pallas kernel itself in TPU interpret mode
    (B=300: a ragged last tile), as tests/test_pallas.py runs it, at that
    file's megakernel tolerances (rtol 1e-2, atol 1e-4).  Kmm jitter 1e-3."""
    a, _, _ = kernel_inputs(seed=1, jitt=1e-3)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fused_cavi_stats_het(
            *(jnp.asarray(a[k]) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma", "ls", "var")),
            a["jitt"], RHO, LAM, kind="rbf",
        )
    out = port_call(a)
    for name, o, r in zip(NAMES, out, ref):
        close(o, r, rtol=1e-2, atol=1e-4, msg=name)


def test_cpu_path_counts_no_launch_and_keeps_dtype():
    a, _, _ = kernel_inputs()
    before = ck.fused_cavi_stats_het.launches
    out = port_call(a, dtype=torch.float32)
    assert ck.fused_cavi_stats_het.launches == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in out)


def test_cuda_argument_checks():
    a, _, _ = kernel_inputs()
    t = {k: torch.as_tensor(a[k], dtype=torch.float32) for k in ("X", "y", "Z", "mu", "Sigma")}
    args = ("fused_cavi_stats_het", t["X"], t["Z"], t["mu"], t["Sigma"])
    ck._check_multi_args(*args, {"yb": (t["y"], (300,))}, "rbf")
    ck._check_multi_args(*args, {"yb": (t["y"], (300,))}, "matern52")
    with pytest.raises(ValueError, match="kinds"):
        ck._check_multi_args(*args, {"yb": (t["y"], (300,))}, "periodic")
    with pytest.raises(ValueError):
        ck._check_multi_args(*args, {"yb": (t["y"][:10], (300,))}, "rbf")
    with pytest.raises(ValueError):
        ck._check_multi_args(*args[:4], t["Sigma"].transpose(1, 2), {"yb": (t["y"], (300,))}, "rbf")


# --------------------------------------------------- (d), (e) the slice
def jax_het(seed=0, lengthscale=2.0):
    X, y = het_data(N, D, seed)
    return jax_svgp(X, y, M, B, sampling="slice", lengthscale=lengthscale,
                    likelihood=agp.HeteroscedasticLikelihood.create())


@pytest.fixture(scope="module")
def runs():
    mj, sj, Xj, yj = jax_het()
    _, idx = _precomputed_draws(mj, sj, Xj, STEPS)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(STEPS)))
    draws = torch.as_tensor(np.array(idx), dtype=torch.int64)
    per_step = []
    for i in range(STEPS):
        mj, sj = _vi_steps(mj, sj, Xj, yj, 1)
        mt, st = vi_steps(mt, st, Xt, yt, 1, draws=draws[i : i + 1])
        per_step.append((mj, sj, mt, st))
    return dict(per_step=per_step, jax=(mj, sj, Xj, yj, idx), port=(mt, st, Xt, yt))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference(runs, step):
    """eta, mu, Sigma, the local variables and lambda after each step, rtol
    1e-8 (atol 1e-12): float64 on both sides, the port through the plain
    fused pass and its lambda epilogue, the reference through its unfused
    XLA path."""
    mj, sj, mt, st = runs["per_step"][step]
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    for name in ("c", "phi", "gamma", "theta", "sigg"):
        close(st.local_vars[name], sj.local_vars[name], msg=name)
    close(mt.likelihood.lam, mj.likelihood.lam, msg="lam")
    assert int(st.opt_state) == int(sj.opt_state) == step + 1
    assert int(st.step) == int(sj.step) == step + 1


def test_predictions_and_elbo_match_reference(runs):
    """predict_f (mean and variance of both latents), predict_y and
    proba_y's (mean, variance) on 200 held-out points, and the ELBO on the
    last step's minibatch, at rtol 1e-8."""
    mj, sj, Xj, yj, idx = runs["jax"]
    mt, st, Xt, yt = runs["port"]
    Xh, _ = het_data(200, D, seed=1)
    mu_j, var_j = agp.predict_f(mj, sj, jnp.asarray(Xh), cov=True)
    mu_t, var_t = agt.predict_f(mt, st, T(Xh), cov=True)
    close(mu_t, mu_j, msg="predict_f mean")
    close(var_t, var_j, msg="predict_f var")
    close(agt.predict_y(mt, st, T(Xh)), agp.predict_y(mj, sj, jnp.asarray(Xh)), msg="predict_y")
    for port, ref in zip(agt.proba_y(mt, st, T(Xh)), agp.proba_y(mj, sj, jnp.asarray(Xh))):
        close(port, ref, msg="proba_y")
    start = int(idx[-1])
    xb, yb = np.asarray(Xj)[start : start + B], np.asarray(yj)[start : start + B]
    e_j = float(agp.elbo(mj, sj, jnp.asarray(xb), jnp.asarray(yb)))
    e_t = float(agt.elbo(mt, st, T(xb), T(yb)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-8)


def test_steps_match_fused_pallas_interpret(monkeypatch):
    """Two steps with the reference forced through its fused
    heteroscedastic Pallas kernel and its lambda epilogue (AGP_TPU_PALLAS=1,
    TPU interpret mode), at tests/test_pallas.py's megakernel tolerances
    (rtol 1e-2, atol 1e-4; lambda rtol 1e-3).  Lengthscale 1, as there."""
    mj, sj, Xj, yj = jax_het(seed=3, lengthscale=1.0)
    _, idx = _precomputed_draws(mj, sj, Xj, 2)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(2)))
    monkeypatch.setenv("AGP_TPU_PALLAS", "1")
    vu = jax.jit(jax_variational_update)
    with pltpu.force_tpu_interpret_mode():
        for i in range(2):
            s = int(idx[i])
            mj, sj = jax.block_until_ready(vu(mj, sj, Xj[s : s + B], yj[s : s + B]))
    mt, st = vi_steps(mt, st, Xt, yt, 2, draws=torch.as_tensor(np.array(idx), dtype=torch.int64))
    close(st.mu, sj.mu, rtol=1e-2, atol=1e-4, msg="mu")
    close(st.Sigma, sj.Sigma, rtol=1e-2, atol=1e-4, msg="Sigma")
    close(mt.likelihood.lam, mj.likelihood.lam, rtol=1e-3, msg="lam")
    for name in ("theta", "gamma", "phi", "sigg", "c"):
        close(st.local_vars[name], sj.local_vars[name], rtol=1e-2, atol=1e-4, msg=name)


def test_unfused_path_matches_fused():
    """A row-weighted batch takes the unfused path; with all weights 1 it
    gives the fused pass's step and lambda.  rtol 1e-10."""
    mj, sj, Xj, yj = jax_het(seed=4)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    xb, yb = Xt[:B], yt[:B]
    m_fused, s_fused = tav.variational_update(mt, st, xb, yb)
    m_plain, s_plain = tav.variational_update(mt, st, xb, yb, w=torch.ones(B, dtype=torch.float64))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(s_fused, name), getattr(s_plain, name), rtol=1e-10, msg=name)
    close(m_fused.likelihood.lam, m_plain.likelihood.lam, rtol=1e-10, msg="lam")


def test_masked_step_matches_reference():
    """A step with some rows masked out (w = 0), as the reference's padded
    drivers take it: the unfused path on both sides, rtol 1e-8."""
    mj, sj, Xj, yj = jax_het(seed=5)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    w = (np.random.default_rng(5).uniform(size=B) > 0.25).astype(float)
    mj, sj = jax_variational_update(mj, sj, Xj[:B], yj[:B], w=jnp.asarray(w))
    mt, st = tav.variational_update(mt, st, Xt[:B], yt[:B], w=T(w))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    close(mt.likelihood.lam, mj.likelihood.lam, msg="lam")


def test_train_through_public_api():
    """agt.train with the port's own generator and Robbins-Monro rule: 300
    steps; predict_y follows sin(x_0) (RMSE 0.348 here, where the JAX
    package's own train reaches 0.349: 24 inducing points at lengthscale 2
    in 4-D fit sin(x_0) only in part; the labels' standard deviation is
    0.72) and lambda has moved up from 1."""
    X, y = het_data(N, D, seed=6)
    Xt = T(X)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0), agt.HeteroscedasticLikelihood.create(),
        agt.AnalyticSVI(B, minibatch_sampling="slice"), Xt[:M], optimiser=None,
    )
    model, state = agt.train(model, Xt, T(y), iterations=300, generator=torch.Generator().manual_seed(0))
    rmse = float(torch.sqrt(torch.mean((agt.predict_y(model, state, Xt) - torch.sin(Xt[:, 0])) ** 2)))
    assert rmse < 0.4
    assert float(model.likelihood.lam) > 1.0
