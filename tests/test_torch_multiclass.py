"""The port's multiclass path against the JAX package, float64:
LogisticSoftMaxLikelihood, the plain version of fused_cavi_stats_multiclass
and the whole stochastic-CAVI slice (SVGP + SqExponentialKernel + slice
sampling, fixed hyperparameters) at K=3, N=2048, D=4, M=24, B=256, from
identical states (``interop``) on the JAX package's own draws."""
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
from agp_tpu_torch.likelihoods.multiclass import LogisticSoftMaxLikelihood
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import jax_rm_scales, jax_svgp, multiclass_data, port_from_jax, replay_rule

N, D, K, M, B, STEPS = 2048, 4, 3, 24, 256, 10
RHO = 3.0

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
def likelihood_inputs(seed=0, b=64):
    rng = np.random.default_rng(seed)
    onehot = np.eye(K)[rng.integers(0, K, size=b)]
    mu, var = rng.normal(size=(K, b)), rng.uniform(0.1, 2.0, size=(K, b))
    local = dict(
        c=rng.uniform(0.5, 2.0, size=(K, b)), alpha=rng.uniform(1.0, 6.0, size=b),
        beta=rng.uniform(1.0, 6.0, size=b), theta=rng.uniform(0.1, 0.5, size=(K, b)),
        gamma=rng.uniform(0.1, 2.0, size=(K, b)),
    )
    return onehot, mu, var, local


def test_likelihood_methods_match_reference():
    """local_updates, grad_e_mu/grad_e_sigma, expec_loglik and aug_kl on the
    same inputs, rtol 1e-10: the same formulas in float64 (the ELBO terms
    are sums, compared with atol 1e-10 as well)."""
    y, mu, var, local = likelihood_inputs()
    lj, lt = agp.LogisticSoftMaxLikelihood.create(K), agt.LogisticSoftMaxLikelihood.create(K)
    _, loc_j = lj.local_updates(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var),
                                {k: jnp.asarray(v) for k, v in local.items()})
    _, loc_t = lt.local_updates(T(y), T(mu), T(var), {k: T(v) for k, v in local.items()})
    for name in ("c", "alpha", "beta", "gamma", "theta"):
        close(loc_t[name], loc_j[name], rtol=1e-10, msg=name)
    close(lt.grad_e_mu(T(y), loc_t), lj.grad_e_mu(jnp.asarray(y), loc_j), rtol=1e-10)
    close(lt.grad_e_sigma(T(y), loc_t), lj.grad_e_sigma(jnp.asarray(y), loc_j), rtol=1e-10)
    close(lt.expec_loglik(T(y), T(mu), T(var), loc_t),
          lj.expec_loglik(jnp.asarray(y), jnp.asarray(mu), jnp.asarray(var), loc_j), rtol=1e-10, atol=1e-10)
    close(lt.aug_kl(loc_t, T(y)), lj.aug_kl(loc_j, jnp.asarray(y)), rtol=1e-10, atol=1e-10)
    init_j, init_t = lj.init_local_vars(B, jnp.float64), lt.init_local_vars(B, torch.float64)
    assert set(init_t) == set(init_j)
    for name in init_j:
        close(init_t[name], init_j[name], rtol=0, atol=0, msg=name)


def test_link_log_prob_and_plugin_proba():
    _, mu, var, _ = likelihood_inputs(1)
    y = np.eye(K)[np.random.default_rng(1).integers(0, K, size=mu.shape[1])].T
    lj, lt = agp.LogisticSoftMaxLikelihood.create(K), agt.LogisticSoftMaxLikelihood.create(K)
    close(lt.link(T(mu)), lj.link(jnp.asarray(mu)), rtol=1e-12)
    close(lt.log_prob(T(y), T(mu)), lj.log_prob(jnp.asarray(y), jnp.asarray(mu)), rtol=1e-12)
    close(lt.compute_proba(T(mu), T(var), n_samples=0), lj.compute_proba(jnp.asarray(mu), jnp.asarray(var), n_samples=0),
          rtol=1e-12)
    np.testing.assert_array_equal(lt.predict_y(T(mu)).numpy(), np.asarray(lj.predict_y(jnp.asarray(mu))))


@pytest.mark.parametrize("labels", [[0, 1, 2, 1], [1, 2, 3, 3], [-4, 7, 7, 10], ["b", "a", "c", "a"]])
def test_treat_labels_matches_reference(labels):
    """The one-hot encoding and the inferred class mapping (0..K-1, 1..K or
    the sorted unique labels), and the way back from indices."""
    y = np.asarray(labels)
    oh_j, lik_j = agp.LogisticSoftMaxLikelihood.create(K).treat_labels(y)
    oh_t, lik_t = agt.LogisticSoftMaxLikelihood.create(K).treat_labels(y)
    np.testing.assert_array_equal(oh_t.numpy(), np.asarray(oh_j))
    assert lik_t.class_mapping == lik_j.class_mapping
    idx = np.array([2, 0, 1])
    np.testing.assert_array_equal(lik_t.labels_from_indices(torch.as_tensor(idx)), lik_j.labels_from_indices(idx))
    created = agt.LogisticSoftMaxLikelihood.create(y)
    assert created.class_mapping == agp.LogisticSoftMaxLikelihood.create(y).class_mapping
    with pytest.raises(ValueError, match="unique labels"):
        agt.LogisticSoftMaxLikelihood.create(2).treat_labels(y)


def test_treat_labels_keeps_the_tensor_device():
    oh, _ = agt.LogisticSoftMaxLikelihood.create(K).treat_labels(torch.tensor([0, 2, 1]))
    assert oh.device.type == "cpu" and oh.dtype == torch.float64
    np.testing.assert_array_equal(oh.numpy(), np.eye(3)[[0, 2, 1]])


# ------------------------------------------------ (b), (c) the plain kernel
def kernel_inputs(kind="rbf", seed=0, b=300, jitt=1e-4):
    """Numpy inputs with per-latent ARD lengthscales, and the JAX model and
    kmat they come from (float64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, D))
    Z = rng.normal(size=(K, M, D))
    ls = rng.uniform(0.8, 1.6, size=(K, D))
    var = rng.uniform(0.8, 1.5, size=K)
    A = rng.normal(size=(K, M, M))
    model = agp.SVGP.create(
        KINDS[kind](lengthscale=jnp.ones(D)), agp.LogisticSoftMaxLikelihood.create(K), agp.AnalyticVI(),
        Z=jnp.asarray(Z[0]), optimiser=None,
    )
    model = model.replace(Z=jnp.asarray(Z), kernel=model.kernel.replace(lengthscale=jnp.asarray(ls),
                                                                       variance=jnp.asarray(var)))
    kmat = compute_kmat(model, jnp.asarray(X))
    a = dict(
        X=X, y=np.eye(K)[rng.integers(0, K, size=b)], Z=Z, ls=ls, var=var,
        mu=rng.normal(size=(K, M)), Sigma=A @ A.transpose(0, 2, 1) / M + np.eye(M),
        alpha=rng.uniform(1.0, 6.0, size=b), beta=np.full(b, float(K)),
        L_invT=np.swapaxes(np.array(kmat["L_inv"]), -1, -2), jitt=jitt,
    )
    return a, model, kmat


def port_call(a, fn=ck.fused_cavi_stats_multiclass, dtype=torch.float64, kind="rbf"):
    t = {k: torch.as_tensor(a[k], dtype=dtype) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma", "ls", "var",
                                                          "alpha", "beta")}
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], a["jitt"], RHO,
              t["alpha"], t["beta"], kind=kind)


NAMES = ("s1", "S2", "c", "theta", "gamma", "alpha")


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_unfused_jax_math(kind):
    """Plain version (f64, B=300) against the JAX package's unfused path:
    latent_moments + LogisticSoftMaxLikelihood.local_updates + the
    statistic einsums of apply_natural_gradient.  rtol 1e-8: float64; K^-1
    comes from L^-T L^-1 here and from the Cholesky solve there."""
    a, model, kmat = kernel_inputs(kind)
    state = TrainState(mu=jnp.asarray(a["mu"]), Sigma=jnp.asarray(a["Sigma"]))
    mf, vf, kappa = latent_moments(model, state, jnp.asarray(a["X"]), kmat)
    local = {"alpha": jnp.asarray(a["alpha"]), "beta": jnp.asarray(a["beta"])}
    _, local = model.likelihood.local_updates(jnp.asarray(a["y"]), mf, vf, local)
    y = jnp.asarray(a["y"])
    gmu = model.likelihood.grad_e_mu(y, local)
    gs = model.likelihood.grad_e_sigma(y, local)
    ref = dict(
        s1=jnp.einsum("lbm,lb->lm", kappa, RHO * gmu), S2=jnp.einsum("lbm,lb,lbn->lmn", kappa, RHO * gs, kappa),
        c=local["c"], theta=local["theta"], gamma=local["gamma"], alpha=local["alpha"],
    )
    out = dict(zip(NAMES, port_call(a, kind=kind)))
    for name, r in ref.items():
        close(out[name], r, atol=1e-10, msg=name)


def test_plain_matches_pallas_kernel_interpret():
    """Plain version against the Pallas kernel itself in TPU interpret mode
    (B=300: a ragged last tile), as tests/test_pallas.py runs it, at that
    file's megakernel tolerances (rtol 1e-2, atol 1e-4): the kernel's
    bf16-split dots and its series digamma make that arm float32-grade.
    Kmm jitter 1e-3, as tests/test_pallas.py takes it."""
    a, _, _ = kernel_inputs(seed=1, jitt=1e-3)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fused_cavi_stats_multiclass(
            *(jnp.asarray(a[k]) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma", "ls", "var")),
            a["jitt"], RHO, jnp.asarray(a["alpha"]), jnp.asarray(a["beta"]), kind="rbf",
        )
    out = port_call(a)
    for name, o, r in zip(NAMES, out, ref):
        close(o, r, rtol=1e-2, atol=1e-4, msg=name)


def test_cpu_path_counts_no_launch_and_keeps_dtype():
    a, _, _ = kernel_inputs()
    before = ck.fused_cavi_stats_multiclass.launches
    out = port_call(a, dtype=torch.float32)
    assert ck.fused_cavi_stats_multiclass.launches == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in out)


def test_cuda_argument_checks():
    """What the CUDA kernel does not take is refused before any launch."""
    a, _, _ = kernel_inputs()
    t = {k: torch.as_tensor(a[k], dtype=torch.float32) for k in ("X", "y", "Z", "mu", "Sigma", "alpha")}
    rows = {"y_onehot": (t["y"], (300, K)), "alpha0": (t["alpha"], (300,))}
    args = ("fused_cavi_stats_multiclass", t["X"], t["Z"], t["mu"], t["Sigma"])
    ck._check_multi_args(*args, rows, "rbf")
    ck._check_multi_args(*args, rows, "matern32")
    with pytest.raises(ValueError, match="kinds"):
        ck._check_multi_args(*args, rows, "periodic")
    with pytest.raises(TypeError):
        ck._check_multi_args(*args, {**rows, "alpha0": (t["alpha"].double(), (300,))}, "rbf")
    with pytest.raises(ValueError):
        ck._check_multi_args(*args, {**rows, "y_onehot": (t["y"].T, (300, K))}, "rbf")
    with pytest.raises(ValueError):
        ck._check_multi_args(*args[:4], t["Sigma"][:2], rows, "rbf")
    Zbig = torch.zeros((K, ck.MAX_M + 1, D))
    big = (Zbig, torch.zeros((K, ck.MAX_M + 1)), torch.zeros((K, ck.MAX_M + 1, ck.MAX_M + 1)))
    with pytest.raises(ValueError, match="M <="):
        ck._check_multi_args(args[0], t["X"], *big, rows, "rbf")


# --------------------------------------------------- (d), (e) the slice
def jax_multiclass(seed=0, lengthscale=2.0):
    X, y = multiclass_data(N, D, K, seed)
    return jax_svgp(X, y, M, B, sampling="slice", lengthscale=lengthscale,
                    likelihood=agp.LogisticSoftMaxLikelihood.create(K))


@pytest.fixture(scope="module")
def runs():
    """10 slice-sampled steps of both packages from one state, the state
    after each, and the final (model, state) of each."""
    mj, sj, Xj, yj = jax_multiclass()
    _, idx = _precomputed_draws(mj, sj, Xj, STEPS)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(STEPS)))
    draws = torch.as_tensor(np.array(idx), dtype=torch.int64)
    per_step = []
    for i in range(STEPS):
        mj, sj = _vi_steps(mj, sj, Xj, yj, 1)
        mt, st = vi_steps(mt, st, Xt, yt, 1, draws=draws[i : i + 1])
        per_step.append((sj, st))
    return dict(per_step=per_step, jax=(mj, sj, Xj, yj, idx), port=(mt, st, Xt, yt))


def test_labels_carried_over(runs):
    mj, _, _, yj, _ = runs["jax"]
    mt, _, _, yt = runs["port"]
    assert mt.likelihood.class_mapping == mj.likelihood.class_mapping == tuple(range(K))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference(runs, step):
    """eta, mu, Sigma and the local variables after each step, rtol 1e-8
    (atol 1e-12): float64 on both sides, the port through the plain fused
    pass, the reference through its unfused XLA path."""
    sj, st = runs["per_step"][step]
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    for name in ("c", "theta", "gamma", "alpha", "beta"):
        close(st.local_vars[name], sj.local_vars[name], msg=name)
    assert int(st.opt_state) == int(sj.opt_state) == step + 1
    assert int(st.step) == int(sj.step) == step + 1


def test_predictions_and_elbo_match_reference(runs):
    """predict_f (mean and variance, [K, n]), predict_y and the plug-in
    proba_y on 200 held-out points at rtol 1e-8, and the ELBO on the last
    step's minibatch.  proba_y with sampling draws other normals than
    threefry: each probability within 5 Monte Carlo standard errors of the
    difference of two independent 200-draw means."""
    mj, sj, Xj, yj, idx = runs["jax"]
    mt, st, Xt, yt = runs["port"]
    Xh, _ = multiclass_data(200, D, K, seed=1)
    mu_j, var_j = agp.predict_f(mj, sj, jnp.asarray(Xh), cov=True)
    mu_t, var_t = agt.predict_f(mt, st, T(Xh), cov=True)
    close(mu_t, mu_j, msg="predict_f mean")
    close(var_t, var_j, msg="predict_f var")
    np.testing.assert_array_equal(agt.predict_y(mt, st, T(Xh)).numpy(), np.asarray(agp.predict_y(mj, sj, jnp.asarray(Xh))))
    close(agt.proba_y(mt, st, T(Xh), n_samples=0), agp.proba_y(mj, sj, jnp.asarray(Xh), n_samples=0), msg="plug-in")

    p_t = agt.proba_y(mt, st, T(Xh))
    p_j = np.asarray(agp.proba_y(mj, sj, jnp.asarray(Xh)))
    eps = torch.randn((200, K, 200), generator=torch.Generator().manual_seed(42), dtype=torch.float64)
    draws = mt.likelihood.link(mu_t[:, None] + torch.sqrt(var_t)[:, None] * eps.transpose(0, 1))  # [K, S, n]
    close(p_t, draws.mean(dim=1).T, rtol=1e-12, msg="proba_y draws")
    se = (draws.std(dim=1).T / np.sqrt(200)).numpy()
    assert np.all(np.abs(p_t.numpy() - p_j) <= 5 * np.sqrt(2) * se + 1e-12)
    assert np.allclose(p_t.sum(dim=1).numpy(), 1.0)

    start = int(idx[-1])
    xb, yb = np.asarray(Xj)[start : start + B], np.asarray(yj)[start : start + B]
    e_j = float(agp.elbo(mj, sj, jnp.asarray(xb), jnp.asarray(yb)))
    e_t = float(agt.elbo(mt, st, T(xb), T(yb)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-8)


@pytest.mark.parametrize("sampling", ["block", "gather"])
def test_other_sampling_modes_match_reference(sampling):
    """The one-hot [N, K] labels through the "block" (aligned 64-row tiles)
    and "gather" draws, replayed from the JAX package: 3 steps at rtol
    1e-8."""
    X, y = multiclass_data(N, D, K, seed=2)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B, sampling=sampling, likelihood=agp.LogisticSoftMaxLikelihood.create(K))
    mode, idx = _precomputed_draws(mj, sj, Xj, 3)
    assert mode == sampling
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(3)))
    mj, sj = _vi_steps(mj, sj, Xj, yj, 3)
    mt, st = vi_steps(mt, st, Xt, yt, 3, draws=torch.as_tensor(np.array(idx), dtype=torch.int64))
    for name in ("mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    close(st.local_vars["gamma"], sj.local_vars["gamma"], msg="gamma")


def test_steps_match_fused_pallas_interpret(monkeypatch):
    """Two steps with the reference forced through its fused multiclass
    Pallas kernel (AGP_TPU_PALLAS=1, TPU interpret mode), at
    tests/test_pallas.py's megakernel tolerances (rtol 1e-2, atol 1e-4).
    Lengthscale 1, as there: at 2, Kmm's condition number carries the
    kernel's float32-grade kappa past that tolerance."""
    mj, sj, Xj, yj = jax_multiclass(seed=3, lengthscale=1.0)
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
    for name in ("theta", "gamma", "alpha", "c"):
        close(st.local_vars[name], sj.local_vars[name], rtol=1e-2, atol=1e-4, msg=name)


def test_unfused_path_matches_fused():
    """A row-weighted batch takes the batched pair (latent_moments'
    fused_kappa_moments_batched + local_updates + apply_natural_gradient's
    cavi_stats_batched, their plain versions here); with all
    weights 1 it gives the fused pass's step.  rtol 1e-10: float64, K^-1
    formed two ways."""
    mj, sj, Xj, yj = jax_multiclass(seed=4)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    assert tav._fused_mc_spec(mt) == "rbf" and tav._fused_het_spec(mt) is None
    xb, yb = Xt[:B], yt[:B]
    _, s_fused = tav.variational_update(mt, st, xb, yb)
    _, s_plain = tav.variational_update(mt, st, xb, yb, w=torch.ones(B, dtype=torch.float64))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(s_fused, name), getattr(s_plain, name), rtol=1e-10, msg=name)
    for name in ("c", "theta", "gamma", "alpha"):
        close(s_fused.local_vars[name], s_plain.local_vars[name], rtol=1e-10, msg=name)


def test_train_through_public_api():
    """agt.train on integer labels given as a tensor, with the port's own
    generator and Robbins-Monro rule: 150 steps at K=3 beat chance (1/3)
    by far on the training set, and the state holds K latents."""
    X, y = multiclass_data(N, D, K, seed=5)
    Xt = T(X)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticSoftMaxLikelihood.create(K),
        agt.AnalyticSVI(B, minibatch_sampling="slice"), Xt[:M], optimiser=None,
    )
    model, state = agt.train(model, Xt, torch.as_tensor(y), iterations=150, generator=torch.Generator().manual_seed(0))
    assert state.mu.shape == (K, M) and state.local_vars["gamma"].shape == (K, B)
    acc = float((agt.predict_y(model, state, Xt).numpy() == y).mean())
    assert acc > 0.7
    assert isinstance(model.likelihood, LogisticSoftMaxLikelihood)
