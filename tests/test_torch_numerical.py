"""The port's numerical VI (Slice F) against the JAX package, float64 at a
small size (N=64, D=2, M=8, B=16, 20 quadrature nodes, 16 Monte Carlo
draws): the expectation gradients (quadrature for logistic, Student-t by
the AD fallback, Laplace and Matern-3/2; Monte Carlo for softmax and
logistic-softmax from the reference's normals, and softmax's closed form
against the AD form) at rtol 1e-10; 10 steps of sparse and dense,
quadrature and Monte Carlo engines, natural and plain gradients, clipping
on, on the reference's minibatch indices and normals, at rtol 1e-8 after
every step; a step whose PSD search halves alpha; the numerical ELBO and
its hyperparameter gradient against ``jax.grad`` of the reference's
``neg_elbo`` at rtol 1e-8; ``sgd`` against ``optax.sgd``;
``moments_to_nat``, ``sqrt_expec_square_diff`` and ``besselk_half``; and
every numerical configuration through the port's ``train``."""
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
import chip_smoke
from agp_tpu.inference import numerical_vi as jnv
from agp_tpu.inference.objective import objective as jax_objective
from agp_tpu.kernels import to_unconstrained as jax_to_unconstrained
from agp_tpu.ops import linalg as jlinalg
from agp_tpu.ops import special as jspecial
from agp_tpu.training.autotuning import _kmat as jax_kmat
from agp_tpu.training.autotuning import _rebuild as jax_rebuild
from agp_tpu.training.train import _precomputed_draws, _vi_steps
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu_torch.inference import numerical_vi as tnv
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu_torch.ops import linalg, special
from agp_tpu_torch.training import autotuning
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import (
    close, jax_single_latent, multiclass_data, port_lik_same_params, port_likelihood, single_latent_data,
    state_arrays, t64,
)

N, D, M, B, NPTS, NMC, STEPS, K = 64, 2, 8, 16, 20, 16, 10, 3


# ------------------------------------------------------------------ helpers
def jax_lik(name):
    if name == "softmax":
        return agp.SoftMaxLikelihood.create(K)
    if name == "logisticsoftmax":
        return agp.LogisticSoftMaxLikelihood.create(K)
    return jax_single_latent(name)


def case_data(name, seed=0):
    if name in ("softmax", "logisticsoftmax"):
        return multiclass_data(N, D, K, seed=seed)
    X, _, y = single_latent_data(name, N, D, seed=seed)
    return X, y


@functools.lru_cache(maxsize=None)
def optax_sgd(lr):
    """One optax.sgd(lr, 0.9) object per rate: the JAX models of two tests
    then share their compiled steps (the optimiser is static in the
    model's pytree)."""
    return optax.sgd(lr, momentum=0.9)


def engines(engine, sparse, lr, **kw):
    """The JAX and the port's engine: quadrature ("quad") or Monte Carlo
    ("mc"), stochastic (B rows) for a sparse model, sgd(lr, 0.9)."""
    j_opt, t_opt = optax_sgd(lr), agt.sgd(lr, 0.9)
    kw = dict(kw, n_points=NPTS) if engine == "quad" else dict(kw, n_mc=NMC)
    if sparse:
        j = (agp.QuadratureSVI if engine == "quad" else agp.MCIntegrationSVI)(B, optimiser=j_opt, **kw)
        t = (agt.QuadratureSVI if engine == "quad" else agt.MCIntegrationSVI)(B, optimiser=t_opt, **kw)
    else:
        j = (agp.QuadratureVI if engine == "quad" else agp.MCIntegrationVI)(optimiser=j_opt, **kw)
        t = (agt.QuadratureVI if engine == "quad" else agt.MCIntegrationVI)(optimiser=t_opt, **kw)
    return j, t


def numerical_arrays(sj):
    """The JAX state as ``state_from_numpy`` takes it, the sgd traces
    (optax's TraceState) as a tuple."""
    arrays = state_arrays(sj)
    arrays["opt_state"] = tuple(np.array(a) for a in sj.opt_state[0].trace)
    return arrays


def build(name, engine, sparse, lr=1e-3, optimiser=None, **kw):
    """(JAX model, state, X, y) and the port's copy (model, state, X, y) of
    a numerical case, float64, lengthscale 1."""
    lik_j = jax_lik(name)
    X, y_raw = case_data(name)
    eng_j, eng_t = engines(engine, sparse, lr, **kw)
    kern_j = agp.SqExponentialKernel(lengthscale=jnp.asarray(1.0), variance=jnp.asarray(1.0))
    opt_j = None if optimiser is None else optax.adam(optimiser)
    opt_t = None if optimiser is None else agt.adam(optimiser)
    Xj = jnp.asarray(X)
    if sparse:
        mj = agp.SVGP.create(kern_j, lik_j, eng_j, Xj[:M], optimiser=opt_j)
        yj, lik2 = mj.likelihood.treat_labels(y_raw)
        mj = mj.replace(likelihood=lik2)
        yj = jnp.asarray(yj, jnp.float64)
        sj = jax_init_state(mj, Xj, yj)
    else:
        mj = agp.VGP.create(Xj, y_raw, kern_j, lik_j, eng_j, optimiser=opt_j)
        sj = jax_init_state(mj)
        Xj, yj = mj.train_x, mj.train_y
    lik_t, params = port_likelihood(mj.likelihood)
    Xt = t64(Xj)
    if sparse:
        mt = agt.SVGP.create(agt.SqExponentialKernel(), lik_t, eng_t, Xt[:M], optimiser=opt_t)
        params["Z"] = np.array(mj.Z)
    else:
        mt = agt.VGP.create(Xt, y_raw, agt.SqExponentialKernel(), lik_t, eng_t, optimiser=opt_t)
        params.update(train_x=np.array(mj.train_x), train_y=np.array(mj.train_y))
    mt = model_from_numpy(dict(params, lengthscale=np.array(mj.kernel.lengthscale),
                               variance=np.array(mj.kernel.variance)), mt)
    if "n_class" not in params:
        mt = mt.replace(likelihood=port_lik_same_params(mj.likelihood))
    st = state_from_numpy(numerical_arrays(sj), "cpu", torch.float64)
    return (mj, sj, Xj, yj), (mt, st, Xt, t64(yj))


def step_inputs(mj, sj, Xj):
    """The reference's next step's minibatch indices (None when full-batch)
    and Monte Carlo normals (None for quadrature), drawn as its step draws
    them: fold_in(key, step) for the batch, split(key) for the normals."""
    idx = None
    if mj.inference.stochastic:
        idx = torch.as_tensor(np.array(_precomputed_draws(mj, sj, Xj, 1)[1]))
    eps = None
    if mj.inference.name == "MCIntegrationVI":
        shape = (mj.inference.n_mc, mj.n_latent, mj.inference.batchsize if mj.inference.stochastic else Xj.shape[0])
        eps = t64(jax.random.normal(jax.random.split(sj.key)[1], shape, dtype=jnp.float64))[None]
    return idx, eps


def replay(jax_case, port_case, steps, check=None):
    """``steps`` steps of both packages on the reference's draws; ``check``
    (port state, JAX state, step) after each."""
    mj, sj, Xj, yj = jax_case
    mt, st, Xt, yt = port_case
    for i in range(steps):
        idx, eps = step_inputs(mj, sj, Xj)
        mj, sj = _vi_steps(mj, sj, Xj, yj, 1)
        mt, st = vi_steps(mt, st, Xt, yt, 1, draws=idx, mc_draws=eps)
        if check is not None:
            check(st, sj, i)
    return (mj, sj, Xj, yj), (mt, st, Xt, yt)


def eta_close(st, sj, i, rtol=1e-8):
    """eta1 = Sigma^-1 mu and eta2 = -Sigma^-1 / 2, made from mu and Sigma by
    a Cholesky inverse, at ``rtol`` with an atol of max(1e-12,
    1e-15 cond(Sigma)) times the largest entry: an entry near 0, or one
    that cancels, carries the inverse's rounding, which cond(Sigma)
    amplifies (the steps leave Sigma with cond up to ~1e5 here)."""
    cond = max(float(np.linalg.cond(S)) for S in np.array(sj.Sigma))
    for field in ("eta1", "eta2"):
        ref = np.array(getattr(sj, field))
        close(getattr(st, field), ref, rtol=rtol, atol=max(1e-12, 1e-15 * cond) * np.abs(ref).max(),
              msg=f"step {i}: {field}")


def states_close(st, sj, i, rtol=1e-8):
    """mu, Sigma and the sgd traces at ``rtol`` (atol 1e-12), eta by
    ``eta_close``."""
    for field in ("mu", "Sigma"):
        close(getattr(st, field), getattr(sj, field), rtol=rtol, msg=f"step {i}: {field}")
    eta_close(st, sj, i, rtol)
    for a, b in zip(st.opt_state, sj.opt_state[0].trace):
        close(a, b, rtol=rtol, msg=f"step {i}: sgd trace")
    assert st.local_vars == {} and int(st.step) == int(sj.step) == i + 1


# ------------------------------------------------------ expectation gradients
@pytest.mark.parametrize("name", ["logistic", "studentt", "laplace", "matern32"])
def test_quad_grads_match_jax(name):
    """E[dlogp], E[d2logp] by 20-node Gauss-Hermite quadrature on the same
    mu/var [1, B], clipping off and at 0.5: rtol 1e-10 (atol 1e-12).
    Student-t takes the AD fallbacks on both sides, Laplace and Matern-3/2
    their closed forms, logistic its own."""
    rng = np.random.default_rng(1)
    _, f, y = single_latent_data(name, B, D)
    mu, var = (f + 0.3 * rng.normal(size=B))[None], rng.uniform(0.05, 0.5, size=(1, B))
    lj = jax_single_latent(name)
    lt = port_lik_same_params(lj)
    for clipping in (0.0, 0.5):
        ej = jax.jit(lambda *a: jnv.quad_grads(lj, *a, NPTS, clipping))(jnp.asarray(y), jnp.asarray(mu),
                                                                         jnp.asarray(var))
        et = tnv.quad_grads(lt, t64(y), t64(mu), t64(var), NPTS, clipping)
        for a, b, what in zip(et, ej, ("E[dlogp]", "E[d2logp]")):
            close(a, b, rtol=1e-10, msg=f"{what}, clipping {clipping}")


@pytest.mark.parametrize("name", ["softmax", "logisticsoftmax"])
def test_mc_grads_match_jax(name):
    """E[dlogp], E[diag d2logp] [K, B] over 16 draws of the reference's own
    normals: rtol 1e-10.  Softmax takes its closed form, which the AD form
    (a gradient and one jvp per latent) matches at 1e-12; logistic-softmax
    takes the AD form."""
    rng = np.random.default_rng(2)
    X, labels = multiclass_data(B, D, K)
    lj = jax_lik(name)
    yj, lj = lj.treat_labels(labels)
    mu, var = rng.normal(size=(K, B)), rng.uniform(0.05, 0.5, size=(K, B))
    key = jax.random.PRNGKey(3)
    ej = jax.jit(lambda *a: jnv.mc_grads(lj, *a, NMC, 0.0))(key, jnp.asarray(yj, jnp.float64), jnp.asarray(mu),
                                                           jnp.asarray(var))
    eps = t64(jax.random.normal(key, (NMC, K, B), dtype=jnp.float64))
    lt = getattr(agt, type(lj).__name__).create(K)
    yt = t64(yj)
    et = tnv.mc_grads(lt, yt, t64(mu), t64(var), eps, 0.0)
    for a, b, what in zip(et, ej, ("E[dlogp]", "E[d2logp]")):
        close(a, b, rtol=1e-10, msg=what)
    f = t64(mu)[None] + torch.sqrt(t64(var))[None] * eps
    ad = tnv._ad_grad_hess(lt, yt.T, f)
    if name == "softmax":
        for a, b in zip(lt.mc_grad_hess(yt.T, f), ad):
            close(a, b, rtol=1e-12, atol=1e-14, msg="closed form vs AD")


# ------------------------------------------------------------- 10 steps
STEP_CASES = {
    # name: (likelihood, engine, sparse, engine options)
    "svgp_quad_logistic": ("logistic", "quad", True, {}),
    "svgp_quad_studentt_plain_clipped": ("studentt", "quad", True, {"natural": False, "clipping": 2.0}),
    "vgp_quad_laplace": ("laplace", "quad", False, {}),
    "svgp_mc_softmax": ("softmax", "mc", True, {}),
    "vgp_mc_logisticsoftmax_plain_clipped": ("logisticsoftmax", "mc", False, {"natural": False, "clipping": 0.4}),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_numerical_steps_match_jax(case):
    """10 steps from identical states on the reference's minibatch indices
    (``_precomputed_draws``) and normals (its key split): mu, Sigma, eta
    and the sgd traces after every step at rtol 1e-8 (``states_close``), with
    sgd(1e-3, 0.9), the reference's acceptance rate.  Sparse and dense,
    quadrature and Monte Carlo, natural and plain gradients, clipping on
    and off."""
    lik, engine, sparse, kw = STEP_CASES[case]
    jax_case, port_case = build(lik, engine, sparse, **kw)
    replay(jax_case, port_case, STEPS, check=states_close)


def test_psd_step_halves_alpha(monkeypatch):
    """A step large enough (sgd(3.0, 0.9), dense quadrature) that Sigma +
    dSigma has no Cholesky factor: the PSD search takes a rung k >= 2
    (alpha = 2^-k) on some step, and mu and Sigma follow the reference's
    at rtol 1e-8 after each of 10 steps (eta by ``eta_close``)."""
    rungs = []
    psd_apply = tnv.psd_apply

    def recorded(S, dS, lazy=False):
        out, k = psd_apply(S, dS, lazy)
        rungs.append(int(k.max()))
        return out, k

    monkeypatch.setattr(tnv, "psd_apply", recorded)

    def check(st, sj, i):
        for field in ("mu", "Sigma"):
            close(getattr(st, field), getattr(sj, field), msg=f"step {i}: {field}")
        eta_close(st, sj, i)

    replay(*build("logistic", "quad", False, lr=3.0), STEPS, check=check)
    assert max(rungs) >= 2, rungs


def test_psd_apply_rungs():
    """psd_apply on a batch of 3: a PD step (rung 0), one PD only at
    alpha = 1/4 (rung 2) and one never PD (Sigma kept, rung 27), the lazy
    form equal to the batch and reading the host once."""
    from agp_tpu_torch.utils.tensors import host_read

    S = torch.eye(2, dtype=torch.float64).expand(3, 2, 2).clone()
    dS = torch.stack([0.5 * torch.eye(2), -3.5 * torch.eye(2), -torch.eye(2) * 1e12]).double()
    dS[2, 0, 0] = 1.0
    out, rungs = tnv.psd_apply(S, dS)
    assert rungs.tolist() == [0, 2, tnv.PSD_RUNGS]
    close(out[0], 1.5 * torch.eye(2), rtol=0, atol=0)
    close(out[1], 0.125 * torch.eye(2), rtol=0, atol=0)
    close(out[2], S[2], rtol=0, atol=0)
    reads = host_read.reads
    lazy, lazy_rungs = tnv.psd_apply(S, dS, lazy=True)
    close(lazy, out, rtol=0, atol=0)
    assert lazy_rungs.tolist() == rungs.tolist()
    assert host_read.reads == reads + 1
    lazy, lazy_rungs = tnv.psd_apply(S[:1], dS[:1], lazy=True)
    close(lazy, out[:1], rtol=0, atol=0)
    assert lazy_rungs.tolist() == [0]


# ------------------------------------------------------------------- ELBO
def jax_neg_elbo_and_grad(mj, sj, xb, yb):
    """The reference's neg_elbo (training/autotuning.py) and its jax.grad
    with respect to the log kernel and the mean, under one jit."""
    def neg_elbo(log_k, mean):
        m2 = jax_rebuild(mj, log_k, mean, None)
        return -jax_objective(m2, sj, xb, yb, kmat=jax_kmat(m2, xb))

    return jax.jit(jax.value_and_grad(neg_elbo, argnums=(0, 1)))(jax_to_unconstrained(mj.kernel), mj.mean)


@pytest.mark.parametrize("case", ["svgp_quad_logistic", "svgp_mc_softmax", "vgp_quad_laplace"])
def test_numerical_elbo_and_hyper_gradient(case, monkeypatch):
    """After 2 replayed steps: the numerical ELBO on the last step's batch
    and the gradient of -ELBO that ``hyper_step`` takes (log kernel
    parameters) against the reference's ELBO and ``jax.grad`` of its
    ``neg_elbo``, rtol 1e-8 (atol 1e-10).  The Monte Carlo ELBO's fixed
    draws (the reference's PRNGKey(7)) are fed to the port in place of its
    seed-7 generator's."""
    lik, engine, sparse, kw = STEP_CASES[case]
    jax_case, port_case = build(lik, engine, sparse, **kw)
    (mj, sj, Xj, yj), (mt, st, Xt, yt) = replay(jax_case, port_case, 2)
    rows = slice(B, 2 * B) if sparse else slice(None)
    xj, yjb, xt, ytb = Xj[rows], yj[rows], Xt[rows], yt[rows]
    if engine == "mc":
        shape = (NMC, mj.n_latent, xj.shape[0])
        eps7 = t64(jax.random.normal(jax.random.PRNGKey(7), shape, dtype=jnp.float64))
        monkeypatch.setattr(tnv, "default_elbo_draws", lambda inf, mu_f: eps7)
    neg_e_j, g_j = jax_neg_elbo_and_grad(mj, sj, xj, yjb)
    close(agt.elbo(mt, st, xt, ytb), -float(neg_e_j), rtol=1e-8, msg="ELBO")
    _, g_k, _, _ = autotuning.hyper_gradients(mt, st, xt, ytb)
    for field in ("lengthscale", "variance"):
        close(g_k[field], getattr(g_j[0], field), rtol=1e-8, atol=1e-10, msg=field)


# ------------------------------------------------------------ small modules
def test_sgd_matches_optax():
    """5 updates of a tuple (a vector, a matrix) with the same gradients:
    the updates and the traces equal optax.sgd's at rtol 1e-12, with and
    without momentum."""
    rng = np.random.default_rng(4)
    for lr, momentum in ((1e-3, 0.9), (0.1, 0.0)):
        params = (rng.normal(size=3), rng.normal(size=(2, 2)))
        opt_j, opt_t = optax.sgd(lr, momentum=momentum), agt.sgd(lr, momentum)
        s_j = opt_j.init(tuple(jnp.asarray(p) for p in params))
        s_t = opt_t.init(tuple(t64(p) for p in params))
        for _ in range(5):
            g = tuple(rng.normal(size=p.shape) for p in params)
            u_j, s_j = opt_j.update(tuple(jnp.asarray(a) for a in g), s_j)
            u_t, s_t = opt_t.update(tuple(t64(a) for a in g), s_t)
            for a, b in zip(u_t, u_j):
                close(a, b, rtol=1e-12, atol=0, msg="update")
            if momentum:
                for a, b in zip(s_t, s_j[0].trace):
                    close(a, b, rtol=1e-12, atol=0, msg="trace")


def test_moments_to_nat_and_special_functions():
    """moments_to_nat against the reference's (rtol 1e-12) and the inverse
    of nat_to_moments; sqrt_expec_square_diff and besselk_half (orders
    1/2 .. 7/2) against the reference's at rtol 1e-12."""
    rng = np.random.default_rng(5)
    A = rng.normal(size=(2, 5, 5))
    Sigma, mu = A @ A.transpose(0, 2, 1) / 5 + np.eye(5), rng.normal(size=(2, 5))
    e1, e2 = linalg.moments_to_nat(t64(mu), t64(Sigma))
    j1, j2 = jax.vmap(jlinalg.moments_to_nat)(jnp.asarray(mu), jnp.asarray(Sigma))
    close(e1, j1, rtol=1e-12, atol=0)
    close(e2, j2, rtol=1e-12, atol=0)
    m2, S2 = linalg.nat_to_moments(e1, e2)
    close(m2, mu, rtol=1e-10)
    close(S2, Sigma, rtol=1e-10)
    x, y, v = rng.normal(size=7), rng.normal(size=7), rng.uniform(0.1, 1.0, size=7)
    close(special.sqrt_expec_square_diff(t64(x), t64(v), t64(y)),
          jspecial.sqrt_expec_square_diff(jnp.asarray(x), jnp.asarray(v), jnp.asarray(y)), rtol=1e-12, atol=0)
    z = rng.uniform(0.1, 5.0, size=7)
    for n in range(4):
        close(special.besselk_half(n, t64(z)), jspecial.besselk_half(n, jnp.asarray(z)), rtol=1e-12, atol=0,
              msg=f"K_{n}+1/2")


# --------------------------------------------------- through the public API
@pytest.mark.parametrize("make", [
    lambda: agt.QuadratureVI(n_points=NPTS, optimiser=agt.sgd(1e-3, 0.9)),
    lambda: agt.QuadratureSVI(B, n_points=NPTS, optimiser=agt.sgd(1e-3, 0.9)),
    lambda: agt.MCIntegrationVI(n_mc=NMC),
    lambda: agt.MCIntegrationSVI(B, n_mc=NMC),
    lambda: agt.NumericalVI("quad", n_points=NPTS),
    lambda: agt.NumericalSVI(B, "mc", n_mc=NMC),
], ids=["QuadratureVI", "QuadratureSVI", "MCIntegrationVI", "MCIntegrationSVI", "NumericalVI", "NumericalSVI"])
def test_numerical_engines_train_through_public_api(make):
    """Each configuration trains an SVGP (logistic, or softmax under Monte
    Carlo) through ``agt.train`` for 5 iterations with the default Adam on
    the kernel, and a VGP when full-batch: finite, the lengthscale moved,
    the ELBO finite; the defaults are the reference's."""
    inf = make()
    mc = inf.name == "MCIntegrationVI"
    if mc:
        X, y = multiclass_data(N, D, K)
    else:
        X, _, y = single_latent_data("logistic", N, D)
    lik = agt.SoftMaxLikelihood.create(K) if mc else agt.LogisticLikelihood.create()
    X = t64(X)
    models = [agt.SVGP.create(agt.SqExponentialKernel(), lik, inf, X[:M])]
    if not inf.stochastic:
        models.append(agt.VGP.create(X, y, agt.SqExponentialKernel(), lik, inf))
    for model in models:
        model, state = agt.train(model, X, y, iterations=5)
        assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()
        assert float(model.kernel.lengthscale.reshape(-1)[0]) != 1.0
        assert np.isfinite(float(agt.elbo(model, state, X, model.likelihood.treat_labels(y)[0])))
    ref = {"QuadratureVI": (agp.QuadratureVI(), "n_points", 100), "MCIntegrationVI": (agp.MCIntegrationVI(), "n_mc", 1000)}
    ref_inf, field, default = ref[inf.name]
    port_default = getattr(agt, inf.name)()
    assert getattr(port_default, field) == getattr(ref_inf, field) == default
    assert (port_default.clipping, port_default.natural) == (ref_inf.clipping, ref_inf.natural) == (0.0, True)
    assert agt.MCIntegrationSVI(4).n_mc == agp.MCIntegrationSVI(4).n_mc == 200


def test_softmax_likelihood_matches_jax():
    """SoftMaxLikelihood's labels, link, log_prob and compute_proba (plug-in,
    and Monte Carlo from the reference's normals) against the reference's
    at rtol 1e-12; its engines are MCIntegrationVI and HMCSampling, and an
    MCGP samples it by NUTS."""
    rng = np.random.default_rng(6)
    _, labels = multiclass_data(B, D, K)
    lj, lt = agp.SoftMaxLikelihood.create(K), agt.SoftMaxLikelihood.create(K)
    yj, lj = lj.treat_labels(labels)
    yt, lt = lt.treat_labels(labels)
    close(yt, yj, rtol=0, atol=0)
    assert lt.class_mapping == lj.class_mapping and lt.implemented() == lj.implemented()
    mu, var = rng.normal(size=(K, B)), rng.uniform(0.05, 0.5, size=(K, B))
    close(lt.link(t64(mu)), lj.link(jnp.asarray(mu)), rtol=1e-12, atol=0)
    close(lt.log_prob(yt.T, t64(mu)), lj.log_prob(jnp.asarray(yj).T, jnp.asarray(mu)), rtol=1e-12, atol=0)
    close(lt.compute_proba(t64(mu), t64(var)), lj.compute_proba(jnp.asarray(mu), jnp.asarray(var)), rtol=1e-12)
    key = jax.random.PRNGKey(8)
    pj = lj.compute_proba(jnp.asarray(mu), jnp.asarray(var), n_samples=50, key=key)
    eps = t64(jax.random.normal(key, (50, K, B), dtype=jnp.float64))
    f = t64(mu)[None] + torch.sqrt(t64(var))[None] * eps
    close(torch.mean(lt.link(f.transpose(0, 1)), dim=1).T, pj, rtol=1e-12)
    assert lt.compute_proba(t64(mu), t64(var), n_samples=50, generator=torch.Generator().manual_seed(0)).shape == (B, K)
    X, labels = multiclass_data(12, D, K)
    mc = agt.MCGP.create(t64(X), labels, agt.SqExponentialKernel(), lt, agt.HMCSampling(n_burnin=5, max_depth=3))
    s = agt.sample(mc, 5, generator=torch.Generator().manual_seed(0))
    assert s.shape == (5, K, 12) and torch.isfinite(s).all()


# ------------------------------------------- ROADMAP queue 3 item 11
# path 30's state on the card (float32) just before its first step after
# which eta or Sigma's sgd trace held a non-finite value, with that step's
# minibatch indices (chip_smoke.py phase 30, ``path30_first_nonfinite``)
PATH30_STATE = Path(__file__).resolve().parent / "data" / "path30_first_nonfinite.npz"


def path30_step(d):
    """One float32 step of each package on the CPU from the dumped state,
    on the dumped minibatch of path 30's data (``chip_smoke.flagship_data``,
    N=200,000, D=20; the reference's ``variational_update`` takes the
    minibatch directly, as its ``_vi_steps`` would after drawing it): the
    JAX (model, state) after it and the port's."""
    X, y = chip_smoke.flagship_data("cpu")
    idx = torch.as_tensor(d["idx"].astype(np.int64))
    xb, yb = X[idx], y[idx]
    ls, var = (float(d[k].reshape(-1)[0]) for k in ("lengthscale", "variance"))
    Z, trace = d["Z"][0], (d["opt_0"], d["opt_1"])
    kj = agp.SqExponentialKernel(lengthscale=jnp.asarray(ls, jnp.float32), variance=jnp.asarray(var, jnp.float32))
    mj = agp.SVGP.create(kj, agp.LogisticLikelihood.create(),
                         agp.QuadratureSVI(4096, n_points=100, optimiser=optax_sgd(1e-3)), jnp.asarray(Z),
                         optimiser=None)
    sj = jax_init_state(mj, jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy()))
    opt = (sj.opt_state[0]._replace(trace=tuple(jnp.asarray(t) for t in trace)),) + tuple(sj.opt_state[1:])
    sj = sj.replace(mu=jnp.asarray(d["mu"]), Sigma=jnp.asarray(d["Sigma"]), rho=jnp.asarray(d["rho"]), opt_state=opt)
    out_j = jax.jit(jnv.variational_update)(mj, sj, jnp.asarray(xb.numpy()), jnp.asarray(yb.numpy()))
    kt = agt.SqExponentialKernel(lengthscale=torch.tensor(ls), variance=torch.tensor(var))
    mt = agt.SVGP.create(kt, agt.LogisticLikelihood.create(),
                         agt.QuadratureSVI(4096, n_points=100, optimiser=agt.sgd(1e-3, 0.9)), torch.as_tensor(Z),
                         optimiser=None)
    st = agt.init_state(mt, xb, yb).replace(mu=torch.as_tensor(d["mu"]), Sigma=torch.as_tensor(d["Sigma"]),
                                            rho=torch.as_tensor(d["rho"]),
                                            opt_state=tuple(torch.as_tensor(t) for t in trace))
    return out_j, tnv.variational_update(mt, st, xb, yb), st


def finite(*arrays):
    return all(bool(np.isfinite(np.asarray(a)).all()) for a in arrays)


def test_path30_nonfinite_step_is_the_references():
    """ROADMAP queue 3 item 11, kept on purpose: path 30's float32 step on
    the card from the state dumped just before it (``PATH30_STATE``, step
    65 on the eager and the captured loop alike) left eta non-finite.
    From that state one float32 step of each package on the CPU, on that
    step's minibatch, stays finite, and the two agree with each other and
    with the card's step within float32's noise (mu within 1e-5 of its
    largest entry, Sigma within 1e-5).  Sigma is singular to float32
    before the step and after it on the card (its smallest eigenvalue
    within 1e-7 of its largest, either sign), so whether a float32
    Cholesky factor of it exists is rounding: the reference's own
    ``moments_to_nat`` on the card's step, (mu, Sigma) as the card left
    them, gives a NaN eta too, as the card's does (both factor the
    symmetrized Sigma and put NaN where the factor fails).  The card's NaN
    is the reference's behaviour met on the card's rounding."""
    d = np.load(PATH30_STATE)
    (_, sj), (_, st), _ = path30_step(d)
    assert finite(sj.eta1, sj.eta2, *sj.opt_state[0].trace)
    assert finite(st.eta1.numpy(), st.eta2.numpy(), *[t.numpy() for t in st.opt_state])
    scale = float(np.abs(d["after_mu"]).max())
    for a, b in ((np.asarray(sj.mu), st.mu.numpy()), (np.asarray(sj.mu), d["after_mu"]), (st.mu.numpy(), d["after_mu"])):
        assert float(np.abs(a - b).max()) <= 1e-5 * scale
    for a, b in ((np.asarray(sj.Sigma), st.Sigma.numpy()), (np.asarray(sj.Sigma), d["after_Sigma"])):
        assert float(np.abs(a - b).max()) <= 1e-5
    for S in (d["Sigma"][0], d["after_Sigma"][0]):
        ev = np.linalg.eigvalsh(S.astype(np.float64))
        assert abs(ev.min()) <= 1e-7 * ev.max()
    assert not finite(d["after_eta1"]) and not bool(d["after_eta2_finite"])
    eta1, eta2 = jax.vmap(jlinalg.moments_to_nat)(jnp.asarray(d["after_mu"]), jnp.asarray(d["after_Sigma"]))
    assert not finite(eta1) and not finite(eta2)
