"""Slice L of the port against the JAX package, float64 on the CPU, inputs
from numpy seeds: sparse models trained with kernels outside the fused
kinds (the plain kappa, statistics on kernels 7 and 5' plain versions),
their hyperparameter gradients (a free projection, a unit Hurst index, an
affine mean), the default Adam on a transformed kernel, a multi-output, a
quadrature and a dense step with such kernels, ``alrsvi``, the new means,
the metrics, a JAX checkpoint of a transformed-kernel model, the plots'
line data, the profiling helpers, the grand tour and the modules' imports."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agp_tpu as agp
import agp_tpu.training.train as jtrain
import agp_tpu_torch as agt
from agp_tpu import kernels as jk
from agp_tpu import means as jm
from agp_tpu.inference.objective import objective as jax_objective
from agp_tpu.models import multioutput as jmo
from agp_tpu.training.autotuning import _kmat as jax_kmat
from agp_tpu.training.autotuning import _rebuild as jax_rebuild
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu.utils import metrics as jmetrics
from agp_tpu.utils.opt import alrsvi as jax_alrsvi
from agp_tpu_torch import kernels as tk
from agp_tpu_torch import means as tm
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.interop import state_from_numpy
from agp_tpu_torch.models import multioutput as tmo
from agp_tpu_torch.training import autotuning
from agp_tpu_torch.training import train as ttrain
from agp_tpu_torch.utils import metrics as tmetrics
from agp_tpu_torch.utils.tensors import path_leaves
from torch_helpers import (
    check_steps, close, jax_kernel_leaves, jax_mo, jax_mo_treat, logistic_data, mo_close, multiclass_data,
    port_from_jax, port_kernel, port_lik_same_params, port_mo, replay_steps, state_arrays, toy,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def path42_kernel(lib, d, q=2):
    """``chip_smoke.py``'s path-42 kernel at D=d: a [q, d] projection (numpy
    seed 4, scaled 1/sqrt(d)) under a squared exponential, plus a linear
    kernel of variance 0.1."""
    A0 = np.random.default_rng(4).normal(size=(q, d)) / np.sqrt(d)
    arr = jnp.asarray if lib is jk else t64
    return lib.with_transform(lib.SqExponentialKernel(), lib.LinearTransform(A=arr(A0))) + lib.LinearKernel(
        variance=arr(0.1))


def jax_model(X, y, kernel, likelihood, M, B=None, sampling="slice", inference=None, **create):
    """A JAX SVGP (float64) with ``kernel`` on Z = X[:M], stochastic on
    batches of B unless B is None, fixed hyperparameters unless ``create``
    names an optimiser: (model, state, X, y) with the labels treated."""
    Xj = jnp.asarray(X)
    if inference is None:
        inference = agp.AnalyticVI() if B is None else agp.AnalyticSVI(B, minibatch_sampling=sampling)
    model = agp.SVGP.create(kernel, likelihood, inference, Xj[:M], **{"optimiser": None, **create})
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    yj = jnp.asarray(y2, Xj.dtype)
    return model, jax_init_state(model, Xj, yj), Xj, yj


def step_case(name, sampling="block"):
    if name == "path42":
        X, y = logistic_data(1024, 6, seed=0)
        return jax_model(X, y, path42_kernel(jk, 6), agp.LogisticLikelihood.create(), 32, 128, sampling), 6
    X, y = multiclass_data(1024, 4, 3, seed=0)
    return jax_model(X, y, jk.RationalQuadraticKernel(alpha=jnp.asarray(2.0)), agp.LogisticSoftMaxLikelihood.create(3),
                     32, 128, "slice"), 4


@pytest.fixture(scope="module")
def path42_runs():
    (mj, sj, Xj, yj), D = step_case("path42")
    return replay_steps(mj, sj, Xj, yj, 10), D


def test_path42_cavi_steps_match_reference(path42_runs):
    """10 block-sampled CAVI steps of path 42's model (a projection under a
    squared exponential plus a linear kernel; the plain kappa, kernel 7's
    plain version) from identical states on the reference's minibatch
    indices: eta, mu, Sigma and the local variables after every step at
    rtol 1e-8, then predict_f and predict_y."""
    runs, D = path42_runs
    check_steps(runs)
    mj, sj, Xj, _, _ = runs["jax"]
    mt, st, Xt, _ = runs["port"]
    mu_j, var_j = agp.predict_f(mj, sj, Xj[:200], cov=True)
    mu_t, var_t = agt.predict_f(mt, st, Xt[:200], cov=True)
    close(mu_t, mu_j, rtol=1e-8, msg="predict_f mean")
    close(var_t, var_j, rtol=1e-8, msg="predict_f var")
    close(agt.predict_y(mt, st, Xt[:200]), agp.predict_y(mj, sj, Xj[:200]), rtol=0, msg="predict_y")


def test_rq_multiclass_cavi_steps_match_reference():
    """10 slice-sampled CAVI steps of a 3-class logistic-softmax model with
    the rational-quadratic kernel (the plain kappa for 3 latents, kernel
    5's plain version) at rtol 1e-8."""
    (mj, sj, Xj, yj), _ = step_case("rq_multiclass")
    check_steps(replay_steps(mj, sj, Xj, yj, 10))


GRAD_CASES = ["path42", "fbm_sum", "affine_mean"]


def grad_case(name):
    X, y = logistic_data(1024, 6, seed=2)
    if name == "path42":
        return jax_model(X, y, path42_kernel(jk, 6), agp.LogisticLikelihood.create(), 32, 128)
    if name == "fbm_sum":
        # inputs on a grid of quarters: every squared distance is exact in
        # float64, so a coincident point's (Kmm's diagonal, Z's own rows in
        # a batch) is exactly 0 in both packages; with rounding there
        # (~1e-16), ** h makes it ~1e-5 in either, by its summation order
        X = np.random.default_rng(2).integers(-8, 9, size=(1024, 6)) / 4.0
        y = np.where(X @ np.random.default_rng(3).normal(size=6) > 0, 1.0, -1.0)
        kern = jk.FBMKernel(hurst=jnp.asarray(0.3)) + jk.SqExponentialKernel(lengthscale=jnp.asarray(2.0))
        return jax_model(X, y, kern, agp.LogisticLikelihood.create(), 32, 128)
    mean = jm.AffineMean(w=jnp.asarray(np.linspace(-0.2, 0.3, 6)), b=jnp.asarray(0.1))
    return jax_model(X, y, jk.Matern52Kernel(lengthscale=jnp.asarray(2.0)), agp.LogisticLikelihood.create(), 32, 128,
                     mean=mean)


@pytest.mark.parametrize("name", GRAD_CASES)
def test_hyper_gradients_match_jax_grad(name):
    """The gradient hyper_step takes, by path (a projection A updated as it
    is, a Hurst index through its logit, the positive leaves in log space)
    and the affine mean's, against jax.grad of the reference's neg_elbo on
    the same float64 state and batch after 2 replayed steps, rtol 1e-8
    (atol 1e-10)."""
    mj, sj, Xj, yj = grad_case(name)
    runs = replay_steps(mj, sj, Xj, yj, 2)
    mj, sj, Xj, yj, idx = runs["jax"]
    mt, st, Xt, yt = runs["port"]
    start, B = int(idx[-1]), 128
    xb, yb = Xj[start:start + B], yj[start:start + B]

    def neg_elbo(log_k, mean):
        m2 = jax_rebuild(mj, log_k, mean, None)
        return -jax_objective(m2, sj, xb, yb, kmat=jax_kmat(m2, xb))

    g_k_j, g_m_j = jax.jit(jax.grad(neg_elbo, argnums=(0, 1)))(jk.to_unconstrained(mj.kernel), mj.mean)
    _, g_k, g_m, _ = autotuning.hyper_gradients(mt, st, Xt[start:start + B], yt[start:start + B])
    ref = jax_kernel_leaves(g_k_j)
    assert list(g_k) == list(ref)
    for p in ref:
        close(g_k[p], ref[p], rtol=1e-8, atol=1e-10, msg=p)
    assert set(g_m) == ({"w", "b"} if name == "affine_mean" else set())
    for k in g_m:
        close(g_m[k], getattr(g_m_j, k), rtol=1e-8, atol=1e-10, msg=f"mean {k}")


@pytest.fixture(scope="module")
def adam_runs():
    """tests/test_components.py::test_transformed_kernel_hyperopt's model
    (numpy data: X [64, 3], y = sin 2x_0 + 0.3 x_2 + 0.05 eps; A0 as
    there) with the default Adam(0.01), atfrequency 2, 10 iterations in
    both packages from identical states: (model, state) after every CAVI
    and hyperparameter step."""
    rng = np.random.default_rng(7)
    X = rng.normal(size=(64, 3))
    y = np.sin(2.0 * X[:, 0]) + 0.3 * X[:, 2] + 0.05 * rng.normal(size=64)
    A0 = np.asarray([[1.0, 0.2, -0.3], [0.0, 1.0, 0.5]])
    kj = jk.with_transform(jk.SqExponentialKernel(), jk.LinearTransform(A=jnp.asarray(A0)))
    mj = agp.SVGP.create(kj, agp.GaussianLikelihood.create(), agp.AnalyticVI(), jnp.asarray(X[:16]), atfrequency=2)
    mt = agt.SVGP.create(port_kernel(kj), agt.GaussianLikelihood.create(), agt.AnalyticVI(), t64(X[:16]),
                         atfrequency=2)
    Xj, yj, Xt, yt = jnp.asarray(X), jnp.asarray(y), t64(X), t64(y)
    seen_j, seen_t = [], []

    def recording(fn, seen):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            seen.append(out)
            return out
        return wrapped

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jtrain, "_vi_step", recording(jtrain._vi_step, seen_j))
        mp.setattr(jtrain, "_hyper_step", recording(jtrain._hyper_step, seen_j))
        mp.setattr(ttrain.analytic_vi, "variational_update", recording(tav.variational_update, seen_t))
        mp.setattr(ttrain.autotuning, "hyper_step", recording(autotuning.hyper_step, seen_t))
        final_j = agp.train(mj, Xj, yj, iterations=10)
        final_t = agt.train(mt, Xt, yt, iterations=10)
    finally:
        mp.undo()
    return list(zip(seen_j, seen_t)) + [(final_j, final_t)], A0


def test_transformed_kernel_adam_matches_reference(adam_runs):
    """After every CAVI and hyperparameter step of the 10 iterations (3
    hyperparameter steps): every kernel leaf by path, eta, mu and Sigma at
    rtol 1e-7 (atol 1e-10); A moved, the lengthscale positive; the Adam
    moments keyed by path in the reference's flatten order."""
    seen, A0 = adam_runs
    assert len(seen) == 10 + 3 + 1
    for i, ((mj, sj), (mt, st)) in enumerate(seen):
        kw = dict(rtol=1e-7, atol=1e-10)
        ref = jax_kernel_leaves(mj.kernel)
        got = path_leaves(mt.kernel)
        assert list(got) == list(ref)
        for p in ref:
            close(got[p], ref[p], msg=f"{i}: {p}", **kw)
        for name in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, name), getattr(sj, name), msg=f"{i}: {name}", **kw)
    (mj, sj), (mt, st) = seen[-1]
    assert float(np.abs(np.asarray(mt.kernel.transform.A[0]) - A0).max()) > 1e-6
    assert float(mt.kernel.inner.lengthscale.reshape(-1)[0]) > 0
    assert list(st.hyper_state["kernel"]["mu"]) == list(jax_kernel_leaves(sj.hyper_state["kernel"][0].mu))


def test_multioutput_quadrature_and_dense_steps_with_other_kernels():
    """One step each, at rtol 1e-8: a MOSVGP (Q=2) with the rational-
    quadratic kernel (the plain kappa for both latents, kernel 5's plain
    version), a quadrature-VI SVGP and a dense Student-t VGP with path 42's
    kernel."""
    X, f = toy(200, seed=3)
    ys = (f + 0.1 * np.random.default_rng(4).normal(size=200), np.sign(f))
    mj = jax_mo(X, (agp.GaussianLikelihood.create(0.1), agp.LogisticLikelihood.create()), 12, 2,
                kernel=jk.RationalQuadraticKernel(alpha=jnp.asarray(2.0)))
    mj, ysj = jax_mo_treat(mj, ys)
    sj = jmo.mo_init_state(mj, jnp.asarray(X), ysj)
    mt, st = port_mo(mj, sj)
    ys_t = tuple(t64(y) for y in ysj)
    m2j, s2j = jmo.mo_variational_update(mj, sj, jnp.asarray(X), ysj)
    m2t, s2t = tmo.mo_variational_update(mt, st, t64(X), ys_t)
    mo_close(m2t, s2t, m2j, s2j, 1e-8, msg="mosvgp: ")

    Xl, yl = logistic_data(256, 4, seed=6)
    eng_j = agp.QuadratureVI(n_points=20, optimiser=optax.sgd(1e-3, momentum=0.9))
    mj, sj, Xj, yj = jax_model(Xl, yl, path42_kernel(jk, 4), agp.LogisticLikelihood.create(), 16, inference=eng_j)
    mt = agt.SVGP.create(path42_kernel(tk, 4), agt.LogisticLikelihood.create(),
                         agt.QuadratureVI(n_points=20, optimiser=agt.sgd(1e-3, 0.9)), t64(Xj[:16]), optimiser=None)
    arrays = state_arrays(sj)
    arrays["opt_state"] = tuple(np.array(a) for a in sj.opt_state[0].trace)
    st = state_from_numpy(arrays, "cpu", torch.float64)
    mj, sj = jtrain._vi_steps(mj, sj, Xj, yj, 1)
    mt, st = ttrain.vi_steps(mt, st, t64(Xj), t64(yj), 1)
    for name in ("mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), rtol=1e-8, msg=f"quadrature: {name}")

    Xv, fv = toy(80, seed=8)
    yv = fv + 0.1 * np.random.default_rng(9).normal(size=80)
    vj = agp.VGP.create(jnp.asarray(Xv), yv, path42_kernel(jk, 2), agp.StudentTLikelihood.create(4.0), agp.AnalyticVI(),
                        optimiser=None)
    vt = agt.VGP.create(t64(Xv), t64(yv), path42_kernel(tk, 2), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                        optimiser=None)
    vj, svj = agp.train(vj, iterations=1)
    vt, svt = agt.train(vt, iterations=1)
    for name in ("eta1", "eta2", "mu", "Sigma"):
        ref = np.array(getattr(svj, name))
        # eta holds K^-1 over the 80 training inputs (entries ~4e3): its
        # small entries carry the inverse's rounding, so normwise
        close(getattr(svt, name), ref, rtol=1e-8, atol=1e-8 * np.abs(ref).max(), msg=f"dense: {name}")


def test_alrsvi_steps_match_reference():
    """14 slice-sampled CAVI steps of a logistic SVGP with alrsvi() (its 10
    warm-up steps and 4 after) from identical states on the reference's
    draws: eta, mu, Sigma and the rule's state (g, h, tau, i) after every
    step at rtol 1e-8 (atol 1e-12)."""
    steps = 14
    X, y = logistic_data(1024, 6, seed=3)
    mj, sj, Xj, yj = jax_model(X, y, jk.SqExponentialKernel(lengthscale=jnp.asarray(2.0)),
                               agp.LogisticLikelihood.create(), 32,
                               inference=agp.AnalyticSVI(128, minibatch_sampling="slice", optimiser=jax_alrsvi()))
    _, idx = jtrain._precomputed_draws(mj, sj, Xj, steps)
    draws = torch.as_tensor(np.array(idx), dtype=torch.int64)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=agt.alrsvi())
    for i in range(steps):
        mj, sj = jtrain._vi_steps(mj, sj, Xj, yj, 1)
        mt, st = ttrain.vi_steps(mt, st, Xt, yt, 1, draws=draws[i:i + 1])
        for name in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, name), getattr(sj, name), rtol=1e-8, msg=f"step {i}: {name}")
        for k in ("h", "tau"):
            close(st.opt_state[k], sj.opt_state[k], rtol=1e-8, msg=f"step {i}: {k}")
        for a, b in zip(st.opt_state["g"], sj.opt_state["g"]):
            close(a, b, rtol=1e-8, msg=f"step {i}: g")
        assert int(st.opt_state["i"]) == int(sj.opt_state["i"]) == i + 1
    assert float(st.opt_state["tau"]) != 10.0  # past the warm-up, the window moved


def test_positive_ascent_matches_reference():
    """positive_ascent (an ascent step in log space) with adam and with sgd
    against the reference's with optax's, three steps, rtol 1e-12."""
    from agp_tpu.utils.opt import positive_ascent as jax_positive_ascent

    from agp_tpu_torch.utils.opt import positive_ascent

    rng = np.random.default_rng(4)
    value = rng.uniform(0.5, 2.0, size=3)
    grads = rng.normal(size=(3, 3))
    for opt_j, opt_t in ((optax.adam(0.05), agt.adam(0.05)), (optax.sgd(0.1), agt.sgd(0.1))):
        vj, vt = jnp.asarray(value), t64(value)
        sj, st = opt_j.init(vj), opt_t.init(vt)
        for g in grads:
            sj, vj = jax_positive_ascent(opt_j, sj, vj, jnp.asarray(g))
            st, vt = positive_ascent(opt_t, st, vt, t64(g))
            close(vt, vj, rtol=1e-12)


def test_means_match_reference():
    """EmpiricalMean and AffineMean's values and as_mean's coercions against
    the reference's; batch_call of replicated means; both accepted by a
    model."""
    Xh = np.random.default_rng(2).normal(size=(7, 3))
    X = t64(Xh)
    v = np.arange(7.0)
    close(tm.EmpiricalMean(v=t64(v))(X), jm.EmpiricalMean(v=jnp.asarray(v))(jnp.asarray(Xh)), rtol=0)
    w = np.asarray([1.0, 0.0, -1.0])
    close(tm.AffineMean(w=t64(w), b=0.5)(X), jm.AffineMean(w=jnp.asarray(w), b=jnp.asarray(0.5))(jnp.asarray(Xh)),
          rtol=1e-15)
    assert isinstance(tm.as_mean(2.0), tm.ConstantMean) and isinstance(tm.as_mean(np.zeros(4)), tm.EmpiricalMean)
    rep = tm.replicate(tm.AffineMean(w=t64(w), b=0.5), 3)
    ref = jm.batch_call(jm.replicate(jm.AffineMean(w=jnp.asarray(w), b=jnp.asarray(0.5)), 3), jnp.asarray(Xh), 3)
    close(tm.batch_call(rep, X, 3), ref, rtol=1e-15)
    close(tm.batch_call(tm.replicate(tm.EmpiricalMean(v=t64(v)), 2), X, 2), np.stack([v, v]), rtol=0)
    Z = t64(Xh[:4])
    for mean in (tm.EmpiricalMean(v=t64(np.ones(4))), tm.AffineMean(w=t64(w)), np.ones(4)):
        m = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticVI(), Z, mean=mean)
        assert tav.prior_mean_stack(m, None).shape == (1, 4)


def test_metrics_match_reference(path42_runs):
    """rmse and negative_log_predictive_density on path 42's trained models
    against the reference's on 200 of their rows at rtol 1e-8; accuracy and
    coverage (two levels) count for count."""
    runs, D = path42_runs
    mj, sj, _, _, _ = runs["jax"]
    mt, st, _, _ = runs["port"]
    Xh, yh = np.array(runs["jax"][2][:200]), np.array(runs["jax"][3][:200])
    Xj, Xt = jnp.asarray(Xh), t64(Xh)
    mu_j, var_j = agp.predict_f(mj, sj, Xj, cov=True)
    mu_t, var_t = agt.predict_f(mt, st, Xt, cov=True)
    kw = dict(rtol=1e-8, atol=1e-12)
    close(tmetrics.rmse(t64(yh), mu_t), jmetrics.rmse(yh, mu_j), **kw)
    close(tmetrics.negative_log_predictive_density(mt, st, Xt, t64(yh)),
          jmetrics.negative_log_predictive_density(mj, sj, Xj, yh), **kw)
    # the reference's means of booleans are float32: compare the counts
    counts = [(tmetrics.accuracy(t64(yh), agt.predict_y(mt, st, Xt)), jmetrics.accuracy(yh, agp.predict_y(mj, sj, Xj)))]
    counts += [(tmetrics.coverage(t64(yh), mu_t, var_t, lv), jmetrics.coverage(yh, mu_j, var_j, lv)) for lv in (0.5, 0.95)]
    for a, b in counts:
        assert round(float(a) * 200) == round(float(b) * 200)
    assert 0 < float(counts[0][0]) < 1 and 0 < float(counts[1][0]) < 1


def test_reference_checkpoint_of_a_transformed_kernel_model_resumes(tmp_path):
    """A JAX checkpoint of a transformed-kernel SVGP trained with alrsvi and
    the default Adam (4 iterations) loads onto port templates, every leaf
    bit-equal by the reference's flatten order (the kernel by path, the
    Adam moments keyed by path, alrsvi's state); 4 resumed iterations on
    the reference's draws at rtol 1e-8."""
    from agp_tpu.training import checkpoint as jckpt

    from agp_tpu_torch.interop import reference_leaf_table

    X, y = logistic_data(512, 4, seed=12)
    kj = jk.with_transform(jk.Matern32Kernel(lengthscale=jnp.asarray(1.5)),
                           jk.LinearTransform(A=jnp.asarray(np.random.default_rng(1).normal(size=(2, 4)))))
    inf_j = agp.AnalyticSVI(64, minibatch_sampling="slice", optimiser=jax_alrsvi())
    mj, sj, Xj, yj = jax_model(X, y, kj, agp.LogisticLikelihood.create(), 16, inference=inf_j,
                               optimiser=optax.adam(0.01))
    mj, sj = agp.train(mj, Xj, yj, iterations=4, state=sj)
    jckpt.save(str(tmp_path), mj, sj)
    mt = agt.SVGP.create(port_kernel(kj), agt.LogisticLikelihood.create(),
                         agt.AnalyticSVI(64, minibatch_sampling="slice", optimiser=agt.alrsvi()), t64(X[:16]),
                         optimiser=agt.adam(0.01))
    st = agt.init_state(mt, t64(X), t64(yj))
    mt, st = agt.checkpoint.load(str(tmp_path), mt, st)
    leaves = {"model": iter(jax.tree_util.tree_leaves(mj)), "state": iter(jax.tree_util.tree_leaves(sj))}
    for which, path, keys, tt in reference_leaf_table(mt, st):
        ref = np.asarray(next(leaves[which]))
        if keys is not None:
            np.testing.assert_array_equal(tt.numpy(), ref, err_msg=path)
    assert next(leaves["model"], None) is None and next(leaves["state"], None) is None
    _, idx = jtrain._precomputed_draws(mj, sj, Xj, 4)
    mj, sj = agp.train(mj, Xj, yj, iterations=4, state=sj)
    mt, st = agt.train(mt, t64(X), t64(yj), iterations=4, state=st, draws=torch.as_tensor(np.array(idx)))
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), rtol=1e-8, msg=name)
    for p, ref in jax_kernel_leaves(mj.kernel).items():
        close(path_leaves(mt.kernel)[p], ref, rtol=1e-8, msg=p)
    close(st.opt_state["tau"], sj.opt_state["tau"], rtol=1e-8)


def test_plots_line_data_match_reference():
    """plot_gp (a regression ribbon), plot_multilatent (3 latents) and
    plot_mo_gp (2 tasks) on models carried from the reference's: every
    line's data equal to the reference's plot at rtol 1e-8, on Agg."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from agp_tpu.utils import plotting as jplot

    from agp_tpu_torch.utils import plotting as tplot

    X, f = toy(120, d=1, seed=5)
    y = f + 0.1 * np.random.default_rng(5).normal(size=120)
    Xs = np.linspace(-2, 2, 50)[:, None]

    def lines_close(ax_t, ax_j, msg):
        assert len(ax_t.lines) == len(ax_j.lines) and len(ax_t.collections) == len(ax_j.collections), msg
        for lt, lj in zip(ax_t.lines, ax_j.lines):
            close(np.asarray(lt.get_xdata()), np.asarray(lj.get_xdata()), rtol=1e-12, msg=msg)
            close(np.asarray(lt.get_ydata()), np.asarray(lj.get_ydata()), rtol=1e-8, atol=1e-12, msg=msg)

    mj, sj, Xj, yj = jax_model(X, y, jk.SqExponentialKernel(), agp.GaussianLikelihood.create(0.01), 10)
    mj, sj = agp.train(mj, Xj, yj, iterations=3, state=sj)
    mt = agt.SVGP.create(agt.SqExponentialKernel(), port_lik_same_params(mj.likelihood), agt.AnalyticVI(),
                         t64(X[:10]), optimiser=None)
    st = state_from_numpy(state_arrays(sj), "cpu", torch.float64)
    lines_close(tplot.plot_gp(mt, st, t64(Xs), t64(X), t64(y)), jplot.plot_gp(mj, sj, Xs, X, y), "plot_gp")
    plt.close("all")

    Xm, ym = multiclass_data(300, 1, 3, seed=6)
    mj, sj, Xj, yj = jax_model(Xm, ym, jk.SqExponentialKernel(), agp.LogisticSoftMaxLikelihood.create(3), 12, 64)
    mj, sj = jtrain._vi_steps(mj, sj, Xj, yj, 3)
    mt, st, _, _ = port_from_jax(mj, sj, Xj, yj)
    lines_close(tplot.plot_multilatent(mt, st, t64(Xs)), jplot.plot_multilatent(mj, sj, Xs), "plot_multilatent")
    plt.close("all")

    ys = (y, np.sign(f))
    mj = jax_mo(X, (agp.GaussianLikelihood.create(0.1), agp.LogisticLikelihood.create()), 10, 2)
    mj, ysj = jax_mo_treat(mj, ys)
    sj = jmo.mo_init_state(mj, jnp.asarray(X), ysj)
    mj, sj = jmo.mo_variational_update(mj, sj, jnp.asarray(X), ysj)
    mt, st = port_mo(mj, sj)
    axes_t = tplot.plot_mo_gp(mt, st, t64(Xs), t64(X), [t64(a) for a in ys])
    axes_j = jplot.plot_mo_gp(mj, sj, Xs, X, ys)
    for i, (a, b) in enumerate(zip(axes_t, axes_j)):
        lines_close(a, b, f"plot_mo_gp task {i}")
    plt.close("all")


def test_profiling_helpers(tmp_path):
    """PhaseTimer accumulates named phases, the result's device synchronised,
    and reports them longest first; trace writes a Chrome trace."""
    from agp_tpu_torch.utils import profiling

    timer = profiling.PhaseTimer()
    for _ in range(2):
        with timer.phase("matmul") as out:
            out["result"] = (torch.ones(64, 64) @ torch.ones(64, 64), {"x": torch.zeros(2)})
    with timer.phase("nothing"):
        pass
    report = timer.report()
    assert list(report) == ["matmul", "nothing"] and report["matmul"] > 0
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0


def test_grand_tour_on_the_cpu():
    """``python3 -m agp_tpu_torch.examples.grand_tour --cpu``: all eleven
    flows pass in float64 on the CPU."""
    from agp_tpu_torch.examples import grand_tour

    ok = grand_tour.run(torch.device("cpu"), torch.float64)
    assert len(ok) == 12 and all(p for _, p in ok), ok


def test_new_modules_import_no_jax():
    """The modules this slice adds (and the kernel library) load no JAX."""
    code = ("import sys; import agp_tpu_torch.kernels, agp_tpu_torch.means, agp_tpu_torch.utils.metrics, "
            "agp_tpu_torch.utils.plotting, agp_tpu_torch.utils.profiling, agp_tpu_torch.utils.opt, "
            "agp_tpu_torch.examples.grand_tour; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'agp_tpu.'))]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]


def test_public_surface_is_complete():
    """Every name of the reference's __all__ is in the port's."""
    assert set(agp.__all__) <= set(agt.__all__), sorted(set(agp.__all__) - set(agt.__all__))
