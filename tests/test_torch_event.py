"""The port's count likelihoods (Poisson with its rate epilogue, negative
binomial) and the Bayesian SVM against the JAX package, float64: their
methods (Poisson with and without a row mask), and the stochastic-CAVI
slice (SVGP, slice sampling, fixed hyperparameters) at N=2048, D=4, M=24,
B=256 through the plain fused_cavi_stats, from identical states
(``interop``) on the JAX package's own draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import agp_tpu_torch as agt
from agp_tpu.inference.analytic_vi import variational_update as jax_variational_update
from agp_tpu.training.train import _precomputed_draws
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import (
    check_likelihood_methods,
    check_predictions_and_elbo,
    check_steps,
    close,
    jax_rm_scales,
    jax_single_latent,
    jax_svgp,
    port_from_jax,
    replay_rule,
    single_latent_data,
    slice_runs,
)

N, D, M, B, STEPS = 2048, 4, 24, 256, 10
LIKS = ("bayesiansvm", "poisson", "negbinomial")


@pytest.mark.parametrize("lik", LIKS)
def test_likelihood_methods_match_reference(lik):
    check_likelihood_methods(lik)


def test_weighted_poisson_rate_matches_reference():
    """Poisson's local_updates with a row mask w: the rate's closed form
    sums over the rows with w = 1 only, as the reference's does (the mask
    reaches the likelihood through _weighted_params); rtol 1e-10."""
    w = (np.random.default_rng(3).uniform(size=64) > 0.3).astype(float)
    lt, lj = check_likelihood_methods("poisson", w=w)
    unmasked, _ = check_likelihood_methods("poisson")
    assert abs(float(lt.lam) - float(unmasked.lam)) > 1e-3 * float(unmasked.lam)


@pytest.fixture(scope="module", params=LIKS)
def runs(request):
    return slice_runs(request.param, N, D, M, B, STEPS)


def test_steps_match_reference(runs):
    """10 steps: eta, mu, Sigma, the local variables (Poisson's gamma from
    the fused pass's epilogue) and Poisson's lambda after each, rtol 1e-8;
    the port through its plain fused pass, the reference through its
    unfused XLA path."""
    check_steps(runs)


def test_predictions_and_elbo_match_reference(runs):
    check_predictions_and_elbo(runs, D)


def jax_poisson(seed, lengthscale=2.0):
    X, _, y = single_latent_data("poisson", N, D, seed)
    return jax_svgp(X, y, M, B, sampling="slice", lengthscale=lengthscale, likelihood=jax_single_latent("poisson"))


def test_masked_poisson_step_matches_reference():
    """A step with rows masked out (w = 0), as the reference's padded
    drivers take it: the unfused path on both sides, lambda from the
    unmasked rows; rtol 1e-8."""
    mj, sj, Xj, yj = jax_poisson(seed=5)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    w = (np.random.default_rng(5).uniform(size=B) > 0.25).astype(float)
    mj, sj = jax_variational_update(mj, sj, Xj[:B], yj[:B], w=jnp.asarray(w))
    mt, st = tav.variational_update(mt, st, Xt[:B], yt[:B], w=torch.as_tensor(w))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    close(mt.likelihood.lam, mj.likelihood.lam, msg="lam")


def test_unfused_path_matches_fused():
    """With all weights 1 the unfused path (local_updates) gives the fused
    pass's step, its gamma and its lambda epilogue.  rtol 1e-10."""
    mj, sj, Xj, yj = jax_poisson(seed=4)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    xb, yb = Xt[:B], yt[:B]
    m_fused, s_fused = tav.variational_update(mt, st, xb, yb)
    m_plain, s_plain = tav.variational_update(mt, st, xb, yb, w=torch.ones(B, dtype=torch.float64))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(s_fused, name), getattr(s_plain, name), rtol=1e-10, msg=name)
    for name in ("c", "theta", "gamma"):
        close(s_fused.local_vars[name], s_plain.local_vars[name], rtol=1e-10, msg=name)
    close(m_fused.likelihood.lam, m_plain.likelihood.lam, rtol=1e-10, msg="lam")


def test_steps_match_fused_pallas_interpret(monkeypatch):
    """Two Poisson steps with the reference forced through its fused Pallas
    kernel and its rate epilogue (AGP_TPU_PALLAS=1, TPU interpret mode), at
    tests/test_pallas.py's tolerances for that path: mu, Sigma rtol 1e-2 /
    atol 1e-4; theta, c, gamma rtol 1e-3 / atol 1e-5; lambda rtol 1e-4.
    Lengthscale 1, as there: the kernel's bf16-split dots grow with
    cond(Kmm)."""
    mj, sj, Xj, yj = jax_poisson(seed=3, lengthscale=1.0)
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
    for name in ("theta", "c", "gamma"):
        close(st.local_vars[name], sj.local_vars[name], rtol=1e-3, atol=1e-5, msg=name)
    close(mt.likelihood.lam, mj.likelihood.lam, rtol=1e-4, msg="lam")


@pytest.mark.parametrize("lik", ["poisson", "negbinomial"])
def test_count_labels_are_checked(lik):
    cls = {"poisson": agt.PoissonLikelihood, "negbinomial": agt.NegBinomialLikelihood}[lik]
    with pytest.raises(ValueError, match="non-negative integers"):
        cls().treat_labels(np.array([0.0, 1.5, 2.0]))
    with pytest.raises(ValueError, match="non-negative integers"):
        cls().treat_labels(torch.tensor([0, -1, 2]))
    y, _ = cls().treat_labels(torch.tensor([0, 3, 2]))
    assert y.dtype == torch.float64 and y.tolist() == [0.0, 3.0, 2.0]


def test_lambda_lives_on_the_model_device_and_dtype():
    Z = torch.zeros((4, 2), dtype=torch.float32)
    model = agt.SVGP.create(agt.Matern12Kernel(), agt.PoissonLikelihood.create(3.0), agt.AnalyticSVI(8), Z,
                            optimiser=None)
    lam = model.likelihood.lam
    assert lam.dtype == torch.float32 and lam.ndim == 0 and float(lam) == 3.0
    assert tav._fused_spec(model)[:2] == ("matern12", "poisson")


def test_train_through_public_api():
    """agt.train with the port's own generator and Robbins-Monro rule on
    the reference's Poisson oracle at N=2048 (rate 20 sigma(f), f the 2-D
    oracle function), M=32, B=256, 150 steps: corr(predict_y, rate) is
    0.9588 here (lambda 13.82), where the JAX package's own train, on its
    own draws, reaches 0.9675 (lambda 14.31); lambda stays finite."""
    rng = np.random.default_rng(8)
    X = rng.uniform(-2, 2, size=(N, 2))
    rate = 20.0 / (1.0 + np.exp(-(np.sin(2 * X[:, 0]) + 0.5 * X[:, 1])))
    X, y = torch.as_tensor(X), torch.as_tensor(rng.poisson(rate))
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.PoissonLikelihood.create(10.0),
                            agt.AnalyticSVI(B, minibatch_sampling="slice"), X[:32], optimiser=None)
    model, state = agt.train(model, X, y, iterations=150, generator=torch.Generator().manual_seed(0))
    corr = float(np.corrcoef(agt.predict_y(model, state, X).numpy(), rate)[0, 1])
    assert corr > 0.9
    assert torch.isfinite(model.likelihood.lam)
