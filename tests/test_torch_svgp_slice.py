"""The port's flagship slice as a whole against the JAX package, float64:
SVGP + SqExponentialKernel + LogisticLikelihood + AnalyticSVI, stochastic
CAVI with fixed hyperparameters, from identical states (``interop``) and on
the same minibatches (the JAX package's own indices)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference.analytic_vi import variational_update as jax_variational_update
from agp_tpu.training.train import _precomputed_draws, _tile_views, _vi_steps
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.training.train import vi_steps
from agp_tpu_torch.utils.opt import GradientTransformation
from torch_helpers import jax_rm_scales, jax_svgp, logistic_data, port_from_jax, replay_rule

N, D, M, B, STEPS = 2048, 8, 32, 256, 10


def close(port, ref, rtol=1e-8, atol=1e-12, msg=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module")
def runs():
    """10 steps of both packages, the state after each, and the port's and
    reference's final (model, state)."""
    X, y = logistic_data(N, D)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B)
    _, tidx = _precomputed_draws(mj, sj, Xj, STEPS)
    # The reference's own float32 Robbins-Monro scales: XLA's and
    # PyTorch's float32 pow differ by 1-2 ulp (test_torch_ops.py bounds the
    # port's rule), which alone moves the trajectories apart at ~1e-8.
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(STEPS)))
    draws = torch.as_tensor(np.array(tidx), dtype=torch.int64)
    per_step = []
    for i in range(STEPS):
        mj, sj = _vi_steps(mj, sj, Xj, yj, 1)
        mt, st = vi_steps(mt, st, Xt, yt, 1, draws=draws[i : i + 1])
        per_step.append((sj, st))
    return dict(per_step=per_step, jax=(mj, sj, Xj, yj, tidx), port=(mt, st, Xt, yt, draws))


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference(runs, step):
    """eta1, eta2, mu, Sigma and the local variables after each step, at
    rtol 1e-8 (atol 1e-12 for entries near zero): float64 on both sides,
    differing in the order of BLAS/LAPACK sums."""
    sj, st = runs["per_step"][step]
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    for name in ("c", "theta"):
        close(st.local_vars[name], sj.local_vars[name], msg=name)
    assert int(st.opt_state) == int(sj.opt_state) == step + 1
    assert int(st.step) == int(sj.step) == step + 1


def test_predictions_and_elbo_match_reference(runs):
    """predict_f (mean and variance), predict_y and proba_y on 200 held-out
    points, and the ELBO on the last step's minibatch (whose local
    variables the state holds), at rtol 1e-8."""
    mj, sj, Xj, yj, tidx = runs["jax"]
    mt, st, Xt, yt, draws = runs["port"]
    Xh, _ = logistic_data(200, D, seed=1)
    mu_j, var_j = agp.predict_f(mj, sj, jnp.asarray(Xh), cov=True)
    mu_t, var_t = agt.predict_f(mt, st, torch.as_tensor(Xh), cov=True)
    close(mu_t, mu_j, msg="predict_f mean")
    close(var_t, var_j, msg="predict_f var")
    close(agt.predict_f(mt, st, torch.as_tensor(Xh)), mu_j, msg="predict_f mean only")
    np.testing.assert_array_equal(
        agt.predict_y(mt, st, torch.as_tensor(Xh)).numpy(), np.asarray(agp.predict_y(mj, sj, jnp.asarray(Xh)))
    )
    close(agt.proba_y(mt, st, torch.as_tensor(Xh)), agp.proba_y(mj, sj, jnp.asarray(Xh)), msg="proba_y")
    Xtile, ytile = _tile_views(Xj, yj, 64)
    xb = np.array(Xtile[tidx[-1]]).reshape(B, D)
    yb = np.array(ytile[tidx[-1]]).reshape(B)
    e_j = float(agp.elbo(mj, sj, jnp.asarray(xb), jnp.asarray(yb)))
    e_t = float(agt.elbo(mt, st, torch.as_tensor(xb), torch.as_tensor(yb)))
    np.testing.assert_allclose(e_t, e_j, rtol=1e-8)


@pytest.mark.parametrize("sampling", ["gather", "slice"])
def test_other_sampling_modes_match_reference(sampling):
    """The "gather" and "slice" draws replayed into the port: 3 steps at
    rtol 1e-8."""
    X, y = logistic_data(N, D, seed=2)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B, sampling=sampling)
    mode, idx = _precomputed_draws(mj, sj, Xj, 3)
    assert mode == sampling
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(3)))
    mj, sj = _vi_steps(mj, sj, Xj, yj, 3)
    mt, st = vi_steps(mt, st, Xt, yt, 3, draws=torch.as_tensor(np.array(idx), dtype=torch.int64))
    close(st.mu, sj.mu, msg="mu")
    close(st.Sigma, sj.Sigma, msg="Sigma")


def test_steps_match_fused_pallas_interpret(monkeypatch):
    """Two steps with the reference forced through its fused Pallas kernel
    (AGP_TPU_PALLAS=1, TPU interpret mode), as tests/test_pallas.py runs
    it, at that test's tolerances: the kernel's bf16-split dots make the
    reference arm float32-grade."""
    X, y = logistic_data(N, D, seed=3)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B)
    _, tidx = _precomputed_draws(mj, sj, Xj, 2)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(2)))
    Xtile, ytile = _tile_views(Xj, yj, 64)
    monkeypatch.setenv("AGP_TPU_PALLAS", "1")
    vu = jax.jit(jax_variational_update)
    with pltpu.force_tpu_interpret_mode():
        for i in range(2):
            xb = Xtile[tidx[i]].reshape(B, D)
            yb = ytile[tidx[i]].reshape(B)
            mj, sj = jax.block_until_ready(vu(mj, sj, xb, yb))
    mt, st = vi_steps(mt, st, Xt, yt, 2, draws=torch.as_tensor(np.array(tidx), dtype=torch.int64))
    close(st.mu, sj.mu, rtol=1e-2, atol=1e-4, msg="mu")
    close(st.Sigma, sj.Sigma, rtol=1e-2, atol=1e-4, msg="Sigma")
    close(st.local_vars["theta"], sj.local_vars["theta"], rtol=1e-3, atol=1e-5, msg="theta")
    close(st.local_vars["c"], sj.local_vars["c"], rtol=1e-3, atol=1e-5, msg="c")


def test_unfused_path_matches_fused():
    """A row-weighted batch takes the unfused path (the single-latent split
    pair: latent_moments' fused_kappa + local_updates +
    apply_natural_gradient's cavi_stats); with all weights 1 it must give
    the fused pass's step.  rtol 1e-10: float64, K^-1 formed two ways."""
    X, y = logistic_data(N, D, seed=4)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    xb, yb = Xt[:B], yt[:B]
    assert tav._fused_spec(mt) is not None
    _, s_fused = tav.variational_update(mt, st, xb, yb)
    _, s_plain = tav.variational_update(mt, st, xb, yb, w=torch.ones(B, dtype=torch.float64))
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(s_fused, name), getattr(s_plain, name), rtol=1e-10, msg=name)
    close(s_fused.local_vars["theta"], s_plain.local_vars["theta"], rtol=1e-10)


@pytest.mark.parametrize("sampling", ["block", "gather", "slice"])
def test_generator_draws(sampling):
    """Draws from the port's own generator: one minibatch of B rows of the
    data, made of aligned 64-row tiles in "block" mode and of one contiguous
    window in "slice" mode; the same seed gives the same batch."""
    from agp_tpu_torch.training.train import _draw_batch

    X, y = logistic_data(1024, D)
    mj, sj, Xj, yj = jax_svgp(X, y, M, B, sampling=sampling)
    mt, _, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    xb, yb = _draw_batch(mt, Xt, yt, torch.Generator().manual_seed(3))
    xb2, _ = _draw_batch(mt, Xt, yt, torch.Generator().manual_seed(3))
    assert xb.shape == (B, D) and yb.shape == (B,)
    assert torch.equal(xb, xb2)
    rows = torch.cdist(xb, Xt).argmin(dim=1)
    assert torch.equal(Xt[rows], xb) and torch.equal(yt[rows], yb)
    if sampling == "block":
        starts = rows.reshape(-1, 64)
        assert torch.equal(starts % 64, torch.arange(64).expand_as(starts))
        assert torch.equal(starts - starts[:, :1], torch.arange(64).expand_as(starts))
    if sampling == "slice":
        assert torch.equal(rows - rows[0], torch.arange(B))


def test_draws_are_checked():
    X, y = logistic_data(512, D)
    mj, sj, Xj, yj = jax_svgp(X, y, M, 128)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj)
    with pytest.raises(ValueError, match="draws"):
        vi_steps(mt, st, Xt, yt, 2, draws=torch.zeros((2, 128), dtype=torch.int64))


def test_create_refuses_what_is_not_ported():
    """The reference's default optimiser (Adam) is ported; an optimiser that
    is not one of the port's GradientTransformations, or a kernel that is
    not ported, raises."""
    Z = torch.zeros((4, 2), dtype=torch.float64)
    kern, lik, inf = agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(8)
    assert isinstance(agt.SVGP.create(kern, lik, inf, Z).optimiser, GradientTransformation)
    with pytest.raises(NotImplementedError, match="not ported"):
        agt.SVGP.create(kern, lik, inf, Z, optimiser=object())
    with pytest.raises(NotImplementedError, match="not ported"):
        agt.SVGP.create(object(), lik, inf, Z, optimiser=None)


def test_skill_oracle_through_public_train():
    """The verify oracle through the port's public API, with the port's own
    generator and Robbins-Monro rule: N=300 2-D sin labels, M=32, B=64,
    150 iterations; training accuracy > 0.9."""
    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.uniform(-2, 2, size=(300, 2)))
    y = (torch.sin(2 * X[:, 0]) + 0.5 * X[:, 1] > 0).to(torch.float64)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(64),
        Z=X[:32], optimiser=None,
    )
    gen = torch.Generator().manual_seed(0)
    model, state = agt.train(model, X, y, iterations=150, generator=gen)
    acc = float(((agt.predict_y(model, state, X) > 0) == (y > 0)).double().mean())
    assert acc > 0.9
    assert int(state.step) == 150
