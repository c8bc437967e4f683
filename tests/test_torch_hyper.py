"""The port's hyperparameter step (Slice B) against the JAX package,
float64: the log transforms of the kernels, ``adam`` against
``optax.adam``, the gradient of -ELBO that ``hyper_step`` takes against
``jax.grad`` of the reference's ``neg_elbo`` (one latent on both sides of
the fused range, ARD, a constant mean, a Zoptimiser, multiclass and
heteroscedastic), 10 training iterations with the default Adam on the
reference's own draws, the Cholesky ladder's gradient when a rung fails,
and the reference's Zoptimiser oracle through the port's public API."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agp_tpu as agp
import agp_tpu.training.train as jtrain
import agp_tpu_torch as agt
from agp_tpu.inference.objective import objective as jax_objective
from agp_tpu.kernels import to_unconstrained as jax_to_unconstrained
from agp_tpu.training.autotuning import _kmat as jax_kmat
from agp_tpu.training.autotuning import _rebuild as jax_rebuild
from agp_tpu_torch import kernels as tk
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.ops import linalg
from agp_tpu_torch.training import autotuning
from agp_tpu_torch.training import train as ttrain
from agp_tpu_torch.utils.opt import adam
from torch_helpers import (
    close, het_data, jax_rm_scales, jax_svgp, logistic_data, multiclass_data, port_from_jax, replay_rule,
    replay_steps, single_latent_data,
)


# ------------------------------------------------------------------ helpers
@pytest.mark.parametrize("ls_shape", [(), (3,), (3, 4)])
@pytest.mark.parametrize("cls", [agt.SqExponentialKernel, agt.Matern12Kernel, agt.Matern32Kernel,
                                 agt.Matern52Kernel])
def test_unconstrained_round_trip(cls, ls_shape):
    """to_unconstrained is the log of every leaf, as the reference's is on
    the same values, and from_unconstrained undoes it (rtol 1e-14)."""
    rng = np.random.default_rng(0)
    ls, var = rng.uniform(0.5, 2.0, size=ls_shape), rng.uniform(0.5, 2.0, size=ls_shape[:1])
    k = cls(lengthscale=torch.as_tensor(ls), variance=torch.as_tensor(var))
    u = tk.to_unconstrained(k)
    kj = getattr(agp, cls.__name__)(lengthscale=jnp.asarray(ls), variance=jnp.asarray(var))
    uj = jax_to_unconstrained(kj)
    close(u.lengthscale, uj.lengthscale, rtol=1e-14, atol=0)
    close(u.variance, uj.variance, rtol=1e-14, atol=0)
    back = tk.from_unconstrained(u)
    assert type(back) is cls
    close(back.lengthscale, ls, rtol=1e-14, atol=0)
    close(back.variance, var, rtol=1e-14, atol=0)


def test_adam_matches_optax():
    """20 updates of a dict of leaves (a scalar, a vector, a matrix) with
    the same gradients: the updates and the state (count, mu, nu) equal
    optax.adam's at rtol 1e-12."""
    rng = np.random.default_rng(1)
    shapes = {"a": (), "b": (3,), "c": (2, 4)}
    params = {k: rng.normal(size=s) for k, s in shapes.items()}
    opt_j, opt_t = optax.adam(0.01), adam(0.01)
    state_j = opt_j.init({k: jnp.asarray(v) for k, v in params.items()})
    state_t = opt_t.init({k: torch.as_tensor(v) for k, v in params.items()})
    for _ in range(20):
        g = {k: rng.normal(size=s) * 10.0 ** rng.uniform(-3, 1) for k, s in shapes.items()}
        u_j, state_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, state_j)
        u_t, state_t = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, state_t)
        for k in shapes:
            close(u_t[k], u_j[k], rtol=1e-12, atol=0, msg=f"update {k}")
            close(state_t["mu"][k], state_j[0].mu[k], rtol=1e-12, atol=0, msg=f"mu {k}")
            close(state_t["nu"][k], state_j[0].nu[k], rtol=1e-12, atol=0, msg=f"nu {k}")
        assert int(state_t["count"]) == int(state_j[0].count)


# ------------------------------------------------ the hyperparameter gradient
def jax_case(name):
    """(JAX model, state, X, y) of gradient case ``name``, its batch size and
    whether Z is optimised."""
    B = 128
    if name in ("logistic_m64", "mean_and_z", "logistic_m130"):
        X, y = logistic_data(1024, 8 if name == "logistic_m130" else 6, seed=2)
        m = 130 if name == "logistic_m130" else 64
        kw = {"mean": agp.ConstantMean(c=jnp.asarray(0.3))} if name == "mean_and_z" else {}
        return jax_svgp(X, y, m, B, sampling="slice", **kw), B, name == "mean_and_z"
    if name == "studentt_ard":
        X, _, y = single_latent_data("studentt", 1024, 6, seed=2)
        ls = np.random.default_rng(3).uniform(1.5, 2.5, size=6)
        return jax_svgp(X, y, 64, B, sampling="slice", lengthscale=ls,
                        likelihood=agp.StudentTLikelihood.create(4.0, 0.7)), B, False
    if name == "multiclass":
        X, y = multiclass_data(1024, 4, 3, seed=2)
        return jax_svgp(X, y, 32, B, sampling="slice", likelihood=agp.LogisticSoftMaxLikelihood.create(3)), B, False
    X, y = het_data(1024, 4, seed=2)
    return jax_svgp(X, y, 32, B, sampling="slice", likelihood=agp.HeteroscedasticLikelihood.create()), B, False


def jax_grads(mj, sj, xb, yb, opt_z):
    """jax.grad of the reference's neg_elbo (training/autotuning.py) with
    respect to the log kernel, the mean and, when ``opt_z``, Z."""

    def neg_elbo(log_k, mean, Z):
        m2 = jax_rebuild(mj, log_k, mean, Z)
        return -jax_objective(m2, sj, xb, yb, kmat=jax_kmat(m2, xb))

    args = (jax_to_unconstrained(mj.kernel), mj.mean, mj.Z if opt_z else None)
    return jax.jit(jax.grad(neg_elbo, argnums=(0, 1, 2) if opt_z else (0, 1)))(*args)


GRAD_CASES = ["logistic_m64", "logistic_m130", "studentt_ard", "mean_and_z", "multiclass", "het"]


@pytest.mark.parametrize("name", GRAD_CASES)
def test_hyper_gradient_matches_jax_grad(name):
    """The gradient hyper_step takes (-ELBO with respect to the log kernel
    parameters, the mean's and Z's under a Zoptimiser) against jax.grad of
    the reference's neg_elbo on the same float64 state and batch (after 2
    replayed CAVI steps), rtol 1e-8 (atol 1e-10): one latent in the fused
    range (M=64) and beyond it (M=130), both through kernel 6's plain
    version; Student-t with ARD lengthscales; a constant mean with a
    Zoptimiser; logistic-softmax K=3 and heteroscedastic through kernel 4's
    plain version."""
    (mj, sj, Xj, yj), B, opt_z = jax_case(name)
    runs = replay_steps(mj, sj, Xj, yj, 2)
    mj, sj, Xj, yj, idx = runs["jax"]
    mt, st, Xt, yt = runs["port"]
    if opt_z:
        mt = mt.replace(Zoptimiser=adam(0.05))
    start = int(idx[-1])
    g_j = jax_grads(mj, sj, Xj[start:start + B], yj[start:start + B], opt_z)
    _, g_k, g_m, g_z = autotuning.hyper_gradients(mt, st, Xt[start:start + B], yt[start:start + B])
    for field in ("lengthscale", "variance"):
        close(g_k[field], getattr(g_j[0], field), rtol=1e-8, atol=1e-10, msg=field)
    assert set(g_m) == ({"c"} if name == "mean_and_z" else set())
    if name == "mean_and_z":
        close(g_m["c"], g_j[1].c, rtol=1e-8, atol=1e-10, msg="mean c")
    assert (g_z is None) is (not opt_z)
    if opt_z:
        close(g_z, g_j[2], rtol=1e-8, atol=1e-10, msg="Z")
    assert all(bool(torch.isfinite(g).all()) for g in g_k.values())


# ------------------------------------------------------ 10 training iterations
@pytest.fixture(scope="module", params=["logistic_m130", "logistic_m64_mean_z"])
def train_runs(request):
    """10 iterations of train with the default Adam(0.01) in both packages,
    from identical states (the Adam states carried by interop) on the
    reference's own draws, with its Robbins-Monro scales replayed: (model,
    state) after every CAVI and hyperparameter step, and the final ones."""
    steps = 10
    if request.param == "logistic_m130":
        X, y = logistic_data(1024, 8, seed=5)
        kw, zopt = {}, None
    else:
        X, y = logistic_data(1024, 6, seed=5)
        kw, zopt = {"mean": agp.ConstantMean(c=jnp.asarray(0.2)), "Zoptimiser": optax.adam(0.05)}, adam(0.05)
    m = 130 if request.param == "logistic_m130" else 64
    mj, sj, Xj, yj = jax_svgp(X, y, m, 128, sampling="slice", optimiser=optax.adam(0.01), **kw)
    _, idx = jtrain._precomputed_draws(mj, sj, Xj, steps)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(steps)))
    mt = mt.replace(optimiser=agt.adam(0.01), Zoptimiser=zopt)
    assert set(st.hyper_state) == set(sj.hyper_state)
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
        final_j = agp.train(mj, Xj, yj, iterations=steps, state=sj)
        final_t = agt.train(mt, Xt, yt, iterations=steps, state=st, draws=torch.as_tensor(np.array(idx)))
    finally:
        mp.undo()
    return dict(seen=list(zip(seen_j, seen_t)), final=(final_j, final_t), steps=steps)


def test_train_runs_the_reference_hyper_schedule(train_runs):
    """A hyperparameter step after iterations 3..9 of 10 (atfrequency 1,
    never on the last), as the reference's loop: 17 steps in all, and the
    Adam counts at 7."""
    assert len(train_runs["seen"]) == train_runs["steps"] + 7
    (_, sj), (_, st) = train_runs["final"]
    for group in sj.hyper_state:
        assert int(st.hyper_state[group]["count"]) == int(sj.hyper_state[group][0].count) == 7


def test_train_matches_reference_after_every_step(train_runs):
    """The kernel parameters, the mean, Z, eta, mu and Sigma after every
    CAVI and hyperparameter step of the 10 iterations, and the kernel
    matrices train refreshes at the end, at rtol 1e-7 (atol 1e-10)."""
    for i, ((mj, sj), (mt, st)) in enumerate(train_runs["seen"] + [train_runs["final"]]):
        kw = dict(rtol=1e-7, atol=1e-10)
        close(mt.kernel.lengthscale, mj.kernel.lengthscale, msg=f"{i}: lengthscale", **kw)
        close(mt.kernel.variance, mj.kernel.variance, msg=f"{i}: variance", **kw)
        if hasattr(mj.mean, "c"):
            close(mt.mean.c, mj.mean.c, msg=f"{i}: mean", **kw)
        close(mt.Z, mj.Z, msg=f"{i}: Z", **kw)
        for name in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, name), getattr(sj, name), msg=f"{i}: {name}", **kw)
    (mj, sj), (mt, st) = train_runs["final"]
    for name in ("L_K", "K_inv"):
        close(st.kmat[name], sj.kmat[name], rtol=1e-7, atol=1e-10, msg=name)
    assert float(jnp.max(jnp.abs(mj.kernel.lengthscale - 2.0))) > 1e-3  # the hyperparameters moved


def test_default_model_learns_through_the_public_api():
    """agt.SVGP.create without an optimiser builds Adam(0.01), and agt.train
    then runs the hyperparameter step: the Adam count is 17 after 20
    iterations, the log-hyperparameters move, by at most Adam's bound of
    lr (1 - b1) / sqrt(1 - b2) a step, and the posterior is finite."""
    X, y = logistic_data(512, 3, seed=6)
    X = torch.as_tensor(X)
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                            agt.AnalyticSVI(128), X[:32])
    model, state = agt.train(model, X, torch.as_tensor(y), iterations=20, generator=torch.Generator().manual_seed(0))
    assert int(state.hyper_state["kernel"]["count"]) == 17 and state.hyper_state["mean"]["mu"] == {}
    k = model.kernel
    moved = float(torch.cat([torch.log(k.lengthscale / 2.0), torch.log(k.variance)]).abs().max())
    assert 0.05 < moved <= 17 * 0.01 * (1 - 0.9) / (1 - 0.999) ** 0.5
    assert bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())


# ------------------------------------------------------------- the ladder
@pytest.fixture
def failed_factors_poison(monkeypatch):
    """torch.linalg.cholesky_ex as it can behave on the card: a failed
    factorization's factor holds NaN, and so does its backward's result,
    even for a zero cotangent (0 * NaN).  On a CPU, LAPACK leaves a failed
    factor finite, which would hide a ladder that differentiates its failed
    rungs."""
    orig = torch.linalg.cholesky_ex

    class Poisoned(torch.autograd.Function):
        @staticmethod
        def forward(ctx, A):
            L, info = orig(A)
            ctx.save_for_backward(A)
            ctx.failed = (info != 0)[..., None, None]
            ctx.mark_non_differentiable(info)
            return torch.where(ctx.failed, torch.full_like(L, float("nan")), L), info

        @staticmethod
        def backward(ctx, gL, _):
            (A,) = ctx.saved_tensors
            with torch.enable_grad():
                A = A.detach().requires_grad_(True)
                gA = torch.autograd.grad(orig(A).L, A, gL)[0]
            return torch.where(ctx.failed, torch.full_like(gA, float("nan")), gA)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", lambda A: torch.return_types.linalg_cholesky_ex(Poisoned.apply(A)))


def test_ladder_gradient_when_the_first_rung_fails(monkeypatch, failed_factors_poison):
    """A matrix whose smallest eigenvalue is -5e-4 (float64 jitter 1e-4):
    the first rung of the ladder fails and the second (1e-3) is chosen, and
    a failed factor poisons its own gradient (``failed_factors_poison``).
    safe_cholesky's gradient is finite and equals that of one Cholesky of
    the chosen rung (rtol 1e-10); so is, and does, the hyperparameter
    gradient with Kmm shifted so that its first rung fails."""
    rng = np.random.default_rng(8)
    Q = np.linalg.qr(rng.normal(size=(16, 16)))[0]
    A = torch.tensor(Q @ np.diag(np.r_[-5e-4, rng.uniform(0.1, 2.0, size=15)]) @ Q.T, requires_grad=True)
    W = torch.as_tensor(rng.normal(size=(16, 16)))
    g = torch.autograd.grad(torch.sum(linalg.safe_cholesky(A, 1e-4) * W), A)[0]
    g_ref = torch.autograd.grad(torch.sum(torch.linalg.cholesky(A + 1e-4 * 10.0 * torch.eye(16, dtype=A.dtype)) * W), A)[0]
    assert bool(torch.isfinite(g).all())
    close(g, g_ref, rtol=1e-10, atol=1e-12)

    X, y = logistic_data(512, 4, seed=9)
    mt, st, Xt, yt = port_from_jax(*jax_svgp(X, y, 32, 128, sampling="slice"))
    gram = tav.batch_gram_zz

    def shifted(kernel, Z):  # smallest eigenvalue -5e-4
        K = gram(kernel, Z)
        lam = torch.linalg.eigvalsh(K.detach())[..., 0]
        return K - (lam + 5e-4)[..., None, None] * torch.eye(K.shape[-1], dtype=K.dtype)

    monkeypatch.setattr(tav, "batch_gram_zz", shifted)
    grads = autotuning.hyper_gradients(mt, st, Xt[:128], yt[:128])[1]
    monkeypatch.setattr(tav.linalg, "safe_cholesky", lambda K, j: torch.linalg.cholesky(
        K + j * 10.0 * torch.eye(K.shape[-1], dtype=K.dtype)))
    ref = autotuning.hyper_gradients(mt, st, Xt[:128], yt[:128])[1]
    for k in grads:
        assert bool(torch.isfinite(grads[k]).all()), k
        close(grads[k], ref[k], rtol=1e-10, atol=1e-12, msg=k)


# -------------------------------------------------------------- the oracle
def test_zoptimiser_moves_inducing_points():
    """The port's version of the reference's Zoptimiser oracle
    (tests/test_engines.py): a Gaussian SVGP on 80 noisy 1-D points with 6
    coarse inducing points, full-batch, Adam(0.01) on the kernel; with a
    Zoptimiser (Adam(0.05)) Z moves and the final ELBO beats the frozen-Z
    control trained identically."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(np.sort(rng.uniform(-3, 3, size=80))[:, None])
    y = torch.sin(2 * X[:, 0]) + 0.5 * torch.sin(5 * X[:, 0]) + 0.05 * torch.as_tensor(rng.normal(size=80))
    Z0 = torch.linspace(float(X.min()), float(X.max()), 6, dtype=torch.float64)[:, None]

    def build(zopt):
        return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=0.5), agt.GaussianLikelihood.create(0.05**2),
                               agt.AnalyticVI(), Z0, optimiser=agt.adam(0.01), Zoptimiser=zopt, atfrequency=1)

    m_z, s_z = agt.train(build(agt.adam(0.05)), X, y, iterations=80)
    m_f, s_f = agt.train(build(None), X, y, iterations=80)
    assert float(torch.max(torch.abs(m_z.Z - Z0[None]))) > 1e-3, "Z must move under a Zoptimiser"
    assert torch.equal(m_f.Z, Z0[None])
    e_z, e_f = float(agt.elbo(m_z, s_z, X, y)), float(agt.elbo(m_f, s_f, X, y))
    assert e_z > e_f, (e_z, e_f)
