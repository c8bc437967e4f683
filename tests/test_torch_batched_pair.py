"""The batched pair of the port against the JAX package, float64:
``fused_kappa_moments_batched`` and ``cavi_stats_batched`` (their plain
versions) against the Pallas kernels in TPU interpret mode and the XLA
math, kernel 4's gradient against ``jax.grad``, the ``fused_fits`` rule
that picks between the fused passes and the pair, and 10 CAVI steps at
M=130, beyond the fused range, for logistic, Poisson, multiclass (K=3) and
heteroscedastic models, from identical states on the JAX package's own
draws."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import agp_tpu as agp
import agp_tpu.inference.analytic_vi as jav
from agp_tpu.ops import pallas_kernels as pk
from agp_tpu.training.state import TrainState
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training.train import vi_steps
from torch_helpers import (
    check_steps, close, het_data, jax_rm_scales, jax_single_latent, jax_svgp, multiclass_data, port_from_jax,
    replay_rule, replay_steps, single_latent_data,
)

L, B, D, M = 3, 300, 5, 32
JAX_KERNELS = {
    "rbf": agp.SqExponentialKernel,
    "matern12": agp.Matern12Kernel,
    "matern32": agp.Matern32Kernel,
    "matern52": agp.Matern52Kernel,
}


def pair_inputs(kind="rbf", seed=0, b=B, n_latent=L, jitt=1e-4):
    """Numpy inputs of kernel 4 (per-latent ARD lengthscales, L^-T of each
    latent's Kmm of ``kind``) and of kernel 5 (g, theta), and the JAX model
    and kmat they come from."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, D))
    Z = rng.normal(size=(n_latent, M, D))
    A = rng.normal(size=(n_latent, M, M))
    lik = agp.LogisticSoftMaxLikelihood.create(n_latent) if n_latent > 1 else agp.LogisticLikelihood.create()
    model = agp.SVGP.create(JAX_KERNELS[kind](lengthscale=jnp.ones(D)), lik, agp.AnalyticVI(),
                            Z=jnp.asarray(Z[0]), optimiser=None)
    a = dict(
        X=X, Z=Z, ls=rng.uniform(0.8, 1.6, size=(n_latent, D)), var=rng.uniform(0.8, 1.5, size=n_latent),
        mu=rng.normal(size=(n_latent, M)), Sigma=A @ A.transpose(0, 2, 1) / M + np.eye(M),
        g=rng.normal(size=(n_latent, b)), theta=rng.uniform(0.0, 1.0, size=(n_latent, b)), jitt=jitt,
    )
    model = model.replace(Z=jnp.asarray(Z), kernel=model.kernel.replace(lengthscale=jnp.asarray(a["ls"]),
                                                                        variance=jnp.asarray(a["var"])))
    kmat = jav.compute_kmat(model, jnp.asarray(X))
    a["L_invT"] = np.swapaxes(np.array(kmat["L_inv"]), -1, -2)
    return a, model, kmat


def T(a):
    return torch.as_tensor(np.asarray(a))


def port_moments(a, kind="rbf", fn=ck.fused_kappa_moments_batched):
    return fn(*(T(a[k]) for k in ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")), a["jitt"], kind)


# --------------------------------------------------- the plain versions
@pytest.mark.parametrize("kind", list(JAX_KERNELS))
def test_kappa_moments_plain_matches_pallas_interpret(kind):
    """Kernel 4's plain version against the Pallas kernel in TPU interpret
    mode (B=300: a ragged last tile of 128), at tests/test_pallas.py's
    tolerances for it (atol 2e-3 on kappa and mf, 3e-3 on vf): the Pallas
    kernel's bf16-split dots are float32-grade."""
    a, _, _ = pair_inputs(kind)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fused_kappa_moments_batched(
            *(jnp.asarray(a[k]) for k in ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")), a["jitt"],
            kind=kind, tile_b=128,
        )
    for name, o, r, atol in zip(("kappa", "mf", "vf"), port_moments(a, kind), ref, (2e-3, 2e-3, 3e-3)):
        close(o, r, rtol=0, atol=atol, msg=name)


def test_stats_plain_matches_pallas_interpret():
    """Kernel 5's plain version against the Pallas kernel in TPU interpret
    mode (B=300, tile 128), at tests/test_pallas.py's tolerances (s1 rtol
    and atol 1e-4; S2 rtol 1e-3, atol 1e-4)."""
    a, _, _ = pair_inputs()
    kappa = port_moments(a)[0]
    with pltpu.force_tpu_interpret_mode():
        s1_j, s2_j = pk.cavi_stats_batched(jnp.asarray(kappa.numpy()), jnp.asarray(a["g"]), jnp.asarray(a["theta"]),
                                           tile_b=128)
    s1, s2 = ck.cavi_stats_batched(kappa, T(a["g"]), T(a["theta"]))
    close(s1, s1_j, rtol=1e-4, atol=1e-4, msg="s1")
    close(s2, s2_j, rtol=1e-3, atol=1e-4, msg="S2")


@pytest.mark.parametrize("n_latent", [1, L])
@pytest.mark.parametrize("kind", list(JAX_KERNELS))
def test_plain_pair_matches_xla_math(kind, n_latent):
    """Both plain versions against the JAX package's XLA math on the same
    float64 inputs, rtol 1e-10 (atol 1e-12): its latent_moments (the gram
    by sq_dist's expanded form, kappa against the kmat's K^-1) and the
    statistic einsums of apply_natural_gradient.  One latent takes the
    reference's squeezed [B, M] branch."""
    a, model, kmat = pair_inputs(kind, n_latent=n_latent)
    state = TrainState(mu=jnp.asarray(a["mu"]), Sigma=jnp.asarray(a["Sigma"]))
    mf_j, vf_j, kappa_j = jav.latent_moments(model, state, jnp.asarray(a["X"]), kmat)
    kappa, mf, vf = port_moments(a, kind)
    for name, o, r in (("kappa", kappa, kappa_j), ("mf", mf, mf_j), ("vf", vf, vf_j)):
        close(o, r, rtol=1e-10, atol=1e-12, msg=name)
    g, th = jnp.asarray(a["g"]), jnp.asarray(a["theta"])
    s1, s2 = ck.cavi_stats_batched(kappa, T(a["g"]), T(a["theta"]))
    close(s1, jnp.einsum("lbm,lb->lm", kappa_j, g), rtol=1e-10, atol=1e-12, msg="s1")
    close(s2, jnp.einsum("lbm,lb,lbn->lmn", kappa_j, th, kappa_j), rtol=1e-10, atol=1e-12, msg="S2")


def test_kappa_moments_gradient_matches_jax_grad():
    """The gradient of a weighted sum of (kappa, mf, vf) with respect to
    X, Z, L^-T, the [L, D] lengthscales, the variances, mu and Sigma: the
    plain version's (what the CUDA call's backward runs) against jax.grad
    through the reference's XLA latent_moments with K^-1 = L^-T L^-1,
    float64, rtol 1e-8 (atol 1e-10)."""
    a, model, _ = pair_inputs()
    rng = np.random.default_rng(5)
    wk, wm, wv = rng.normal(size=(L, B, M)), rng.normal(size=(L, B)), rng.normal(size=(L, B))
    names = ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")

    def loss_j(X, Z, L_invT, ls, var, mu, Sigma):
        m = model.replace(Z=Z, kernel=model.kernel.replace(lengthscale=ls, variance=var))
        kmat = {"K_inv": jnp.einsum("lij,lkj->lik", L_invT, L_invT)}
        mf, vf, kappa = jav.latent_moments(m, TrainState(mu=mu, Sigma=Sigma), X, kmat)
        return jnp.sum(kappa * wk) + jnp.sum(mf * wm) + jnp.sum(vf * wv)

    grads_j = jax.grad(loss_j, argnums=tuple(range(7)))(*(jnp.asarray(a[k]) for k in names))
    inputs = [T(a[k]).requires_grad_(True) for k in names]
    kappa, mf, vf = ck.fused_kappa_moments_batched(*inputs, a["jitt"], "rbf")
    loss = torch.sum(kappa * T(wk)) + torch.sum(mf * T(wm)) + torch.sum(vf * T(wv))
    for name, g_t, g_j in zip(names, torch.autograd.grad(loss, inputs), grads_j):
        close(g_t, g_j, rtol=1e-8, atol=1e-10, msg=name)


class _LargestOutput(TorchDispatchMode):
    """Records the largest number of elements of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


@pytest.mark.parametrize("d", [8, 64, 256])
def test_plain_gram_memory_does_not_grow_with_d(d):
    """Kernel 4's plain version forms the gram by direct differences over
    feature chunks: no tensor it makes holds more than [L, B, M, 8]
    elements at any D (the whole [L, B, M, D] difference would be 32x that
    at D=256), and r2 equals the unchunked sum at rtol 1e-12."""
    n_latent, b, m = 2, 64, 64
    rng = np.random.default_rng(d)
    X, Z = T(rng.normal(size=(b, d))), T(rng.normal(size=(n_latent, m, d)))
    L_invT = T(np.broadcast_to(np.eye(m), (n_latent, m, m)).copy())
    args = (X, Z, L_invT, T(np.full((n_latent, d), 0.5 * d**0.5)), T(np.ones(n_latent)),
            T(rng.normal(size=(n_latent, m))), L_invT.clone())
    with _LargestOutput() as seen:
        kappa = ck.fused_kappa_moments_batched_reference(*args, 1e-4, "rbf")[0]
    assert seen.numel <= n_latent * b * m * ck._FEATURE_CHUNK
    diff = X[None, :, None, :] - Z[:, None, :, :]
    r2 = ck._sq_dist_chunked(X[None].expand(n_latent, b, d), Z)
    close(r2, torch.sum(diff * diff, dim=-1), rtol=1e-12, atol=0, msg="r2")
    assert kappa.shape == (n_latent, b, m) and bool(torch.isfinite(kappa).all())


def test_cpu_pair_counts_no_launch_and_keeps_dtype():
    a, _, _ = pair_inputs()
    before = (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches)
    t = {k: torch.as_tensor(a[k], dtype=torch.float32) for k in ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")}
    kappa, mf, vf = ck.fused_kappa_moments_batched(*t.values(), a["jitt"], "rbf")
    s1, s2 = ck.cavi_stats_batched(kappa, mf, vf)
    assert (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches) == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in (kappa, mf, vf, s1, s2))
    assert kappa.shape == (L, B, M) and s2.shape == (L, M, M)


# --------------------------------------------------------- the dispatch
@pytest.mark.parametrize("n_latent,D_,M_,fits", [
    (1, 2, 128, True), (1, 2, 129, False), (1, 44, 128, True), (1, 45, 128, True), (1, 4096, 128, True),
    (3, 45, 128, True), (3, 46, 128, True), (3, 4096, 128, True), (10, 4096, 128, True), (2, 2, 129, False),
    (1, 20, 0, False), (1, 0, 64, False),
])
def test_fused_fits_edges(n_latent, D_, M_, fits):
    """The fused kernels take M <= 128 at any D, one latent (kernel 1) or
    several (kernels 2-3): their shared row tile stages the gram in chunks
    of features."""
    assert ck.fused_fits(n_latent, D_, M_) is fits


def _spy(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(ck, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ck, name, spy)
    return calls


def dispatch_model(which, m):
    """A small port model of ``which`` with m inducing points, its data and
    labels as train treats them."""
    import agp_tpu_torch as agt

    X = torch.as_tensor(np.random.default_rng(0).normal(size=(512, 3)))
    liks = {"logistic": (agt.LogisticLikelihood.create(), torch.sign(X[:, 0])),
            "multiclass": (agt.LogisticSoftMaxLikelihood.create(3), torch.argmax(X, dim=1)),
            "het": (agt.HeteroscedasticLikelihood.create(), torch.sin(X[:, 0]))}
    lik, y = liks[which]
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik, agt.AnalyticSVI(128, minibatch_sampling="slice"),
                            X[:m], optimiser=None)
    return model, X, y


FUSED_OF = {"logistic": "fused_cavi_stats", "multiclass": "fused_cavi_stats_multiclass", "het": "fused_cavi_stats_het"}


@pytest.mark.parametrize("which", list(FUSED_OF))
@pytest.mark.parametrize("m", [64, 130])
def test_dispatch_picks_the_pair_exactly_beyond_the_fused_range(monkeypatch, which, m):
    """3 steps through agt.train: at M=64 one fused pass a step and no pair;
    at M=130 (fused_fits false) one launch of each kernel of a split pair a
    step and no fused pass: the batched pair for several latents, the
    single-latent pair (fused_kappa, cavi_stats) for one."""
    import agp_tpu_torch as agt

    model, X, y = dispatch_model(which, m)
    assert ck.fused_fits(model.n_latent, 3, m) is (m == 64)
    pairs = {"batched": ("fused_kappa_moments_batched", "cavi_stats_batched"), "single": ("fused_kappa", "cavi_stats")}
    calls = _spy(monkeypatch, list(FUSED_OF.values()) + [n for names in pairs.values() for n in names])
    agt.train(model, X, y, iterations=3)
    fused = FUSED_OF[which]
    pair = m > ck.MAX_M
    route = "single" if which == "logistic" else "batched"
    assert calls[fused] == (0 if pair else 3)
    for kind, names in pairs.items():
        assert [calls[n] for n in names] == [3 if pair and kind == route else 0] * 2, (kind, calls)
    assert sum(calls[name] for name in FUSED_OF.values() if name != fused) == 0


# ---------------------------------------------------- the steps at M=130
SN, SD, SM, SB, STEPS = 1024, 8, 130, 256, 10


def jax_case(which):
    """(model, state, X, y) of the JAX package for case ``which`` at M=130
    in 8-D, slice sampling, lengthscale 2 (Kmm's condition number 6.5e3),
    float64."""
    if which in ("logistic", "poisson"):
        X, _, y = single_latent_data(which, SN, SD)
        lik = jax_single_latent(which)
    elif which == "multiclass":
        X, y = multiclass_data(SN, SD, 3)
        lik = agp.LogisticSoftMaxLikelihood.create(3)
    else:
        X, y = het_data(SN, SD)
        lik = agp.HeteroscedasticLikelihood.create()
    return jax_svgp(X, y, SM, SB, sampling="slice", likelihood=lik)


@pytest.fixture(scope="module", params=["logistic", "poisson", "multiclass", "het"])
def m130_runs(request):
    return replay_steps(*jax_case(request.param), STEPS)


def test_steps_at_m130_match_reference(m130_runs):
    """10 slice-sampled steps at M=130, beyond the fused range, through the
    plain versions of the pair (the port) and the XLA path (the JAX
    package): eta, mu, Sigma, every local variable and the likelihood's
    parameters (Poisson's and the heteroscedastic lambda) after each step
    at rtol 1e-8."""
    assert tav._fused_spec(m130_runs["port"][0]) is None
    check_steps(m130_runs)


def test_multiclass_steps_match_pallas_pair_interpret(monkeypatch):
    """Two multiclass steps at M=130 against the reference forced through
    its batched pair (AGP_TPU_PALLAS=1, its fused multiclass kernel turned
    off, TPU interpret mode), at tests/test_pallas.py's megakernel
    tolerances (rtol 1e-2, atol 1e-4): the Pallas pair's kappa is
    float32-grade, and Kmm's condition number (6.5e3 here, 130 points in
    8-D at lengthscale 2) carries that into the step."""
    X, y = multiclass_data(SN, SD, 3, seed=3)
    mj, sj, Xj, yj = jax_svgp(X, y, SM, SB, sampling="slice",
                              likelihood=agp.LogisticSoftMaxLikelihood.create(3))
    from agp_tpu.training.train import _precomputed_draws

    _, idx = _precomputed_draws(mj, sj, Xj, 2)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(2)))
    monkeypatch.setenv("AGP_TPU_PALLAS", "1")
    monkeypatch.setattr(jav, "_pallas_fused_mc_spec", lambda model: None)
    assert jav._pallas_kind_batched(mj) == "rbf"
    vu = jax.jit(jav.variational_update)
    with pltpu.force_tpu_interpret_mode():
        for i in range(2):
            s = int(idx[i])
            mj, sj = jax.block_until_ready(vu(mj, sj, Xj[s : s + SB], yj[s : s + SB]))
    mt, st = vi_steps(mt, st, Xt, yt, 2, draws=torch.as_tensor(np.array(idx), dtype=torch.int64))
    close(st.mu, sj.mu, rtol=1e-2, atol=1e-4, msg="mu")
    close(st.Sigma, sj.Sigma, rtol=1e-2, atol=1e-4, msg="Sigma")
    for name in ("theta", "gamma", "alpha", "c"):
        close(st.local_vars[name], sj.local_vars[name], rtol=1e-2, atol=1e-4, msg=name)
