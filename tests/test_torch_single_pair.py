"""The single-latent split pair of the port against the JAX package,
float64: ``fused_kappa`` and ``cavi_stats`` (their plain versions) against
the Pallas kernels in TPU interpret mode and against the reference's XLA
twin, kernel 6's gradient against ``jax.grad`` through that twin (the
plain version's, and the ``autograd.Function``'s that the card runs), the
closed-form gradient of r2 whose memory does not grow with D, which calls
take the pair, and 10 Student-t steps with ARD lengthscales at M=130
through it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.ops import pallas_kernels as pk
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import check_steps, close, jax_svgp, replay_steps, single_latent_data

B, D, M = 300, 8, 64
KINDS = {"rbf": agt.SqExponentialKernel, "matern12": agt.Matern12Kernel, "matern32": agt.Matern32Kernel,
         "matern52": agt.Matern52Kernel}


def T(a):
    return torch.as_tensor(np.asarray(a))


def kappa_inputs(kind="rbf", m=M, ard=False, seed=0):
    """Numpy inputs of kernel 6 (as tests/test_pallas.py makes them: X and Z
    standard normal, lengthscale 1.3, variance 2, jitter 1e-3, L^-T of the
    kind's Kmm + jitter) and of kernel 7 (g normal, theta uniform)."""
    rng = np.random.default_rng(seed)
    ls = rng.uniform(1.0, 1.6, size=D) if ard else 1.3
    a = dict(X=rng.normal(size=(B, D)), Z=rng.normal(size=(m, D)), ls=ls, var=2.0, jitt=1e-3,
             g=rng.normal(size=B), theta=rng.uniform(0.0, 1.0, size=B))
    K = KINDS[kind](lengthscale=T(ls), variance=2.0).gram(T(a["Z"])) + 1e-3 * torch.eye(m, dtype=torch.float64)
    L = torch.linalg.cholesky(K)
    a["L_invT"] = torch.linalg.solve_triangular(L, torch.eye(m, dtype=torch.float64), upper=False).T.numpy()
    return a


@pytest.fixture
def exact_dot3(monkeypatch):
    """The reference's _dot3 (a 3-pass bf16 emulation, float32-grade even
    on a CPU) as a float64 dot, so that its XLA twin's math is held to
    float64 rounding."""
    monkeypatch.setattr(pk, "_dot3", lambda a, b, dims=(((1,), (0,)), ((), ())): jax.lax.dot_general(
        a, b, dims, precision=jax.lax.Precision.HIGHEST))


def port_kappa(a, kind):
    return ck.fused_kappa(*(T(a[k]) for k in ("X", "Z", "L_invT", "ls")), a["var"], a["jitt"], kind)


# --------------------------------------------------- the plain versions
@pytest.mark.parametrize("kind", list(KINDS))
def test_fused_kappa_plain_matches_pallas_interpret(kind):
    """Kernel 6's plain version against the Pallas kernel in TPU interpret
    mode at B=300 (a ragged last tile of 128), at tests/test_pallas.py's
    tolerances (atol 2e-4 on kappa, 5e-5 on Ktilde): the Pallas kernel's
    3-pass bf16 dots are float32-grade."""
    a = kappa_inputs(kind)
    with pltpu.force_tpu_interpret_mode():
        kappa_j, kt_j = pk.fused_kappa(*(jnp.asarray(a[k]) for k in ("X", "Z", "L_invT")), a["ls"], a["var"],
                                       a["jitt"], kind, tile_b=128)
    kappa, kt = port_kappa(a, kind)
    close(kappa, kappa_j, rtol=0, atol=2e-4, msg="kappa")
    close(kt, kt_j, rtol=0, atol=5e-5, msg="Ktilde")


@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("kind,m", [(k, M) for k in KINDS] + [("rbf", 130)])
def test_fused_kappa_plain_matches_xla_twin(exact_dot3, kind, m, ard):
    """Kernel 6's plain version against the reference's _kappa_xla_twin
    (its custom VJP's forward, ``exact_dot3``) on the same float64 inputs,
    rtol 1e-10 (atol 1e-12), with a scalar and an ARD lengthscale."""
    a = kappa_inputs(kind, m=m, ard=ard)
    ref = pk._kappa_xla_twin(*(jnp.asarray(a[k]) for k in ("X", "Z", "L_invT", "ls")), a["var"], a["jitt"], kind)
    for name, o, r in zip(("kappa", "Ktilde"), port_kappa(a, kind), ref):
        close(o, r, rtol=1e-10, atol=1e-12, msg=name)


def test_cavi_stats_plain_matches_pallas_interpret_and_xla():
    """Kernel 7's plain version against the Pallas kernel in TPU interpret
    mode (B=300, tile 128) at tests/test_pallas.py's tolerances (s1 rtol
    2e-4, atol 1e-4; S2 rtol 2e-3, atol 1e-4), and against the XLA products
    at rtol 1e-10."""
    a = kappa_inputs()
    kappa = port_kappa(a, "rbf")[0]
    g, th = T(a["g"]), T(a["theta"])
    with pltpu.force_tpu_interpret_mode():
        s1_j, s2_j = pk.cavi_stats(jnp.asarray(kappa.numpy()), jnp.asarray(a["g"]), jnp.asarray(a["theta"]), tile_b=128)
    s1, s2 = ck.cavi_stats(kappa, g, th)
    close(s1, s1_j, rtol=2e-4, atol=1e-4, msg="s1")
    close(s2, s2_j, rtol=2e-3, atol=1e-4, msg="S2")
    kj = jnp.asarray(kappa.numpy())
    close(s1, kj.T @ jnp.asarray(a["g"]), rtol=1e-10, atol=1e-12, msg="s1")
    close(s2, (kj * jnp.asarray(a["theta"])[:, None]).T @ kj, rtol=1e-10, atol=1e-12, msg="S2")


def test_cpu_pair_counts_no_launch_and_keeps_dtype():
    a = kappa_inputs()
    before = (ck.fused_kappa.launches, ck.cavi_stats.launches)
    f32 = {k: torch.as_tensor(a[k], dtype=torch.float32) for k in ("X", "Z", "L_invT", "g", "theta")}
    kappa, kt = ck.fused_kappa(f32["X"], f32["Z"], f32["L_invT"], 1.3, 2.0, 1e-3)
    s1, s2 = ck.cavi_stats(kappa, f32["g"], f32["theta"])
    assert (ck.fused_kappa.launches, ck.cavi_stats.launches) == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in (kappa, kt, s1, s2))
    assert kappa.shape == (B, M) and kt.shape == (B,) and s2.shape == (M, M)


# ------------------------------------------------------- kernel 6's gradient
NAMES = ("X", "Z", "L_invT", "ls", "var")


def twin_grads(a, kind, w):
    def loss(X, Z, L_invT, ls, var):
        kappa, kt = pk._kappa_xla_twin(X, Z, L_invT, ls, var, a["jitt"], kind)
        return jnp.sum(kappa * w[0]) + jnp.sum(kt * w[1])

    return jax.grad(loss, argnums=tuple(range(5)))(*(jnp.asarray(a[k]) for k in NAMES))


@pytest.mark.parametrize("through", ["plain", "function"])
@pytest.mark.parametrize("kind,ard", [("rbf", False), ("rbf", True), ("matern32", True)])
def test_fused_kappa_gradient_matches_jax_grad(monkeypatch, exact_dot3, kind, ard, through):
    """The gradient of a weighted sum of (kappa, Ktilde) with respect to X,
    Z, L^-T, the lengthscale (scalar or [D]) and the variance, against
    jax.grad through the reference's _kappa_xla_twin (``exact_dot3``), float64, rtol 1e-8
    (atol 1e-10): through the plain version (a CPU tensor) and through
    kernel 6's autograd.Function, whose forward is the kernel and whose
    backward the plain version's vjp (here the launch replaced by the plain
    forward)."""
    a = kappa_inputs(kind, ard=ard)
    rng = np.random.default_rng(7)
    w = (rng.normal(size=(B, M)), rng.normal(size=B))
    inputs = [T(a[k]).requires_grad_(True) for k in NAMES]
    if through == "plain":
        kappa, kt = ck.fused_kappa(*inputs[:4], inputs[4], a["jitt"], kind)
    else:
        monkeypatch.setattr(ck, "_fused_kappa_launch", lambda *args: ck._fused_kappa_from_kinv(*args))
        X, Z, L_invT, ls, var = inputs
        ls_d = torch.broadcast_to(ls.reshape(-1), (D,))
        kappa, kt = ck._FusedKappa.apply(X, Z, ck._kinv(L_invT), ls_d, var.reshape(()), a["jitt"], kind)
    loss = torch.sum(kappa * T(w[0])) + torch.sum(kt * T(w[1]))
    for name, g_t, g_j in zip(NAMES, torch.autograd.grad(loss, inputs), twin_grads(a, kind, w)):
        close(g_t, g_j, rtol=1e-8, atol=1e-10, msg=name)


class _Memory(TorchDispatchMode):
    """The largest number of elements of any tensor an op makes."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numel = max([self.numel] + [t.numel() for t in tree_leaves(out) if isinstance(t, torch.Tensor)])
        return out


@pytest.mark.parametrize("which", ["kernel 4", "kernel 6"])
@pytest.mark.parametrize("d", [8, 64, 256])
def test_plain_backward_memory_does_not_grow_with_d(which, d):
    """The backward of kernels 4 and 6 (their plain versions' vjp) through
    the closed-form gradient of r2: autograd saves no per-feature
    difference (what it saves grows with D only by the [L, B, D] and
    [L, M, D] inputs, where the differences alone would be [L, B, M, D]),
    no op of the backward makes more than [L, B, M] or an input's size, and
    the gradient equals autograd through the unchunked differences at rtol
    1e-10."""
    n_latent, b, m = (2, 64, 64) if which == "kernel 4" else (1, 64, 64)
    rng = np.random.default_rng(d)
    X = T(rng.normal(size=(b, d))).requires_grad_(True)
    Z = T(rng.normal(size=(n_latent, m, d))).requires_grad_(True)
    L_invT = T(np.broadcast_to(np.eye(m), (n_latent, m, m)).copy())
    ls = T(np.full((n_latent, d), 0.5 * d**0.5)).requires_grad_(True)
    w = T(rng.normal(size=(n_latent, b, m)))

    def forward(sq_dist):
        if which == "kernel 4":
            mu, Sigma = T(rng.normal(size=(n_latent, m))), L_invT.clone()
            return ck.fused_kappa_moments_batched_reference(X, Z, L_invT, ls, T(np.ones(n_latent)), mu, Sigma,
                                                            1e-4, "rbf")[0]
        return ck.fused_kappa_reference(X, Z[0], L_invT[0], ls[0], 1.0, 1e-4, "rbf")[0][None]

    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t, lambda t: t):
        kappa = forward(ck._sq_dist_chunked)
    with _Memory() as seen:
        grads = torch.autograd.grad(torch.sum(kappa * w), (X, Z, ls))
    inputs = n_latent * (b + m) * d
    assert sum(saved) <= 12 * n_latent * b * m + 3 * n_latent * m * m + 4 * inputs, sum(saved)
    assert seen.numel <= max(n_latent * b * m, n_latent * m * m, inputs)

    def unchunked(x, z):
        diff = x[:, :, None, :] - z[:, None, :, :]
        return torch.sum(diff * diff, dim=-1)

    original = ck._sq_dist_chunked
    try:
        ck._sq_dist_chunked = unchunked
        ref = torch.autograd.grad(torch.sum(forward(unchunked) * w), (X, Z, ls))
    finally:
        ck._sq_dist_chunked = original
    for name, g, r in zip(("X", "Z", "ls"), grads, ref):
        close(g, r, rtol=1e-10, atol=1e-12, msg=name)


# ------------------------------------------------------------ the dispatch
def _spy(monkeypatch, names):
    calls = {name: 0 for name in names}
    for name in names:
        fn = getattr(ck, name)

        def spy(*args, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)

        monkeypatch.setattr(ck, name, spy)
    return calls


PAIRS = ("fused_kappa", "cavi_stats", "fused_kappa_moments_batched", "cavi_stats_batched")


@pytest.mark.parametrize("which", ["logistic", "multiclass"])
def test_row_weighted_step_and_elbo_take_the_split_pairs(monkeypatch, which):
    """In the fused range (M=32), a row-weighted step takes kernels 6-7 for
    one latent and kernels 4-5 for several, once each, and no fused pass;
    elbo takes kernel 6 or kernel 4 once."""
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(256, 3)))
    lik, y = ((agt.LogisticLikelihood.create(), torch.sign(X[:, 0])) if which == "logistic"
              else (agt.LogisticSoftMaxLikelihood.create(3), torch.argmax(X, dim=1)))
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik, agt.AnalyticSVI(64), X[:32],
                            optimiser=None)
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X, y_t)
    calls = _spy(monkeypatch, PAIRS + ("fused_cavi_stats", "fused_cavi_stats_multiclass"))
    model, state = tav.variational_update(model, state, X[:64], y_t[:64], w=torch.ones(64, dtype=X.dtype))
    kappa_k, stats_k = PAIRS[:2] if which == "logistic" else PAIRS[2:]
    assert calls == {**dict.fromkeys(calls, 0), kappa_k: 1, stats_k: 1}
    assert torch.isfinite(agt.elbo(model, state, X[:64], y_t[:64]))
    assert calls == {**dict.fromkeys(calls, 0), kappa_k: 2, stats_k: 1}


# ------------------------------------------------ 10 steps at M=130 with ARD
def test_studentt_ard_steps_at_m130_match_reference():
    """10 slice-sampled Student-t steps at M=130 (beyond the fused range)
    with ARD lengthscales through the plain versions of kernels 6-7 (the
    port) and the XLA path (the JAX package): eta, mu, Sigma, the local
    variables after each step at rtol 1e-8."""
    X, _, y = single_latent_data("studentt", 1024, D)
    ls = np.random.default_rng(3).uniform(1.5, 2.5, size=D)
    runs = replay_steps(*jax_svgp(X, y, 130, 256, sampling="slice", lengthscale=ls,
                                  likelihood=agp.StudentTLikelihood.create(4.0, 0.7)), 10)
    assert tav._fused_spec(runs["port"][0]) is None
    check_steps(runs)
