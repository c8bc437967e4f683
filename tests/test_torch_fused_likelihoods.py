"""The port's fused_cavi_stats on every likelihood branch and gram kind
against the JAX package: its plain version against the unfused JAX math for
every (likelihood, kind) pair, and against the Pallas kernel itself in TPU
interpret mode for each likelihood (rbf) and each kind (Student-t).  B=300
leaves a ragged last tile.  The CUDA kernel against the plain version is in
test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference.analytic_vi import _pallas_fused_spec, compute_kmat, latent_moments, pallas_override
from agp_tpu.kernels import batch_gram_zz
from agp_tpu.ops import pallas_kernels as pk
from agp_tpu.training.state import TrainState
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import close, jax_single_latent, port_lik_same_params, single_latent_labels

B, D, M = 300, 8, 64
LS, VAR, RHO = 1.3, 2.0, 3.0

KINDS = {
    "rbf": agp.SqExponentialKernel,
    "matern12": agp.Matern12Kernel,
    "matern32": agp.Matern32Kernel,
    "matern52": agp.Matern52Kernel,
}
OUTS = ("s1", "S2", "c", "theta", "mf", "vf")


def inputs(lik, kind="rbf", seed=0, jitt=1e-4):
    """Numpy inputs for likelihood ``lik``, and the JAX model and kmat they
    come from (float64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(B, D))
    Z = rng.normal(size=(M, D))
    mu = rng.normal(size=M)
    A = rng.normal(size=(M, M))
    model = agp.SVGP.create(
        KINDS[kind](lengthscale=jnp.asarray(LS), variance=jnp.asarray(VAR)),
        jax_single_latent(lik), agp.AnalyticVI(), Z=jnp.asarray(Z), optimiser=None,
    )
    y, lj = model.likelihood.treat_labels(single_latent_labels(lik, np.sin(X[:, 0]), rng))
    model = model.replace(likelihood=lj)
    kmat = compute_kmat(model, jnp.asarray(X))
    a = dict(X=X, Z=Z, y=np.array(y, dtype=np.float64), mu=mu, Sigma=A @ A.T / M + np.eye(M),
             L_invT=np.array(kmat["L_inv"][0]).T, jitt=jitt)
    return a, model, kmat


def port_call(a, lik_j, kind, dtype=torch.float64, fn=ck.fused_cavi_stats):
    """The port's pass with the likelihood parameters its step hands over
    (analytic_vi._fused_lik_spec)."""
    name, p0, p1, _ = tav._fused_lik_spec(port_lik_same_params(lik_j, dtype))
    t = {k: torch.as_tensor(a[k], dtype=dtype) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma")}
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], LS, VAR, a["jitt"], RHO,
              lik_p0=p0, lik_p1=p1, kind=kind, lik=name)


def reference_spec(model):
    """The reference's (kind, lik, p0, p1, c_key), its fused tier forced on
    (off a TPU its gate is closed)."""
    with pallas_override("on"):
        return _pallas_fused_spec(model)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("lik", ck.LIKS)
def test_plain_matches_unfused_jax_math(lik, kind):
    """Plain version (f64) against the JAX package's unfused path:
    latent_moments + the likelihood's local_updates, grad_e_mu and
    grad_e_sigma + the statistic einsums of apply_natural_gradient.  rtol
    1e-8 (atol 1e-10): float64 on both sides; K^-1 formed two ways.  c is
    the local variable the step stores (none for the Gaussian)."""
    a, model, kmat = inputs(lik, kind)
    lj = model.likelihood
    state = TrainState(mu=jnp.asarray(a["mu"])[None], Sigma=jnp.asarray(a["Sigma"])[None])
    mf, vf, kappa = latent_moments(model, state, jnp.asarray(a["X"]), kmat)
    y = jnp.asarray(a["y"])
    _, local = lj.local_updates(y, mf, vf, lj.init_local_vars(B, jnp.float64))
    k1 = np.asarray(kappa[0])
    gmu, gs = np.asarray(lj.grad_e_mu(y, local)[0]), np.asarray(lj.grad_e_sigma(y, local)[0])
    ref = dict(s1=k1.T @ (RHO * gmu), S2=(k1 * (RHO * gs)[:, None]).T @ k1, theta=local["theta"],
               mf=mf[0], vf=vf[0])
    c_key = reference_spec(model)[4]
    if c_key is not None:
        ref["c"] = local[c_key]
    out = dict(zip(OUTS, port_call(a, lj, kind)))
    for name, r in ref.items():
        close(out[name], r, rtol=1e-8, atol=1e-10, msg=name)


def test_fused_lik_spec_matches_reference():
    """_fused_lik_spec hands the kernel the parameters the reference's
    _pallas_fused_spec does (Student-t: sigma^2; Laplace: a; Poisson: lam)
    and names the same local variable for c."""
    for lik in ck.LIKS:
        model = inputs(lik)[1]
        _, name, p0, p1, c_key = reference_spec(model)
        got = tav._fused_lik_spec(port_lik_same_params(model.likelihood))
        assert got[0] == name == lik and got[3] == c_key
        close(torch.as_tensor(got[1]), p0, rtol=1e-12, msg=f"{lik} p0")
        close(torch.as_tensor(got[2]), p1, rtol=1e-12, msg=f"{lik} p1")


CASES = [(lik, "rbf") for lik in ck.LIKS] + [("studentt", kind) for kind in ck.KINDS[1:]]


@pytest.mark.parametrize("lik,kind", CASES)
def test_plain_matches_pallas_kernel_interpret(lik, kind):
    """Plain version against the Pallas kernel itself, in TPU interpret mode
    as tests/test_pallas.py runs it, at that file's tolerances: its fused
    step's rtol 1e-2 / atol 1e-4 for s1 and S2 (what mu and Sigma are made
    of) and rtol 1e-3 for the per-row outputs, with its direct kernel
    test's atol 1e-4 for entries near zero (mf crosses 0).  The kernel's
    bf16-split dots make that arm float32-grade.  Kmm jitter 1e-3, as
    there."""
    a, model, _ = inputs(lik, kind, seed=1, jitt=1e-3)
    K = np.array(batch_gram_zz(model.kernel, model.Z)[0]) + 1e-3 * np.eye(M)
    a["L_invT"] = np.linalg.inv(np.linalg.cholesky(K)).T
    _, name, p0, p1, _ = reference_spec(model)
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fused_cavi_stats(
            *(jnp.asarray(a[k]) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma")),
            LS, VAR, a["jitt"], RHO, lik_p0=p0, lik_p1=p1, kind=kind, lik=name, tile_b=128,
        )
    out = port_call(a, model.likelihood, kind)
    for name, o, r in zip(OUTS, out, ref):
        tol = dict(rtol=1e-2, atol=1e-4) if name in ("s1", "S2") else dict(rtol=1e-3, atol=1e-4)
        close(o, r, msg=name, **tol)


@pytest.mark.parametrize("lik", ck.LIKS)
def test_cpu_path_counts_no_launch_and_keeps_dtype(lik):
    a, model, _ = inputs(lik)
    before = ck.fused_cavi_stats.launches
    out = port_call(a, model.likelihood, "matern32", dtype=torch.float32)
    assert ck.fused_cavi_stats.launches == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" and torch.isfinite(o).all() for o in out)


def test_plain_refuses_unknown_names():
    a, model, _ = inputs("studentt")
    with pytest.raises(ValueError, match="likelihoods"):
        ck.fused_cavi_stats_reference(*(torch.as_tensor(a[k]) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma")),
                                      LS, VAR, 1e-4, RHO, lik="softmax")
    with pytest.raises(ValueError, match="kinds"):
        port_call(a, model.likelihood, "periodic")


def test_every_component_is_fused():
    """Each ported kernel and single-latent likelihood takes the fused pass,
    with no shape gate."""
    Z = torch.zeros((4, 2), dtype=torch.float64)
    for kern_cls, kind in agt.kernels.FUSED_KINDS.items():
        for lik in ck.LIKS:
            lik_t = port_lik_same_params(jax_single_latent(lik))
            model = agt.SVGP.create(kern_cls(), lik_t, agt.AnalyticSVI(8), Z, optimiser=None)
            spec = tav._fused_spec(model)
            assert spec[:2] == (kind, lik)
            assert tav._fused_mc_spec(model) is None and tav._fused_het_spec(model) is None
