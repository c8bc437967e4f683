"""The port's fused_cavi_stats (ops/cuda_kernels.py) against the JAX package:
its plain version against the unfused JAX math and against the Pallas
kernel (interpret mode).  B=300 leaves a ragged last tile.  The CUDA
kernel against the plain version is in test_torch_cuda.py, which imports
no JAX so that it runs on a machine with a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import agp_tpu as agp
from agp_tpu.inference.analytic_vi import compute_kmat, latent_moments
from agp_tpu.kernels import batch_gram_zz
from agp_tpu.ops import pallas_kernels as pk
from agp_tpu.training.state import TrainState
from agp_tpu_torch.ops import cuda_kernels as ck

B, D, M = 300, 8, 64
LS, VAR, RHO = 1.3, 2.0, 3.0

KINDS = {
    "rbf": agp.SqExponentialKernel,
    "matern12": agp.Matern12Kernel,
    "matern32": agp.Matern32Kernel,
    "matern52": agp.Matern52Kernel,
}


def inputs(kind="rbf", seed=0, b=B, d=D, m=M):
    """Numpy inputs and the JAX model/state/kmat they come from (float64)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, d))
    Z = rng.normal(size=(m, d))
    y = np.where(rng.normal(size=b) > 0, 1.0, -1.0)
    mu = rng.normal(size=m)
    A = rng.normal(size=(m, m))
    Sigma = A @ A.T / m + np.eye(m)
    model = agp.SVGP.create(
        KINDS[kind](lengthscale=jnp.asarray(LS), variance=jnp.asarray(VAR)),
        agp.LogisticLikelihood.create(), agp.AnalyticVI(), Z=jnp.asarray(Z), optimiser=None,
    )
    kmat = compute_kmat(model, jnp.asarray(X))
    arrays = dict(X=X, Z=Z, y=y, mu=mu, Sigma=Sigma, L_invT=np.array(kmat["L_inv"][0]).T,
                  jitt=1e-4)
    return arrays, model, kmat


def port_call(a, fn=ck.fused_cavi_stats, dtype=torch.float64, device="cpu", kind="rbf"):
    t = {k: torch.as_tensor(a[k], dtype=dtype, device=device)
         for k in ("X", "y", "Z", "L_invT", "mu", "Sigma")}
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"],
              LS, VAR, a["jitt"], RHO, kind=kind, lik="logistic")


@pytest.mark.parametrize("kind", list(KINDS))
def test_plain_matches_unfused_jax_math(kind):
    """Plain version (f64) against the JAX package's unfused path:
    latent_moments + LogisticLikelihood.local_updates + the statistic
    einsums of apply_natural_gradient.  rtol 1e-9 (atol 1e-10): float64 on
    both sides; K^-1 comes from L^-T L^-1 here and from the Cholesky solve
    there, which differ by cond(Kmm) * 1e-16."""
    a, model, kmat = inputs(kind)
    state = TrainState(mu=jnp.asarray(a["mu"])[None], Sigma=jnp.asarray(a["Sigma"])[None])
    mf, vf, kappa = latent_moments(model, state, jnp.asarray(a["X"]), kmat)
    _, local = model.likelihood.local_updates(
        jnp.asarray(a["y"]), mf, vf, model.likelihood.init_local_vars(B, jnp.float64)
    )
    k1 = np.asarray(kappa[0])
    th = np.asarray(local["theta"])
    ref = dict(
        s1=k1.T @ (RHO * a["y"] / 2), S2=(k1 * (RHO * th / 2)[:, None]).T @ k1,
        c=np.asarray(local["c"]), theta=th, mf=np.asarray(mf[0]), vf=np.asarray(vf[0]),
    )
    out = dict(zip(("s1", "S2", "c", "theta", "mf", "vf"), port_call(a, kind=kind)))
    for name, r in ref.items():
        np.testing.assert_allclose(out[name].numpy(), r, rtol=1e-9, atol=1e-10, err_msg=name)


def test_plain_matches_pallas_kernel_interpret():
    """Plain version against the Pallas kernel itself, run in TPU interpret
    mode as tests/test_pallas.py runs it.  The kernel's bf16-split dots
    (_dot3) make that arm float32-grade: rtol/atol 1e-4 for s1, mf, vf, c,
    theta, and rtol 5e-3 / atol 1e-3 for S2, the same tolerances as
    tests/test_pallas.py, whose Kmm jitter (1e-3) this test takes too."""
    a, model, _ = inputs(seed=1)
    a["jitt"] = 1e-3
    K = np.array(batch_gram_zz(model.kernel, model.Z)[0]) + 1e-3 * np.eye(M)
    a["L_invT"] = np.linalg.inv(np.linalg.cholesky(K)).T
    with pltpu.force_tpu_interpret_mode():
        ref = pk.fused_cavi_stats(
            *(jnp.asarray(a[k]) for k in ("X", "y", "Z", "L_invT", "mu", "Sigma")),
            LS, VAR, a["jitt"], RHO, kind="rbf", lik="logistic", tile_b=128,
        )
    out = port_call(a)
    for name, o, r in zip(("s1", "S2", "c", "theta", "mf", "vf"), out, ref):
        tol = dict(rtol=5e-3, atol=1e-3) if name == "S2" else dict(rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(o.numpy(), np.asarray(r), err_msg=name, **tol)


def test_cpu_path_counts_no_launch_and_keeps_dtype():
    a, _, _ = inputs()
    before = ck.fused_cavi_stats.launches
    out = port_call(a, dtype=torch.float32)
    assert ck.fused_cavi_stats.launches == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for o in out)


def test_cuda_argument_checks():
    """What the CUDA kernel does not take is refused before any launch."""
    a, _, _ = inputs()
    t = {k: torch.as_tensor(a[k], dtype=torch.float32) for k in ("X", "y", "Z", "mu", "Sigma")}
    args = (t["X"], t["y"], t["Z"], t["mu"], t["Sigma"])
    ck._check_cuda_args(*args, "rbf", "logistic")
    for kind in ck.KINDS:
        for lik in ck.LIKS:
            ck._check_cuda_args(*args, kind, lik)
    with pytest.raises(ValueError, match="kinds"):
        ck._check_cuda_args(*args, "periodic", "logistic")
    with pytest.raises(ValueError, match="likelihoods"):
        ck._check_cuda_args(*args, "rbf", "softmax")
    with pytest.raises(TypeError):
        ck._check_cuda_args(t["X"].double(), *args[1:], "rbf", "logistic")
    with pytest.raises(ValueError):
        ck._check_cuda_args(t["X"], t["y"], t["Z"], t["mu"], t["Sigma"].T, "rbf", "logistic")
    with pytest.raises(ValueError):
        ck._check_cuda_args(t["X"], t["y"][:10], t["Z"], t["mu"], t["Sigma"], "rbf", "logistic")
    big = inputs(b=16, m=ck.MAX_M + 1)[0]
    tb = {k: torch.as_tensor(big[k], dtype=torch.float32) for k in ("X", "y", "Z", "mu", "Sigma")}
    with pytest.raises(ValueError, match="M <="):
        ck._check_cuda_args(tb["X"], tb["y"], tb["Z"], tb["mu"], tb["Sigma"], "rbf", "logistic")
