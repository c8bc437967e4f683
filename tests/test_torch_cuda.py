"""The port's CUDA kernels against their plain versions on the card, the
wrappers' refusals, and the main paths' launch counts.  These tests need an NVIDIA GPU and skip
elsewhere; the file imports no JAX so that it runs on a machine with a card
(``python -m pytest tests/test_torch_cuda.py -m cuda``)."""
import numpy as np
import pytest
import torch

import agp_tpu_torch as agt
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.ops import linalg

LS, VAR, RHO, JITT = 2.0, 1.0, 40.0, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def kernel_inputs(b, m, d, device, seed=0):
    """Float32 inputs on ``device``: Z from the data as the main path takes
    it, a random SPD Sigma."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(m, m))
    arrays = dict(
        X=X[m:], Z=X[:m], y=np.where(rng.normal(size=b) > 0, 1.0, -1.0),
        mu=rng.normal(size=m), Sigma=A @ A.T / m + np.eye(m),
    )
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
    kern = agt.SqExponentialKernel(lengthscale=LS, variance=VAR)
    L = linalg.safe_cholesky(kern.gram(t["Z"].double()), JITT)
    eye = torch.eye(m, dtype=torch.float64, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.float()
    return t


def call(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], LS, VAR, JITT, RHO)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(4096, 64), (300, 64), (4096, 128)])
def test_cuda_kernel_matches_plain(cuda_device, b, m):
    """CUDA kernel against the plain version on the same card tensors, both
    float32.  The sums run in another order; the tolerance is 1e-4 of each
    output's largest entry (float32 against float64 the plain version is off
    by ~1e-6 here, where Kmm has cond ~5)."""
    t = kernel_inputs(b, m, 20, cuda_device)
    before = ck.fused_cavi_stats.launches
    out = call(ck.fused_cavi_stats, t)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 1
    ref = call(ck.fused_cavi_stats_reference, t)
    for name, o, r in zip(("s1", "S2", "c", "theta", "mf", "vf"), out, ref):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
def test_train_launches_once_per_step(cuda_device):
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32, device=cuda_device)
    y = torch.where(X[:, 0] > 0, 1.0, -1.0)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
        agt.AnalyticSVI(512, minibatch_sampling="block"), X[:32], optimiser=None,
    )
    before = ck.fused_cavi_stats.launches
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 20
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


def multi_inputs(b, m, n_latent, d, device, seed=0):
    """Float32 card tensors for the multi-latent kernels: per-latent ARD
    lengthscales, Z from the data, random SPD Sigma, one-hot labels
    (multiclass) and real targets (heteroscedastic)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(n_latent, m, m))
    ls = rng.uniform(1.5, 2.5, size=(n_latent, d))
    arrays = dict(
        X=X[m:], Z=np.stack([X[:m]] * n_latent), ls=ls, var=rng.uniform(0.8, 1.2, size=n_latent),
        mu=rng.normal(size=(n_latent, m)), Sigma=A @ A.transpose(0, 2, 1) / m + np.eye(m),
        onehot=np.eye(n_latent)[rng.integers(0, n_latent, size=b)], yr=np.sin(X[m:, 0]),
        alpha=rng.uniform(1.0, 2.0 * n_latent, size=b), beta=np.full(b, float(n_latent)),
    )
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
    kern = agt.SqExponentialKernel()
    L = torch.stack([linalg.safe_cholesky(kern.gram(t["Z"][l].double() / t["ls"][l].double()) * float(arrays["var"][l]), JITT)
                     for l in range(n_latent)])
    eye = torch.eye(m, dtype=torch.float64, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).mT.float().contiguous()
    return t


def call_mc(fn, t):
    return fn(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], JITT, RHO,
              t["alpha"], t["beta"])


def call_het(fn, t, lam=3.0):
    return fn(t["X"], t["yr"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], JITT, RHO, lam)


def assert_kernel_matches_plain(wrapper, plain, call, t, names):
    before = wrapper.launches
    out = call(wrapper, t)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = call(plain, t)
    for name, o, r in zip(names, out, ref):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(2048, 64), (300, 64), (2048, 128)])
def test_cuda_multiclass_kernel_matches_plain(cuda_device, b, m):
    """fused_cavi_stats_multiclass at K=10, D=10 against its plain version on
    the same card tensors, both float32: 1e-4 of each output's largest
    entry (sums in another order, the series digamma against
    torch.special.digamma)."""
    t = multi_inputs(b, m, 10, 10, cuda_device)
    assert_kernel_matches_plain(ck.fused_cavi_stats_multiclass, ck.fused_cavi_stats_multiclass_reference, call_mc, t,
                                ("s1", "S2", "c", "theta", "gamma", "alpha"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(2048, 64), (300, 64), (2048, 128)])
def test_cuda_het_kernel_matches_plain(cuda_device, b, m):
    """fused_cavi_stats_het at D=10 against its plain version, as above."""
    t = multi_inputs(b, m, 2, 10, cuda_device)
    assert_kernel_matches_plain(ck.fused_cavi_stats_het, ck.fused_cavi_stats_het_reference, call_het, t,
                                ("s1", "S2", "c", "phi", "gamma", "theta", "sigg"))


@pytest.mark.cuda
def test_cuda_multi_wrappers_raise(cuda_device):
    """On a CUDA tensor the wrappers launch or raise: no fallback for a
    kind, dtype or shape their kernels do not take."""
    t = multi_inputs(64, 16, 3, 4, cuda_device)
    with pytest.raises(NotImplementedError):
        ck.fused_cavi_stats_multiclass(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"],
                                       t["var"], JITT, RHO, t["alpha"], t["beta"], kind="matern32")
    with pytest.raises(TypeError):
        call_mc(ck.fused_cavi_stats_multiclass, {**t, "X": t["X"].double()})
    big = multi_inputs(64, ck.MAX_M + 1, 2, 4, cuda_device)
    with pytest.raises(ValueError, match="M <="):
        call_het(ck.fused_cavi_stats_het, big)
    with pytest.raises(ValueError, match="2 latents"):
        call_het(ck.fused_cavi_stats_het, t)
    th = multi_inputs(64, 16, 2, 4, cuda_device)
    with pytest.raises(NotImplementedError):
        ck.fused_cavi_stats_het(th["X"], th["yr"], th["Z"], th["L_invT"], th["mu"], th["Sigma"], th["ls"],
                                th["var"], JITT, RHO, 1.0, kind="matern52")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["multiclass", "het"])
def test_train_multi_latent_launches_once_per_step(cuda_device, which):
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.normal(size=(4096, 6)), dtype=torch.float32, device=cuda_device)
    if which == "multiclass":
        lik, y, wrapper = agt.LogisticSoftMaxLikelihood.create(4), torch.argmax(X[:, :4], dim=1), ck.fused_cavi_stats_multiclass
    else:
        lik, y, wrapper = agt.HeteroscedasticLikelihood.create(), torch.sin(X[:, 0]), ck.fused_cavi_stats_het
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik,
                            agt.AnalyticSVI(512, minibatch_sampling="slice"), X[:32], optimiser=None)
    before = wrapper.launches
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 20
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()
