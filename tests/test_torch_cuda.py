"""The port's CUDA kernel against its plain version on the card, and the
main path's launch count.  These tests need an NVIDIA GPU and skip
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
