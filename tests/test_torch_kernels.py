"""The port's kernels.py and means.py against agp_tpu.kernels / agp_tpu.means,
float64.  Tolerance: rtol 1e-12 (atol 1e-14): the same formulas, differing
only in the order of the D-axis sums."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
from agp_tpu import kernels as jk
from agp_tpu import means as jm
from agp_tpu_torch import kernels as tk
from agp_tpu_torch import means as tm

RTOL, ATOL = 1e-12, 1e-14


def data(seed=0, N=40, M=12, D=5):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, D)), rng.normal(size=(M, D))


def close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_sq_dist():
    X, Z = data()
    close(tk.sq_dist(torch.as_tensor(X), torch.as_tensor(Z)), jk.sq_dist(jnp.asarray(X), jnp.asarray(Z)))


@pytest.mark.parametrize("ard", [False, True])
def test_sqexponential_gram_and_diag(ard):
    X, Z = data(1)
    ls = np.array([0.7, 1.3, 2.0, 0.9, 1.1]) if ard else np.array(1.7)
    kj = agp.SqExponentialKernel(lengthscale=jnp.asarray(ls), variance=jnp.asarray(2.5))
    kt = tk.SqExponentialKernel(lengthscale=torch.as_tensor(ls), variance=torch.as_tensor(2.5))
    Xj, Zj, Xt, Zt = jnp.asarray(X), jnp.asarray(Z), torch.as_tensor(X), torch.as_tensor(Z)
    close(kt.gram(Xt, Zt), kj.gram(Xj, Zj))
    close(kt.gram(Xt), kj.gram(Xj))
    close(kt.diag(Xt), kj.diag(Xj))


@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("name", ["Matern12Kernel", "Matern32Kernel", "Matern52Kernel"])
def test_matern_gram_and_diag(name, ard):
    """The Matern kernels' gram (cross and self) and diag, and their kind
    for the fused kernels.  The self-gram's diagonal sits at r = 0, where
    r = sqrt of the expanded |x|^2 + |z|^2 - 2 x.z carries the square root
    of that sum's rounding (~1e-8 in float64, summed in another order in
    each package).  Matern-1/2 is linear in r there, so its diagonal
    carries that square root and is held at atol 1e-6; Matern-3/2 and 5/2
    are quadratic in r, so their diagonals carry the rounding of r^2
    itself, times up to 1.5 v (a few 1e-14), and are held at atol 1e-12.
    The rest is held at RTOL."""
    X, Z = data(5)
    ls = np.array([0.7, 1.3, 2.0, 0.9, 1.1]) if ard else np.array(1.7)
    kj = getattr(agp, name)(lengthscale=jnp.asarray(ls), variance=jnp.asarray(2.5))
    kt = getattr(tk, name)(lengthscale=torch.as_tensor(ls), variance=torch.as_tensor(2.5))
    Xj, Zj, Xt, Zt = jnp.asarray(X), jnp.asarray(Z), torch.as_tensor(X), torch.as_tensor(Z)
    close(kt.gram(Xt, Zt), kj.gram(Xj, Zj))
    self_t, self_j = kt.gram(Xt), np.asarray(kj.gram(Xj))
    off = ~np.eye(len(X), dtype=bool)
    close(self_t[torch.as_tensor(off)], self_j[off])
    np.testing.assert_allclose(np.diag(self_t.numpy()), np.diag(self_j), rtol=0,
                               atol=1e-6 if name == "Matern12Kernel" else 1e-12)
    close(kt.diag(Xt), kj.diag(Xj))
    assert tk.fused_kind(kt) == {"Matern12Kernel": "matern12", "Matern32Kernel": "matern32",
                                 "Matern52Kernel": "matern52"}[name]


def test_batch_gram_zz_diag_over_latents():
    X, Z = data(2)
    Z3 = np.stack([Z, Z + 0.1])
    kj = jk.replicate(agp.SqExponentialKernel(lengthscale=jnp.asarray(1.2)), 2)
    kt = tk.replicate(tk.SqExponentialKernel(lengthscale=torch.as_tensor(1.2, dtype=torch.float64)), 2)
    close(tk.batch_gram(kt, torch.as_tensor(X), torch.as_tensor(Z3)), jk.batch_gram(kj, jnp.asarray(X), jnp.asarray(Z3)))
    close(tk.batch_gram(kt, torch.as_tensor(X), torch.as_tensor(Z)), jk.batch_gram(kj, jnp.asarray(X), jnp.asarray(Z)))
    close(tk.batch_gram_zz(kt, torch.as_tensor(Z3)), jk.batch_gram_zz(kj, jnp.asarray(Z3)))
    close(tk.batch_diag(kt, torch.as_tensor(X)), jk.batch_diag(kj, jnp.asarray(X)))


@pytest.mark.parametrize("ard", [False, True])
def test_per_latent_lengthscales(ard):
    """A scalar or an ARD [D] lengthscale replicated to [L] or [L, D], then
    made per-latent, through batch_gram, batch_gram_zz and batch_diag; and
    the [L, D] table the multi-latent fused kernels take."""
    X, Z = data(4)
    L, D = 3, X.shape[1]
    ls = np.array([0.7, 1.3, 2.0, 0.9, 1.1]) if ard else np.array(1.7)
    per_latent = np.stack([ls * (1.0 + 0.2 * l) for l in range(L)])  # [L] or [L, D]
    kj = jk.replicate(agp.SqExponentialKernel(lengthscale=jnp.asarray(ls), variance=jnp.asarray(1.5)), L)
    kt = tk.replicate(tk.SqExponentialKernel(lengthscale=torch.as_tensor(ls), variance=torch.tensor(1.5, dtype=torch.float64)), L)
    assert tuple(kt.lengthscale.shape) == kj.lengthscale.shape == per_latent.shape
    kj = kj.replace(lengthscale=jnp.asarray(per_latent))
    kt = kt.replace(lengthscale=torch.as_tensor(per_latent))
    Z3 = np.stack([Z + 0.1 * l for l in range(L)])
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    close(tk.batch_gram(kt, Xt, torch.as_tensor(Z3)), jk.batch_gram(kj, Xj, jnp.asarray(Z3)))
    close(tk.batch_gram_zz(kt, torch.as_tensor(Z3)), jk.batch_gram_zz(kj, jnp.asarray(Z3)))
    close(tk.batch_diag(kt, Xt), jk.batch_diag(kj, Xj))
    ls2d = jnp.broadcast_to(jnp.reshape(kj.lengthscale, (L, -1)), (L, D))  # analytic_vi.py:545-548
    close(tk.lengthscale_2d(kt, D), ls2d)


@pytest.mark.parametrize("mean", ["zero", "constant"])
def test_mean_batch_call(mean):
    X, Z = data(3)
    if mean == "zero":
        mj, mt = jm.ZeroMean(), tm.ZeroMean()
    else:
        mj, mt = jm.ConstantMean(c=jnp.asarray(0.3)), tm.ConstantMean(c=torch.tensor(0.3, dtype=torch.float64))
    mj, mt = jm.replicate(mj, 2), tm.replicate(mt, 2)
    close(tm.batch_call(mt, torch.as_tensor(X), 2), jm.batch_call(mj, jnp.asarray(X), 2))
    Z3 = np.stack([Z, Z])
    close(tm.batch_call(mt, torch.as_tensor(Z3), 2), jm.batch_call(mj, jnp.asarray(Z3), 2))
