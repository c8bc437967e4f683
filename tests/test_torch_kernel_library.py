"""The port's kernel library (``agp_tpu_torch/kernels.py``) against the JAX
package's on the same float64 inputs: every form of the reference's
ALL_KERNELS, the input transforms, the unconstrained mapping, the latent
helpers on a nested kernel, WhiteKernel through the kernel matrices and
the predictions, and the dispatch by exact type."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu import kernels as jk
from agp_tpu.inference import analytic_vi as jav
from agp_tpu_torch import kernels as tk
from agp_tpu_torch.inference import analytic_vi as tav
from agp_tpu_torch.utils.tensors import keystr, path_leaves, with_path_leaves
from tests.test_components import ALL_KERNELS
from torch_helpers import close, jax_kernel_leaves, port_kernel

FORM_IDS = [f"{i}-{type(k).__name__}" for i, k in enumerate(ALL_KERNELS)]


def inputs(n=15, m=7, d=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, d)), rng.normal(size=(m, d))


@pytest.mark.parametrize("kj", ALL_KERNELS, ids=FORM_IDS)
def test_form_matches_reference(kj):
    """gram(X, Z), gram(X), gram(X, X) and diag(X) at rtol 1e-12 (atol
    1e-12) against the reference's, in float64."""
    kt = port_kernel(kj)
    Xh, Zh = inputs()
    Xj, Zj, Xt, Zt = jnp.asarray(Xh), jnp.asarray(Zh), torch.as_tensor(Xh), torch.as_tensor(Zh)
    kw = dict(rtol=1e-12, atol=1e-12)
    close(kt.gram(Xt, Zt), kj.gram(Xj, Zj), msg="gram", **kw)
    close(kt.gram(Xt), kj.gram(Xj), msg="symmetric gram", **kw)
    close(kt.gram(Xt, Xt), kj.gram(Xj, Xj), msg="gram of X with itself", **kw)
    close(kt.diag(Xt), kj.diag(Xj), msg="diag", **kw)


def test_input_transforms():
    """The reference's transform identities (test_input_transforms) in the
    port, and each transformed gram against the reference's at 1e-12."""
    Xh = np.random.default_rng(3).normal(size=(12, 3))
    X, Xj = torch.as_tensor(Xh), jnp.asarray(Xh)
    base = agt.SqExponentialKernel()
    kw = dict(rtol=1e-12, atol=1e-12)
    ks = agt.with_transform(base, agt.ScaleTransform(s=0.5))
    close(ks.gram(X, X), agt.SqExponentialKernel(lengthscale=2.0).gram(X, X), **kw)
    v = torch.tensor([0.5, 1.0, 4.0], dtype=torch.float64)
    ka = agt.with_transform(base, agt.ARDTransform(v=v))
    close(ka.gram(X, X), agt.SqExponentialKernel(lengthscale=1.0 / v).gram(X, X), **kw)
    A = np.random.RandomState(0).randn(2, 3)
    kl = agt.with_transform(base, agt.LinearTransform(A=torch.as_tensor(A)))
    XA = X @ torch.as_tensor(A).T
    close(kl.gram(X, X), base.gram(XA, XA), **kw)
    close(kl.diag(X), torch.diagonal(kl.gram(X, X)), **kw)
    ksel = agt.with_transform(base, agt.SelectTransform(dims=(1,)))
    close(ksel.gram(X, X), base.gram(X[:, 1:2], X[:, 1:2]), **kw)
    kf = agt.with_transform(base, agt.FunctionTransform(fn=torch.sin))
    close(kf.gram(X, X), base.gram(torch.sin(X), torch.sin(X)), **kw)
    refs = [
        jk.with_transform(jk.SqExponentialKernel(), jk.LinearTransform(A=jnp.asarray(A))),
        jk.with_transform(jk.SqExponentialKernel(), jk.SelectTransform(dims=(1,))),
        jk.with_transform(jk.SqExponentialKernel(), jk.FunctionTransform(fn=jnp.sin)),
        jk.with_transform(jk.Matern52Kernel(), jk.ChainTransform(transforms=(
            jk.LinearTransform(A=jnp.asarray(A)), jk.ScaleTransform(s=jnp.asarray(0.3))))),
    ]
    for kj in refs:
        close(port_kernel(kj, fn=torch.sin).gram(X, X), kj.gram(Xj, Xj), **kw)


def test_unconstrained_mapping():
    """to_unconstrained / from_unconstrained against the reference's: log on
    positive leaves, identity on FREE_PARAMS (LinearTransform.A), logit on
    UNIT_PARAMS (FBM's Hurst index), static fields untouched; a +50 step
    in the Hurst index's logit saturates at 1 and the gram stays PSD."""
    A = jnp.asarray([[1.0, -2.0], [0.5, 3.0]])
    kj = (jk.with_transform(jk.SqExponentialKernel(lengthscale=jnp.asarray(2.0)), jk.LinearTransform(A=A))
          + jk.FBMKernel(hurst=jnp.asarray(0.4)) * jk.PolynomialKernel(degree=3))
    kt = port_kernel(kj)
    u_j, u_t = jk.to_unconstrained(kj), tk.to_unconstrained(kt)
    ref = jax_kernel_leaves(u_j)
    got = path_leaves(u_t)
    assert list(got) == list(ref)
    for p in ref:
        close(got[p], ref[p], rtol=1e-12, atol=1e-14, msg=p)
    close(u_t.left.transform.A, A, rtol=0, atol=0)
    close(u_t.right.left.hurst, np.log(0.4 / 0.6), rtol=1e-12)
    assert u_t.right.right.degree == 3
    back = tk.from_unconstrained(u_t)
    for p, v in path_leaves(back).items():
        close(v, path_leaves(kt)[p], rtol=1e-12, msg=p)
    fbm = agt.FBMKernel(hurst=0.4)
    u = tk.to_unconstrained(fbm)
    sat = tk.from_unconstrained(u.replace(hurst=u.hurst + 50.0))
    ref_sat = jk.from_unconstrained(jk.to_unconstrained(jk.FBMKernel(hurst=jnp.asarray(0.4))).replace(
        hurst=jnp.asarray(np.log(0.4 / 0.6) + 50.0)))
    close(sat.hurst, ref_sat.hurst, rtol=1e-15)
    assert 0.0 < float(sat.hurst) <= 1.0
    X = torch.as_tensor(np.random.default_rng(0).normal(size=(12, 2)))
    evals = torch.linalg.eigvalsh(sat.gram(X, X))
    assert bool(torch.isfinite(evals).all()) and float(evals.min()) > -1e-7


def composite(lib):
    """Path 42's kernel form with a chain transform, in either package."""
    A = np.random.default_rng(5).normal(size=(2, 3))
    arr = jnp.asarray if lib is jk else (lambda a: torch.as_tensor(np.asarray(a)))
    chain = lib.ChainTransform(transforms=(lib.LinearTransform(A=arr(A)), lib.ARDTransform(v=arr([0.5, 2.0]))))
    return lib.with_transform(lib.Matern32Kernel(), chain) + lib.LinearKernel(variance=arr(0.1))


def test_replicate_and_batch_gram_of_a_nested_kernel():
    """replicate, latent, batch_gram (shared and per-latent Z), batch_gram_zz
    and batch_diag of a composite kernel over 3 latents whose leaves differ
    by latent, against the reference's vmapped ones at 1e-12; the latent
    count read from the first leaf in path order."""
    L = 3
    kj = jk.replicate(composite(jk), L)
    scale = jnp.asarray([1.0, 1.3, 0.7])
    kj = jax.tree_util.tree_map(lambda a: a * scale.reshape((L,) + (1,) * (a.ndim - 1)), kj)
    kt = tk.replicate(composite(tk), L)
    kt = with_path_leaves(kt, {p: torch.as_tensor(v) for p, v in jax_kernel_leaves(kj).items()})
    assert tk.n_latent(kt) == L
    assert [p for p in path_leaves(kt)] == list(jax_kernel_leaves(kj))
    rng = np.random.default_rng(1)
    Xh, Zh, Z3 = rng.normal(size=(9, 3)), rng.normal(size=(5, 3)), rng.normal(size=(L, 5, 3))
    kw = dict(rtol=1e-12, atol=1e-12)
    X, Z = torch.as_tensor(Xh), torch.as_tensor(Zh)
    close(tk.batch_gram(kt, X), jk.batch_gram(kj, jnp.asarray(Xh)), **kw)
    close(tk.batch_gram(kt, X, Z), jk.batch_gram(kj, jnp.asarray(Xh), jnp.asarray(Zh)), **kw)
    close(tk.batch_gram(kt, X, torch.as_tensor(Z3)), jk.batch_gram(kj, jnp.asarray(Xh), jnp.asarray(Z3)), **kw)
    close(tk.batch_gram_zz(kt, torch.as_tensor(Z3)), jk.batch_gram_zz(kj, jnp.asarray(Z3)), **kw)
    close(tk.batch_diag(kt, X), jk.batch_diag(kj, jnp.asarray(Xh)), **kw)
    close(tk.latent(kt, 1).right.variance, 0.13, rtol=1e-12)


def test_white_kernel_through_kmat_and_predictions():
    """WhiteKernel adds its variance where the reference's does: Kmm
    (batch_gram_zz's gram of Z with itself), a VGP's K over its training
    inputs, predict_f's full covariance (the gram of X_test with itself),
    never the cross gram; each against the reference at 1e-10."""
    rng = np.random.default_rng(2)
    Xh = rng.normal(size=(30, 2))
    y = np.sin(Xh[:, 0]) + 0.1 * rng.normal(size=30)
    kj = jk.SqExponentialKernel() + jk.WhiteKernel(variance=jnp.asarray(0.3))
    mj = agp.SVGP.create(kj, agp.GaussianLikelihood.create(0.1), agp.AnalyticVI(), jnp.asarray(Xh[:8]),
                         optimiser=None)
    mt = agt.SVGP.create(port_kernel(kj), agt.GaussianLikelihood.create(0.1), agt.AnalyticVI(),
                         torch.as_tensor(Xh[:8]), optimiser=None)
    kmj, kmt = jav.compute_kmat(mj, jnp.asarray(Xh)), tav.compute_kmat(mt)
    close(kmt["L_K"], kmj["L_K"], rtol=1e-10, atol=1e-12)
    K = kmt["L_K"][0] @ kmt["L_K"][0].T
    plain = agt.SqExponentialKernel().gram(torch.as_tensor(Xh[:8]), torch.as_tensor(Xh[:8]))
    close(torch.diagonal(K - plain), np.full(8, 0.3 + 1e-4), rtol=1e-10)
    mj, sj = agp.train(mj, jnp.asarray(Xh), y, iterations=3)
    mt, st = agt.train(mt, torch.as_tensor(Xh), torch.as_tensor(y), iterations=3)
    Xs = rng.normal(size=(6, 2))
    mu_j, cov_j = agp.predict_f(mj, sj, jnp.asarray(Xs), cov=True, diag=False)
    mu_t, cov_t = agt.predict_f(mt, st, torch.as_tensor(Xs), cov=True, diag=False)
    close(mu_t, mu_j, rtol=1e-10, atol=1e-12)
    close(cov_t, cov_j, rtol=1e-10, atol=1e-12)
    _, var_t = agt.predict_f(mt, st, torch.as_tensor(Xs), cov=True)
    close(var_t, np.diag(np.asarray(cov_j)), rtol=1e-10, atol=1e-12)
    vj = agp.VGP.create(jnp.asarray(Xh), y, kj, agp.GaussianLikelihood.create(0.1), agp.AnalyticVI(), optimiser=None)
    vt = agt.VGP.create(torch.as_tensor(Xh), torch.as_tensor(y), port_kernel(kj), agt.GaussianLikelihood.create(0.1),
                        agt.AnalyticVI(), optimiser=None)
    close(tav.compute_kmat(vt, vt.train_x)["L_K"], jav.compute_kmat(vj, vj.train_x)["L_K"], rtol=1e-10, atol=1e-12)


def test_dispatch_by_exact_type():
    """A scalar times a fused kernel keeps its type (and the fused kernels);
    a sum, a product, a transformed kernel and the new kernels take the
    plain kappa."""
    k = 2.5 * agt.SqExponentialKernel()
    assert type(k) is agt.SqExponentialKernel and tk.fused_kind(k) == "rbf"
    close(k.variance, 2.5, rtol=0)
    assert tk.fused_kind(agt.Matern52Kernel() * 0.5) == "matern52"
    for other in (agt.SqExponentialKernel() + agt.Matern32Kernel(), agt.SqExponentialKernel() * agt.LinearKernel(),
                  agt.with_transform(agt.SqExponentialKernel(), agt.ScaleTransform()), agt.RationalQuadraticKernel(),
                  agt.PeriodicKernel(), agt.WhiteKernel()):
        assert tk.fused_kind(other) is None
    with pytest.raises(AttributeError):
        agt.with_transform(agt.SqExponentialKernel(), agt.ScaleTransform()) * 2.0


def test_path_leaves_round_trip_and_reference_paths():
    """path_leaves walks a nested kernel in declaration order (left before
    right, inner before transform, a chain's transforms in order, static
    fields skipped); with_path_leaves puts values back; keystr writes the
    reference's tree_flatten_with_path paths."""
    kj, kt = composite(jk), composite(tk)
    ref = jax.tree_util.tree_flatten_with_path(kj)[0]
    leaves = path_leaves(kt)
    assert [keystr(p) for p in leaves] == [jax.tree_util.keystr(p) for p, _ in ref]
    doubled = with_path_leaves(kt, {p: 2 * v for p, v in leaves.items()})
    for p, v in path_leaves(doubled).items():
        close(v, 2 * leaves[p], rtol=0)
    assert doubled.left.transform.transforms[0].A.shape == (2, 3)
