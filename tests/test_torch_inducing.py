"""The port's inducing-point algorithms (agp_tpu_torch/inducing) against the
JAX package's, float64: every offline algorithm selects the same points
(with the native library and with the numpy versions), the port's native
OIPS and k-means equal its numpy versions, and each online update
(oips_update, unigrid_update, webscale_update, streamkmeans_update) gives
the same slots, mask and counts as the reference's on the same inputs,
with the tie rules (the first inactive slot, a stable farthest-first
order) and no host read: OIPS's and StreamKmeans' walks (their plain
versions here, ``oips_accept_reference`` and
``streamkmeans_pass_reference``; the CUDA kernels are held to them on the
card, ``tests/test_torch_cuda.py``) in float64 and float32, on random
batches and on the edge cases (a full buffer, no active slot, a point at
exactly rho or r^2, a point that the slots alone would let through and
an earlier point of its batch stops).

Tolerances: a selection of input rows is compared exactly; a computed
point (k-means centres, grid nodes, moved centres) at rtol 1e-12, the same
float64 arithmetic in another summation order; in float32 at rtol 1e-6
(the same operations, XLA's and PyTorch's grams apart)."""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu.utils.native as jax_native
from agp_tpu.inducing import algorithms as ja
from agp_tpu_torch import kernels as tk
from agp_tpu_torch.inducing import algorithms as ta
from agp_tpu_torch.utils import native
from agp_tpu_torch.utils.tensors import host_read

ROOT = Path(__file__).resolve().parent.parent


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def data(n=200, d=2, seed=0):
    return np.random.RandomState(seed).randn(n, d)


@pytest.fixture(params=["native", "numpy"])
def host_tier(request, monkeypatch):
    """Both packages with their native library, or both on their numpy
    versions."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jax_native, "available", lambda: False)
    else:
        assert native.available(), "the port's host library did not build"
    return request.param


def kernel_pair(name, ls):
    """A JAX kernel and the port's, float64, lengthscale ``ls``."""
    kj = getattr(agp, name)(lengthscale=jnp.asarray(ls), variance=jnp.asarray(1.3))
    kt = getattr(tk, name)(lengthscale=t64(ls), variance=t64(1.3))
    return kj, kt


# case: (algorithm and its arguments, the kernel (name, lengthscale) or None)
OFFLINE = {
    "kmeans": (("KmeansAlg", 16), None),
    "kmeans_key": (("KmeansAlg", 12, 7), None),
    "random": (("RandomSubset", 10), None),
    "unigrid": (("UniGrid", 5), None),
    "oips": (("OIPS", 0.8, 64), None),
    "oips_rbf": (("OIPS", 0.6, 40), ("SqExponentialKernel", 0.7)),
    "oips_ard": (("OIPS", 0.6, 40), ("SqExponentialKernel", [0.7, 1.1])),
    "oips_matern": (("OIPS", 0.6, 40), ("Matern32Kernel", 0.7)),
    "greedy": (("GreedyVariance", 12), None),
    "greedy_kernel": (("GreedyVariance", 12), ("Matern52Kernel", 1.2)),
    "unigrid_online": (("UniGridOnline", 4), None),
    "webscale": (("Webscale", 9), None),
    "streamkmeans": (("StreamKmeans", 30, 0.5), None),
}


@pytest.mark.parametrize("case", list(OFFLINE))
def test_offline_selection_matches_reference(case, host_tier):
    """inducingpoints on the same X selects what the reference selects
    (rows exactly; centres and grid nodes at rtol 1e-12); a seed as the
    reference takes it from a key's last word."""
    X = data()
    (name, *args), kernel = OFFLINE[case]
    kj, kt = kernel_pair(*kernel) if kernel is not None else (None, None)
    key = 5 if case == "kmeans_key" else None
    Zj = ja.inducingpoints(getattr(ja, name)(*args), X, key=None if key is None else jax.random.PRNGKey(key),
                           kernel=kj)
    Zt = ta.inducingpoints(getattr(ta, name)(*args), t64(X), key=key, kernel=kt)
    assert Zt.dtype == torch.float64 and Zt.shape == Zj.shape
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-12, atol=0)


def test_selection_of_rows_is_exact(host_tier):
    """OIPS, RandomSubset and GreedyVariance return rows of X, bit for bit."""
    X = data(seed=3)
    for alg in (ta.OIPS(0.7, 50), ta.RandomSubset(10), ta.GreedyVariance(8)):
        Z = ta.inducingpoints(alg, t64(X)).numpy()
        assert all((X == z).all(1).any() for z in Z), alg


def test_native_equals_numpy():
    """The port's C++ OIPS and Lloyd k-means (its own build under
    agp_tpu_torch/_build) equal its numpy versions: OIPS's rows exactly,
    the centres at rtol 1e-12."""
    assert native.available()
    assert Path(native.library_path()).is_relative_to(ROOT / "agp_tpu_torch" / "_build")
    X = data(500, 3, seed=1)
    for rho, ls, cap in ((0.8, 1.0, 64), (0.5, 0.6, 100), (0.95, 2.0, 7)):
        Zn = native.oips(X, rho, ls, cap)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(native, "available", lambda: False)
            kern = tk.SqExponentialKernel(lengthscale=t64(ls), variance=t64(1.0))
            Zp = ta.OIPS(rho, cap)(t64(X), kernel=kern).numpy()
        np.testing.assert_array_equal(Zn, Zp)
    C = native.kmeans(X, 8, n_iters=5, seed=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(native, "available", lambda: False)
        Cp = ta.KmeansAlg(8, n_iters=5)(t64(X), key=2).numpy()
    np.testing.assert_allclose(C, Cp, rtol=1e-12, atol=1e-15)


def test_native_counts_its_calls():
    calls = native.oips.calls
    ta.OIPS(0.8, 16)(t64(data(50)), kernel=tk.SqExponentialKernel(lengthscale=t64(1.0), variance=t64(1.0)))
    assert native.oips.calls == calls + 1


# ------------------------------------------------------------ online updates
def slots(cap, d, active, seed=0):
    """Z [cap, D] with random rows, the mask ``active`` (a list of bools,
    False past its end) and counts 1 on the active slots."""
    Z = np.random.RandomState(seed).uniform(-2, 2, size=(cap, d))
    mask = np.zeros(cap, bool)
    mask[: len(active)] = active
    return Z, mask, mask.astype(np.float64)


DTYPES = {"float64": (torch.float64, np.float64), "float32": (torch.float32, np.float32)}


def oips_both(kj, kt, Z, mask, Xb, rho, dtype):
    """The reference's oips_update (jitted) and the port's, in ``dtype``:
    (Zj, mj, Zt, mt) as numpy arrays; the port's read nothing back."""
    td, nd = DTYPES[dtype]
    Zj, mj = jax.jit(lambda Z, m, x: ja.oips_update(kj, Z, m, x, rho))(jnp.asarray(Z, nd), jnp.asarray(mask),
                                                                      jnp.asarray(Xb, nd))
    reads = host_read.reads
    Zt, mt = ta.oips_update(kt, torch.as_tensor(Z, dtype=td), torch.as_tensor(mask), torch.as_tensor(Xb, dtype=td),
                            rho)
    assert host_read.reads == reads and Zt.dtype == td
    return np.asarray(Zj), np.asarray(mj), Zt.numpy(), mt.numpy()


def kernels_in(name, ls, dtype):
    kj, kt = kernel_pair(name, ls)
    td, nd = DTYPES[dtype]
    return (kj.replace(lengthscale=kj.lengthscale.astype(nd), variance=kj.variance.astype(nd)),
            kt.to(dtype=td))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("active", [[True] * 5, [True, False, True, False, True], [], [True] * 16])
@pytest.mark.parametrize("kernel", [("SqExponentialKernel", 0.6), ("Matern12Kernel", 0.9)])
def test_oips_update_matches_reference(active, kernel, dtype):
    """The same accepted points in the same slots, the first inactive ones
    in order (holes in the mask filled first), as the reference's scan, in
    float64 and float32; no host read; a full buffer accepts nothing."""
    kj, kt = kernels_in(*kernel, dtype)
    Z, mask, _ = slots(16, 2, active)
    Xb = np.random.RandomState(4).uniform(-2, 2, size=(24, 2))
    Zj, mj, Zt, mt = oips_both(kj, kt, Z, mask, Xb, 0.5, dtype)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(Zt, Zj)
    assert int(mt.sum()) > len(active) or len(active) == 16


def oips_edge(case):
    """(Z, mask, X batch, rho) of an OIPS edge case, on dyadic points so
    that every distance is exact in both packages: "full" (no free slot),
    "none_active" (the first point is always accepted), "exactly_rho" (a
    point equal to an active slot, correlation exactly 1, at rho = 1: not
    accepted; the others are), "row_rejects" (two batch points close to
    each other and far from every slot: the first is accepted, and its row
    stops the second, which the slots alone would accept)."""
    Z = np.zeros((8, 2))
    Z[:3] = [[4.0, 4.0], [-4.0, 4.0], [4.0, -4.0]]
    mask = np.zeros(8, bool)
    mask[:3] = True
    Xb = np.array([[0.0, 0.0], [0.25, 0.0], [-4.0, -4.0], [4.0, 4.0], [0.5, 0.5]])
    if case == "full":
        return np.random.RandomState(1).uniform(-2, 2, size=(8, 2)), np.ones(8, bool), Xb, 0.9
    if case == "none_active":
        return Z, np.zeros(8, bool), Xb, 0.5
    if case == "exactly_rho":
        return Z, mask, Xb, 1.0
    return Z, mask, Xb, 0.9


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["full", "none_active", "exactly_rho", "row_rejects"])
def test_oips_walk_edge_cases(case, dtype):
    """The plain walk against the reference's scan on each edge case of
    ``oips_edge``, in float64 and float32: the same slots taken, the same
    rows in them, and the case's own outcome."""
    kj, kt = kernels_in("SqExponentialKernel", 1.0, dtype)
    Z, mask, Xb, rho = oips_edge(case)
    Zj, mj, Zt, mt = oips_both(kj, kt, Z, mask, Xb, rho, dtype)
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(Zt, Zj)
    taken = [tuple(z) for z in Zt[mt & ~mask]]
    if case == "full":
        assert mt.all() and (Zt == Z.astype(Zt.dtype)).all()
    elif case == "none_active":
        assert taken[0] == (0.0, 0.0) and len(taken) == 3  # (0.25, 0) and (0.5, 0.5) stopped by (0, 0)
    elif case == "exactly_rho":
        assert (4.0, 4.0) not in taken and len(taken) == 4
    else:
        g = kt.gram(torch.as_tensor(Xb[1:2], dtype=DTYPES[dtype][0]), torch.as_tensor(Z[:3], dtype=DTYPES[dtype][0]))
        assert float(g.max()) / 1.3 < rho  # the slots alone let (0.25, 0) through
        assert (0.0, 0.0) in taken and (0.25, 0.0) not in taken


def test_unigrid_update_matches_reference():
    """test_components' covering case: the regenerated grid over the widened
    bounds, equal to the reference's (rtol 1e-12), P**D slots active."""
    P, cap = 4, 20
    X1 = np.random.RandomState(0).uniform(size=(20, 2))
    X2 = 2.0 + np.random.RandomState(1).uniform(size=(20, 2))
    Z0 = np.asarray(ja.inducingpoints(ja.UniGridOnline(P), X1))
    Z = np.zeros((cap, 2))
    Z[: P * P] = Z0
    mask = np.zeros(cap, bool)
    mask[: P * P] = True
    Zj, mj = jax.jit(lambda Z, m, x: ja.unigrid_update(Z, m, x, P))(jnp.asarray(Z), jnp.asarray(mask), jnp.asarray(X2))
    Zt, mt = ta.unigrid_update(t64(Z), torch.as_tensor(mask), t64(X2), P)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-12, atol=0)
    act = Zt.numpy()[: P * P]
    np.testing.assert_allclose(act.min(0), np.minimum(X1.min(0), X2.min(0)), rtol=1e-12)
    np.testing.assert_allclose(act.max(0), np.maximum(X1.max(0), X2.max(0)), rtol=1e-12)


@pytest.mark.parametrize("active,k", [([True] * 6, None), ([True] * 3, 10), ([], 8), ([True, False] * 4, 12)])
def test_webscale_update_matches_reference(active, k):
    """Moved centres (rtol 1e-12), the same slots activated farthest first
    (a stable order: with no active centre every distance ties and the
    batch's order decides) and the same counts."""
    Z, mask, counts = slots(16, 2, active, seed=2)
    Xb = np.random.RandomState(5).uniform(-2, 2, size=(12, 2))
    f = jax.jit(lambda Z, m, c, x: ja.webscale_update(Z, m, c, x, k))
    Zj, mj, cj = f(jnp.asarray(Z), jnp.asarray(mask), jnp.asarray(counts), jnp.asarray(Xb))
    Zt, mt, ct = ta.webscale_update(t64(Z), torch.as_tensor(mask), t64(counts), t64(Xb), k)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_allclose(Zt.numpy(), np.asarray(Zj), rtol=1e-12, atol=1e-15)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))


def test_webscale_update_moves_centres_to_cluster_means():
    """test_components' oracle: two far clusters, two active centres; after
    20 batches each centre sits near one cluster's mean."""
    gen = torch.Generator().manual_seed(2)
    c0, c1 = torch.zeros(2, dtype=torch.float64), torch.full((2,), 10.0, dtype=torch.float64)
    Z, mask, counts = torch.stack([c0 + 1.5, c1 - 1.5]), torch.ones(2, dtype=torch.bool), torch.ones(2, dtype=torch.float64)
    for _ in range(20):
        pts = torch.cat([c0 + 0.1 * torch.randn(16, 2, generator=gen, dtype=torch.float64),
                         c1 + 0.1 * torch.randn(16, 2, generator=gen, dtype=torch.float64)])
        Z, mask, counts = ta.webscale_update(Z, mask, counts, pts)
    assert float(torch.linalg.norm(Z[0] - c0)) < 0.3 and float(torch.linalg.norm(Z[1] - c1)) < 0.3
    assert float(counts.min()) > 100


def streamkmeans_both(Z, mask, counts, Xb, r2, cap, dtype):
    """The reference's streamkmeans_update (jitted) and the port's, in
    ``dtype``: (Zj, mj, cj, Zt, mt, ct) as numpy arrays; the port's read
    nothing back."""
    td, nd = DTYPES[dtype]
    f = jax.jit(lambda Z, m, c, x: ja.streamkmeans_update(Z, m, c, x, r2, cap))
    Zj, mj, cj = f(jnp.asarray(Z, nd), jnp.asarray(mask), jnp.asarray(counts, nd), jnp.asarray(Xb, nd))
    reads = host_read.reads
    Zt, mt, ct = ta.streamkmeans_update(torch.as_tensor(Z, dtype=td), torch.as_tensor(mask),
                                        torch.as_tensor(counts, dtype=td), torch.as_tensor(Xb, dtype=td), r2, cap)
    assert host_read.reads == reads and Zt.dtype == ct.dtype == td
    return np.asarray(Zj), np.asarray(mj), np.asarray(cj), Zt.numpy(), mt.numpy(), ct.numpy()


def check_streamkmeans(got, dtype):
    Zj, mj, cj, Zt, mt, ct = got
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_allclose(Zt, Zj, rtol=1e-12 if dtype == "float64" else 1e-6, atol=1e-15)
    np.testing.assert_array_equal(ct, cj)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("active,cap", [([True], None), ([True, False, True], None), ([True] * 6, 7), ([], None)])
def test_streamkmeans_update_matches_reference(active, cap, dtype):
    """Opened and absorbing centres (rtol 1e-12; float32 1e-6), mask and
    counts equal to the reference's scan, in float64 and float32; no host
    read."""
    Z, mask, counts = slots(12, 2, active, seed=3)
    Xb = np.random.RandomState(6).uniform(-2, 2, size=(25, 2))
    check_streamkmeans(streamkmeans_both(Z, mask, counts, Xb, 0.6, cap, dtype), dtype)


def streamkmeans_edge(case):
    """(Z, mask, counts, X batch, r2, cap) of a StreamKmeans edge case, on
    dyadic points (every distance exact in both packages): "full" (cap
    reached: every point absorbed), "none_active" (the first point opens a
    centre), "exactly_r2" (a point at squared distance exactly r2 from its
    nearest centre: absorbed, not opened), "row_rejects" (a point far from
    every centre opens one, and a later point near it, which the centres
    before the batch would open another for, is absorbed by it)."""
    Z = np.zeros((6, 2))
    Z[:2] = [[0.0, 0.0], [8.0, 8.0]]
    mask = np.zeros(6, bool)
    mask[:2] = True
    counts = mask.astype(np.float64) * 2.0
    if case == "full":
        return Z, mask, counts, np.array([[4.0, 4.0], [-4.0, 0.0], [0.5, 0.0]]), 1.0, 2
    if case == "none_active":
        return Z, np.zeros(6, bool), np.zeros(6), np.array([[1.0, 1.0], [1.5, 1.0], [-3.0, 2.0]]), 1.0, None
    if case == "exactly_r2":
        return Z, mask, counts, np.array([[1.0, 0.0], [8.0, 7.0], [0.0, 0.5]]), 1.0, None
    return Z, mask, counts, np.array([[4.0, -4.0], [4.5, -4.0], [0.25, 0.0]]), 1.0, None


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["full", "none_active", "exactly_r2", "row_rejects"])
def test_streamkmeans_walk_edge_cases(case, dtype):
    """The plain walk against the reference's scan on each edge case of
    ``streamkmeans_edge``, in float64 and float32: Z, the mask and the
    counts, and the case's own outcome."""
    Z, mask, counts, Xb, r2, cap = streamkmeans_edge(case)
    got = streamkmeans_both(Z, mask, counts, Xb, r2, cap, dtype)
    check_streamkmeans(got, dtype)
    mt, ct = got[4], got[5]
    if case == "full":
        assert int(mt.sum()) == 2 and ct.sum() == counts.sum() + 3
    elif case == "none_active":
        assert mt[:2].all() and int(mt.sum()) == 2 and list(ct[:2]) == [2.0, 1.0]
    elif case == "exactly_r2":
        assert int(mt.sum()) == 2 and list(ct[:2]) == [4.0, 3.0]
    else:
        assert int(mt.sum()) == 3 and ct[2] == 2.0


def test_streamkmeans_pass_refuses_cap_over_the_buffer():
    """The walk's wrapper takes cap <= Mc, the rule
    ``streamkmeans_update_latents`` clamps to: past it, the plain version
    would open over an active centre where the kernel absorbs."""
    from agp_tpu_torch.ops import cuda_kernels

    Z = torch.zeros(1, 2, 2, dtype=torch.float64)
    mask = torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="cap 3 exceeds"):
        cuda_kernels.streamkmeans_pass(Z, mask, torch.ones(1, 2, dtype=torch.float64), t64([[9.0, 9.0]]), 1.0, 3)
    Z2, m2, c2 = ta.streamkmeans_update_latents(Z, mask, torch.ones(1, 2, dtype=torch.float64), t64([[9.0, 9.0]]),
                                                1.0, cap=3)
    assert bool(m2.all()) and c2[0].tolist() == [2.0, 1.0]


def test_streamkmeans_update_opens_and_absorbs():
    """test_components' oracle: a near point is absorbed by a running mean,
    a far one opens a centre."""
    Z = torch.zeros(8, 2, dtype=torch.float64)
    mask = torch.zeros(8, dtype=torch.bool)
    mask[0] = True
    counts = mask.to(torch.float64)
    Z2, m2, c2 = ta.streamkmeans_update(Z, mask, counts, t64([[0.2, 0.0], [5.0, 5.0]]), radius2=1.0)
    assert int(m2.sum()) == 2
    np.testing.assert_allclose(Z2[0].numpy(), [0.1, 0.0], atol=1e-12)
    np.testing.assert_allclose(Z2[1].numpy(), [5.0, 5.0], atol=1e-12)
    assert float(c2[0]) == 2.0 and float(c2[1]) == 1.0


def test_online_updates_keep_the_dtype_and_device():
    """Each update returns float32 buffers for float32 inputs (the card's
    dtype), the mask boolean."""
    Z, mask, counts = slots(8, 2, [True, True])
    Z32, X32 = torch.as_tensor(Z, dtype=torch.float32), torch.rand(6, 2)
    m = torch.as_tensor(mask)
    k = tk.SqExponentialKernel(lengthscale=torch.tensor(0.5), variance=torch.tensor(1.0))
    c32 = torch.as_tensor(counts, dtype=torch.float32)
    outs = [ta.oips_update(k, Z32, m, X32, 0.8), ta.unigrid_update(Z32, m, X32, 2),
            ta.webscale_update(Z32, m, c32, X32), ta.streamkmeans_update(Z32, m, c32, X32, 0.3)]
    for out in outs:
        assert out[0].dtype == torch.float32 and out[1].dtype == torch.bool


def test_importing_the_online_model_loads_no_jax():
    """In a fresh process, importing agp_tpu_torch.models.online_svgp and
    the inducing algorithms leaves JAX and the JAX package unloaded."""
    code = ("import sys; import agp_tpu_torch.models.online_svgp, agp_tpu_torch.inducing; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'agp_tpu.')) or m == 'agp_tpu']; "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
