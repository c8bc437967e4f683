"""The column-blocked form of kernels 4 and 6 (csrc/kappa_cols.cuh),
checked on the CPU: a numpy emulation of its tiling (column tiles, k-chunks,
the row partials summed over the column tiles in a fixed order, Ktilde's
clamp after that sum) against the plain versions; its float32 form's 3xTF32
split past the row slab's range; the route rule by kernel, M and dtype at
the old ceilings' edges; the Python mirrors of its shared memory and
scratch against the header; and a multi-output model on the card taking
any N.  The kernels themselves run only on a card
(tests/test_torch_cuda.py, chip_smoke.py phases 46 and 50-52)."""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import agp_tpu_torch as agt
import chip_smoke as smoke
from agp_tpu_torch.models import base, multioutput
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import kappa_tf32, tf32_product

CSRC = Path(ck.__file__).resolve().parent.parent / "csrc"
JITTER = 1e-3


def gram_np(x, z, kind, var):
    """The gram of x [B, D] against z [M, D] (both already over ls) as the
    kernels form it: r2 summed feature by feature, then the kind's
    formula."""
    r2 = np.zeros((x.shape[0], z.shape[0]))
    for d in range(x.shape[1]):
        df = x[:, d:d + 1] - z[None, :, d]
        r2 = r2 + df * df
    if kind == "rbf":
        return var * np.exp(-0.5 * r2)
    s = {"matern12": 1.0, "matern32": 3.0, "matern52": 5.0}[kind]
    r = np.sqrt(np.maximum(s * r2, 1e-36))
    poly = {"matern12": 1.0, "matern32": 1.0 + r, "matern52": 1.0 + r + r * r / 3.0}[kind]
    return var * poly * np.exp(-r)


def cols_product(a, b, tb, tn, kc, sym=False):
    """a [B, K] @ b [K, N] tile by tile as the column-blocked kernel forms
    it: [tb, tn] output tiles, each summed over k-chunks of kc; with each
    tile's row sums of (a b) o a[:, the tile's columns] (a's own columns:
    the kernels' epilogue reads its A operand back there).  With ``sym``
    (b symmetric: kernel 4's kappa Sigma) a tile sums k only up to its last
    column, the chunks below its first column twice."""
    B, K = a.shape
    N = b.shape[1]
    nc = -(-N // tn)
    out, part = np.zeros((B, N)), np.zeros((nc, B))
    for r0 in range(0, B, tb):
        rows = slice(r0, min(r0 + tb, B))
        for j in range(nc):
            cols = slice(j * tn, min(j * tn + tn, N))
            acc = np.zeros((rows.stop - r0, cols.stop - cols.start))
            for k0 in range(0, cols.stop if sym else K, kc):
                scale = 2.0 if sym and k0 + kc <= cols.start else 1.0
                acc += a[rows, k0:k0 + kc] @ (scale * b[k0:k0 + kc, cols])
            out[rows, cols] = acc
            part[j, rows] = np.sum(acc * a[rows, cols], axis=1)
    return out, part


def cols_emulation(x, z, kinv, ls, var, jitt, kind, mu=None, sigma=None, dtype=torch.float64):
    """Kernel 4 (mu, sigma given: kappa, mf, vf) or 6 (kappa, Ktilde) of
    every latent in the column-blocked form's order, in numpy float64: the
    gram once (gram_rows), kappa tile by tile with Ktilde's and mf's row
    partials a column tile, kernel 4's kappa Sigma the same way on kappa
    (by Sigma's symmetry, about half of it), then the partials summed over the column tiles in order and Ktilde
    clamped after the sum (kappa_cols_finish).  Tiles: _COL_TILES[dtype]."""
    tb, tn, kc = ck._COL_TILES[dtype][:3]
    L = z.shape[0]
    outs = []
    for l in range(L):
        knm = gram_np(x / ls[l], z[l] / ls[l], kind, var[l])
        kappa, kpart = cols_product(knm, kinv[l], tb, tn, kc)
        kt = np.maximum(var[l] + jitt - np.sum(kpart, axis=0), 1e-12)
        if mu is None:
            outs.append((kappa, kt))
            continue
        nc = kpart.shape[0]
        mpart = np.stack([kappa[:, j * tn:(j + 1) * tn] @ mu[l, j * tn:(j + 1) * tn] for j in range(nc)])
        _, vpart = cols_product(kappa, sigma[l], tb, tn, kc, sym=True)
        outs.append((kappa, np.sum(mpart, axis=0), np.maximum(kt + np.sum(vpart, axis=0), 1e-12)))
    return [np.stack(v) for v in zip(*outs)]


@functools.lru_cache(maxsize=None)
def case(n_latent, kind, jitt):
    """Inputs at ragged B=300 (three row tiles of 128) and M=129 (two
    column tiles, five k-chunks of 32), D=5, Z = the batch's first rows
    (so that some rows' Ktilde is the jitter's alone), per-latent
    lengthscales and variances, K^-1 from the float64 Cholesky of Kmm +
    1e-3 I, a random mu and SPD Sigma; numpy float64."""
    rng = np.random.default_rng(7 + n_latent)
    B, M, D = 300, 129, 5
    X = rng.normal(size=(B, D))
    ls = rng.uniform(1.5, 2.5, size=(n_latent, D))
    var = rng.uniform(0.8, 1.2, size=n_latent)
    Z = np.stack([X[:M]] * n_latent)
    L_invT = []
    for l in range(n_latent):
        kmm = gram_np(Z[l] / ls[l], Z[l] / ls[l], kind, var[l]) + JITTER * np.eye(M)
        L_invT.append(np.linalg.inv(np.linalg.cholesky(kmm)).T)
    L_invT = np.stack(L_invT)
    A = rng.normal(size=(n_latent, M, M))
    return dict(X=X, Z=Z, L_invT=L_invT, kinv=ck._kinv(torch.as_tensor(L_invT)).numpy(), ls=ls, var=var, jitt=jitt,
                mu=rng.normal(size=(n_latent, M)), Sigma=A @ A.transpose(0, 2, 1) / M + np.eye(M))


@pytest.mark.parametrize("kind", list(ck.KINDS))
@pytest.mark.parametrize("n_latent", [1, 3])
def test_kernel4_tiling_matches_plain(n_latent, kind):
    """Kernel 4's column-blocked order (the emulation) against its plain
    version at ragged B and M, one and three latents, each gram kind:
    kappa, mf and vf to 1e-10 of each output's largest entry."""
    t = case(n_latent, kind, JITTER)
    got = cols_emulation(t["X"], t["Z"], t["kinv"], t["ls"], t["var"], t["jitt"], kind, t["mu"], t["Sigma"])
    T = {k: torch.as_tensor(v) for k, v in t.items() if isinstance(v, np.ndarray)}
    ref = ck.fused_kappa_moments_batched_reference(T["X"], T["Z"], T["L_invT"], T["ls"], T["var"], T["mu"],
                                                   T["Sigma"], t["jitt"], kind)
    for name, g, r in zip(("kappa", "mf", "vf"), got, ref):
        assert g.shape == tuple(r.shape), name
        assert np.abs(g - r.numpy()).max() <= 1e-10 * max(np.abs(r.numpy()).max(), 1.0), name


@pytest.mark.parametrize("kind", list(ck.KINDS))
def test_kernel6_tiling_matches_plain(kind):
    """Kernel 6's column-blocked order against its plain version at ragged
    B and M, each gram kind, with a negative jitter so that the rows whose
    points are inducing points clamp: Ktilde's clamp comes after the
    partials' sum over the column tiles, and those rows come out 1e-12
    exactly."""
    t = case(1, kind, -JITTER)
    kappa, kt = cols_emulation(t["X"], t["Z"], t["kinv"], t["ls"], t["var"], t["jitt"], kind)
    T = {k: torch.as_tensor(v) for k, v in t.items() if isinstance(v, np.ndarray)}
    ref_kappa, ref_kt = ck.fused_kappa_reference(T["X"], T["Z"][0], T["L_invT"][0], T["ls"][0], T["var"][0],
                                                 t["jitt"], kind)
    assert np.abs(kappa[0] - ref_kappa.numpy()).max() <= 1e-10 * max(np.abs(ref_kappa.numpy()).max(), 1.0)
    assert np.abs(kt[0] - ref_kt.numpy()).max() <= 1e-10
    clamped = ref_kt.numpy() <= 1e-12
    assert clamped[:129].all() and (kt[0][clamped] == 1e-12).all()


@functools.lru_cache(maxsize=None)
def wide_inputs(shape, m):
    """(Knm [B, M], K^-1 [M, M], kappa [B, M], Sigma [M, M]), float32, at M
    past the row slab's float32 range, as test_torch_kappa_tc.inputs makes
    them at M=512: well conditioned (B=512, D=20, lengthscale 2, X normal)
    or ill-conditioned (B=512, D=2, lengthscale 1, X uniform on [-2, 2]^2,
    Z = the first M rows of 4,096)."""
    rng = np.random.default_rng(5)
    if shape == "ill_conditioned":
        X, ls = rng.uniform(-2, 2, size=(4096, 2)), 1.0
    else:
        X, ls = rng.normal(size=(max(m, 512), 20)), 2.0
    x64 = torch.as_tensor(X / ls)
    z64 = x64[:m]
    kmm = ck._gram_from_r2(ck._sq_dist_chunked(z64[None], z64[None])[0], 1.0, "rbf")
    L = torch.linalg.cholesky(kmm + JITTER * torch.eye(m, dtype=torch.float64))
    L_invT = torch.linalg.solve_triangular(L, torch.eye(m, dtype=torch.float64), upper=False).T
    kinv = ck._kinv(L_invT.to(torch.float32))
    x, z = x64[:512].to(torch.float32), z64.to(torch.float32)
    kappa, _, knm = ck._kappa_ktilde(x[None], z[None], kinv[None], torch.ones(1), JITTER, "rbf")
    A = rng.normal(size=(m, m))
    sigma = torch.as_tensor(A @ A.T / m + np.eye(m), dtype=torch.float32)
    return knm[0], kinv, kappa[0], sigma


@pytest.mark.parametrize("shape", ["well_conditioned", "ill_conditioned"])
@pytest.mark.parametrize("product,m", [("kappa", 2407), ("kappa_sigma", 2393)])
def test_float32_split_past_the_slab(product, m, shape):
    """The float32 column-blocked form's 3xTF32 split (kernel 6's kappa past
    M=2,406, kernel 4's kappa Sigma past 2,392) within FLOAT32_FACTOR times
    the float32 plain product's own error against float64, as the slab
    form's is at M=512 (tests/test_torch_kappa_tc.py)."""
    knm, kinv, kappa, sigma = wide_inputs(shape, m)
    a, b = (knm, kinv) if product == "kappa" else (kappa, sigma)
    ref = a.double() @ b.double()
    scale = max(float(ref.abs().max()), 1.0)
    e32 = float(((a @ b).double() - ref).abs().max()) / scale
    split = kappa_tf32(a, b, passes=3) if product == "kappa" else tf32_product(a, b, passes=3)
    e3 = float((split.double() - ref).abs().max()) / scale
    assert e3 <= smoke.FLOAT32_FACTOR * e32, (e3, e32)


@pytest.mark.parametrize("which,m,dtype,form", [
    ("moments", 128, torch.float64, "slab"), ("single", 129, torch.float64, "cols"),
    ("moments", 1184, torch.float64, "cols"), ("moments", 1185, torch.float64, "cols"),
    ("single", 1192, torch.float64, "cols"), ("single", 1193, torch.float64, "cols"),
    ("moments", 2392, torch.float32, "slab"), ("moments", 2393, torch.float32, "cols"),
    ("single", 2406, torch.float32, "slab"), ("single", 2407, torch.float32, "cols"),
])
def test_route_at_the_old_ceilings(which, m, dtype, form):
    """The route rule at the edges of the row slab's old ceilings: float32
    keeps the slab (16-row tiles at its last M, bit-equal to the parent's
    kernels) and takes the column-blocked form past it; float64 takes the
    slab up to M=128 (64-row tiles), the column-blocked form past it; no M
    is refused."""
    got = ck.kappa_route(which, m, dtype)
    assert got[0] == form
    assert got[1] == ({torch.float32: 16, torch.float64: 64}[dtype] if form == "slab" else None)
    if form == "slab":
        assert got == ("slab", ck.kappa_tile_rows(which, m, dtype=dtype))


def header_col_tiles():
    """{dtype: (TB, TN, WARPS_M, WARPS_N, STAGES, MIN_BLOCKS)} of ColTileOf
    as csrc/kappa_cols.cuh declares it (k-chunks of 32 elements)."""
    src = (CSRC / "kappa_cols.cuh").read_text()
    found = re.findall(r"struct ColTileOf<(float|double)> {\s*using type = ColShape<\1, (\d+), (\d+), (\d+), (\d+), "
                       r"(\d+), (\d+), 32>;", src)
    return {{"float": torch.float32, "double": torch.float64}[e]: tuple(map(int, rest)) for e, *rest in found}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cols_smem_and_scratch_mirror_the_header(dtype):
    """kappa_cols_smem_bytes and kappa_cols_scratch, the Python copies the
    wrappers size the launch and the scratch by, equal the header's
    formulas (ColShape: KC = 32, SA = KC + 8, SB = TN + 2 doubles or + 4
    floats, SMEM = STAGES (TB SA + KC SB) elements, room for the epilogue's
    A tile [TB, TN + 8] and two row sums;
    cols_scratch = L B M + (3 or 1) L ceil(M / TN) B) at every (kernel, B,
    M, L) of a grid; on the card chip_smoke holds them against the
    library's own functions.  One block a tile whatever M."""
    tb, tn, wm, wn, stages, minb = header_col_tiles()[dtype]
    f64 = dtype == torch.float64
    kc = 32
    smem = (8 if f64 else 4) * stages * (tb * (kc + 8) + kc * (tn + (2 if f64 else 4)))
    assert tb * (tn + 8) + 2 * wn * tb <= smem // (8 if f64 else 4)
    assert ck.kappa_cols_smem_bytes(dtype) == smem and minb * smem <= ck.SMEM_OPTIN
    assert ck._COL_TILES[dtype] == (tb, tn, kc, stages, 8, 2 if f64 else 4)
    for b, m, n_latent in ((1, 1, 1), (300, 129, 3), (65_536, 512, 1), (16_384, 4096, 1), (3000, 3000, 2)):
        for which in ("moments", "single"):
            want = n_latent * b * m + (3 if which == "moments" else 1) * n_latent * -(-m // tn) * b
            assert ck.kappa_cols_scratch(which, b, m, n_latent, dtype) == want


@pytest.mark.parametrize("q,n,dtype", [(2, 2393, torch.float32), (2, 1185, torch.float64),
                                       (1, 2407, torch.float32), (1, 1193, torch.float64)])
def test_movgp_on_the_card_takes_any_n(monkeypatch, q, n, dtype):
    """A MOVGP (M = N) on a "cuda" device is built at an N past the row
    slab's old ceilings, in either dtype, where create refused it before;
    its step's kernel (4 for Q > 1, 6 for Q = 1) takes the column-blocked
    form there."""
    def card(device, dt, what="model"):
        base.check_card_dtype("cuda", dt, what)

    monkeypatch.setattr(multioutput, "check_card_dtype", card)
    X = torch.as_tensor(np.random.default_rng(0).uniform(-2, 2, size=(n, 2)), dtype=dtype)
    model = agt.MOVGP.create(X, [agt.GaussianLikelihood.create(0.1)], agt.SqExponentialKernel(), agt.AnalyticVI(), q)
    assert model.Z.shape == (q, n, 2) and model.Z.dtype == dtype
    assert ck.kappa_route("moments" if q > 1 else "single", n, dtype) == ("cols", None)
