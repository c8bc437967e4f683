"""Kernels 4 and 6 (``fused_kappa_moments_batched``, ``fused_kappa``) on
the tensor cores, checked on the CPU: their 3xTF32 split of each operand
of kappa = Knm K^-1 and of kernel 4's kappa Sigma
(``torch_helpers.kappa_tf32``, ``tf32_product``) against the float64
product of the same float32 inputs, and their wrapper's Python mirror of
the row-tile choice (``cuda_kernels.kappa_tile_rows``).

The emulation checks the split only: each pass is a float32 matmul, which
rounds to nearest.  A tensor-core mma aligns its addends to the largest and
truncates, which the kernels bound by starting each 8-deep step's passes
from a zero accumulator; that, and the kernels themselves, are checked only
on a card, against float64 with no floor below float32's own error
(tests/test_torch_cuda.py::test_cuda_kappa_tc_oracle_precision,
chip_smoke.py phase 12)."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import kappa_tf32, tf32_product

M512 = 512
JITTER = 1e-3


@functools.lru_cache(maxsize=None)
def inputs(shape):
    """(Knm [B, M], K^-1 [M, M], kappa [B, M], Sigma [M, M]), float32, as
    kernels 4 and 6 receive or form them: Knm by the plain version's gram
    (RBF, variance 1) of the rows X against Z = X[:512] (the batch's rows,
    as a path's first slice), K^-1 = L^-T L^-1 in float32 (the wrappers'
    ``_kinv``) from the float64 Cholesky of Kmm + 1e-3 I, kappa the float32
    plain product, Sigma = A A^T / M + I.  At the M=512 oracle shape
    (B=8192, D=2, lengthscale 1, X uniform on [-2, 2]^2, cond(Kmm) ~1e5) or
    a well-conditioned one (B=16,384, D=20, lengthscale 2, X normal); from
    a numpy seed."""
    rng = np.random.default_rng(3)
    if shape == "oracle":
        X, ls = rng.uniform(-2, 2, size=(smoke.OB, 2)), 1.0
    else:
        X, ls = rng.normal(size=(16_384, 20)), 2.0
    x64 = torch.as_tensor(X / ls)
    z64 = x64[:M512]
    kmm = ck._gram_from_r2(ck._sq_dist_chunked(z64[None], z64[None])[0], 1.0, "rbf")
    L = torch.linalg.cholesky(kmm + JITTER * torch.eye(M512, dtype=torch.float64))
    L_invT = torch.linalg.solve_triangular(L, torch.eye(M512, dtype=torch.float64), upper=False).T
    kinv = ck._kinv(L_invT.to(torch.float32))
    x, z = x64.to(torch.float32), z64.to(torch.float32)
    var = torch.ones(1, dtype=torch.float32)
    kappa, _, knm = ck._kappa_ktilde(x[None], z[None], kinv[None], var, JITTER, "rbf")
    A = rng.normal(size=(M512, M512))
    sigma = torch.as_tensor(A @ A.T / M512 + np.eye(M512), dtype=torch.float32)
    return knm[0], kinv, kappa[0], sigma


def rel(out, ref64):
    """Largest |out - ref64| over max(|ref64|, 1)."""
    return float((out.double() - ref64).abs().max()) / max(float(ref64.abs().max()), 1.0)


@functools.lru_cache(maxsize=None)
def errors(shape, product):
    """{"float32", "3xtf32", "1xtf32"}: kappa's ("kappa") or kernel 4's
    kappa Sigma's ("kappa_sigma") largest error against the float64 product
    of the same float32 inputs, over max(|product|, 1)."""
    knm, kinv, kappa, sigma = inputs(shape)
    if product == "kappa":
        ref = knm.double() @ kinv.double()
        return {"float32": rel(kappa, ref), "3xtf32": rel(kappa_tf32(knm, kinv, passes=3), ref),
                "1xtf32": rel(kappa_tf32(knm, kinv, passes=1), ref)}
    ref = kappa.double() @ sigma.double()
    return {"float32": rel(kappa @ sigma, ref), "3xtf32": rel(tf32_product(kappa, sigma, passes=3), ref),
            "1xtf32": rel(tf32_product(kappa, sigma, passes=1), ref)}


@pytest.mark.parametrize("product", ["kappa", "kappa_sigma"])
@pytest.mark.parametrize("shape", ["oracle", "well_conditioned"])
def test_three_tf32_passes_are_as_close_as_float32(shape, product):
    """The 3xTF32 split within FLOAT32_FACTOR (2.0) times the float32 plain
    product's own error against float64 (sums rounded to nearest)."""
    e = errors(shape, product)
    assert e["3xtf32"] <= smoke.FLOAT32_FACTOR * e["float32"], e


@pytest.mark.parametrize("product", ["kappa", "kappa_sigma"])
@pytest.mark.parametrize("shape", ["oracle", "well_conditioned"])
def test_one_tf32_pass_is_not(shape, product):
    """One TF32 pass falls 100x or more beyond float32's error: why the
    kernels take three for kappa and for kappa Sigma alike."""
    e = errors(shape, product)
    assert e["1xtf32"] > max(smoke.FLOAT32_FACTOR, 100.0) * e["float32"], e


def test_oracle_shape_is_ill_conditioned():
    """The oracle shape's kappa cancels: K^-1's entries reach hundreds,
    where the well-conditioned shape's stay near 1."""
    assert float(inputs("oracle")[1].abs().max()) > 100.0
    assert float(inputs("well_conditioned")[1].abs().max()) < 10.0


# the row tile (kernel 4, kernel 6) that csrc/batched_pair.cu::km_smem and
# csrc/kappa_single.cu::ks_smem admit within an H100's 232,448 bytes a
# block: the [TB, M] slab of row stride round_up(M, 8) + 4 floats, then a
# ring of 3 stages of 16 rows x 264 floats (8 rows x 136 at TB = 16) or
# the gram's staging (8 (TB + M + 2) floats), whichever is larger, and the
# row sums (kernel 4: three)
TILE_CHOICE = {1: (64, 64), 64: (64, 64), 128: (64, 64), 129: (64, 64), 512: (64, 64), 700: (32, 32),
               1680: (16, 16), 2158: (16, 16)}


@pytest.mark.parametrize("m", sorted(TILE_CHOICE))
@pytest.mark.parametrize("which", ["moments", "single"])
def test_kappa_tile_rows_mirror_the_kernels(which, m):
    """The wrapper's row tile at M: the largest whose shared memory fits a
    block, the next larger one beyond it; None past the kernel's range."""
    want = TILE_CHOICE[m][0 if which == "moments" else 1]
    got = ck.kappa_tile_rows(which, m)
    assert got == want, (which, m, got)
    fits = [t for t in (64, 32, 16) if ck.kappa_smem_bytes(which, m, t) <= ck.SMEM_OPTIN]
    assert got == (fits[0] if fits else None)
    if got is not None:
        assert all(ck.kappa_smem_bytes(which, m, t) > ck.SMEM_OPTIN for t in (64, 32, 16) if t > got)


def test_kappa_smem_at_the_main_shapes():
    """At M=512 kernels 6 and 4 take 64-row tiles in 184,832 and 188,928
    bytes: one block an SM, each block's read of K^-1 (and Sigma) serving
    64 rows."""
    assert ck.kappa_smem_bytes("single", M512, 64) == 4 * (64 * 516 + 3 * 16 * 264 + 8 * 64) == 184_832
    assert ck.kappa_smem_bytes("moments", M512, 64) == 4 * (64 * 516 + 3 * 16 * 264 + 3 * 8 * 64) == 188_928


@pytest.mark.parametrize("which,top", [("moments", 2392), ("single", 2406)])
def test_kappa_max_m_keeps_the_parents_range(which, top):
    """Kernel 4 takes M up to 2,392 and kernel 6 up to 2,406 on an H100,
    past the 1,680 and 2,158 that the FP32 design took."""
    assert ck.kappa_max_m(which) == top
    assert ck.kappa_tile_rows(which, top) == 16 and ck.kappa_tile_rows(which, top + 1) is None
