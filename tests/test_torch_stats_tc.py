"""Kernels 5 and 7 (``cavi_stats_batched``, ``cavi_stats``) on the tensor
cores, checked on the CPU: their 3xTF32 split of each operand
(``torch_helpers.stats_tf32``) against the float64 plain version, and the
chunk plan of their wrapper (``cuda_kernels._stats_plan``).

The emulation checks the split only (hi rounded to nearest, lo truncated
as the mma reads it): each pass is a float32 matmul, which rounds to
nearest.  A tensor-core mma aligns its addends to the largest and
truncates, which the kernels bound by starting each 8 rows' passes from a
zero accumulator; that, and the kernels themselves, are checked only on a
card, against float64 with no floor below float32's own error
(tests/test_torch_cuda.py::test_cuda_stats_tc_oracle_precision,
chip_smoke.py phase 12)."""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import stats_tf32, tf32_round, tf32_truncate

M512 = 512


def kappa_at(X, m, ls, jitter=1e-3):
    """kappa = Knm K^-1 [B, m] in float64 for the rows X [B, D] against
    Z = X[:m] (the batch's rows, as a path's first slice), RBF with
    lengthscale ls and variance 1, K = Kmm + jitter I."""
    Z = X[:m]

    def gram(a, b):
        r2 = (a * a).sum(1)[:, None] + (b * b).sum(1)[None, :] - 2.0 * a @ b.T
        return np.exp(-0.5 * np.maximum(r2, 0.0) / ls**2)

    return np.linalg.solve(gram(Z, Z) + jitter * np.eye(m), gram(X, Z).T).T


@functools.lru_cache(maxsize=None)
def errors(shape):
    """{"float32", "3xtf32", "1xtf32"}: S2's largest error against the
    float64 plain version on the same float32 inputs, over S2's largest
    entry, at the M=512 oracle shape (B=8192, D=2, lengthscale 1, X uniform
    on [-2, 2]^2, cond(Kmm) ~1e5) or a well-conditioned one (B=16,384,
    D=20, lengthscale 4); g normal, theta uniform on [0, 0.5], from a numpy
    seed, as chip_smoke.pair_inputs makes them."""
    rng = np.random.default_rng(3)
    if shape == "oracle":
        X, ls = rng.uniform(-2, 2, size=(smoke.OB, 2)), 1.0
    else:
        X, ls = rng.normal(size=(16_384, 20)), 4.0
    b = X.shape[0]
    kappa = torch.as_tensor(kappa_at(X, M512, ls), dtype=torch.float32)
    g = torch.as_tensor(rng.normal(size=b), dtype=torch.float32)
    theta = torch.as_tensor(rng.uniform(0.0, 0.5, size=b), dtype=torch.float32)
    ref = ck.cavi_stats_reference(kappa.double(), g.double(), theta.double())[1]
    scale = float(ref.abs().max())

    def err(S2):
        return float((S2.double() - ref).abs().max()) / scale

    return {"float32": err(ck.cavi_stats_reference(kappa, g, theta)[1]),
            "3xtf32": err(stats_tf32(kappa, g, theta, passes=3)[1]),
            "1xtf32": err(stats_tf32(kappa, g, theta, passes=1)[1])}


def test_tf32_truncate_drops_the_low_bits():
    """The lo part as the mma reads it: the low 13 bits cleared, toward
    zero; hi + tf32_truncate(x - hi) keeps ~21 bits of x."""
    u = 2.0**-10
    x = torch.tensor([1.0, 1 + u / 2, 1 + 3 * u / 2, -(1 + u / 2), 1 + u - 2.0**-23])
    got = tf32_truncate(x)
    assert torch.equal(got, torch.tensor([1.0, 1.0, 1 + u, -1.0, 1.0]))
    y = torch.as_tensor(np.random.default_rng(0).normal(size=1000), dtype=torch.float32)
    hi = tf32_round(y)
    lo = tf32_truncate(y - hi)
    assert float(((hi.double() + lo.double() - y.double()).abs() / y.double().abs()).max()) <= 2.0**-20


def test_tf32_round_is_cvt_rna():
    """To the nearest TF32 value (10 explicit mantissa bits), ties away from
    zero, the low 13 bits cleared; hi + lo keeps ~21 bits."""
    u = 2.0**-10  # TF32's ulp at 1
    x = torch.tensor([1.0, 1 + u / 2, 1 + u / 4, 1 + 3 * u / 2, -(1 + u / 2), 1 + u / 2 - 2.0**-23, -(1 + u / 4)])
    got = tf32_round(x)
    want = torch.tensor([1.0, 1 + u, 1.0, 1 + 2 * u, -(1 + u), 1.0, -1.0])
    assert torch.equal(got, want)
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())
    y = torch.as_tensor(np.random.default_rng(0).normal(size=1000), dtype=torch.float32)
    hi = tf32_round(y)
    lo = tf32_round(y - hi)
    assert float(((hi.double() + lo.double() - y.double()).abs() / y.double().abs()).max()) <= 2.0**-21


@pytest.mark.parametrize("shape", ["oracle", "well_conditioned"])
def test_three_tf32_passes_are_as_close_as_float32(shape):
    """The 3xTF32 split's S2 within FLOAT32_FACTOR (2.0) times the float32
    plain version's own error against float64 (sums rounded to nearest)."""
    e = errors(shape)
    assert e["3xtf32"] <= smoke.FLOAT32_FACTOR * e["float32"], e


@pytest.mark.parametrize("shape", ["oracle", "well_conditioned"])
def test_one_tf32_pass_is_not(shape):
    """One TF32 pass falls outside FLOAT32_FACTOR times float32's error,
    100x or more beyond float32's: why the kernels take three."""
    e = errors(shape)
    assert e["1xtf32"] > max(smoke.FLOAT32_FACTOR, 100.0) * e["float32"], e


# (B, M, L) of every case of chip_smoke.pair_cases and single_cases, of the
# card tests' largest M with three latents, and the smallest call
PLAN_SHAPES = sorted({
    (smoke.LB, smoke.PM, 1), (smoke.OB, smoke.PM, 1), (smoke.PAIR_MC_B, smoke.PM, 3),
    (smoke.PAIR_HET_B, smoke.PM, 2), (300, 129, 1), (300, 129, 2), (300, 129, 3),
    (smoke.B, smoke.M, 1), (8192, 1681, 3), (7, 8, 2), (1, 1, 1),
})
# the tile edge (TILE in csrc/stats_tc.cuh), and the blocks a card holds at
# once: 2 an SM on an H100 SXM's 132 SMs and on an H100 PCIe's 114
TILE = 128
PLAN_SLOTS = [264, 228]


@pytest.mark.parametrize("slots", PLAN_SLOTS)
@pytest.mark.parametrize("b,m,n_latent", PLAN_SHAPES)
def test_stats_plan_covers_every_row_once_in_one_wave(b, m, n_latent, slots):
    """Whole stages a chunk, _STATS_MIN_ROWS rows or more where B allows,
    every row in exactly one non-empty chunk, and the grid within one wave
    unless the tiles alone fill more."""
    nchunks, rows = ck._stats_plan(b, m, n_latent, slots, TILE)
    assert nchunks >= 1 and rows >= 1 and rows % ck._STATS_STAGE_ROWS == 0
    assert nchunks <= -(-b // ck._STATS_MIN_ROWS)
    assert (nchunks - 1) * rows < b <= nchunks * rows
    nt = -(-m // TILE)
    blocks = nt * (nt + 1) // 2 * n_latent
    assert nchunks * blocks <= slots or nchunks == 1


@pytest.mark.parametrize("slots", PLAN_SLOTS)
def test_stats_plan_stops_growing_with_b(slots):
    """The chunk count depends on the card and M, not on B beyond one wave:
    the scratch of partials does not grow with the batch."""
    counts = {b: ck._stats_plan(b, M512, 1, slots, TILE)[0] for b in (2**16, 2**18, 2**20)}
    assert len(set(counts.values())) == 1, counts
    assert counts[2**16] * ((-(-M512 // TILE)) * (-(-M512 // TILE) + 1) // 2) > slots // 2
