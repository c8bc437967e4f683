"""Kernels 8 and 9 (``direct_stats``, ``two_factor_nt``) on the tensor
cores, checked on the CPU: kernel 9's products as the kernel splits them
(``torch_helpers.two_factor_tf32``: W = Knm L^-T in four TF32 passes with
L^-T split in three, kappa = W L^-1, kappa Sigma and S2 in three) against
the float64 plain version at the ill-conditioned oracle shapes, and the
wrappers' Python mirror of the kernels' row tiles
(``fused_variants.variant_tile``, ``variant_smem_bytes``).

Kernel 8's kappa = Knm K^-1 and kappa Sigma are kernels 4 and 6's products
(tests/test_torch_kappa_tc.py), its S2 kernels 5 and 7's
(tests/test_torch_stats_tc.py).  The emulation checks the split only: each
pass is a float32 matmul, which rounds to nearest; the tensor cores'
truncating alignment, and the kernels themselves, are checked on a card,
against float64 with no floor below float32's own error
(tests/test_torch_cuda.py::test_cuda_fused_variants_ill_conditioned,
chip_smoke.py phase 16)."""
import functools

import pytest
import torch

import agp_tpu_torch as agt
import chip_smoke as smoke
from agp_tpu_torch.benchmarks import fused_variants as fv
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import two_factor_tf32

OUTPUTS = {"s1": 0, "S2": 1, "c": 2, "theta": 3, "mf": 4, "Ktilde": 5}  # vf is Ktilde: Sigma = 0


@functools.lru_cache(maxsize=None)
def oracle(m):
    """The oracle shape's inputs (B=8192, D=2, lengthscale 1, Z on the
    batch's rows, L^-T from the float32 Cholesky of Kmm + 1e-3 I, Sigma =
    0; chip_smoke.ill_conditioned_inputs on the CPU) and kernel 9's plain
    version on them in float32 and in float64."""
    t = smoke.ill_conditioned_inputs(agt, "cpu", m)
    plain = fv.two_factor_nt_reference
    return t, smoke.ill_call(plain, t), smoke.ill_call(plain, smoke.to_float64(t))


@functools.lru_cache(maxsize=None)
def errors(m, w_passes, passes):
    """{output: (emulated, float32 plain)} largest error against the
    float64 plain version, over max(|float64|, 1)."""
    t, ref32, ref64 = oracle(m)
    out = smoke.ill_call(functools.partial(two_factor_tf32, w_passes=w_passes, passes=passes), t)

    def rel(o, i):
        return float((o[i].double() - ref64[i]).abs().max()) / max(float(ref64[i].abs().max()), 1.0)

    return {name: (rel(out, i), rel(ref32, i)) for name, i in OUTPUTS.items()}


@pytest.mark.parametrize("m", [smoke.OM, smoke.PM])
def test_two_factor_on_the_tensor_cores_is_as_close_as_float32(m):
    """Kernel 9's split (W in four passes, the rest in three) keeps every
    output, K^tilde and S2 among them, within FLOAT32_FACTOR (2.0) times
    the float32 plain version's own error against float64: the two-factor
    form's lead over the direct one (K^tilde 730x, S2 33x at M=128) holds."""
    e = errors(m, 4, 3)
    assert all(got <= smoke.FLOAT32_FACTOR * plain for got, plain in e.values()), e


def test_three_passes_of_w_are_not():
    """With W in three passes, as kernels 4-8 split their products, S2 falls
    beyond 2x float32's error at M=128: L^-T's entries (up to ~30, against
    W's ~1) cancel in W, and 3xTF32 keeps ~2^-22 of each term where
    float32's fused multiply-add keeps it whole.  Why W takes a fourth
    pass."""
    e = errors(smoke.OM, 3, 3)
    assert e["S2"][0] > smoke.FLOAT32_FACTOR * e["S2"][1], e
    assert float(oracle(smoke.OM)[0]["L_invT"].abs().max()) > 10.0


@pytest.mark.parametrize("m", [smoke.OM, smoke.PM])
def test_one_tf32_pass_is_not(m):
    """One TF32 pass for every product falls 100x or more beyond float32's
    error in K^tilde and S2."""
    e = errors(m, 1, 1)
    for name in ("Ktilde", "S2"):
        assert e[name][0] > 100.0 * e[name][1], e


# the row tile (rows, columns of an output tile) kernels 8-9 take at M,
# every form alike: the narrow 64 x 128 tile while kappa's M columns fit
# it, then kernel 4's tiles by shared memory
NARROW, T64, T32, T16 = (64, 128), (64, 256), (32, 256), (16, 128)
TILE_CHOICE = {1: NARROW, 64: NARROW, 127: NARROW, 128: NARROW, 129: T64, 512: T64, 680: T64, 681: T32,
               1392: T32, 1393: T16, 2392: T16}


@pytest.mark.parametrize("m", sorted(TILE_CHOICE))
def test_variant_tile_mirrors_the_kernels(m):
    """At each M the tile: the narrow one where M fits its 128 columns,
    else the largest of kernel 4's whose shared memory fits a block; the
    next larger of kernel 4's tiles does not fit."""
    tile = fv.variant_tile(m)
    assert tile[:2] == TILE_CHOICE[m], (m, tile)
    assert fv.variant_smem_bytes(m, tile) <= ck.SMEM_OPTIN
    if tile in fv._VARIANT_TILES[2:]:
        assert fv.variant_smem_bytes(m, fv._VARIANT_TILES[fv._VARIANT_TILES.index(tile) - 1]) > ck.SMEM_OPTIN


def test_every_shape_taken_before_keeps_a_tile():
    """Every M the FP32 kernels took (M <= 128, at any D) takes the narrow
    tile, in every form: packed's [Sigma | mu ...] operand (M + 1
    columns rounded up to 8) spans two of its output tiles at M=128."""
    assert all(fv.variant_tile(m)[:2] == NARROW for m in range(1, 129))
    assert fv.variant_cols("packed", 128) == 136 and fv.variant_cols("direct", 128) == 128
    assert fv.variant_cols("packed", 127) == 128 and fv.variant_cols("two_factor", 64) == 64


@pytest.mark.parametrize("limit,top", [(ck.SMEM_OPTIN, 2392), (101_376, 1030)])
def test_largest_m(limit, top):
    """Kernels 8-9 take M up to 2,392 on an H100, kernel 4's edge (one
    [16, M] slab and an 8-row ring a block), in every form; within a
    smaller card's 101,376 bytes a block, up to 1,030 (16-row tiles)."""
    assert fv.variant_max_m(limit) == top
    assert fv.variant_tile(top, limit)[:2] == T16 and fv.variant_tile(top + 1, limit) is None
    assert fv.variant_tile(0) is None
    assert fv.variant_max_m() == ck.kappa_max_m("moments")


def test_variant_smem():
    """Kernel 4's tiles take kernel 4's footprint; the narrow tile at the
    sweep's M=128 takes 62,976 bytes (two blocks an SM)."""
    for m in (1, 64, 128, 129, 512, 1392, 2392):
        for tile in fv._VARIANT_TILES[1:]:
            assert fv.variant_smem_bytes(m, tile) == ck.kappa_smem_bytes("moments", m, tile[0])
    assert fv.variant_smem_bytes(128, fv._VARIANT_TILES[0]) == 4 * (64 * 132 + 3 * 16 * 136 + 3 * 4 * 64) == 62_976
