"""Kernel 1 (``fused_cavi_stats``) on the tensor cores, checked on the CPU:
its products as the kernel splits them (``torch_helpers.fused_tf32``:
kappa = Knm K^-1 and kappa Sigma by ``kappa_tf32`` / ``tf32_product``, S2
by ``stats_tf32``, each in three TF32 passes, with the plain E-step of
each likelihood, ``_estep_reference``) against the float64 plain version
at the M=128 oracle shape, and the dispatch's Python copy of the kernel's
shared memory (``cuda_kernels.fused_fits``).

The emulation checks the split only: each pass is a float32 matmul, which
rounds to nearest; the tensor cores' truncating alignment, and the kernel
itself, are checked on a card, against float64 with no floor below
float32's own error (tests/test_torch_cuda.py::
test_cuda_kernel_oracle_shape_matches_plain, chip_smoke.py phases 3 and
16)."""
import functools

import pytest
import torch

import agp_tpu_torch as agt
import chip_smoke as smoke
from agp_tpu_torch.benchmarks import fused_variants as fv
from agp_tpu_torch.inference.analytic_vi import _fused_lik_spec
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import fused_tf32

# each likelihood branch with the RBF gram, and each Matern kind with the
# Student-t branch: the cases of chip_smoke.py's phase 3 at the oracle shape
BRANCHES = [(lik, "rbf") for lik in ck.LIKS] + [("studentt", kind) for kind in ck.KINDS[1:]]


@functools.lru_cache(maxsize=None)
def sigma0_inputs(lik):
    """chip_smoke.ill_conditioned_inputs (B=8192, D=2, M=128, lengthscale
    1, Z on the batch's rows, Sigma = 0 so that vf is Ktilde) on the CPU,
    with the labels the oracle draws for ``lik`` on the same rows and the
    likelihood's (p0, p1) as the step takes them."""
    t = smoke.ill_conditioned_inputs(agt, "cpu")
    t["y"] = smoke.oracle_data(lik, "cpu")[1][: smoke.OB].contiguous()
    _, p0, p1, _ = _fused_lik_spec(smoke.single_latent_lik(agt, lik).to(dtype=torch.float32))
    return t, {"lik_p0": p0, "lik_p1": p1, "kind": "rbf", "lik": lik}


def run(inputs, fn, float64=False):
    """fn on a case's inputs: ("oracle", lik, kind) chip_smoke.branch_inputs
    at the oracle shape (a random SPD Sigma), ("sigma0", lik) sigma0_inputs."""
    if inputs[0] == "oracle":
        t = smoke.branch_inputs(agt, smoke.OB, smoke.OM, "cpu", inputs[1], inputs[2], at="oracle")
        return smoke.call_branch(fn, smoke.to_float64(t) if float64 else t)
    t, kw = sigma0_inputs(inputs[1])
    return smoke.ill_call(fn, smoke.to_float64(t) if float64 else t, **kw)


@functools.lru_cache(maxsize=None)
def errors(inputs, passes):
    """{output: (emulated, float32 plain)} error against the float64 plain
    version over max(|float64|, 1): the largest, and (key output + "_rms")
    the root mean square over the entries."""
    plain = ck.fused_cavi_stats_reference
    ref32, ref64 = run(inputs, plain), run(inputs, plain, float64=True)
    out = run(inputs, functools.partial(fused_tf32, passes=passes))
    e = {}
    for i, name in enumerate(smoke.STATS_NAMES):
        scale = max(float(ref64[i].abs().max()), 1.0)
        d = [(o[i].double() - ref64[i]).abs() / scale for o in (out, ref32)]
        e[name] = tuple(float(x.max()) for x in d)
        e[name + "_rms"] = tuple(float(x.pow(2).mean().sqrt()) for x in d)
    return e


def within_float32(e, names):
    return all(e[n][0] <= smoke.FLOAT32_FACTOR * e[n][1] for n in names)


@pytest.mark.parametrize("lik,kind", BRANCHES)
def test_fused_on_the_tensor_cores_is_as_close_as_float32(lik, kind):
    """Kernel 1's split (kappa, kappa Sigma and S2 in three TF32 passes)
    keeps every output of every likelihood branch and gram kind within
    FLOAT32_FACTOR (2.0) times the float32 plain version's own error
    against float64 at the oracle shape, with no floor: their largest
    errors, emulated at 0.8-1.45 times float32's."""
    e = errors(("oracle", lik, kind), 3)
    assert within_float32(e, smoke.STATS_NAMES), e


@pytest.mark.parametrize("lik", ck.LIKS)
def test_fused_keeps_ktilde_as_close_as_float32(lik):
    """With Sigma = 0, vf is Ktilde = var + jitter - rowsum(kappa o Knm),
    which cancels to ~1e-3: the statistics s1, S2 and the moments mf, vf of
    every branch keep their largest errors within FLOAT32_FACTOR times
    float32's, and the E-step's c and theta their root-mean-square ones.
    The largest error of c = sqrt(d^2 + vf) (Gaussian, Laplace, Matern-3/2
    noise) is one row's: where d^2 + vf is smallest (0.0012 for Matern-3/2
    noise) an error in vf moves c 14 times as much, and which arm's error
    lands there is a draw: 2.0 times float32's for Matern-3/2 noise
    (theta 2.2), 0.37-1.13 for the others, with kappa in four passes as
    in three, while its root mean square and 99th percentile read 1.01 and
    0.94 times."""
    e = errors(("sigma0", lik), 3)
    assert within_float32(e, ("s1", "S2", "mf", "vf", "c_rms", "theta_rms")), e


def test_one_tf32_pass_is_not():
    """One TF32 pass for every product falls 100x or more beyond float32's
    error in Ktilde (vf with Sigma = 0) and S2."""
    e = errors(("sigma0", "logistic"), 1)
    for name in ("vf", "S2"):
        assert e[name][0] > 100.0 * e[name][1], e


def tile_bytes(m):
    """Kernel 1's shared memory at M, a copy of csrc/fused_cavi_stats.cu::
    rows_smem for its 64 x 128 tile: the [64, M] slab (row stride M
    rounded up to 8, + 4), the ring (3 stages of 16 rows of 128 + 8
    floats) or the gram's staging of 8 features (8 (64 + M + 2) floats),
    whichever is larger, and three row sums of 4 warp columns x 64 rows."""
    return 4 * (64 * (-(-m // 8) * 8 + 4) + max(3 * 16 * 136, 8 * (64 + m + 2)) + 3 * 4 * 64)


@pytest.mark.parametrize("m", [1, 8, 63, 64, 127, 128, 129, 512])
def test_fused_fits_follows_the_tile(m):
    """One latent or several: fused exactly where 1 <= M <= 128, at any D;
    kernels 1-3 share the tile, whose footprint (kernel 8's narrow tile's)
    reaches 62,976 bytes at M=128, a quarter of a block's 232,448 (two
    blocks an SM)."""
    assert tile_bytes(m) == fv.variant_smem_bytes(m, fv._VARIANT_TILES[0])
    assert (tile_bytes(m) <= 62_976) is (m <= ck.MAX_M)
    for n_latent in (1, 2, 3, 10):
        for d in (1, 2, 20, 44, 45, 46, 4096):
            assert ck.fused_fits(n_latent, d, m) is (m <= ck.MAX_M)
        assert ck.fused_fits(n_latent, 0, m) is False
