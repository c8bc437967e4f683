"""The port's fused variants (agp_tpu_torch/benchmarks/fused_variants.py,
kernels 8 and 9) against the JAX package's benchmarks/fused_variants.py:
the plain versions against the Pallas kernels in TPU interpret mode, in
float64 against a numpy copy of the sweep's XLA bar, and at a ragged B
where the reference pads without masking.  The CUDA kernels against the
plain versions are in test_torch_cuda.py, which imports no JAX."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from agp_tpu_torch.benchmarks import fused_variants as fv
from agp_tpu_torch.ops import cuda_kernels as ck

B, TILE_B, D, M = 256, 128, 3, 16
LS, VAR, JITT, RHO = 1.3, 1.1, 1e-3, 4.0
NAMES = ("s1", "S2", "c", "theta", "mf", "vf")


def reference_module():
    """The reference's benchmarks/fused_variants.py, loaded from its path
    (its folder is no package)."""
    path = Path(__file__).resolve().parent.parent / "benchmarks" / "fused_variants.py"
    spec = importlib.util.spec_from_file_location("reference_fused_variants", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = reference_module()


def inputs(b=B, seed=0, m=M, d=D):
    """Float32 numpy inputs as the sweep makes them (X, Z standard normal, y
    +-1, mu normal) with a random SPD Sigma and L^-T of the RBF Kmm + 1e-3 I
    (well conditioned), made in float64."""
    rng = np.random.default_rng(seed)
    X, Z = rng.normal(size=(b, d)), rng.normal(size=(m, d))
    A = rng.normal(size=(m, m))
    zs = Z / LS
    Kzz = VAR * np.exp(-0.5 * ((zs[:, None, :] - zs[None, :, :]) ** 2).sum(-1)) + 1e-3 * np.eye(m)
    Linv = np.linalg.inv(np.linalg.cholesky(Kzz))
    a = dict(X=X, y=np.where(rng.normal(size=b) > 0, 1.0, -1.0), Z=Z, L_invT=Linv.T, mu=rng.normal(size=m),
             Sigma=A @ A.T / m + np.eye(m))
    return {k: v.astype(np.float32) for k, v in a.items()}


KEYS = ("X", "y", "Z", "L_invT", "mu", "Sigma")


def port(fn, a, dtype=torch.float64, **kw):
    return fn(*(torch.as_tensor(a[k], dtype=dtype) for k in KEYS), LS, VAR, JITT, RHO, **kw)


def pallas(fn, a, **kw):
    with pltpu.force_tpu_interpret_mode():
        out = fn(*(jnp.asarray(a[k]) for k in KEYS), LS, VAR, JITT, RHO, **kw)
    return [np.asarray(o) for o in out]


# The Pallas kernels form the gram's cross term and kappa with 3-pass bf16
# dots (_dot3, ~4.5e-6 relative a pass) and run in float32; on these inputs
# (cond(Kmm) ~1.4e3) they differ from the port's float64 plain versions by
# up to 2.9e-4 of each output's largest entry (the port's plain versions in
# float32 by 5.9e-6).  Each output is held within 2e-3 of its largest
# entry, 7x the measured gap.
INTERPRET_TOL = 2e-3


def assert_close(out, ref, tol):
    for name, o, r in zip(NAMES, out, ref):
        err = np.abs(o.numpy() - r).max() / np.abs(r).max()
        assert err <= tol, (name, err)


@pytest.mark.parametrize("variant", fv.VARIANTS)
def test_direct_plain_matches_pallas_interpret(variant):
    """direct_stats_reference (float64) against the reference's direct_stats
    in TPU interpret mode, B=256 with tile_b=128 (no padding)."""
    a = inputs()
    ref = pallas(REF.direct_stats, a, variant=variant, tile_b=TILE_B)
    assert_close(port(fv.direct_stats, a, variant=variant, tile_b=TILE_B), ref, INTERPRET_TOL)


def test_two_factor_plain_matches_pallas_interpret():
    a = inputs(seed=1)
    ref = pallas(REF.two_factor_nt, a, tile_b=TILE_B)
    assert_close(port(fv.two_factor_nt, a, tile_b=TILE_B), ref, INTERPRET_TOL)


@pytest.mark.parametrize("fn,kw", [(fv.direct_stats, {"variant": v}) for v in fv.VARIANTS] + [(fv.two_factor_nt, {})])
def test_plain_matches_pallas_interpret_past_m128(fn, kw):
    """The plain versions at M=256, the range the CUDA kernels reach since
    they stream K^-1 (L^-T) and Sigma from L2 (the reference sweep's M=256
    row, D=8), against the reference's Pallas kernel in TPU interpret mode
    at B=128 with tile_b=64 (no padding)."""
    a = inputs(b=128, seed=7, m=256, d=8)
    ref = pallas(getattr(REF, fn.__name__), a, tile_b=64, **kw)
    assert_close(port(fn, a, tile_b=64, **kw), ref, INTERPRET_TOL)


def numpy_xla_stats(X, y, Z, Kinv, mu, Sigma, ls, var, rho, jitt=1e-4):
    """The sweep's xla_stats (fused_variants.py:262-279) in float64 numpy;
    its jitter, 1e-4 there, is an argument here."""
    x, z = X / ls, Z / ls
    r2 = np.maximum((x * x).sum(1)[:, None] + (z * z).sum(1)[None, :] - 2.0 * x @ z.T, 0.0)
    knm = var * np.exp(-0.5 * r2)
    kappa = knm @ Kinv
    ktilde = np.maximum(var + jitt - (kappa * knm).sum(1), 1e-12)
    mf = kappa @ mu
    vf = ktilde + ((kappa @ Sigma) * kappa).sum(1)
    c = np.sqrt(mf * mf + vf)
    theta = np.tanh(c / 2.0) / (2.0 * c)
    return kappa.T @ (rho * (y / 2.0)), (kappa * (rho * theta / 2.0)[:, None]).T @ kappa


def float64_bar(a, jitt=JITT):
    a = {k: v.astype(np.float64) for k, v in a.items()}
    return numpy_xla_stats(a["X"], a["y"], a["Z"], a["L_invT"] @ a["L_invT"].T, a["mu"], a["Sigma"], LS, VAR, RHO,
                           jitt)


@pytest.mark.parametrize("fn,kw", [(fv.direct_stats, {"variant": v}) for v in fv.VARIANTS] + [(fv.two_factor_nt, {})])
def test_plain_float64_matches_the_sweeps_bar(fn, kw):
    """Each plain version in float64 against a float64 numpy copy of the
    sweep's xla_stats: rtol 1e-10 (float64 on both sides; the gram in the
    direct and in the expanded form, kappa from K^-1 or from two factors,
    which differ by cond(Kmm) * 1e-16)."""
    a = inputs(seed=2)
    s1, S2 = float64_bar(a)
    out = port(fn, a, **kw)
    np.testing.assert_allclose(out[0].numpy(), s1, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out[1].numpy(), S2, rtol=1e-10, atol=1e-12)


def test_xla_stats_reference_matches_numpy():
    """The port's bar, xla_stats_reference, in float64 against the numpy
    copy of the sweep's xla_stats, with its jitter 1e-4: rtol 1e-12 (the
    same formulas)."""
    a = inputs(seed=3)
    s1, S2 = float64_bar(a, jitt=1e-4)
    t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in a.items()}
    out = fv.xla_stats_reference(t["X"], t["y"], t["Z"], t["L_invT"] @ t["L_invT"].T, t["mu"], t["Sigma"], LS, VAR,
                                 RHO)
    np.testing.assert_allclose(out[0].numpy(), s1, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(out[1].numpy(), S2, rtol=1e-12, atol=1e-14)


def test_ragged_batch_sums_only_its_rows():
    """At B=100 the port's plain versions sum the 100 rows given: they equal
    the reference called with tile_b=100, which does not pad.  The
    reference with tile_b=64 pads to 128 rows and, not masking them, adds
    the 28 zero rows' theta to S2 (a reference-side fault the port does not
    carry): its S2 is larger there."""
    a = inputs(b=100, seed=4)
    for fn, kw in ((fv.direct_stats, {"variant": "nt"}), (fv.two_factor_nt, {})):
        ref = pallas(getattr(REF, fn.__name__), a, tile_b=100, **kw)
        out = port(fn, a, tile_b=64, **kw)
        assert_close(out, ref, INTERPRET_TOL)
    padded = pallas(REF.two_factor_nt, a, tile_b=64)
    assert np.trace(padded[1]) > np.trace(ref[1]) * 1.01
    np.testing.assert_allclose(padded[0], ref[0], rtol=1e-5, atol=1e-6)


def test_tile_b_changes_nothing():
    """tile_b is taken for the reference's signature only."""
    a = inputs(b=100, seed=5)
    for fn, kw in ((fv.direct_stats, {"variant": "packed"}), (fv.two_factor_nt, {})):
        first, second = port(fn, a, tile_b=64, **kw), port(fn, a, tile_b=1024, **kw)
        for o, p in zip(first, second):
            assert torch.equal(o, p)


def test_cpu_path_counts_no_launch_and_keeps_dtype():
    a = inputs()
    before = (fv.direct_stats.launches, fv.two_factor_nt.launches)
    outs = [port(fv.direct_stats, a, dtype=torch.float32, variant=v) for v in fv.VARIANTS]
    outs.append(port(fv.two_factor_nt, a, dtype=torch.float32))
    assert (fv.direct_stats.launches, fv.two_factor_nt.launches) == before
    assert all(o.dtype == torch.float32 and o.device.type == "cpu" for out in outs for o in out)


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="variants"):
        port(fv.direct_stats, inputs(), variant="tn")


def test_cuda_argument_checks():
    """What the CUDA kernels do not take is refused before the library is
    loaded: float64, a wrong shape, M one past the largest the kernels'
    row tiles take (variant_max_m: 2,392 within an H100's 232,448 bytes a
    block, every form alike; before, fused_fits' M <= 128)."""
    def launch(a, form="direct", dtype=torch.float32, **over):
        t = {k: torch.as_tensor(a[k], dtype=dtype) for k in KEYS}
        t.update(over)
        return fv._variant_launch("direct_stats", form, *(t[k] for k in KEYS), LS, VAR, JITT, RHO)

    a = inputs()
    with pytest.raises(TypeError):
        launch(a, dtype=torch.float64)
    with pytest.raises(ValueError):
        launch(a, y=torch.zeros(10))
    with pytest.raises(ValueError):
        launch(a, form="two_factor", Sigma=torch.zeros((M, M)).T)
    edge = fv.variant_max_m()
    assert edge == 2392
    rng = np.random.default_rng(6)
    big = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("X", (8, D)), ("y", (8,)), ("Z", (edge + 1, D)), ("L_invT", (edge + 1,) * 2), ("mu", (edge + 1,)),
        ("Sigma", (edge + 1,) * 2))}
    for form in ("direct", "packed", "two_factor"):
        with pytest.raises(ValueError, match=f"M <= {edge}"):
            launch(big, form=form)
    assert ck.fused_fits(1, 45, 128) and not ck.fused_fits(1, 8, 129)
