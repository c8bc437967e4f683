"""Float64 on the card, checked without one: the shared-memory mirrors of
kernels 4 and 6 by dtype against the C++ formulas they copy (read from
csrc/pair_core.cuh and csrc/stats_tc.cuh), the fused passes' float32-only
rule, the route a float64 sparse model takes (kernels 6 + 7 for one
latent, 4 + 5 for several, never kernels 1-3), the kernels' dtype checks,
and each model family's dtype rule on a "cuda" device."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import agp_tpu_torch as agt
from agp_tpu_torch.inference import analytic_vi
from agp_tpu_torch.models import base, gp, mcgp, multioutput, svgp, vstp
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training import train

CSRC = Path(ck.__file__).resolve().parent.parent / "csrc"
H100_OPTIN = 232448


def header_tiles(dtype):
    """{TB: (WARPS_M, WARPS_N, MI, NJ, KB)} of KTileOf (float) or
    KTileF64Of (double) as csrc/pair_core.cuh declares them."""
    src = (CSRC / "pair_core.cuh").read_text()
    name, elem = ("KTileF64Of", r",\s*double") if dtype == torch.float64 else ("KTileOf", "")
    found = re.findall(name + r"<(\d+)>\s*{\s*using type = TileShape<(\d+), (\d+), (\d+), (\d+), (\d+), (\d+)" + elem
                       + r">;", src)
    return {int(tb): tuple(map(int, rest)) for tb, _, *rest in found}


def cpp_smem(which, M, tb, dtype):
    """pair_core.cuh's rows_smem (kernel 4) or kappa_single.cu's ks_smem
    (kernel 6) written out from the header's tile: TileShape's SP (NT + 8
    floats, NT + 4 doubles), RING = KT_STAGES KB SP, slab_scratch = the
    larger of the ring and DC (TB + M + 2), the slab TB (round_up(M, 8) + 4),
    the row sums (3 or 1) WARPS_N TB, in elements of dtype."""
    warps_m, warps_n, mi, nj, kb = header_tiles(dtype)[tb]
    nt = warps_n * 8 * nj
    sp = nt + (4 if dtype == torch.float64 else 8)
    ring = 3 * kb * sp
    scratch = max(8 * (tb + M + 2), ring)
    sums = (3 if which == "moments" else 1) * warps_n * tb
    return (8 if dtype == torch.float64 else 4) * (tb * ((M + 7) // 8 * 8 + 4) + scratch + sums)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["moments", "single"])
def test_kappa_smem_mirror_matches_the_headers(which, dtype):
    """kappa_smem_bytes, the Python copy that picks kernels 4 and 6's row
    tiles, equals the C++ formula of the header's tiles at every row tile
    on a grid of M, in each dtype (on the card chip_smoke holds it against
    the library's own functions)."""
    tiles = header_tiles(dtype)
    assert sorted(tiles) == [16, 32, 64]
    for m in (1, 8, 63, 64, 128, 129, 320, 321, 336, 337, 512, 680, 696, 697, 1184, 1185, 1192, 1193, 2392, 2406):
        for tb in tiles:
            assert ck.kappa_smem_bytes(which, m, tb, dtype) == cpp_smem(which, m, tb, dtype), (m, tb)


@pytest.mark.parametrize("which,f32,f64", [("moments", 2392, 1184), ("single", 2406, 1192)])
def test_kappa_max_m_by_dtype(which, f32, f64):
    """The ceiling of kernels 4 and 6 on an H100's opt-in shared memory:
    float64's slab of doubles about halves float32's; the row tile each M
    takes (64 rows while they fit, then 32, then 16)."""
    assert ck.kappa_max_m(which, H100_OPTIN) == f32
    assert ck.kappa_max_m(which, H100_OPTIN, torch.float64) == f64
    assert ck.kappa_tile_rows(which, f64, dtype=torch.float64) == 16
    assert ck.kappa_tile_rows(which, f64 + 1, dtype=torch.float64) is None
    assert ck.kappa_tile_rows(which, 512, dtype=torch.float64) == 32
    assert ck.kappa_tile_rows(which, 512) == 64
    assert ck.kappa_tile_rows(which, 64, dtype=torch.float64) == 64
    with pytest.raises(TypeError, match="float32 or float64"):
        ck.kappa_smem_bytes(which, 64, 64, torch.float16)


def header_stats_shapes():
    """{name: (elem, KB, TILE, WARPS_M, WARPS_N, MIN_BLOCKS, PAD, MMA_K)} of
    the stats geometries csrc/stats_tc.cuh declares (StatsF32, StatsF64K8,
    StatsF64K4)."""
    src = (CSRC / "stats_tc.cuh").read_text()
    found = re.findall(r"using (Stats\w+) = StatsGeometry<(float|double), (\d+), (\d+), (\d+), (\d+), (\d+), "
                       r"(\d+), (\d+)>;", src)
    return {name: (elem, *map(int, rest)) for name, elem, *rest in found}


def test_stats_tiles_fit_one_block_an_sm():
    """Kernels 5 and 7's stage rings as stats_tc.cuh declares them: float
    two blocks an SM, double one (the m16n8k8 geometry: 32-row stages of
    8 warps of 64 x 32, 204 KB for three; the m8n8k4 one: 16-row stages
    of 16 warps of 32 x 32), each within the H100's opt-in shared memory;
    their rows of a stage divide the chunk rows that _stats_plan makes (a
    multiple of 32); the double m16n8k8 stride is 4 mod 16 doubles (its
    quarter-warps' 16-byte loads on distinct banks)."""
    shapes = header_stats_shapes()
    assert set(shapes) == {"StatsF32", "StatsF64K8", "StatsF64K4"}
    for elem, kb, tile, warps_m, warps_n, min_blocks, pad, mma_k in shapes.values():
        smem = {"float": 4, "double": 8}[elem] * 3 * (2 * kb * (tile + pad) + 2 * kb)
        assert min_blocks * smem <= H100_OPTIN and ck._STATS_STAGE_ROWS % kb == 0
        assert (32 * warps_m * warps_n) % tile == 0 and kb % mma_k == 0
    assert shapes["StatsF64K8"] == ("double", 32, 128, 2, 4, 1, 4, 8)
    assert shapes["StatsF64K4"] == ("double", 16, 128, 4, 4, 1, 4, 4)
    assert 8 * 3 * (2 * 32 * 132 + 64) == 204_288


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m", [1, 64, 128, 129, 512, 4096])
def test_stats_plan_rows_whole_stages_of_each_geometry(dtype, m):
    """The chunk rows _stats_plan makes are a whole number of stages of
    every geometry of the dtype (stats_tc.cuh), and STATS_F64_MMA_K, the
    depth the wrappers pass the float64 form at every M (no small-M rule:
    the m16n8k8 geometry ran no slower at M = 64 and 128 on an H100),
    names the m16n8k8 geometry the header declares."""
    shapes = header_stats_shapes()
    elem = "double" if dtype == torch.float64 else "float"
    kbs = {v[1] for v in shapes.values() if v[0] == elem}
    assert ck.STATS_F64_MMA_K == shapes["StatsF64K8"][7] == 8
    for b in (1, 300, 8192, 65_536):
        nchunks, rows = ck._stats_plan(b, m, 1, 132, 128)
        assert all(rows % kb == 0 for kb in kbs) and (nchunks - 1) * rows < b <= nchunks * rows


@pytest.mark.parametrize("n_latent", [1, 3])
def test_fused_fits_is_float32_only(n_latent):
    """The fused passes (kernels 1-3) take float32 alone: a float64 model
    of a shape they fit takes the split pairs."""
    assert ck.fused_fits(n_latent, 20, 64)
    assert ck.fused_fits(n_latent, 20, 64, torch.float32)
    assert not ck.fused_fits(n_latent, 20, 64, torch.float64)
    assert not ck.fused_fits(n_latent, 20, 129, torch.float32)


def test_kernel_dtype_checks():
    """The wrappers' argument check: kernels 1-3 and 8-10 take float32
    alone, kernels 4-7 float32 or float64, one dtype for all tensors."""
    x32, x64 = torch.zeros(4, 2), torch.zeros(4, 2, dtype=torch.float64)
    with pytest.raises(TypeError, match="must be float32 on CUDA"):
        ck._check_tensors(x64, {"xb": (x64, (4, 2))})
    ck._check_tensors(x64, {"xb": (x64, (4, 2))}, ck.PAIR_DTYPES)
    with pytest.raises(TypeError, match="one dtype"):
        ck._check_tensors(x32, {"X": (x32, (4, 2)), "Z": (x64, (4, 2))}, ck.PAIR_DTYPES)
    with pytest.raises(TypeError, match="float32 or float64"):
        ck._check_tensors(x32.half(), {"X": (x32.half(), (4, 2))}, ck.PAIR_DTYPES)


def sparse_model(which, dtype, m=64):
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.normal(size=(256, 2)), dtype=dtype)
    lik, y = {
        "logistic": (agt.LogisticLikelihood.create(), torch.sign(X[:, 0])),
        "studentt": (agt.StudentTLikelihood.create(4.0), torch.sin(X[:, 0])),
        "multiclass": (agt.LogisticSoftMaxLikelihood.create(3), torch.argmax(X @ torch.ones(2, 3, dtype=dtype)
                                                                             + X[:, :1] * torch.arange(3.0, dtype=dtype), 1)),
        "het": (agt.HeteroscedasticLikelihood.create(), torch.sin(X[:, 0])),
    }[which]
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=1.5), lik, agt.AnalyticSVI(128), X[:m],
                            optimiser=None)
    return model, X, y


KERNEL_WRAPPERS = ("fused_cavi_stats", "fused_cavi_stats_multiclass", "fused_cavi_stats_het",
                   "fused_kappa_moments_batched", "cavi_stats_batched", "fused_kappa", "cavi_stats")


@pytest.fixture
def calls(monkeypatch):
    """Counts each CUDA kernel wrapper's calls through the dispatch (on the
    CPU each runs its plain version)."""
    seen = {name: 0 for name in KERNEL_WRAPPERS}
    for name in KERNEL_WRAPPERS:
        fn = getattr(ck, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            seen[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(ck, name, counted)
    return seen


@pytest.mark.parametrize("which,fused,pair", [
    ("logistic", "fused_cavi_stats", ("fused_kappa", "cavi_stats")),
    ("studentt", "fused_cavi_stats", ("fused_kappa", "cavi_stats")),
    ("multiclass", "fused_cavi_stats_multiclass", ("fused_kappa_moments_batched", "cavi_stats_batched")),
    ("het", "fused_cavi_stats_het", ("fused_kappa_moments_batched", "cavi_stats_batched")),
])
def test_float64_sparse_model_takes_the_split_pair(monkeypatch, calls, which, fused, pair):
    """At M=64, within the fused kernels' range, with the card's dispatch
    rule (``_route_dtype`` on a CUDA device: the model's dtype): a float32
    model's CAVI step takes its fused pass (kernel 1, 2 or 3) once, the
    same model in float64 kernels 6 + 7 (one latent) or 4 + 5 (several)
    once each and no fused pass (the dispatch's specs are None for it).
    On the CPU a float64 model keeps the float32 route, whose plain
    versions take any dtype."""
    model, _, _ = sparse_model(which, torch.float64)
    assert analytic_vi._route_dtype(model) == torch.float32
    assert any(s is not None for s in (analytic_vi._fused_spec(model), analytic_vi._fused_mc_spec(model),
                                       analytic_vi._fused_het_spec(model)))
    monkeypatch.setattr(analytic_vi, "_route_dtype", lambda m: m.Z.dtype)
    for dtype, want in ((torch.float32, {fused: 1}), (torch.float64, {pair[0]: 1, pair[1]: 1})):
        model, X, y = sparse_model(which, dtype)
        specs = (analytic_vi._fused_spec(model), analytic_vi._fused_mc_spec(model), analytic_vi._fused_het_spec(model))
        assert any(s is not None for s in specs) == (dtype == torch.float32)
        y_t, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        state = agt.init_state(model, X, y_t.to(dtype))
        for name in calls:
            calls[name] = 0
        model, state = analytic_vi.variational_update(model, state, X[:128], y_t[:128].to(dtype))
        assert calls == {name: want.get(name, 0) for name in KERNEL_WRAPPERS}, dtype
        assert state.mu.dtype == dtype and bool(torch.isfinite(state.mu).all())


def test_float64_numerical_step_takes_kernels_6_and_7(calls):
    """Numerical VI (quadrature) on a float64 sparse model follows the same
    rule: kernel 6 for the moments, kernel 7 for the statistics."""
    from agp_tpu_torch.inference import numerical_vi

    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(256, 2)))
    y = torch.sign(X[:, 0])
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                            agt.QuadratureSVI(128, n_points=20), X[:32], optimiser=None)
    state = agt.init_state(model, X, y)
    model, state = numerical_vi.variational_update(model, state, X[:128], y[:128])
    assert calls == {name: int(name in ("fused_kappa", "cavi_stats")) for name in KERNEL_WRAPPERS}


def on_the_card(monkeypatch):
    """Each model module's check_card_dtype sees a "cuda" device, whatever
    the tensors' own (the CPU here)."""
    def card(device, dtype, what="model"):
        base.check_card_dtype("cuda", dtype, what)

    for module in (svgp, gp, vstp, mcgp, multioutput, train):
        monkeypatch.setattr(module, "check_card_dtype", card)


FAMILIES = {
    "SVGP": lambda X, y: agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                                         agt.AnalyticSVI(16), X[:8], optimiser=None),
    "VGP": lambda X, y: agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                                       agt.AnalyticVI()),
    "GP": lambda X, y: agt.GP.create(X, y, agt.SqExponentialKernel()),
    "VStP": lambda X, y: agt.VStP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                                         agt.AnalyticVI(), nu=5.0),
    "MCGP": lambda X, y: agt.MCGP.create(X, y, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                                         agt.GibbsSampling()),
    "MOSVGP": lambda X, y: agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1),
                                                                         agt.LogisticLikelihood.create()],
                                             agt.AnalyticSVI(16), X[:8], n_latent=2, optimiser=None),
}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_card_dtype_rule_for_each_model_family(monkeypatch, family):
    """On a "cuda" device every model family is built in float64 (the
    sparse ones then take kernels 4-7's float64 form; the GP, the VGP, the
    VStP and the MCGP run no kernel of the port) and refused in float16
    and bfloat16, for which the port has no path; init_state applies the
    same rule to the data."""
    on_the_card(monkeypatch)
    rng = np.random.default_rng(0)
    X64 = torch.as_tensor(rng.uniform(-2, 2, size=(32, 2)))
    y64 = torch.sign(X64[:, 0])
    model = FAMILIES[family](X64, y64)
    assert (model.Z if family in ("SVGP", "MOSVGP") else model.train_x).dtype == torch.float64
    if family == "SVGP":
        assert agt.init_state(model, X64, y64).mu.dtype == torch.float64
    for dtype in (torch.float16, torch.bfloat16):
        with pytest.raises(TypeError, match="float32 or float64 on the card"):
            FAMILIES[family](X64.to(dtype), y64.to(dtype))
    if family == "SVGP":
        with pytest.raises(TypeError, match="data"):
            agt.init_state(model, X64.half(), y64.half())
