"""The port's Polya-Gamma and GIG samplers (``agp_tpu_torch.distributions``)
in distribution, float64 on the CPU: each moment within SE standard errors
of its closed form (the variance's standard error from the draws' own
fourth central moment), the half-integer GIG closed forms against scipy,
the extreme tilts of ``tests/test_robustness.py`` in float32, and a
two-sample Kolmogorov-Smirnov test of the port's draws against the JAX
package's at 20,000 lanes (fixed seeds; p above KS_P, fixed beforehand)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st
import torch

from agp_tpu.distributions import gig as jgig
from agp_tpu.distributions import polyagamma as jpg
from agp_tpu_torch.distributions.gig import gig_mean, gig_mean_inv, sample_gig
from agp_tpu_torch.distributions.polyagamma import pg_mean, pg_var, sample_pg, sample_pg1, sample_pg_series
from agp_tpu_torch.utils.tensors import host_read, run_trips
from torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SE = 6.0
KS_P = 1e-3
KS_LANES = 20_000
GIG_CASES = [
    (-2.0, 2.0, 3.0),
    (-0.5, 1.0, 2.0),
    (0.5, 2.0, 3.0),
    (1.7, 0.5, 0.2),
    (1.5, 3.0, 0.01),  # the Matern-3/2 Gibbs regime, a near-zero residual
    (0.3, 0.05, 0.05),  # the small-omega concave regime
    (0.3, 1e-6, 1e-6),  # omega -> 0, where a cancelling mode formula gives 0
    (0.9, 1e-6, 1e-6),
    (-3.5, 1.0, 1.0),
]


def gen(seed):
    return torch.Generator().manual_seed(seed)


def full(n, v):
    return torch.full((n,), float(v), dtype=torch.float64)


def check_moments(s, mean, var, what):
    """The draws' mean and variance each within SE standard errors."""
    s = np.asarray(s, dtype=np.float64)
    n = s.size
    m4 = np.mean((s - s.mean()) ** 4)
    z_mean = (s.mean() - mean) / np.sqrt(var / n)
    z_var = (s.var() - var) / np.sqrt((m4 - s.var() ** 2) / n)
    assert abs(z_mean) < SE and abs(z_var) < SE, (what, z_mean, z_var)


@pytest.mark.parametrize("c", [0.0, 0.5, 1.0, 2.5, 6.0])
def test_pg1_mean_and_variance(c):
    s = sample_pg1(gen(int(c * 10) + 3), full(40_000, c))
    assert s.dtype == torch.float64 and bool((s > 0).all())
    check_moments(s.numpy(), float(pg_mean(1.0, c)), float(pg_var(1.0, c)), c)


@pytest.mark.parametrize("b,c", [(2.0, 1.0), (3.5, 0.5), (25.0, 2.0), (0.3, 1.5)])
def test_pg_general_b_mean_and_variance(b, c):
    """PG(b, c): the integer units exact (one sample_pg1 call over a leading
    units axis), the rest by the corrected series."""
    s = sample_pg(gen(int(b * 100 + c)), full(12_000, b), full(12_000, c))
    check_moments(s.numpy(), float(pg_mean(b, c)), float(pg_var(b, c)), (b, c))


def test_pg_data_dependent_b():
    """b = y + gamma differs lane by lane, as in the count likelihoods'
    draws: each column's mean within SE standard errors."""
    b = torch.tensor([1.0, 2.0, 5.0, 11.0, 0.0], dtype=torch.float64)
    c = torch.tensor([0.5, 1.0, 2.0, 0.1, 1.0], dtype=torch.float64)
    s = sample_pg(gen(0), b.expand(4000, 5), c.expand(4000, 5))
    assert bool((s[:, 4] == 0).all())
    m, v = pg_mean(b[:4], c[:4]).numpy(), pg_var(b[:4], c[:4]).numpy()
    z = (s[:, :4].mean(0).numpy() - m) / np.sqrt(v / 4000)
    assert np.all(np.abs(z) < SE), z


@pytest.mark.parametrize("p,a,b", GIG_CASES)
def test_gig_general_p_moments(p, a, b):
    """The GIG sampler's mean and variance against the Bessel ratios
    E[X] = sqrt(b/a) K_{p+1}(w) / K_p(w), w = sqrt(ab), in all three
    regimes and the sign inversion; every draw positive."""
    s = sample_gig(gen(abs(hash((p, a, b))) % 100_000), full(40_000, a), full(40_000, b), p).numpy()
    om, sc = np.sqrt(a * b), np.sqrt(b / a)
    m1 = sc * sp.kv(p + 1, om) / sp.kv(p, om)
    m2 = sc**2 * sp.kv(p + 2, om) / sp.kv(p, om)
    assert np.all(s > 0)
    check_moments(s, m1, m2 - m1**2, (p, a, b))


def test_gig_half_integer_closed_forms():
    """gig_mean / gig_mean_inv against scipy's Bessel functions, and equal
    to the reference's."""
    for p in (-1.5, -0.5, 0.5, 1.5):
        for a, b in ((2.0, 3.0), (0.5, 0.1)):
            om, sc = np.sqrt(a * b), np.sqrt(b / a)
            m1 = sc * sp.kv(p + 1, om) / sp.kv(p, om)
            minv = sp.kv(p - 1, om) / sp.kv(p, om) / sc
            np.testing.assert_allclose(float(gig_mean(a, b, p)), m1, rtol=1e-10)
            np.testing.assert_allclose(float(gig_mean_inv(a, b, p)), minv, rtol=1e-10)
            np.testing.assert_allclose(float(gig_mean(a, b, p)), float(jgig.gig_mean(a, b, p)), rtol=1e-12)
            np.testing.assert_allclose(float(gig_mean_inv(a, b, p)), float(jgig.gig_mean_inv(a, b, p)), rtol=1e-12)


def test_pg_moments_match_reference():
    """pg_mean and pg_var equal the reference's, the c -> 0 limits too."""
    c = np.array([0.0, 1e-7, 1e-5, 0.3, 2.0, 40.0])
    for b in (1.0, 3.5):
        np.testing.assert_allclose(pg_mean(b, torch.as_tensor(c)).numpy(), np.asarray(jpg.pg_mean(b, c)), rtol=1e-12)
        np.testing.assert_allclose(pg_var(b, torch.as_tensor(c)).numpy(), np.asarray(jpg.pg_var(b, c)), rtol=1e-12)


def test_pg_sampler_extreme_tilts():
    """PG(1, c) at c in {0, 1e-6, 5, 50, 500}, float32: finite, positive and
    within 8 % of tanh(c/2)/(2c) (tests/test_robustness.py's check)."""
    c = torch.tensor([0.0, 1e-6, 5.0, 50.0, 500.0])
    w = sample_pg1(gen(3), c.expand(4000, 5))
    assert w.dtype == torch.float32 and bool(torch.isfinite(w).all()) and bool((w > 0).all())
    np.testing.assert_allclose(w.mean(0).numpy(), pg_mean(1.0, c).numpy(), rtol=0.08)


def test_gig_sampler_extreme_parameters():
    """GIG draws with a and b across 12 orders of magnitude stay finite and
    positive for p in {-1.5, 0.3, 1.5}, float32."""
    a = torch.tensor([1e-6, 1.0, 1e6, 1e-6, 1e6]).repeat(200)
    b = torch.tensor([1e6, 1.0, 1e-6, 1e-6, 1e6]).repeat(200)
    for p in (-1.5, 0.3, 1.5):
        x = sample_gig(gen(4), a, b, p)
        assert bool(torch.isfinite(x).all()) and bool((x > 0).all()), p


def test_rejection_loop_reads_the_host_every_few_trips():
    """The masked loop reads "all done" once every CHECK_EVERY (4) trips
    and stops at max_trips; a lane that never drains keeps 2/pi^2 (/4)."""
    reads, trips = host_read.reads, run_trips.trips
    s = sample_pg1(gen(5), full(50_000, 1.0), max_trips=5)
    assert run_trips.trips - trips == 5 and host_read.reads - reads == 2
    fallback = s == 2.0 / np.pi**2 / 4.0
    assert 0 < int(fallback.sum()) < 50_000
    reads, trips = host_read.reads, run_trips.trips
    sample_pg1(gen(5), full(1000, 1.0))
    n = run_trips.trips - trips
    assert host_read.reads - reads == -(-n // 4) and n <= 64


def test_series_sampler_mean():
    """The fully-series sampler: its mean is exact (its variance runs
    slightly low from the truncation)."""
    b, c = 2.5, 1.3
    s = sample_pg_series(gen(6), full(20_000, b), full(20_000, c)).numpy()
    assert abs(s.mean() - float(pg_mean(b, c))) < SE * np.sqrt(float(pg_var(b, c)) / 20_000)


def ks(port, ref, what):
    p = st.ks_2samp(np.asarray(port), np.asarray(ref)).pvalue
    assert p > KS_P, (what, p)


@pytest.mark.parametrize("c", [0.5, 2.0])
def test_pg1_ks_against_reference(c):
    port = sample_pg1(gen(11), full(KS_LANES, c))
    ref = jpg.sample_pg1(jax.random.PRNGKey(11), jnp.full((KS_LANES,), c))
    ks(port, ref, c)


def test_pg_ks_against_reference():
    b, c = 3.5, 1.2
    port = sample_pg(gen(12), full(KS_LANES, b), full(KS_LANES, c))
    ref = jpg.sample_pg(jax.random.PRNGKey(12), jnp.full((KS_LANES,), b), jnp.full((KS_LANES,), c))
    ks(port, ref, (b, c))


@pytest.mark.parametrize("p,a,b", [(0.5, 2.0, 3.0), (1.5, 3.0, 0.5), (0.3, 0.05, 0.05)])
def test_gig_ks_against_reference(p, a, b):
    port = sample_gig(gen(13), full(KS_LANES, a), full(KS_LANES, b), p)
    ref = jgig.sample_gig(jax.random.PRNGKey(13), jnp.full((KS_LANES,), a), jnp.full((KS_LANES,), b), p)
    ks(port, ref, (p, a, b))
