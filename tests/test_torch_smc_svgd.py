"""The port's SMC and SVGD samplers (``inference/smc.py``,
``inference/svgd.py``) against the JAX package, float64 on the CPU:
``systematic_resample`` at the reference's own offset, index for index;
SVGD from the reference's own initial particles, 50 steps at rtol 1e-8;
SMC's log marginal likelihood against the port's exact GP; both samplers'
posterior means on tests/test_engines.py's classification data."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference import smc as jsmc
from agp_tpu_torch.inference import smc, svgd
from agp_tpu_torch.models.gp import analytic_update, log_py
from torch_helpers import close, cls_data, jax_mcgp, port_mcgp, t64
from torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# SMC against the exact log p(y): at P=512 particles, 40 temperatures and
# 10 MALA steps of 0.1 the estimate sits 0.01-0.41 nats from it over seeds
# 0-4 (both packages; at the defaults, 5 steps of 0.05 and 20
# temperatures, the estimator's known low bias reaches 1.2-5.4 nats)
SMC_LOGZ_BOUND = 1.0


@pytest.mark.parametrize("n", [7, 64, 256])
def test_systematic_resample_matches_reference(n):
    rng = np.random.default_rng(n)
    log_w = rng.normal(size=n) * 3.0
    key = jax.random.PRNGKey(n)
    ref = jsmc.systematic_resample(key, jnp.asarray(log_w), n)
    u0 = jax.random.uniform(key, (), dtype=jnp.float64)
    got = smc.systematic_resample(t64(log_w), n, t64(u0))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_median_averages_the_middle_pair():
    """The SVGD bandwidth's median is jnp.median's (torch.median would take
    the lower of the two middle values of an even count)."""
    for n in (16, 15, 1):
        x = np.random.default_rng(n).normal(size=n)
        np.testing.assert_allclose(float(svgd._median(t64(x))), float(jnp.median(jnp.asarray(x))), rtol=1e-15)


@pytest.mark.parametrize("which", ["logistic", "multiclass"])
def test_svgd_from_the_reference_particles(which):
    """50 SVGD steps from the reference's v0 = normal(key, (P, L, N))."""
    X, f, y = cls_data(25, seed=3)
    if which == "multiclass":
        y = np.digitize(f, [-0.5, 0.5])
        lik = agp.LogisticSoftMaxLikelihood.create(3)
    else:
        lik = agp.LogisticLikelihood.create()
    mj = jax_mcgp(lik, X, y, ls=0.8)
    mt = port_mcgp(mj, y)
    P, key = 16, jax.random.PRNGKey(41)
    ref = agp.svgd_sample(mj, n_particles=P, n_steps=50, step_size=0.05, key=key)
    v0 = jax.random.normal(key, (P, mj.n_latent, 25), dtype=jnp.float64)
    got = svgd._svgd_run(mt, t64(v0), 50, 0.05)
    close(got, ref, rtol=1e-8, atol=1e-12 * float(jnp.abs(ref).max()))


def test_smc_log_z_matches_the_exact_gp():
    """SMC's log Z on a Gaussian likelihood (noise 0.1) against the exact
    GP's log p(y) with noise 0.1 + the float64 jitter 1e-4 (the SMC prior
    is N(0, K + 1e-4 I)), within SMC_LOGZ_BOUND nats."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(20, 2))
    y = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=20)
    gp = agt.GP.create(t64(X), t64(y), agt.SqExponentialKernel(), noise=0.1 + 1e-4, opt_noise=False, optimiser=None)
    gp, state = analytic_update(gp, gp.init_state())
    exact = float(log_py(gp, state))
    m = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.1))
    fs, log_z = agt.smc_sample(m, n_particles=512, n_temps=40, n_mala=10, mala_step=0.1,
                               generator=torch.Generator().manual_seed(0))
    assert fs.shape == (512, 1, 20) and bool(torch.isfinite(fs).all())
    assert abs(float(log_z) - exact) < SMC_LOGZ_BOUND, (float(log_z), exact)


def test_smc_and_svgd_logistic():
    """tests/test_engines.py:94-102 and :650-660 with the port: SMC's mean
    sign agrees with the labels on more than 0.7 of the points, SVGD's
    mean correlates with Gibbs's above 0.95."""
    X, _, y = cls_data(30, seed=5)
    mg = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=200))
    fs, log_z = agt.smc_sample(mg, n_particles=128, n_temps=10, generator=torch.Generator().manual_seed(5))
    assert fs.shape == (128, 1, 30) and np.isfinite(float(log_z))
    assert np.mean(np.sign(fs.mean(0)[0].numpy()) == y) > 0.7
    fv = agt.svgd_sample(mg, n_particles=64, n_steps=300, generator=torch.Generator().manual_seed(41))
    assert fv.shape == (64, 1, 30)
    s = agt.sample(mg, 300, generator=torch.Generator().manual_seed(42))
    assert np.corrcoef(fv.mean(0)[0].numpy(), s.mean(0)[0].numpy())[0, 1] > 0.95
