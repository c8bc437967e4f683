"""The port's autoregressive rollouts (``predict_ar``, ``sample_ar``)
against the JAX package's, float64: tests/test_engines.py:311-326's model
trained by the JAX package and carried across by ``interop``, the
deterministic rollout and the sampled one fed the reference's normals at
1e-10; the reference's check through the port; the rollouts' host reads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu_torch.utils.tensors import host_read
from torch_helpers import close, one_torch_thread, state_arrays, t64

LAG = 5
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def series_data(n=200, periods=8, lag=LAG):
    """tests/test_engines.py's series: sin over ``periods`` pi in n points,
    lag windows Xl [n - lag, lag] and their next values."""
    series = np.sin(np.linspace(0, periods * np.pi, n))
    Xl = np.stack([series[i:i + lag] for i in range(n - lag)])
    return series, Xl, series[lag:]


@pytest.fixture(scope="module")
def trained():
    """The reference's AR model (SVGP + Gaussian(1e-3), Z = Xl[:20], 15
    full-batch iterations) trained by the JAX package and carried
    across."""
    series, Xl, yl = series_data()
    mj = agp.SVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(1e-3, opt_noise=False),
                         agp.AnalyticVI(), Z=jnp.asarray(Xl[:20]), optimiser=None)
    mj, sj = agp.train(mj, jnp.asarray(Xl), yl, iterations=15)
    template = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(1e-3), agt.AnalyticVI(),
                               Z=t64(Xl[:20]), optimiser=None)
    mt = model_from_numpy(dict(Z=np.array(mj.Z), lengthscale=np.array(mj.kernel.lengthscale),
                               variance=np.array(mj.kernel.variance), sigma2=np.array(mj.likelihood.sigma2)), template)
    return mj, sj, mt, state_from_numpy(state_arrays(sj), "cpu", torch.float64), series


def test_predict_ar_matches_jax(trained):
    """predict_ar over 20 steps at rtol 1e-10, atol 1e-10 (the lag windows
    of a sine make Kmm ill-conditioned: each step's mean k*^T K^-1 mu
    rounds at ~1e-11, and the rollout feeds it back; |y| <= 1)."""
    mj, sj, mt, st, series = trained
    close(agt.predict_ar(mt, st, t64(series[-LAG:]), 20), agp.predict_ar(mj, sj, jnp.asarray(series[-LAG:]), 20),
          rtol=1e-10, atol=1e-10)


def reference_normals(n_samples, n_steps, key=None):
    """The standard normals the reference's sample_ar draws: trajectory i
    from split(key, n_samples)[i], step t from split(that, n_steps)[t]."""
    key = jax.random.PRNGKey(0) if key is None else key
    return np.array([[float(jax.random.normal(k_t, (), dtype=jnp.float64)) for k_t in jax.random.split(k, n_steps)]
                     for k in jax.random.split(key, n_samples)])


def test_sample_ar_matches_jax(trained):
    """sample_ar's 6 trajectories of 8 steps, fed the reference's normals,
    at rtol 1e-10: the port's one [6, lag] window a step equals the
    reference's vmap over trajectories (atol 1e-10, as predict_ar's)."""
    mj, sj, mt, st, series = trained
    ref = agp.sample_ar(mj, sj, jnp.asarray(series[-LAG:]), n_steps=8, n_samples=6)
    out = agt.sample_ar(mt, st, t64(series[-LAG:]), n_steps=8, n_samples=6, eps=t64(reference_normals(6, 8)))
    assert out.shape == (6, 8)
    close(out, ref, rtol=1e-10, atol=1e-10)


def test_ar_reference_check():
    """tests/test_engines.py:311-326 through the port: predict_ar's mean
    absolute error over 20 steps < 0.5, sample_ar's shape (4, 10) with a
    generator; the grand tour's section 10 rollout (lag 4) finite."""
    series, Xl, yl = series_data()
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(1e-3), agt.AnalyticVI(),
                            Z=t64(Xl[:20]), optimiser=None)
    model, state = agt.train(model, t64(Xl), yl, iterations=15)
    t = np.linspace(0, 8 * np.pi, 200)
    preds = agt.predict_ar(model, state, t64(series[-LAG:]), n_steps=20)
    future = np.sin(t[-1] + (t[1] - t[0]) * np.arange(1, 21))
    assert float(np.mean(np.abs(preds.numpy() - future))) < 0.5
    traj = agt.sample_ar(model, state, series[-LAG:], n_steps=10, n_samples=4, generator=torch.Generator().manual_seed(1))
    assert traj.shape == (4, 10) and bool(torch.isfinite(traj).all())
    s4, X4, y4 = series_data(300, 12, 4)
    ar = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(1e-3), agt.AnalyticVI(),
                         Z=t64(X4[:16]), optimiser=None)
    ar, ars = agt.train(ar, t64(X4), y4, iterations=10)
    assert bool(torch.isfinite(agt.predict_ar(ar, ars, s4[-4:], 10)).all())


def test_rollouts_read_nothing_from_the_host(trained):
    """Neither rollout reads the device back (utils.tensors.host_read)."""
    _, _, mt, st, series = trained
    reads = host_read.reads
    agt.predict_ar(mt, st, t64(series[-LAG:]), 10)
    agt.sample_ar(mt, st, t64(series[-LAG:]), 10, n_samples=3)
    assert host_read.reads == reads


def test_slice_h_names_are_public():
    """The public names of Slice H and MultiClassLikelihood resolve from
    agp_tpu_torch, as they do from agp_tpu."""
    names = ("VStP", "MOSVGP", "MOVGP", "mo_train", "mo_init_state", "mo_elbo", "mo_predict_f", "mo_predict_y",
             "mo_proba_y", "predict_ar", "sample_ar", "MultiClassLikelihood")
    assert all(hasattr(agp, n) and n in agt.__all__ and hasattr(agt, n) for n in names)
