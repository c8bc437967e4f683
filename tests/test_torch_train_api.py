"""The rest of the port's ``train()`` and predictions against the JAX
package's, float64: when the callback runs (before a VGP's hyperparameter
step, after a GP's), what ``verbose=2`` prints, the iteration where
``conv_eps`` stops, ``chunk_size`` (equal to the unchunked call and to the
reference's; refused with the full covariance), ``model_repr``,
``sample_f`` (its moments against ``predict_f``'s and its reproducibility
under a fixed generator) and carrying a JAX GP and VGP across."""
import functools
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from torch_helpers import close, close_tree, logistic_data, multiclass_data, state_arrays

N, D = 100, 2


def toy(n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, D))
    return X, np.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.1 * rng.normal(size=n)


def gp_pair(**kw):
    X, y = toy()
    return (agp.GP.create(jnp.asarray(X), jnp.asarray(y), agp.SqExponentialKernel(), **kw),
            agt.GP.create(torch.as_tensor(X), torch.as_tensor(y), agt.SqExponentialKernel(), **kw))


def vgp_pair(lik="studentt", **kw):
    """The same VGP in both packages (Matern-5/2 kernel)."""
    if lik == "multiclass":
        X, y = multiclass_data(N, D, 3)
        liks = agp.LogisticSoftMaxLikelihood.create(3), agt.LogisticSoftMaxLikelihood.create(3)
    elif lik == "logistic":
        X, y = logistic_data(N, D)
        liks = agp.LogisticLikelihood.create(), agt.LogisticLikelihood.create()
    else:
        X, y = toy()
        liks = agp.StudentTLikelihood.create(4.0), agt.StudentTLikelihood.create(4.0)
    return (agp.VGP.create(jnp.asarray(X), y, agp.Matern52Kernel(), liks[0], agp.AnalyticVI(), **kw),
            agt.VGP.create(torch.as_tensor(X), y, agt.Matern52Kernel(), liks[1], agt.AnalyticVI(), **kw))


@pytest.mark.parametrize("model", ["vgp", "gp"])
def test_callback_runs_where_the_reference_runs_it(model):
    """callback(model, state, i) runs once an iteration, with i from 1:
    for a VGP after the CAVI step and before that iteration's
    hyperparameter step, for a GP after both (the hyperparameter steps
    being after iterations 3..n-1), as in the reference: the Adam count it
    sees is the reference's at every iteration."""
    mj, mt = vgp_pair() if model == "vgp" else gp_pair()
    seen = [], []
    agp.train(mj, iterations=6, callback=lambda m, s, i: seen[0].append((i, int(s.hyper_state["kernel"][0].count))))
    agt.train(mt, iterations=6, callback=lambda m, s, i: seen[1].append((i, int(s.hyper_state["kernel"]["count"]))))
    assert seen[1] == seen[0]
    want = [0, 0, 0, 1, 2, 3] if model == "vgp" else [0, 0, 1, 2, 3, 3]
    assert seen[1] == list(zip(range(1, 7), want))


def printed(capsys):
    return [(int(i), float(v)) for i, v in re.findall(r"^iter (\d+): .* = (\S+)$", capsys.readouterr().out, re.M)]


@pytest.mark.parametrize("model", ["vgp", "gp"])
def test_verbose_prints_the_reference_lines(model, capsys):
    """verbose=2 prints one line an iteration ("iter i: ELBO = ..." for a
    VGP, "iter i: log p(y) = ..." for a GP) with the reference's values
    (rtol 1e-6, six decimals); verbose=1 prints nothing."""
    mj, mt = vgp_pair() if model == "vgp" else gp_pair()
    agp.train(mj, iterations=4, verbose=2)
    ref_out = capsys.readouterr().out
    agt.train(mt, iterations=4, verbose=2)
    out = capsys.readouterr().out
    word = "ELBO" if model == "vgp" else "log p(y)"
    assert [line.split("=")[0] for line in out.splitlines()] == [f"iter {i}: {word} " for i in range(1, 5)]
    assert [line.split("=")[0] for line in ref_out.splitlines()] == [line.split("=")[0] for line in out.splitlines()]
    got = [float(line.split("=")[1]) for line in out.splitlines()]
    ref = [float(line.split("=")[1]) for line in ref_out.splitlines()]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-6)
    agt.train(mt, iterations=2, verbose=1)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("every", [5, 10])
def test_conv_eps_stops_where_the_reference_stops(every):
    """A VGP without hyperparameter learning stops at the window where its
    ELBO moves by less than conv_eps an iteration, the reference's
    iteration (its step count), before the iteration budget."""
    mj, mt = vgp_pair("logistic", optimiser=None)
    _, sj = agp.train(mj, iterations=300, conv_eps=1e-4, conv_check_every=every)
    _, st = agt.train(mt, iterations=300, conv_eps=1e-4, conv_check_every=every)
    assert int(st.step) == int(sj.step)
    assert int(st.step) < 300 and int(st.step) % every == 0


def test_conv_eps_stochastic_checks_a_fresh_batch():
    """A stochastic SVGP checks its ELBO on a fresh minibatch at the end of
    each window: with a bound no ELBO change meets it stops at the first
    comparison (two windows), with a bound every change exceeds it runs
    every iteration."""
    X, y = logistic_data(512, D)
    m = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(64),
                        torch.as_tensor(X[:16]), optimiser=None)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    _, s = agt.train(m, Xt, yt, iterations=100, conv_eps=1e12, conv_check_every=7)
    assert int(s.step) == 14
    _, s = agt.train(m, Xt, yt, iterations=100, conv_eps=1e-300, conv_check_every=7)
    assert int(s.step) == 100


@functools.lru_cache(maxsize=None)
def trained(model):
    """(JAX model, state, port model, state) of a model trained 6
    iterations in each package (made once a process: the tests only read
    them)."""
    if model == "gp":
        mj, mt = gp_pair()
    else:
        mj, mt = vgp_pair("multiclass" if model == "vgp_multiclass" else "studentt")
    return (*agp.train(mj, iterations=6), *agt.train(mt, iterations=6))


@pytest.mark.parametrize("model", ["gp", "vgp", "vgp_multiclass"])
def test_chunk_size_equals_the_whole_call(model):
    """predict_f (mean, diagonal variance), predict_y and proba_y in chunks
    of 17 rows (the last padded and cut) equal the unchunked call (rtol
    1e-12) and the reference's chunked call (rtol 1e-7: trained apart);
    the full covariance with chunk_size raises ValueError, as the
    reference's does."""
    mj, sj, mt, st = trained(model)
    Xh = np.random.default_rng(1).uniform(-2, 2, size=(60, D))
    Xj, Xt = jnp.asarray(Xh), torch.as_tensor(Xh)
    kw = dict(n_samples=0) if model == "vgp_multiclass" else {}
    calls = (
        lambda pkg, m, s, x, **c: pkg.predict_f(m, s, x, **c),
        lambda pkg, m, s, x, **c: pkg.predict_f(m, s, x, cov=True, **c),
        lambda pkg, m, s, x, **c: pkg.predict_y(m, s, x, **c),
        lambda pkg, m, s, x, **c: pkg.proba_y(m, s, x, **kw, **c),
    )
    for k, fn in enumerate(calls):
        chunked = fn(agt, mt, st, Xt, chunk_size=17)
        close_tree(chunked, fn(agt, mt, st, Xt), rtol=1e-12, atol=1e-14, msg=f"call {k}")
        close_tree(chunked, fn(agp, mj, sj, Xj, chunk_size=17), rtol=1e-7, atol=1e-9, msg=f"call {k} vs jax")
    for pkg, m, s, x in ((agp, mj, sj, Xj), (agt, mt, st, Xt)):
        with pytest.raises(ValueError, match="chunk_size"):
            pkg.predict_f(m, s, x, cov=True, diag=False, chunk_size=17)


def test_model_repr_matches_the_reference():
    """repr of an SVGP, a VGP (one latent and three) and a GP reads as the
    reference's model_repr."""
    X, y = logistic_data(40, D)
    pairs = [
        (agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticLikelihood.create(), agp.AnalyticSVI(8),
                         jnp.asarray(X[:8])),
         agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(8),
                         torch.as_tensor(X[:8]))),
        vgp_pair(),
        vgp_pair("multiclass"),
        gp_pair(),
    ]
    for mj, mt in pairs:
        assert repr(mt) == repr(mj)
    assert repr(pairs[0][1]) == "SVGP(likelihood=LogisticLikelihood, inference=AnalyticVI, n_latent=1, n_inducing=8)"
    assert repr(pairs[3][1]) == "GP(likelihood=GaussianLikelihood, inference=Analytic, n_latent=1)"


@pytest.mark.parametrize("model", ["gp", "vgp_multiclass"])
def test_sample_f_moments_and_reproducibility(model):
    """4,000 joint samples: their mean and covariance within 5 standard
    errors of predict_f's (plus the diagonal jitter sample_f adds), the
    reference's shape ([S, n], or [S, L, n] for several latents), and the
    same draws again from a generator with the same seed."""
    mj, sj, mt, st = trained(model)
    Xh = torch.as_tensor(np.random.default_rng(2).uniform(-2, 2, size=(12, D)))
    S = 4000
    samples = agt.sample_f(mt, st, Xh, S, generator=torch.Generator().manual_seed(3))
    ref_shape = agp.sample_f(mj, sj, jnp.asarray(Xh.numpy()), n_samples=S).shape
    assert tuple(samples.shape) == tuple(ref_shape)
    again = agt.sample_f(mt, st, Xh, S, generator=torch.Generator().manual_seed(3))
    assert torch.equal(samples, again)
    assert not torch.equal(samples, agt.sample_f(mt, st, Xh, S, generator=torch.Generator().manual_seed(4)))
    mu, cov = agt.predict_f(mt, st, Xh, cov=True, diag=False)
    cov = cov + agt.config.jitter(torch.float64) * torch.eye(12, dtype=torch.float64)
    if samples.ndim == 2:
        samples, mu, cov = samples[:, None], mu[None], cov[None]
    for l in range(mu.shape[0]):
        x = samples[:, l]
        var = torch.diagonal(cov[l])
        assert ((x.mean(0) - mu[l]).abs() <= 5 * torch.sqrt(var / S)).all()
        emp = torch.cov(x.T)
        se = torch.sqrt((var[:, None] * var[None, :] + cov[l] ** 2) / S)
        assert ((emp - cov[l]).abs() <= 5 * se + 1e-12).all()


def test_interop_round_trip():
    """A trained JAX GP and VGP carried into the port hold the reference's
    leaves exactly: model (training data, kernel, likelihood, sigma^2) and
    state (alpha, chol_Sigma, the noise rule's Adam state; eta, mu, Sigma
    and the dense kmat with no L_inv)."""
    from agp_tpu_torch.interop import model_from_numpy, state_from_numpy

    for mj, mt in (gp_pair(), vgp_pair()):
        mj, sj = agp.train(mj, iterations=4)
        params = dict(train_x=np.array(mj.train_x), train_y=np.array(mj.train_y),
                      lengthscale=np.array(mj.kernel.lengthscale), variance=np.array(mj.kernel.variance))
        for k in ("sigma2", "nu", "sigma"):
            if hasattr(mj.likelihood, k):
                params[k] = np.array(getattr(mj.likelihood, k))
        m2 = model_from_numpy(params, mt)
        s2 = state_from_numpy(state_arrays(sj), "cpu", torch.float64)
        for k, v in params.items():
            got = getattr(m2, k) if k.startswith("train") else getattr(
                m2.kernel if k in ("lengthscale", "variance") else m2.likelihood, k)
            close(got, v, rtol=0, atol=0, msg=k)
        for k in ("alpha", "chol_Sigma", "eta1", "eta2", "mu", "Sigma"):
            if getattr(sj, k) is not None:
                close(getattr(s2, k), getattr(sj, k), rtol=0, atol=0, msg=k)
        if sj.kmat is not None:
            assert set(s2.kmat) == {"L_K", "K_inv"}
        if isinstance(mt, agt.GP):
            assert int(s2.local_vars["state_sigma2"]["count"]) == int(sj.local_vars["state_sigma2"][0].count) == 5


def test_train_takes_the_models_own_data():
    """train(vgp) and train(gp) need no X and y; train(svgp) without them
    raises ValueError, as the reference's does."""
    _, mt = vgp_pair()
    _, st = agt.train(mt, iterations=2)
    assert int(st.step) == 2
    X, y = logistic_data(64, D)
    m = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(16),
                        torch.as_tensor(X[:8]))
    with pytest.raises(ValueError, match="needs X, y"):
        agt.train(m, iterations=2)
