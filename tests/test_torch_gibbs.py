"""The port's exact augmented Gibbs sampler (``inference/gibbs.py``,
``models/mcgp.py``) against the JAX package, float64 on the CPU.

* Each likelihood's ``sample_local`` in distribution against the
  reference's at a fixed f: a two-sample Kolmogorov-Smirnov test per lane
  (p above KS_P, fixed seeds), the discrete Poisson counts by their means.
* The global resample, given the reference's omega and the same normals
  (the reference's key splits reproduced here), equal to the reference's
  ``gibbs_step`` at rtol 1e-8 (Cholesky) and 1e-6 (CG), for one latent and
  for three.
* Gaussian-likelihood chains against the closed-form posterior with both
  solvers; CAVI (the port's VGP) against Gibbs for Student-t and logistic.
* ``predict_f_samples`` and ``proba_y_mc`` against the reference's on the
  same samples at rtol 1e-8; ``model_from_numpy`` for an MCGP; the kept
  samples' indices; the host reads of a sweep."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference import gibbs as jgibbs
from agp_tpu.means import batch_call as jax_batch_call
from agp_tpu.models import mcgp as jmcgp
from agp_tpu_torch.inference import gibbs
from agp_tpu_torch.interop import model_from_numpy
from agp_tpu_torch.means import batch_call
from agp_tpu_torch.models import mcgp
from agp_tpu_torch.utils.tensors import host_read
from torch_helpers import close, cls_data, jax_kmat, jax_mcgp, port_likelihood, port_mcgp, reg_data, t64
from torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KS_P = 1e-3
SE = 6.0


# ---------------------------------------------------------- sample_local
def lik_case(name):
    """(JAX likelihood, labels [B] or one-hot labels, f [L, B]) at four
    lanes."""
    f1 = np.array([-1.5, -0.2, 0.4, 2.5])
    if name == "multiclass":
        f = np.stack([f1, -0.5 * f1, np.array([0.3, 1.0, -1.0, 0.0])])
        return agp.LogisticSoftMaxLikelihood.create(3), np.eye(3)[[0, 1, 2, 1]], f
    if name == "het":
        return agp.HeteroscedasticLikelihood.create(2.0), np.array([0.5, -1.0, 2.0, 0.0]), np.stack([f1, -f1])
    y = {"logistic": np.array([1.0, -1.0, 1.0, 1.0]), "poisson": np.array([0.0, 2.0, 1.0, 5.0]),
         "negbinomial": np.array([0.0, 3.0, 1.0, 7.0])}.get(name, np.array([-1.0, 0.3, 1.0, 2.0]))
    lik = {"logistic": agp.LogisticLikelihood.create(), "poisson": agp.PoissonLikelihood.create(3.0),
           "negbinomial": agp.NegBinomialLikelihood.create(4.0), "studentt": agp.StudentTLikelihood.create(4.0, 0.5),
           "laplace": agp.LaplaceLikelihood.create(0.7), "matern32": agp.Matern32Likelihood.create(0.8),
           "gaussian": agp.GaussianLikelihood.create(0.1)}[name]
    return lik, y, f1[None]


DRAWN = {"logistic": ("theta",), "poisson": ("theta",), "negbinomial": ("theta",), "studentt": ("c", "theta"),
         "laplace": ("b", "theta"), "matern32": ("theta",), "multiclass": ("alpha", "theta"), "het": ("theta",),
         "gaussian": ()}
COUNTS = {"poisson": ("gamma",), "multiclass": ("gamma",), "het": ("gamma",)}


@pytest.mark.parametrize("name", list(DRAWN))
def test_sample_local_in_distribution(name):
    """R = 2000 draws of omega | f at each lane, the port's (one call over a
    [R] chain axis) against the reference's (vmapped over keys)."""
    R = 2000
    lik_j, y, f = lik_case(name)
    lt = port_likelihood(lik_j)[0]
    lt = lt.replace(**{k: t64(getattr(lik_j, k)) for k in ("lam", "r", "nu", "sigma", "beta", "rho", "sigma2")
                       if k in type(lik_j).__dataclass_fields__})
    B = f.shape[1]
    local_j = lik_j.init_local_vars(B, jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(7), R)
    ref = jax.jit(jax.vmap(lambda k: lik_j.sample_local(k, jnp.asarray(y), jnp.asarray(f), local_j)))(keys)
    local_t = {k: t64(v) for k, v in local_j.items()}
    got = lt.sample_local(torch.Generator().manual_seed(7), t64(y), t64(f).expand((R,) + f.shape), local_t)
    if name == "gaussian":
        for k in local_j:
            close(got[k], local_j[k], rtol=0, atol=0)
    if name == "matern32":  # c = |f - y|, not drawn
        close(got["c"].expand(R, B), np.asarray(ref["c"]), rtol=1e-15)
    for k in DRAWN[name]:
        g, r = got[k].reshape(R, -1).numpy(), np.asarray(ref[k]).reshape(R, -1)
        assert g.shape == r.shape, (k, g.shape, r.shape)
        for j in range(g.shape[1]):
            p = st.ks_2samp(g[:, j], r[:, j]).pvalue
            assert p > KS_P, (name, k, j, p)
    for k in COUNTS.get(name, ()):
        g, r = got[k].reshape(R, -1).numpy(), np.asarray(ref[k]).reshape(R, -1)
        z = (g.mean(0) - r.mean(0)) / np.sqrt((g.var(0) + r.var(0)) / R + 1e-300)
        assert np.all(np.abs(z) < SE), (name, k, z)


# ------------------------------------------------------ global resample
@pytest.mark.parametrize("solver", ["chol", "cg"])
@pytest.mark.parametrize("which", ["logistic", "multiclass"])
def test_global_resample_matches_reference(solver, which):
    """The reference's ``gibbs_step`` from a random f; the port's global
    resample from the reference's omega and the normals of the reference's
    own key splits: f equal at rtol 1e-8 (Cholesky) and 1e-6 (CG, whose
    stopping rule the port copies); the port's setup (L_K, K^-1) at 1e-10."""
    if which == "logistic":
        X, _, y = cls_data(40)
        lik = agp.LogisticLikelihood.create()
    else:
        X, f_, _ = cls_data(30, seed=1)
        y = np.digitize(f_, [-0.5, 0.5])
        lik = agp.LogisticSoftMaxLikelihood.create(3)
    mj = jax_mcgp(lik, X, y, solver)
    mt = port_mcgp(mj, y)
    L, N = mj.n_latent, X.shape[0]
    kmat_j = jax_kmat(mj)
    kmat_t = mcgp.gibbs_setup(mt)
    for k in ("L_K", "K_inv"):
        close(kmat_t[k], kmat_j[k], rtol=1e-10, atol=1e-12 * float(jnp.abs(kmat_j[k]).max()), msg=k)
    mu0 = jax_batch_call(mj.mean, mj.train_x, L)
    f = jnp.asarray(np.random.default_rng(3).normal(size=(L, N)))
    key = jax.random.PRNGKey(5)
    f_ref, local = jax.jit(jgibbs.gibbs_step)(mj, kmat_j, mu0, key, f, mj.likelihood.init_local_vars(N, jnp.float64))
    _, k_glob = jax.random.split(key)
    keys = jax.random.split(k_glob, L)
    local_t = {k: t64(v) for k, v in local.items()}
    lt = mt.likelihood
    gmu = lt.grad_e_mu(mt.train_y, local_t).expand(L, N)[None]
    gs = lt.grad_e_sigma(mt.train_y, local_t).expand(L, N)[None]
    mu0_t = batch_call(mt.mean, mt.train_x, L)
    if solver == "chol":
        eps = torch.stack([t64(jax.random.normal(k, (N,), dtype=jnp.float64)) for k in keys])[None]
        got = gibbs._global_resample_chol(gmu, gs, kmat_t["K_inv"], mu0_t, eps)
        rtol = 1e-8
    else:
        xi = [[t64(jax.random.normal(kk, (N,), dtype=jnp.float64)) for kk in jax.random.split(k)] for k in keys]
        xi1 = torch.stack([a for a, _ in xi])[None]
        xi2 = torch.stack([b for _, b in xi])[None]
        got = gibbs._global_resample_cg(gmu, gs, kmat_t["K_inv"], kmat_t["L_K"], mu0_t, xi1, xi2)
        rtol = 1e-6
    close(got[0], f_ref, rtol=rtol, atol=rtol * float(jnp.abs(f_ref).max()))


def test_chains_are_independent_and_batched():
    """Chains as a leading axis: the chol resample of two chains equals
    each chain's own at 1e-12; the CG resample within 1e-6 of the largest
    entry (each system frozen on its own convergence; the batch's width
    changes the matvecs' rounding, which CG carries to ~1e-7 here, below
    its own 1e-5 residual)."""
    X, _, y = cls_data(40)
    mt = port_mcgp(jax_mcgp(agp.LogisticLikelihood.create(), X, y), y)
    kmat = mcgp.gibbs_setup(mt)
    mu0 = batch_call(mt.mean, mt.train_x, 1)
    rng = np.random.default_rng(0)
    gmu, gs, e1, e2 = (t64(rng.normal(size=(2, 1, 40))) for _ in range(4))
    gs = gs.abs()
    both = gibbs._global_resample_chol(gmu, gs, kmat["K_inv"], mu0, e1)
    both_cg = gibbs._global_resample_cg(gmu, gs, kmat["K_inv"], kmat["L_K"], mu0, e1, e2)
    for c in range(2):
        one = gibbs._global_resample_chol(gmu[c:c + 1], gs[c:c + 1], kmat["K_inv"], mu0, e1[c:c + 1])
        close(both[c], one[0], rtol=1e-12, atol=1e-12)
        one_cg = gibbs._global_resample_cg(gmu[c:c + 1], gs[c:c + 1], kmat["K_inv"], kmat["L_K"], mu0, e1[c:c + 1],
                                           e2[c:c + 1])
        close(both_cg[c], one_cg[0], rtol=0, atol=1e-6 * float(one_cg.abs().max()))


def test_run_chain_keeps_the_reference_samples(monkeypatch):
    """run_chain keeps all_f[n_burnin + thinning - 1 :: thinning], written
    into [n_samples, C, L, N]."""
    X, _, y = cls_data(10)
    mt = port_mcgp(jax_mcgp(agp.LogisticLikelihood.create(), X, y), y)
    count = {"t": 0}

    def fake_step(model, kmat, mu0, generator, f, local):
        count["t"] += 1
        return torch.full_like(f, float(count["t"] - 1)), local

    monkeypatch.setattr(gibbs, "gibbs_step", fake_step)
    for n_samples, n_burnin, thinning in ((5, 3, 1), (4, 7, 3), (3, 0, 2)):
        count["t"] = 0
        kept, _, _ = gibbs.run_chain(mt, None, None, n_samples, n_burnin, thinning, {}, n_chains=2)
        all_t = np.arange(n_burnin + n_samples * thinning)
        assert kept.shape == (n_samples, 2, 1, 10)
        np.testing.assert_array_equal(kept[:, 0, 0, 0].numpy(), all_t[n_burnin + thinning - 1::thinning])


def test_a_chol_sweep_reads_the_host_only_in_its_draws():
    """A Gaussian sweep (no augmentation to draw) with the Cholesky solver
    reads nothing back to the host; a CG sweep reads at most once every 8
    iterations."""
    X, _, y = cls_data(40)
    for solver, most in (("chol", 0), ("cg", -(-40 // 8))):
        mt = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.1),
                             agt.GibbsSampling(solver=solver))
        kmat = mcgp.gibbs_setup(mt)
        mu0 = batch_call(mt.mean, mt.train_x, 1)
        local = mt.likelihood.init_local_vars(40, torch.float64)
        reads = host_read.reads
        gibbs.gibbs_step(mt, kmat, mu0, torch.Generator().manual_seed(0), torch.zeros(3, 1, 40, dtype=torch.float64),
                         local)
        assert 0 < host_read.reads - reads <= most if most else host_read.reads == reads, solver


# ------------------------------------------------------------- chains
@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_gibbs_matches_exact_gaussian(solver):
    """tests/test_engines.py:64-79: with a Gaussian likelihood the chain's
    mean correlates with the exact posterior mean above 0.99."""
    X, _, y = reg_data()
    mg = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05),
                         agt.GibbsSampling(n_burnin=100, solver=solver))
    s = agt.sample(mg, 300, generator=torch.Generator().manual_seed(3))
    assert s.shape == (300, 1, 30)
    K = agt.SqExponentialKernel().gram(t64(X), t64(X)).numpy() + 1e-4 * np.eye(30)
    mean_exact = K @ np.linalg.solve(K + 0.05 * np.eye(30), y)
    assert np.corrcoef(s.mean(0)[0].numpy(), mean_exact)[0, 1] > 0.99


@pytest.mark.parametrize("solver", ["chol", "cg"])
def test_gibbs_solver_matches_exact_posterior(solver):
    """tests/test_engines.py:694-727, for each solver: N=80 in 1-D, noise
    0.01, burn-in 200, thinning 2, 600 samples: corr > 0.999, max |d mean|
    < 0.05, median relative variance error < 0.2."""
    N = 80
    X = np.linspace(-3, 3, N)[:, None]
    y = np.sin(1.5 * X[:, 0]) + 0.1 * np.random.default_rng(0).normal(size=N)
    kern = agt.SqExponentialKernel(lengthscale=0.7)
    K = kern.gram(t64(X), t64(X)).numpy() + 1e-4 * np.eye(N)
    Sig = np.linalg.inv(np.linalg.inv(K) + np.eye(N) / 0.01)
    mu_exact, var_exact = Sig @ (y / 0.01), np.diag(Sig)
    m = agt.MCGP.create(t64(X), t64(y), kern, agt.GaussianLikelihood.create(0.01),
                        agt.GibbsSampling(n_burnin=200, thinning=2, solver=solver))
    s = agt.sample(m, 600, generator=torch.Generator().manual_seed(1))[:, 0].numpy()
    assert np.corrcoef(s.mean(0), mu_exact)[0, 1] > 0.999
    assert np.max(np.abs(s.mean(0) - mu_exact)) < 0.05
    assert np.median(np.abs(s.var(0) - var_exact) / var_exact) < 0.2


def test_cavi_gibbs_agreement_studentt():
    """tests/test_engines.py:380-397 with the port's VGP: corr > 0.99 and
    max |d mean| < 0.3."""
    X, _, y = reg_data()
    lik = agt.StudentTLikelihood.create(4.0)
    vg = agt.VGP.create(t64(X), t64(y), agt.SqExponentialKernel(), lik, agt.AnalyticVI(), optimiser=None)
    vg, vst = agt.train(vg, iterations=40)
    mg = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), lik, agt.GibbsSampling(n_burnin=200))
    mu_g = agt.sample(mg, 400, generator=torch.Generator().manual_seed(11)).mean(0)[0].numpy()
    mu_v = vst.mu[0].numpy()
    assert np.corrcoef(mu_g, mu_v)[0, 1] > 0.99
    assert np.max(np.abs(mu_g - mu_v)) < 0.3


def test_cavi_gibbs_agreement_logistic():
    """The repository's strong oracle with the port's VGP: the logistic
    CAVI posterior mean against Gibbs's (4 chains), corr > 0.99."""
    X, _, y = cls_data(40)
    vg = agt.VGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticVI(),
                        optimiser=None)
    vg, vst = agt.train(vg, iterations=60)
    mg = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=200))
    s = agt.sample(mg, 300, generator=torch.Generator().manual_seed(2), n_chains=4)
    assert s.shape == (4, 300, 1, 40)
    assert np.corrcoef(s.mean((0, 1))[0].numpy(), vst.mu[0].numpy())[0, 1] > 0.99


# --------------------------------------------------------- predictions
@pytest.mark.parametrize("which", ["logistic", "gaussian", "poisson", "multiclass"])
def test_predictions_from_samples_match_reference(which):
    """predict_f_samples and proba_y_mc on the same samples at rtol 1e-8."""
    X, f, y = cls_data(30, seed=2)
    lik = {"logistic": agp.LogisticLikelihood.create(), "gaussian": agp.GaussianLikelihood.create(0.1),
           "poisson": agp.PoissonLikelihood.create(2.0), "multiclass": agp.LogisticSoftMaxLikelihood.create(3)}[which]
    y = {"gaussian": f, "poisson": np.round(2 * np.exp(0.3 * f)), "multiclass": np.digitize(f, [-0.5, 0.5])}.get(which, y)
    mj = jax_mcgp(lik, X, y, ls=0.8)
    mt = port_mcgp(mj, y)
    rng = np.random.default_rng(4)
    samples = rng.normal(size=(7, mj.n_latent, 30))
    Xt = rng.uniform(-2, 2, size=(11, 2))
    close(mcgp.predict_f_samples(mt, t64(samples), t64(Xt)),
          jmcgp.predict_f_samples(mj, jnp.asarray(samples), jnp.asarray(Xt)), rtol=1e-8, atol=1e-12)
    got = mcgp.proba_y_mc(mt, t64(samples), t64(Xt))
    ref = jmcgp.proba_y_mc(mj, jnp.asarray(samples), jnp.asarray(Xt))
    if isinstance(ref, tuple):
        for g, r in zip(got, ref):
            close(g, r, rtol=1e-8, atol=1e-12)
    else:
        close(got, ref, rtol=1e-8, atol=1e-12)


def test_model_from_numpy_builds_an_mcgp():
    """interop's train_x/train_y branch carries an MCGP: data, kernel and
    likelihood parameters land on the template's device and dtype."""
    X, f, y = cls_data(20)
    template = agt.MCGP.create(t64(X), np.round(np.exp(f)), agt.SqExponentialKernel(), agt.PoissonLikelihood.create(),
                               agt.GibbsSampling(n_burnin=3))
    m = model_from_numpy(dict(train_x=X[::-1].copy(), train_y=np.arange(20.0), lengthscale=np.array([0.6]),
                              variance=np.array([1.7]), lam=np.array(2.5)), template)
    assert isinstance(m, agt.MCGP) and m.inference == template.inference
    close(m.train_x, X[::-1], rtol=0, atol=0)
    close(m.train_y, np.arange(20.0), rtol=0, atol=0)
    close(m.kernel.lengthscale, [0.6], rtol=0, atol=0)
    close(m.kernel.variance, [1.7], rtol=0, atol=0)
    close(m.likelihood.lam, 2.5, rtol=0, atol=0)
    assert m.train_x.dtype == torch.float64 and m.likelihood.lam.dtype == torch.float64
    assert torch.isfinite(agt.sample(m, 4)).all()


def test_mcgp_refuses_what_the_reference_refuses():
    """The likelihood/engine gate: the Bayesian SVM takes no Gibbs, the
    Matern-3/2 noise no HMC; an unknown solver raises."""
    X, _, y = cls_data(10)
    with pytest.raises(ValueError):
        agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.BayesianSVM.create())
    with pytest.raises(ValueError):
        agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.Matern32Likelihood.create(), agt.HMCSampling())
    with pytest.raises(ValueError):
        agt.GibbsSampling(solver="lu")
