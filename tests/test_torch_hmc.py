"""The port's HMC and NUTS (``inference/hmc.py``) against the JAX package,
float64 on the CPU: the whitened log joint and its gradient against
``jax.value_and_grad`` of the reference's ``make_log_joint`` (one latent
and three) at rtol 1e-10, batched chains each equal to their own;
``leapfrog`` from a fed momentum, 16 steps, at rtol 1e-8; NUTS and HMC on
the conjugate Gaussian posterior (tests/test_engines.py:448-467's
bounds); NUTS's host reads per step."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference import hmc as jhmc
from agp_tpu.means import batch_call as jax_batch_call
from agp_tpu_torch.inference import hmc
from agp_tpu_torch.means import batch_call
from agp_tpu_torch.models.mcgp import prior_chol
from agp_tpu_torch.utils.tensors import host_read
from torch_helpers import close, cls_data, jax_kmat, jax_mcgp, port_mcgp, reg_data, t64
from torch_helpers import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def case(which):
    """(JAX MCGP, port MCGP, JAX L_K, mu0) of a logistic (one latent) or
    logistic-softmax (K=3) model on 30 points."""
    X, f, y = cls_data(30, seed=1)
    if which == "multiclass":
        y = np.digitize(f, [-0.5, 0.5])
        lik = agp.LogisticSoftMaxLikelihood.create(3)
    elif which == "het":
        y = f
        lik = agp.HeteroscedasticLikelihood.create(2.0)
    else:
        lik = agp.LogisticLikelihood.create()
    mj = jax_mcgp(lik, X, y, ls=0.8)
    return mj, port_mcgp(mj, y), jax_kmat(mj)["L_K"], jax_batch_call(mj.mean, mj.train_x, mj.n_latent)


def port_vg(mt):
    L_K = prior_chol(mt)
    return hmc.value_and_grad(hmc.make_log_joint(mt, L_K, batch_call(mt.mean, mt.train_x, mt.n_latent))), L_K


@pytest.mark.parametrize("which", ["logistic", "multiclass", "het"])
def test_log_joint_and_gradient_match_reference(which):
    mj, mt, L_K, mu0 = case(which)
    vg_j = jax.value_and_grad(jhmc.make_log_joint(mj, L_K, mu0))
    vg_t, L_K_t = port_vg(mt)
    close(L_K_t, L_K, rtol=1e-12, atol=1e-14)
    v = np.random.default_rng(0).normal(size=(3, mj.n_latent, 30))
    lp, g = vg_t(t64(v))
    for c in range(3):
        lp_j, g_j = vg_j(jnp.asarray(v[c]))
        close(lp[c], lp_j, rtol=1e-10, atol=0, msg=f"log joint, chain {c}")
        close(g[c], g_j, rtol=1e-10, atol=1e-13, msg=f"gradient, chain {c}")


@pytest.mark.parametrize("which", ["logistic", "multiclass"])
def test_leapfrog_matches_reference(which):
    """16 leapfrog steps of size 0.05 from a fed momentum."""
    mj, mt, L_K, mu0 = case(which)
    vg_j = jax.value_and_grad(jhmc.make_log_joint(mj, L_K, mu0))
    vg_t, _ = port_vg(mt)
    rng = np.random.default_rng(1)
    v, p = rng.normal(size=(2, mj.n_latent, 30)) * 0.5
    _, g = vg_j(jnp.asarray(v))
    ref = jhmc.leapfrog(vg_j, jnp.asarray(v), jnp.asarray(p), g, 0.05, 16)
    got = hmc.leapfrog(vg_t, t64(v)[None], t64(p)[None], t64(g)[None], torch.tensor([0.05], dtype=torch.float64), 16)
    for name, a, b in zip(("v", "p", "grad"), got, ref):
        close(a[0], b, rtol=1e-8, atol=1e-12, msg=name)


def conjugate():
    """tests/test_engines.py:448-467's conjugate posterior: reg_data with
    noise 0.05^2; the exact posterior mean and variances."""
    X, _, y = reg_data()
    sigma2 = 0.05**2
    K = agt.SqExponentialKernel().gram(t64(X), t64(X)).numpy()
    mean = K @ np.linalg.solve(K + sigma2 * np.eye(30), y)
    var = np.diag(K - K @ np.linalg.solve(K + sigma2 * np.eye(30), K))
    return X, y, sigma2, mean, var


@pytest.mark.parametrize("algorithm", ["nuts", "hmc"])
def test_conjugate_posterior(algorithm):
    """corr > 0.999 with the exact posterior mean, median variance ratio in
    (0.75, 1.33), over 600 samples or more: NUTS in 32 chains of 20 after 60
    burn-in steps (the posterior's whitened condition number ~1e4 fills
    most trees to max_depth 8: ~245 leaves a step, each a few dozen
    host-dispatched ops on the CPU), HMC in 2 chains of 600 after 300 (16
    leapfrog steps)."""
    X, y, sigma2, mean, var = conjugate()
    burnin, n, chains = (60, 20, 32) if algorithm == "nuts" else (300, 600, 2)
    m = agt.MCGP.create(t64(X), t64(y), agt.SqExponentialKernel(), agt.GaussianLikelihood.create(sigma2),
                        agt.HMCSampling(n_burnin=burnin, step_size=0.1, algorithm=algorithm))
    s = agt.sample(m, n, generator=torch.Generator().manual_seed(7), n_chains=chains)
    s = s.reshape(-1, 1, 30)[:, 0].numpy()
    assert np.all(np.isfinite(s))
    assert np.corrcoef(s.mean(0), mean)[0, 1] > 0.999
    ratio = np.median(s.var(0) / var)
    assert 0.75 < ratio < 1.33, ratio


def test_nuts_reads_the_host_once_per_doubling():
    """One NUTS step of 3 chains reads "every chain done" at most
    max_depth times, and a chain's proposal is one of its leaves (finite,
    its log joint consistent)."""
    mj, mt, _, _ = case("logistic")
    vg, _ = port_vg(mt)
    v = torch.zeros(3, 1, 30, dtype=torch.float64)
    lp, g = vg(v)
    reads = host_read.reads
    v1, lp1, g1, acc = hmc.nuts_step(torch.Generator().manual_seed(0), vg, v, lp, g, 0.2, max_depth=5)
    assert 1 <= host_read.reads - reads <= 5
    lp_check, g_check = vg(v1)
    close(lp1, lp_check, rtol=1e-12)
    close(g1, g_check, rtol=1e-12, atol=1e-14)
    assert acc.shape == (3,) and bool(((acc >= 0) & (acc <= 1)).all())
