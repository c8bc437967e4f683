"""The port's streaming OnlineSVGP (agp_tpu_torch/models/online_svgp.py,
Slice I) against the JAX package, float64 on the CPU, at the reference
tests' sizes (tests/test_engines.py: 30 points in 2-D, batches of 10,
capacity 16-32, 5 iterations a batch).

Tolerances, each set from float64 and the depth of the chain it covers:
* one-batch pieces from one mid-stream state carried across
  (``masked_kmat``, ``masked_kappa``, ``masked_kappa_a``,
  ``save_old_parameters``, one ``online_variational_update``,
  ``online_extra_kl``): rtol 1e-10;
* ``online_elbo`` and its gradient in the kernel's log parameters (against
  ``jax.grad`` of the reference's ``neg_elbo``): rtol 1e-8;
* 3-batch streams from the same data (OIPS, UniGridOnline, Webscale,
  StreamKmeans; Gaussian and logistic; fixed hyperparameters, and the
  default Adam after every batch): rtol 1e-7 on eta1, eta2, mu and Sigma,
  z_mask identical, Z's slots identical (OIPS, UniGrid) or within rtol
  1e-12 (the k-means families); the predictions at rtol 1e-8.
The rest are the port's own invariants: the stream driver bit-equal to
the per-batch one, capacity saturation, Webscale reaching k after a small
first batch, ``train`` refusing an online model, inactive slots leaving
the predictive mean unchanged."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.inference.objective import objective as jax_objective
from agp_tpu.kernels import to_unconstrained as jax_to_unconstrained
from agp_tpu.models import online_svgp as jo
from agp_tpu.training.autotuning import _kmat as jax_kmat
from agp_tpu.training.autotuning import _rebuild as jax_rebuild
from agp_tpu_torch.config import jitter
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu_torch.models import online_svgp as to
from agp_tpu_torch.training import autotuning
from torch_helpers import adam_state_arrays, close, port_likelihood, reg_data, state_arrays

B, N_BATCHES, ITERS = 10, 3, 5
F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def data():
    X, f, y = reg_data()
    return X, f, y, np.sign(f)


# (JAX algorithm, the port's) of tests/test_engines.py:231-785, each with
# 32 slots (one shape for the reference's compiles)
ALGS = {
    "oips": (None, None),
    "unigrid": (agp.inducing.UniGridOnline(3), agt.inducing.UniGridOnline(3)),
    "webscale": (agp.inducing.Webscale(8), agt.inducing.Webscale(8)),
    "streamkmeans": (agp.inducing.StreamKmeans(capacity=24, radius2=0.25),
                     agt.inducing.StreamKmeans(capacity=24, radius2=0.25)),
}
CAP = 32


def likelihoods(name):
    if name == "gaussian":
        return agp.GaussianLikelihood.create(0.05, opt_noise=False), agt.GaussianLikelihood.create(0.05)
    return agp.LogisticLikelihood.create(), agt.LogisticLikelihood.create()


def models(alg="oips", lik="gaussian", default_adam=False, mean=None, ls=1.0):
    """The same OnlineSVGP in both packages (float64, the port's on the
    CPU): fixed hyperparameters unless ``default_adam``."""
    alg_j, alg_t = ALGS[alg]
    lik_j, lik_t = likelihoods(lik)
    kw = {} if default_adam else dict(optimiser=None)
    mj = agp.OnlineSVGP.create(agp.SqExponentialKernel(lengthscale=jnp.asarray(ls)), lik_j, agp.AnalyticVI(), Zalg=alg_j, n_dim=2, capacity=CAP,
                               mean=None if mean is None else agp.ConstantMean(c=jnp.asarray(mean)), **kw)
    mt = agt.OnlineSVGP.create(agt.SqExponentialKernel(lengthscale=ls), lik_t, agt.AnalyticVI(), Zalg=alg_t, n_dim=2, capacity=CAP,
                               mean=None if mean is None else agt.ConstantMean(c=mean), **kw, **F64)
    return mj, mt


def batch(X, y, i):
    return X[i * B:(i + 1) * B], y[i * B:(i + 1) * B]


def check_states(mt, st, mj, sj, rtol, exact_Z=True, msg=""):
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), rtol=rtol, atol=1e-12, msg=f"{msg} {name}")
    np.testing.assert_array_equal(mt.z_mask.numpy(), np.asarray(mj.z_mask), err_msg=msg)
    if exact_Z:
        np.testing.assert_array_equal(mt.Z.numpy(), np.asarray(mj.Z), err_msg=msg)
    else:
        close(mt.Z, mj.Z, rtol=1e-12, atol=1e-15, msg=f"{msg} Z")
    close(mt.z_counts, mj.z_counts, rtol=0, atol=0, msg=f"{msg} counts")


def port_from_reference(mj, sj, mt):
    """The port's (model, state) carrying the JAX package's mid-stream model
    and state (interop.model_from_numpy / state_from_numpy)."""
    _, lik_params = port_likelihood(mj.likelihood)
    params = dict(Z=np.array(mj.Z), z_mask=np.array(mj.z_mask), Za=np.array(mj.Za), za_mask=np.array(mj.za_mask),
                  z_counts=np.array(mj.z_counts), lengthscale=np.array(mj.kernel.lengthscale),
                  variance=np.array(mj.kernel.variance), capacity=mj.capacity, rho_accept=mj.rho_accept,
                  Zalg=(type(mj.Zalg).__name__, dataclasses.asdict(mj.Zalg)), **lik_params)
    if type(mj.mean).__name__ == "ConstantMean":
        params["mean_c"] = np.array(mj.mean.c)
    arrays = state_arrays(sj)
    arrays["previous"] = {k: np.array(v) for k, v in sj.previous.items()}
    return model_from_numpy(params, mt), state_from_numpy(arrays, "cpu", torch.float64)


def jax_stream(mj, X, y, n):
    sj = None
    for i in range(n):
        mj, sj = agp.online_train(mj, *map(jnp.asarray, batch(X, y, i)), state=sj, iterations=ITERS)
    return mj, sj


@pytest.fixture(scope="module")
def mid_stream(data):
    """Both packages at one state after two batches of the reference's
    stream (ConstantMean 0.3, so the masked prior mean counts; lengthscale
    0.3, so the second batch adds slots), the port's carried across; and
    the third batch."""
    X, f, y, _ = data
    mj, mt = models(mean=0.3, ls=0.3)
    mj, sj = jax_stream(mj, X, y, 2)
    mt, st = port_from_reference(mj, sj, mt)
    return mj, sj, mt, st, batch(X, y, 2), batch(X, y, 1)


def test_carried_state_is_the_reference(mid_stream):
    mj, sj, mt, st, _, _ = mid_stream
    assert 0 < int(mt.z_mask.sum()) < mt.capacity and not torch.equal(mt.Z, mt.Za)
    check_states(mt, st, mj, sj, rtol=0)
    assert repr(mt) == repr(mj)


def test_masked_kernel_matrices(mid_stream):
    """masked_kmat, masked_kappa (Knm, kappa, Ktilde at the next batch) and
    masked_kappa_a against the reference's, rtol 1e-10."""
    mj, sj, mt, st, (xb, _), _ = mid_stream
    kj, kt = jo.masked_kmat(mj), to.masked_kmat(mt)
    assert set(kt) == {"L_K", "K_inv"}
    for k in kt:
        close(kt[k], kj[k], rtol=1e-10, msg=k)
    for a, b in zip(to.masked_kappa(mt, torch.as_tensor(xb), kt), jo.masked_kappa(mj, jnp.asarray(xb), kj)):
        close(a, b, rtol=1e-10)
    for a, b in zip(to.masked_kappa_a(mt, kt), jo.masked_kappa_a(mj, kj)):
        close(a, b, rtol=1e-10)
    close(to.masked_mu0(mt), jo.masked_mu0(mj), rtol=1e-10)


def test_save_old_parameters(mid_stream):
    mj, sj, mt, st, _, _ = mid_stream
    mj2, sj2 = jo.save_old_parameters(mj, sj)
    mt2, st2 = to.save_old_parameters(mt, st)
    for k in ("invDa", "prev_eta1", "prev_L_a"):
        close(st2.previous[k], sj2.previous[k], rtol=1e-10, msg=k)
    assert torch.equal(mt2.Za, mt.Z) and torch.equal(mt2.za_mask, mt.z_mask)


def test_one_variational_update_and_extra_kl(mid_stream):
    """One streaming CAVI iteration on the batch whose local variables the
    state holds, then the extra KL, rtol 1e-10."""
    mj, sj, mt, st, _, (xb, yb) = mid_stream
    mj2, sj2 = jo.online_variational_update(mj, sj, jnp.asarray(xb), jnp.asarray(yb))
    mt2, st2 = to.online_variational_update(mt, st, torch.as_tensor(xb), torch.as_tensor(yb))
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st2, name), getattr(sj2, name), rtol=1e-10, msg=name)
    for k, v in st2.local_vars.items():
        close(v, sj2.local_vars[k], rtol=1e-10, msg=k)
    close(to.online_extra_kl(mt2, st2), jo.online_extra_kl(mj2, sj2), rtol=1e-10)


def test_online_elbo_and_its_gradient(mid_stream):
    """online_elbo, and the gradient of -ELBO (extra KL included, the masked
    kmat made from the candidate kernel) in the kernel's log parameters
    and the constant mean, against jax.grad of the reference's, rtol 1e-8."""
    mj, sj, mt, st, _, (xb, yb) = mid_stream
    xj, yj, xt, yt = jnp.asarray(xb), jnp.asarray(yb), torch.as_tensor(xb), torch.as_tensor(yb)
    close(agt.online_elbo(mt, st, xt, yt), agp.online_elbo(mj, sj, xj, yj), rtol=1e-8)

    def neg_elbo(log_k, mean):
        m2 = jax_rebuild(mj, log_k, mean, None)
        return -jax_objective(m2, sj, xj, yj, kmat=jax_kmat(m2, xj))

    g_kj, g_mj = jax.grad(neg_elbo, argnums=(0, 1))(jax_to_unconstrained(mj.kernel), mj.mean)
    _, g_kt, g_mt, g_z = autotuning.hyper_gradients(mt, st, xt, yt)
    assert g_z is None
    close(g_kt["lengthscale"], g_kj.lengthscale, rtol=1e-8)
    close(g_kt["variance"], g_kj.variance, rtol=1e-8)
    close(g_mt["c"], g_mj.c, rtol=1e-8)


@pytest.mark.parametrize("lik", ["gaussian", "logistic"])
@pytest.mark.parametrize("alg", list(ALGS))
def test_stream_matches_reference(data, alg, lik):
    """Three batches of online_train in both packages, held together after
    every batch; then predict_f (mean and variance), predict_y, proba_y
    and online_elbo at rtol 1e-8."""
    X, f, y, ys = data
    labels = y if lik == "gaussian" else ys
    mj, mt = models(alg, lik)
    sj = st = None
    for i in range(N_BATCHES):
        xb, yb = batch(X, labels, i)
        mj, sj = agp.online_train(mj, jnp.asarray(xb), yb, state=sj, iterations=ITERS)
        mt, st = agt.online_train(mt, torch.as_tensor(xb), torch.as_tensor(yb), state=st, iterations=ITERS)
        check_states(mt, st, mj, sj, rtol=1e-7, exact_Z=alg in ("oips", "unigrid"), msg=f"batch {i}")
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    for a, b in zip(agt.predict_f(mt, st, Xt, cov=True), agp.predict_f(mj, sj, Xj, cov=True)):
        close(a, b, rtol=1e-8)
    close(agt.predict_y(mt, st, Xt), agp.predict_y(mj, sj, Xj), rtol=1e-8)
    close(agt.proba_y(mt, st, Xt)[0] if lik == "gaussian" else agt.proba_y(mt, st, Xt),
          agp.proba_y(mj, sj, Xj)[0] if lik == "gaussian" else agp.proba_y(mj, sj, Xj), rtol=1e-8)
    xb, yb = batch(X, labels, N_BATCHES - 1)
    close(agt.online_elbo(mt, st, torch.as_tensor(xb), torch.as_tensor(yb)),
          agp.online_elbo(mj, sj, jnp.asarray(xb), jnp.asarray(yb)), rtol=1e-8)


def test_default_adam_stream_matches_reference(data):
    """OnlineSVGP.create's default Adam(0.01) (hyperparameter steps after
    iterations 3 and 4 of each batch, through the masked kmat and the extra
    KL): the kernel, the optimiser's state and the posterior after every
    batch at rtol 1e-7."""
    X, f, y, _ = data
    mj, mt = models(default_adam=True)
    assert isinstance(mt.optimiser, agt.utils.opt.GradientTransformation)
    sj = st = None
    for i in range(N_BATCHES):
        xb, yb = batch(X, y, i)
        mj, sj = agp.online_train(mj, jnp.asarray(xb), yb, state=sj, iterations=ITERS)
        mt, st = agt.online_train(mt, torch.as_tensor(xb), torch.as_tensor(yb), state=st, iterations=ITERS)
        check_states(mt, st, mj, sj, rtol=1e-7, msg=f"batch {i}")
        close(mt.kernel.lengthscale, mj.kernel.lengthscale, rtol=1e-7)
        close(mt.kernel.variance, mj.kernel.variance, rtol=1e-7)
        ref = adam_state_arrays(sj.hyper_state)["kernel"]
        assert int(st.hyper_state["kernel"]["count"]) == int(ref["count"])
        for k in ("mu", "nu"):
            close(st.hyper_state["kernel"][k]["lengthscale"], ref[k]["lengthscale"], rtol=1e-7)
        for k in ("L_K", "K_inv"):
            close(st.kmat[k], sj.kmat[k], rtol=1e-7)
    assert abs(float(mt.kernel.lengthscale[0]) - 1.0) > 1e-2


# ----------------------------------------------------------- the port alone
def port_model(**kw):
    kw = {"optimiser": None, "n_dim": 2, "capacity": 32, **kw}
    return agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                                 **kw, **F64)


@pytest.mark.parametrize("lik", ["gaussian", "multiclass"])
def test_stream_driver_is_bit_equal_to_per_batch(data, lik):
    """online_train_stream over the buffered batches equals online_train
    batch by batch bit for bit (a multiclass stream's labels one-hot once
    for the stream, back in [n_batches, B, K]); it refuses an optimiser."""
    X, f, y, _ = data
    labels = y if lik == "gaussian" else np.digitize(f, np.quantile(f, [1 / 3, 2 / 3]))
    likelihood = agt.GaussianLikelihood.create(0.05) if lik == "gaussian" else agt.LogisticSoftMaxLikelihood.create(3)

    def make():
        return agt.OnlineSVGP.create(agt.SqExponentialKernel(), likelihood, agt.AnalyticVI(), n_dim=2, capacity=32,
                                     optimiser=None, **F64)

    m1, s1 = make(), None
    for i in range(N_BATCHES):
        m1, s1 = agt.online_train(m1, *batch(X, labels, i), state=s1, iterations=ITERS)
    n = N_BATCHES * B
    m2, s2 = agt.online_train_stream(make(), X[:n].reshape(N_BATCHES, B, 2), labels[:n].reshape(N_BATCHES, B),
                                     iterations=ITERS)
    for name in ("eta1", "eta2", "mu", "Sigma"):
        assert torch.equal(getattr(s1, name), getattr(s2, name)), name
    assert torch.equal(m1.z_mask, m2.z_mask) and torch.equal(m1.Z, m2.Z)
    with pytest.raises(ValueError, match="optimiser=None"):
        agt.online_train_stream(port_model(optimiser="default"), X[:n].reshape(N_BATCHES, B, 2),
                                y[:n].reshape(N_BATCHES, B))


def test_capacity_saturation():
    """tests/test_robustness.py:153-171 on the port: more distinct inputs
    than slots fill the buffer to its capacity and no further, and the
    posterior and the predictions stay finite."""
    m = agt.OnlineSVGP.create(agt.SqExponentialKernel(lengthscale=0.5), agt.GaussianLikelihood.create(0.1),
                              agt.AnalyticVI(), n_dim=1, capacity=16, optimiser=None, **F64)
    s = None
    for i in range(10):
        Xb = torch.linspace(i, i + 1, 25, dtype=torch.float64)[:, None]
        m, s = agt.online_train(m, Xb, torch.sin(2 * Xb[:, 0]), state=s, iterations=5)
    assert int(m.z_mask[0].sum()) == 16
    assert torch.isfinite(s.mu).all() and torch.isfinite(s.Sigma).all()
    mu, var = agt.predict_f(m, s, torch.linspace(9.0, 10.0, 20, dtype=torch.float64)[:, None], cov=True)
    assert torch.isfinite(mu).all() and torch.isfinite(var).all()


def test_webscale_small_first_batch_reaches_k(data):
    """tests/test_engines.py:787-809 on the port: a first batch of 5 < k=12
    opens 5 centres, the next batch opens the rest, then k stays."""
    X, f, y, _ = data
    m = port_model(Zalg=agt.inducing.Webscale(12), capacity=16)
    m, s = agt.online_train(m, X[:5], y[:5], iterations=3)
    assert int(m.z_mask[0].sum()) == 5
    m, s = agt.online_train(m, X[5:15], y[5:15], state=s, iterations=3)
    assert int(m.z_mask[0].sum()) == 12
    m, s = agt.online_train(m, X[15:30], y[15:30], state=s, iterations=3)
    assert int(m.z_mask[0].sum()) == 12
    assert float(torch.mean(torch.abs(agt.predict_f(m, s, X) - torch.as_tensor(f)))) < 1.0


def test_train_refuses_an_online_model(data):
    X, f, y, _ = data
    with pytest.raises(TypeError, match="online_train"):
        agt.train(port_model(), X, y)


def test_predictions_and_inactive_slots(data):
    """An inactive slot carries mu = 0, Sigma = I and no coupling to the
    active ones, so the predictive mean ignores it bit for bit wherever its
    Z row lies.  Its block of A = K^-1 (I - Sigma K^-1) is c (1 - c) I with
    c = 1 / (1 + jitter), not zero (the jitter ladder adds to every
    diagonal entry, as the reference's does), so an inactive slot moves
    the variance by at most jitter * k(x, z)^2."""
    X, f, y, _ = data
    m, s = agt.online_train(port_model(), X[:10], y[:10], iterations=5)
    act = m.z_mask[0]
    assert 0 < int(act.sum()) < m.capacity
    assert torch.equal(s.mu[0][~act], torch.zeros(int((~act).sum()), dtype=torch.float64))
    assert torch.equal(s.Sigma[0][act][:, ~act], torch.zeros(int(act.sum()), int((~act).sum()), dtype=torch.float64))
    close(s.Sigma[0][~act][:, ~act], np.eye(int((~act).sum())), rtol=0, atol=1e-14)
    Xt = torch.as_tensor(X)
    mu, var = agt.predict_f(m, s, Xt, cov=True)
    moved = m.replace(Z=torch.where(act[None, :, None], m.Z, torch.full_like(m.Z, 0.5)))
    mu2, var2 = agt.predict_f(moved, s, Xt, cov=True)
    assert torch.equal(mu, mu2)
    bound = jitter(torch.float64) * float(m.kernel.variance[0]) ** 2 * int((~act).sum())
    assert float((var - var2).abs().max()) <= bound


def test_device_and_dtype_follow_the_choice():
    """create puts the buffers on config.default_device() (the CUDA card
    unless the CPU was chosen) in torch's default dtype unless told."""
    prev = agt.config.set_default_device("cpu")
    try:
        m = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                                  n_dim=3, capacity=8, optimiser=None)
    finally:
        agt.config.set_default_device(prev)
    assert m.Z.device.type == "cpu" and m.Z.dtype == torch.get_default_dtype() and m.Z.shape == (1, 8, 3)
    assert m.z_mask.dtype == torch.bool and m.kernel.lengthscale.dtype == m.Z.dtype
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="set_default_device"):
            agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI())
