"""Builds the same SVGP model in the JAX package and in the PyTorch port,
and carries the JAX model's parameters and state over, so that a test can
run both from identical states (the port's tests)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu.utils.opt import robbins_monro as jax_robbins_monro
from agp_tpu_torch.interop import model_from_numpy, state_from_numpy
from agp_tpu_torch.utils.opt import GradientTransformation


def logistic_data(N, D, seed=0):
    """X [N, D] standard normal and +-1 labels of a random linear rule."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    w = rng.normal(size=D)
    return X, np.where(X @ w > 0, 1.0, -1.0)


def multiclass_data(N, D, K, seed=0):
    """X [N, D] standard normal and labels 0..K-1, the argmax of X W with
    W [D, K] standard normal (the multiclass bench configuration's rule)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    return X, np.argmax(X @ rng.normal(size=(D, K)), axis=1)


def het_data(N, D, seed=0):
    """X [N, D] standard normal and y = sin(x_0) + 0.1 eps (the
    heteroscedastic bench configuration's rule)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    return X, np.sin(X[:, 0]) + 0.1 * rng.normal(size=N)


def jax_svgp(X, y, M, B, sampling="block", lengthscale=2.0, likelihood=None):
    """An SVGP in the JAX package (float64; the logistic likelihood unless
    ``likelihood`` is given): (model, state, X, y) with the labels
    treated."""
    Xj = jnp.asarray(X)
    model = agp.SVGP.create(
        agp.SqExponentialKernel(lengthscale=jnp.asarray(lengthscale), variance=jnp.asarray(1.0)),
        agp.LogisticLikelihood.create() if likelihood is None else likelihood,
        agp.AnalyticSVI(B, minibatch_sampling=sampling),
        Xj[:M],
        optimiser=None,
    )
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    yj = jnp.asarray(y2, Xj.dtype)
    return model, jax_init_state(model, Xj, yj), Xj, yj


def state_arrays(s):
    """The JAX TrainState's leaves the port's state holds, as numpy."""
    leaves = dict(
        eta1=s.eta1, eta2=s.eta2, mu=s.mu, Sigma=s.Sigma,
        local_vars=dict(s.local_vars), opt_state=s.opt_state, rho=s.rho,
        step=s.step, kmat=dict(s.kmat),
    )
    return jax.tree_util.tree_map(lambda a: np.array(a), leaves)


def port_likelihood(lik_j):
    """The port's counterpart of a JAX likelihood, with its parameters as
    ``model_from_numpy`` takes them."""
    name = type(lik_j).__name__
    if name == "LogisticSoftMaxLikelihood":
        return agt.LogisticSoftMaxLikelihood.create(lik_j.n_class), dict(
            n_class=lik_j.n_class, class_mapping=lik_j.class_mapping
        )
    if name == "HeteroscedasticLikelihood":
        return agt.HeteroscedasticLikelihood.create(), dict(lam=np.array(lik_j.lam))
    return agt.LogisticLikelihood.create(), {}


def port_from_jax(mj, sj, Xj, yj, dtype=torch.float64, device="cpu", optimiser=None):
    """The port's (model, state, X, y) carrying the JAX model's parameters
    and state; ``optimiser`` replaces the port's Robbins-Monro rule."""
    B = mj.inference.batchsize
    inference = agt.AnalyticSVI(B, optimiser=optimiser, minibatch_sampling=mj.inference.minibatch_sampling)
    X = torch.as_tensor(np.array(Xj), dtype=dtype, device=device)
    M = mj.Z.shape[1]
    lik, lik_params = port_likelihood(mj.likelihood)
    mt = agt.SVGP.create(agt.SqExponentialKernel(), lik, inference, X[:M], optimiser=None)
    mt = model_from_numpy(
        dict(Z=np.array(mj.Z), lengthscale=np.array(mj.kernel.lengthscale),
             variance=np.array(mj.kernel.variance), **lik_params),
        mt,
    )
    st = state_from_numpy(state_arrays(sj), device, dtype)
    y = torch.as_tensor(np.array(yj), dtype=dtype, device=device)
    return mt, st, X, y


def jax_rm_scales(n):
    """The JAX package's float32 Robbins-Monro scales of steps 0..n-1."""
    opt = jax_robbins_monro()
    step = jax.jit(lambda s: opt.update((-jnp.ones((), jnp.float64),), s)[0][0])
    return np.array([float(step(jnp.asarray(i, jnp.int32))) for i in range(n)])


def replay_rule(scales):
    """A port step-size rule that replays the given per-step scales.

    XLA's float32 pow and PyTorch's differ by 1-2 ulp at most steps, which
    moves float64 trajectories apart at about 1e-8; replaying the reference's
    own scales isolates the CAVI step from that rounding."""
    table = torch.as_tensor(np.asarray(scales))

    def init(params):
        return torch.zeros((), dtype=torch.int32, device=params[0].device)

    def update(updates, state):
        scale = table.to(updates[0].device)[state.long()]
        return tuple(-u * scale for u in updates), state + 1

    return GradientTransformation(init, update)
