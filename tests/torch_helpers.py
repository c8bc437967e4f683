"""Builds the same SVGP model in the JAX package and in the PyTorch port,
and carries the JAX model's parameters and state over, so that a test can
run both from identical states (the port's tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.config import jitter as jax_jitter
from agp_tpu.kernels import batch_gram as jax_batch_gram
from agp_tpu.ops import linalg as jlinalg
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu.utils.opt import robbins_monro as jax_robbins_monro
from agp_tpu_torch.interop import LIKELIHOOD_PARAMS, model_from_numpy, state_from_numpy
from agp_tpu_torch.utils.opt import GradientTransformation
from chip_smoke import single_latent_labels, single_latent_lik
from tests.testingtools import generate_f


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


def jax_svgp(X, y, M, B, sampling="block", lengthscale=2.0, likelihood=None, kernel=None, **create):
    """An SVGP in the JAX package (float64; the logistic likelihood unless
    ``likelihood`` is given, the squared-exponential kernel unless
    ``kernel``, a JAX kernel class, is; fixed hyperparameters unless
    ``create`` names an optimiser, a Zoptimiser or a mean): (model, state,
    X, y) with the labels treated."""
    Xj = jnp.asarray(X)
    kernel = agp.SqExponentialKernel if kernel is None else kernel
    model = agp.SVGP.create(
        kernel(lengthscale=jnp.asarray(lengthscale), variance=jnp.asarray(1.0)),
        agp.LogisticLikelihood.create() if likelihood is None else likelihood,
        agp.AnalyticSVI(B, minibatch_sampling=sampling),
        Xj[:M],
        **{"optimiser": None, **create},
    )
    y2, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    yj = jnp.asarray(y2, Xj.dtype)
    return model, jax_init_state(model, Xj, yj), Xj, yj


def optax_adam_arrays(s):
    """optax's Adam state (ScaleByAdamState, EmptyState) as the port keeps
    it: {"count", "mu", "nu"}, the moments as numpy (an array, or a dict of
    a group's leaves by field name)."""

    def tree(t):
        if isinstance(t, jax.Array):
            return np.array(t)
        return {f.name: np.array(getattr(t, f.name)) for f in dataclasses.fields(t)
                if isinstance(getattr(t, f.name), jax.Array)}

    return {"count": np.array(s[0].count), "mu": tree(s[0].mu), "nu": tree(s[0].nu)}


def adam_state_arrays(hyper_state):
    """The JAX package's hyperparameter state (optax's Adam state per group)
    as ``interop.state_from_numpy`` takes it: {"count", "mu", "nu"} per
    group, each moment a dict of leaves by field name (an array for Z)."""

    return {group: optax_adam_arrays(s) for group, s in hyper_state.items()}


def state_arrays(s):
    """The JAX TrainState's leaves the port's state holds, as numpy (the
    Gaussian noise rule's local state as ``optax_adam_arrays``; a GP's
    alpha and chol_Sigma, and no eta, moments or kmat; a VStP's
    prior_state)."""
    leaves = dict(
        eta1=s.eta1, eta2=s.eta2, mu=s.mu, Sigma=s.Sigma,
        opt_state=s.opt_state, rho=s.rho, step=s.step, alpha=s.alpha, chol_Sigma=s.chol_Sigma,
        kmat=None if s.kmat is None else dict(s.kmat),
    )
    out = jax.tree_util.tree_map(lambda a: np.array(a), leaves)
    out["local_vars"] = {k: optax_adam_arrays(v) if k == "state_sigma2" else np.array(v)
                         for k, v in s.local_vars.items()}
    if s.hyper_state is not None:
        out["hyper_state"] = adam_state_arrays(s.hyper_state)
    if s.prior_state is not None:
        out["prior_state"] = {k: np.array(v) for k, v in s.prior_state.items()}
    return out


def port_likelihood(lik_j):
    """The port's counterpart of a JAX likelihood, with its parameters as
    ``model_from_numpy`` takes them."""
    name = type(lik_j).__name__
    if name == "GaussianLikelihood" and lik_j.opt_noise is not None:
        # the reference's create(opt_noise=True) rule, adam(0.05)
        return agt.GaussianLikelihood.create(opt_noise=True), {"sigma2": np.array(lik_j.sigma2)}
    if name in ("LogisticSoftMaxLikelihood", "SoftMaxLikelihood"):
        return getattr(agt, name).create(lik_j.n_class), dict(
            n_class=lik_j.n_class, class_mapping=lik_j.class_mapping
        )
    params = {k: np.array(getattr(lik_j, k)) for k in LIKELIHOOD_PARAMS if k in type(lik_j).__dataclass_fields__}
    return getattr(agt, name)(), params


def port_lik_same_params(lik_j, dtype=torch.float64):
    """The port's likelihood of the same type and parameters as ``lik_j``."""
    lik, params = port_likelihood(lik_j)
    if "n_class" in params:
        return lik
    return lik.replace(**{k: torch.as_tensor(v, dtype=dtype) for k, v in params.items()})


def port_from_jax(mj, sj, Xj, yj, dtype=torch.float64, device="cpu", optimiser=None, likelihood=None):
    """The port's (model, state, X, y) carrying the JAX model's parameters
    and state; ``optimiser`` replaces the port's Robbins-Monro rule;
    ``likelihood`` (a generic likelihood built from the same septuple,
    whose callables do not cross) replaces the port's copy of the JAX
    model's."""
    B = mj.inference.batchsize
    inference = agt.AnalyticSVI(B, optimiser=optimiser, minibatch_sampling=mj.inference.minibatch_sampling)
    X = torch.as_tensor(np.array(Xj), dtype=dtype, device=device)
    M = mj.Z.shape[1]
    lik, lik_params = port_likelihood(mj.likelihood) if likelihood is None else (likelihood, {})
    kernel = port_kernel(jax.tree_util.tree_map(lambda a: a[0], mj.kernel))
    mt = agt.SVGP.create(kernel, lik, inference, X[:M], optimiser=None)
    mt = model_from_numpy(dict(Z=np.array(mj.Z), kernel=jax_kernel_leaves(mj.kernel), **mean_params(mj.mean),
                               **lik_params), mt)
    st = state_from_numpy(state_arrays(sj), device, dtype)
    y = torch.as_tensor(np.array(yj), dtype=dtype, device=device)
    return mt, st, X, y


def port_kernel(kj, fn=None):
    """The port's kernel (or transform) of the same structure, static
    fields and values as the JAX kernel ``kj``; ``fn`` stands in for a
    FunctionTransform's callable."""
    from agp_tpu import kernels as jk

    if isinstance(kj, (jk.Kernel, jk.Transform)):
        cls = getattr(agt.kernels, type(kj).__name__)
        return cls(**{f.name: port_kernel(getattr(kj, f.name), fn) for f in dataclasses.fields(kj)})
    if isinstance(kj, tuple):
        return tuple(port_kernel(v, fn) for v in kj)
    if isinstance(kj, jax.Array):
        return torch.as_tensor(np.array(kj))
    return fn if callable(kj) else kj


def port_path(path):
    """A JAX leaf path (``jax.tree_util.keystr``: ".transform.transforms[1].v")
    as ``utils.tensors.path_leaves`` names it ("transform.transforms.1.v")."""
    import re

    return re.sub(r"\[(\d+)\]", r".\1", jax.tree_util.keystr(path))[1:]


def jax_kernel_leaves(kj):
    """{port path: numpy array} of a JAX kernel, as
    ``interop.model_from_numpy`` takes it under "kernel"."""
    return {port_path(p): np.array(v) for p, v in jax.tree_util.tree_flatten_with_path(kj)[0]}


def mean_params(mean_j):
    """A JAX prior mean's leaves as ``model_from_numpy`` takes them
    ("mean_c", "mean_v", "mean_w" and "mean_b"), none for a zero mean."""
    return {f"mean_{f.name}": np.array(getattr(mean_j, f.name)) for f in dataclasses.fields(mean_j)}


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


# ------------------------------------------- the single-latent likelihoods
def jax_single_latent(name):
    """The JAX likelihood of ``fused_cavi_stats``'s branch ``name``: the
    type and parameters of ``chip_smoke.single_latent_lik``, made by the
    JAX class's ``create``, whose positional parameters come in the order
    of ``LIKELIHOOD_PARAMS`` (the Gaussian's noise fixed)."""
    lt = single_latent_lik(agt, name)
    return getattr(agp, type(lt).__name__).create(*(float(getattr(lt, k)) for k in LIKELIHOOD_PARAMS if hasattr(lt, k)))


def single_latent_data(name, N, D, seed=0):
    """X [N, D] standard normal, f = sin(x_0) + 0.5 x_1 and its labels."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D))
    f = np.sin(X[:, 0]) + 0.5 * X[:, 1]
    return X, f, single_latent_labels(name, f, rng)


def close(port, ref, rtol=1e-8, atol=1e-12, msg=""):
    port = port.detach().cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    np.testing.assert_allclose(port, np.asarray(ref), rtol=rtol, atol=atol, err_msg=msg)


def close_tree(port, ref, **kw):
    """``close`` over a tensor or a tuple of them (compute_proba's output)."""
    if isinstance(ref, tuple):
        assert isinstance(port, tuple) and len(port) == len(ref)
        for p, r in zip(port, ref):
            close(p, r, **kw)
    else:
        close(port, ref, **kw)


def lik_params_close(lt, lj, **kw):
    for k in LIKELIHOOD_PARAMS:
        if k in type(lj).__dataclass_fields__:
            close(getattr(lt, k), getattr(lj, k), msg=k, **kw)


def check_likelihood_methods(name, w=None, b=64, seed=0):
    """The port's likelihood ``name`` against the JAX package's on the same
    float64 inputs, rtol 1e-10 (sums also atol 1e-10): treat_labels,
    local_updates (with the row mask ``w``), the parameters it updates,
    grad_e_mu, grad_e_sigma, expec_loglik, aug_kl, compute_proba,
    predict_y and log_prob."""
    rng = np.random.default_rng(seed)
    f = rng.normal(size=b)
    y = single_latent_labels(name, f, rng)
    mu = (f + 0.3 * rng.normal(size=b))[None]
    var = rng.uniform(0.05, 0.5, size=(1, b))
    lj = jax_single_latent(name)
    yj, lj = lj.treat_labels(y)
    yj = jnp.asarray(yj, jnp.float64)
    lt = port_lik_same_params(lj)
    yt, lt = lt.treat_labels(y)
    close(yt, yj, rtol=0, msg="treat_labels")
    yt = yt.double()
    kw = dict(rtol=1e-10, atol=1e-10)
    mj, vj, mt, vt = jnp.asarray(mu), jnp.asarray(var), torch.as_tensor(mu), torch.as_tensor(var)
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.as_tensor(w)
    lj2, loc_j = lj.local_updates(yj, mj, vj, lj.init_local_vars(b, jnp.float64), w=wj)
    lt2, loc_t = lt.local_updates(yt, mt, vt, lt.init_local_vars(b, torch.float64), w=wt)
    assert set(loc_t) == set(loc_j), (set(loc_t), set(loc_j))
    for k in loc_j:
        close(loc_t[k], loc_j[k], msg=k, **kw)
    lik_params_close(lt2, lj2, **kw)
    close(lt2.grad_e_mu(yt, loc_t), lj2.grad_e_mu(yj, loc_j), msg="grad_e_mu", **kw)
    close(lt2.grad_e_sigma(yt, loc_t), lj2.grad_e_sigma(yj, loc_j), msg="grad_e_sigma", **kw)
    close(lt2.expec_loglik(yt, mt, vt, loc_t), lj2.expec_loglik(yj, mj, vj, loc_j), msg="expec_loglik", **kw)
    close(lt2.aug_kl(loc_t, yt), lj2.aug_kl(loc_j, yj), msg="aug_kl", **kw)
    close_tree(lt2.compute_proba(mt[0], vt[0]), lj2.compute_proba(mj[0], vj[0]), **kw)
    close(lt2.predict_y(mt[0]), lj2.predict_y(mj[0]), msg="predict_y", **kw)
    close(lt2.log_prob(yt, mt[0]), lj2.log_prob(yj, mj[0]), msg="log_prob", **kw)
    return lt2, lj2


def slice_runs(name, N, D, M, B, steps, kernel=None, seed=0):
    """``steps`` slice-sampled CAVI steps of both packages from identical
    states on the JAX package's own draws (``replay_steps``) for the
    single-latent likelihood ``name`` on ``single_latent_data``."""
    X, _, y = single_latent_data(name, N, D, seed)
    return replay_steps(*jax_svgp(X, y, M, B, sampling="slice", likelihood=jax_single_latent(name), kernel=kernel),
                        steps)


def replay_steps(mj, sj, Xj, yj, steps, likelihood=None):
    """``steps`` CAVI steps of the JAX model (mj, sj) and of the port's copy
    of it (with ``likelihood``, as ``port_from_jax`` takes it), on the JAX
    package's own draws, with its Robbins-Monro scales replayed: the
    states after each step and the final models."""
    from agp_tpu.training.train import _precomputed_draws, _vi_steps
    from agp_tpu_torch.training.train import vi_steps

    B = mj.inference.batchsize
    _, idx = _precomputed_draws(mj, sj, Xj, steps)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(steps)),
                                   likelihood=likelihood)
    draws = torch.as_tensor(np.array(idx), dtype=torch.int64)
    per_step = []
    for i in range(steps):
        mj, sj = _vi_steps(mj, sj, Xj, yj, 1)
        mt, st = vi_steps(mt, st, Xt, yt, 1, draws=draws[i : i + 1])
        per_step.append((mj, sj, mt, st))
    return dict(per_step=per_step, jax=(mj, sj, Xj, yj, idx), port=(mt, st, Xt, yt), B=B)


def check_steps(runs, rtol=1e-8):
    """eta, mu, Sigma, every local variable and the likelihood's parameters
    after each step, at rtol (atol 1e-12)."""
    for step, (mj, sj, mt, st) in enumerate(runs["per_step"]):
        for name in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, name), getattr(sj, name), rtol=rtol, msg=f"step {step}: {name}")
        locals_close(st.local_vars, sj.local_vars, rtol=rtol, msg=f"step {step}: ")
        lik_params_close(mt.likelihood, mj.likelihood, rtol=rtol)
        assert int(st.opt_state) == int(sj.opt_state) == step + 1
        assert int(st.step) == int(sj.step) == step + 1


def adam_close(port, ref_optax, rtol, msg=""):
    """The port's Adam state (a dict) against optax's, leaf by leaf."""
    ref = optax_adam_arrays(ref_optax)
    assert int(port["count"]) == int(ref["count"]), msg
    for key in ("mu", "nu"):
        if isinstance(ref[key], dict):
            for leaf in ref[key]:
                close(port[key][leaf], ref[key][leaf], rtol=rtol, msg=f"{msg}{key} {leaf}")
        else:
            close(port[key], ref[key], rtol=rtol, msg=f"{msg}{key}")


def locals_close(port, ref, rtol, msg=""):
    """Every local variable at rtol (atol 1e-12), the Gaussian noise rule's
    state "state_sigma2" by ``adam_close``."""
    assert set(port) == set(ref), (set(port), set(ref))
    for name in ref:
        if name == "state_sigma2":
            adam_close(port[name], ref[name], rtol, msg=f"{msg}{name} ")
        else:
            close(port[name], ref[name], rtol=rtol, msg=f"{msg}{name}")


def check_predictions_and_elbo(runs, D, rtol=1e-8):
    """predict_f (mean and variance), predict_y and proba_y on 200 held-out
    points, and the ELBO on the last step's minibatch, at rtol."""
    mj, sj, Xj, yj, idx = runs["jax"]
    mt, st, Xt, yt = runs["port"]
    Xh = np.random.default_rng(1).normal(size=(200, D))
    Xhj, Xht = jnp.asarray(Xh), torch.as_tensor(Xh)
    mu_j, var_j = agp.predict_f(mj, sj, Xhj, cov=True)
    mu_t, var_t = agt.predict_f(mt, st, Xht, cov=True)
    close(mu_t, mu_j, rtol=rtol, msg="predict_f mean")
    close(var_t, var_j, rtol=rtol, msg="predict_f var")
    close(agt.predict_y(mt, st, Xht), agp.predict_y(mj, sj, Xhj), rtol=rtol, msg="predict_y")
    close_tree(agt.proba_y(mt, st, Xht), agp.proba_y(mj, sj, Xhj), rtol=rtol)
    start, B = int(idx[-1]), runs["B"]
    xb, yb = np.array(Xj)[start : start + B], np.array(yj)[start : start + B]
    e_j = float(agp.elbo(mj, sj, jnp.asarray(xb), jnp.asarray(yb)))
    e_t = float(agt.elbo(mt, st, torch.as_tensor(xb), torch.as_tensor(yb)))
    np.testing.assert_allclose(e_t, e_j, rtol=rtol)


# -------------------------- kernels 4-7's tensor-core arithmetic (3xTF32)
def tf32_round(x):
    """Float32 ``x`` rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    10 explicit mantissa bits, the nearest value, ties away from zero, by
    bit operations on the float32 pattern (finite x)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x):
    """Float32 ``x`` with its low 13 bits dropped: the TF32 value a
    tensor-core mma reads from an FP32 register."""
    return (x.to(torch.float32).contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_product(a, b, passes=3):
    """a @ b of float32 matrices with the kernels' split of both operands
    (on no path of the package, ``csrc/tf32_mma.cuh::split_tf32``): each x
    split into hi = tf32(x) (to nearest, ``tf32_round``) and lo = x - hi,
    which the mma reads truncated (``tf32_truncate``);
    (a_lo b_hi + a_hi b_lo) + a_hi b_hi with passes=3, a_hi b_hi alone with
    passes=1.  With passes=4 b splits in three as kernel 9's W product
    splits L^-T (``split3_tf32``): r = b - b_hi, b_mid = tf32_truncate(r),
    b_lo = tf32_truncate(r - b_mid), and ((a_hi b_lo + a_lo b_hi) +
    a_hi b_mid) + a_hi b_hi.  A product of two TF32 values is exact in
    float32.  Each pass is one float32 matmul rounded to nearest: this
    models the split, not the order in which the kernels add, nor the
    tensor cores' truncating alignment."""
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    out = a_hi @ b_hi
    if passes == 3:
        a_lo, b_lo = tf32_truncate(a - a_hi), tf32_truncate(b - b_hi)
        out = (a_lo @ b_hi + a_hi @ b_lo) + out
    elif passes == 4:
        a_lo, r = tf32_truncate(a - a_hi), b - b_hi
        b_mid = tf32_truncate(r)
        b_lo = tf32_truncate(r - b_mid)
        out = ((a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_mid) + out
    return out


def stats_tf32(kappa, g, theta, passes=3):
    """s1 = kappa^T g and S2 = kappa^T diag(theta) kappa of float32 [B, M]
    kappa as kernels 5 and 7 form them on the tensor cores: A = theta kappa
    in float32, S2 = A^T kappa by ``tf32_product`` over all of B.  s1 is
    float32, as the kernel's FMA sum."""
    kappa, g, theta = (t.to(torch.float32) for t in (kappa, g, theta))
    return kappa.T @ g, tf32_product((kappa * theta[:, None]).T, kappa, passes)


def kappa_tf32(knm, kinv, passes=3):
    """kappa = Knm K^-1 of float32 Knm [B, M] and K^-1 [M, M] as kernels 4
    and 6 form it on the tensor cores (``tf32_product``); kernel 4 forms
    kappa Sigma the same way, its A operand the float32 kappa."""
    return tf32_product(knm, kinv, passes)


def two_factor_tf32(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, w_passes=4, passes=3):
    """Kernel 9's function (``two_factor_nt_reference``) on float32 inputs
    with its products as the kernel forms them on the tensor cores
    (``tf32_product``): W = Knm L^-T in ``w_passes`` passes (the kernel's
    4: L^-T split in three), kappa = W L^-1 and kappa Sigma in ``passes``,
    S2 by ``stats_tf32``; the gram, Ktilde's and vf's row sums, mf = kappa
    mu and the E-step in float32, as the kernel's FP32 epilogues.  Returns
    (s1, S2, c, theta, mf, vf)."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    xb, Z, L_invT, mu, Sigma = (t.to(torch.float32) for t in (xb, Z, L_invT, mu, Sigma))
    var_t = torch.full((1,), float(var))
    knm = ck._gram_from_r2(ck._sq_dist_chunked((xb / ls)[None], (Z / ls)[None]), var_t[:, None, None], "rbf")[0]
    W = tf32_product(knm, L_invT, w_passes)
    ktilde = torch.clamp(var + jitt - torch.sum(W * W, dim=-1), min=1e-12)
    kappa = tf32_product(W, L_invT.T.contiguous(), passes)
    mf = kappa @ mu
    vf = torch.clamp(ktilde + torch.sum(tf32_product(kappa, Sigma, passes) * kappa, dim=-1), min=1e-12)
    c = torch.sqrt(mf * mf + vf)
    theta = torch.tanh(c / 2.0) / (2.0 * c)
    s1, S2 = stats_tf32(kappa, rho * yb.to(torch.float32) / 2.0, rho * theta / 2.0, passes)
    return s1, S2, c, theta, mf, vf


def moments_tf32(xb, Z, L_invT, mu, Sigma, ls, var, jitt, kind="rbf", passes=3):
    """kappa [B, M], mf, vf [B] of one latent on float32 inputs as the
    moments pass of kernels 1-4 (``csrc/pair_core.cuh::moment_rows``)
    forms them on the tensor cores: the gram of ``kind`` with x / ls and
    z / ls as products with 1 / ls (ls a number or [D], as
    ``gram_slab``), kappa = Knm K^-1 and kappa Sigma by ``tf32_product``
    in ``passes`` passes; the gram, Ktilde's and vf's row sums and
    mf = kappa mu in float32, as the kernel's FP32 epilogues."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    xb, Z, L_invT, mu, Sigma = (t.to(torch.float32) for t in (xb, Z, L_invT, mu, Sigma))
    inv_ls = 1.0 / torch.as_tensor(ls, dtype=torch.float32)
    var_t = torch.as_tensor(var, dtype=torch.float32).reshape(1)
    knm = ck._gram_from_r2(ck._sq_dist_chunked((xb * inv_ls)[None], (Z * inv_ls)[None]), var_t[:, None, None],
                           kind)[0]
    kappa = kappa_tf32(knm, ck._kinv(L_invT), passes)
    ktilde = torch.clamp(var_t + jitt - torch.sum(kappa * knm, dim=-1), min=1e-12)
    mf = kappa @ mu
    vf = torch.clamp(ktilde + torch.sum(tf32_product(kappa, Sigma, passes) * kappa, dim=-1), min=1e-12)
    return kappa, mf, vf


def fused_tf32(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, lik_p0=0.0, lik_p1=0.0, kind="rbf",
               lik="logistic", passes=3):
    """Kernel 1's function (``fused_cavi_stats_reference``) on float32
    inputs with its products as the kernel forms them on the tensor cores:
    the moments by ``moments_tf32``, S2 by ``stats_tf32``, the E-step of
    ``lik`` (``_estep_reference``) in float32, as the kernel's FP32
    epilogue.  Returns (s1, S2, c, theta, mf, vf)."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    p0, p1 = (torch.as_tensor(p, dtype=torch.float32) for p in (lik_p0, lik_p1))
    kappa, mf, vf = moments_tf32(xb, Z, L_invT, mu, Sigma, ls, var, jitt, kind, passes)
    c, theta, gmu, gs = ck._estep_reference(lik, mf, vf, yb.to(torch.float32), p0, p1)
    s1, S2 = stats_tf32(kappa, rho * gmu, rho * gs, passes)
    return s1, S2, c, theta, mf, vf


def multi_tf32(which, passes=3):
    """Kernel 2's (``which="multiclass"``) or 3's (``"het"``) function,
    with its plain version's signature, on float32 inputs with its products
    as the kernel forms them on the tensor cores: each latent's moments by
    ``moments_tf32`` (its lengthscale row and variance), the plain
    versions' E-steps (``_multiclass_estep``, ``_het_estep``) in float32,
    as the kernel's one thread a row, and each latent's S2 by
    ``stats_tf32``."""
    from agp_tpu_torch.ops import cuda_kernels as ck

    def fn(xb, y, Z, L_invT, mu, Sigma, ls, var, jitt, rho, *estep, kind="rbf"):
        L, _, D = Z.shape
        ls = torch.broadcast_to(torch.as_tensor(ls, dtype=torch.float32).reshape(L, -1), (L, D))
        var = torch.broadcast_to(torch.as_tensor(var, dtype=torch.float32).reshape(-1), (L,))
        kappa, mf, vf = (torch.stack(o) for o in zip(*(
            moments_tf32(xb, Z[l], L_invT[l], mu[l], Sigma[l], ls[l], var[l], jitt, kind, passes) for l in range(L))))
        y, estep = y.to(torch.float32), [e.to(torch.float32) if isinstance(e, torch.Tensor) else e for e in estep]
        if which == "multiclass":
            *outs, gmu, gs = ck._multiclass_estep(mf, vf, y, *estep)
        else:
            *outs, gmu, gs = ck._het_estep(mf, vf, y, *estep)
        s1, S2 = (torch.stack(o) for o in zip(*(stats_tf32(kappa[l], rho * gmu[l], rho * gs[l], passes)
                                               for l in range(L))))
        return (s1, S2, *outs)

    return fn


# ------------------------------------------------------------ MCGP
@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the samplers' tests: their tensors are small
    enough that one thread runs them as fast, and several threads a worker
    oversubscribe the CPU when the suite runs in parallel workers (5-9x
    slower there).  The previous count is restored after the test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t64(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


def cls_data(n=40, seed=0):
    """X ~ U[-2, 2]^2, f = sin(2 x_0) + 0.5 x_1, y = sign(f)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    return X, f, np.sign(f)


def reg_data():
    """tests/test_engines.py's reg_data: 30 points of a GP draw in 2-D,
    y = f + 0.05 eps."""
    X, f = generate_f(30, 2, agp.SqExponentialKernel())
    y = f + 0.05 * jax.random.normal(jax.random.PRNGKey(9), f.shape, dtype=jnp.float64)
    return np.asarray(X), np.asarray(f), np.asarray(y)


def jax_mcgp(lik, X, y, solver="chol", ls=1.0):
    return agp.MCGP.create(jnp.asarray(X), y, agp.SqExponentialKernel(lengthscale=jnp.asarray(ls),
                                                                         variance=jnp.asarray(1.0)),
                           lik, agp.GibbsSampling(solver=solver))


def port_mcgp(mj, y_raw):
    """The port's copy of a JAX MCGP (``model_from_numpy``)."""
    lik, params = port_likelihood(mj.likelihood)
    template = agt.MCGP.create(t64(mj.train_x), y_raw, agt.SqExponentialKernel(), lik,
                               agt.GibbsSampling(solver=mj.inference.solver))
    return model_from_numpy(dict(train_x=np.array(mj.train_x), train_y=np.array(mj.train_y),
                                 lengthscale=np.array(mj.kernel.lengthscale),
                                 variance=np.array(mj.kernel.variance), **params), template)


def jax_kmat(mj):
    """The reference's setup in ``_gibbs_chains``."""
    K = jax_batch_gram(mj.kernel, mj.train_x)
    L_K = jax.vmap(lambda k: jlinalg.safe_cholesky(k, jax_jitter(K.dtype)))(K)
    return {"L_K": L_K, "K_inv": jax.vmap(jlinalg.chol_inv)(L_K)}


# ------------------------------------------- Slice H: VStP, MOSVGP, MOVGP
def toy(n, d=2, seed=0):
    """benchmarks/tpu_acceptance.py's toy rule made with numpy: X uniform
    on [-2, 2]^d, f = sin(2 x_0) + 0.5 x_1."""
    X = np.random.default_rng(seed).uniform(-2, 2, size=(n, d))
    return X, np.sin(2 * X[:, 0]) + 0.5 * (X[:, 1] if d > 1 else 0.0)


def grand_tour_data():
    """examples/grand_tour.py's data: X uniform on [-2, 2]^2 from
    PRNGKey(0) (120 points), f = sin(2 x_0) + 0.5 x_1, yr = f + 0.05 eps."""
    X = np.array(jax.random.uniform(jax.random.PRNGKey(0), (120, 2), dtype=jnp.float64) * 4 - 2)
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    return X, f, f + 0.05 * np.random.RandomState(0).randn(120)


def jax_vstp(X, y, lik, nu=5.0, **create):
    """A JAX VStP (float64, lengthscale 1, fixed hyperparameters unless
    ``create`` names an optimiser) and its initial state."""
    m = agp.VStP.create(jnp.asarray(X), y, agp.SqExponentialKernel(lengthscale=jnp.asarray(1.0),
                                                                   variance=jnp.asarray(1.0)),
                        lik, agp.AnalyticVI(), nu=nu, **{"optimiser": None, **create})
    return m, jax_init_state(m)


def port_vstp(mj, sj, y_raw, optimiser=None):
    """The port's copy of a JAX VStP and its state (``interop``)."""
    lik, params = port_likelihood(mj.likelihood)
    template = agt.VStP.create(t64(mj.train_x), y_raw, agt.SqExponentialKernel(), lik, agt.AnalyticVI(),
                               nu=float(mj.nu), optimiser=optimiser)
    mt = model_from_numpy(dict(train_x=np.array(mj.train_x), train_y=np.array(mj.train_y),
                               lengthscale=np.array(mj.kernel.lengthscale), variance=np.array(mj.kernel.variance),
                               prior_nu=np.array(mj.nu), **params), template)
    return mt, state_from_numpy(state_arrays(sj), "cpu", torch.float64)


def jax_mo(X, likelihoods, M, Q, batch=None, movgp=False, kernel=None, **create):
    """A JAX MOSVGP on Z = X[:M] (or a MOVGP on X), float64, full batch
    unless ``batch`` is given, A fixed and the hyperparameters fixed unless
    ``create`` names optimisers; the squared-exponential kernel unless
    ``kernel`` (a JAX kernel) is given."""
    Xj = jnp.asarray(X)
    kw = {"optimiser": None, "Aoptimiser": None, **create}
    inference = agp.AnalyticVI() if batch is None else agp.AnalyticSVI(batch)
    kernel = agp.SqExponentialKernel() if kernel is None else kernel
    if movgp:
        return agp.MOVGP.create(Xj, list(likelihoods), kernel, inference, n_latent=Q, **kw)
    return agp.MOSVGP.create(kernel, list(likelihoods), inference, Xj[:M], n_latent=Q, **kw)


def jax_mo_treat(mj, ys):
    """(model with the labels' likelihoods, treated labels as float64 JAX
    arrays), as ``mo_train`` treats them."""
    out, liks = [], []
    for lik, y in zip(mj.likelihoods, ys):
        y2, lik2 = lik.treat_labels(y)
        out.append(jnp.asarray(y2, jnp.float64))
        liks.append(lik2)
    return mj.replace(likelihoods=tuple(liks)), tuple(out)


def jax_mo_draws(mj, sj, N, steps):
    """The reference's iid minibatch indices of steps 0..steps-1
    (``_mo_draw_batch``: fold_in(state.key, step), randint)."""
    return np.stack([np.array(jax.random.randint(jax.random.fold_in(sj.key, i), (mj.inference.batchsize,), 0, N))
                     for i in range(steps)])


def mo_state_arrays(s, A=None):
    """A JAX multi-output TrainState as ``interop.state_from_numpy`` takes
    it: per-task local variables, A's optimiser state (optax's Adam as
    ``optax_adam_arrays``; sgd, which keeps none, as the port's zero
    trace of A's shape), and no hyperparameter state unless it has one."""
    out = jax.tree_util.tree_map(lambda a: np.array(a), dict(
        eta1=s.eta1, eta2=s.eta2, mu=s.mu, Sigma=s.Sigma, opt_state=s.opt_state, rho=s.rho, step=s.step,
        kmat=dict(s.kmat)))
    out["local_vars"] = [{k: np.array(v) for k, v in lv.items()} for lv in s.local_vars]
    if s.A_state is not None:
        adam = getattr(s.A_state[0], "mu", None) is not None
        out["A_state"] = optax_adam_arrays(s.A_state) if adam else np.zeros_like(np.array(A))
    if s.hyper_state is not None:
        out["hyper_state"] = adam_state_arrays(s.hyper_state)
    return out


def port_mo(mj, sj, optimiser=None, Aoptimiser=None, inference=None, generator=None):
    """The port's copy of a JAX multi-output model and its state
    (``interop``): the same kernel, mean, Z, A and per-task likelihood
    parameters, float64 on the CPU; ``inference`` (default the JAX model's
    engine) replaces the port's."""
    liks, params = zip(*(port_likelihood(lik) for lik in mj.likelihoods))
    if inference is None:
        inf = mj.inference
        inference = agt.AnalyticSVI(inf.batchsize) if inf.stochastic else agt.AnalyticVI()
    kw = dict(n_latent=mj.n_latent, optimiser=optimiser, Aoptimiser=Aoptimiser, atfrequency=mj.atfrequency,
              generator=generator)
    kernel = port_kernel(jax.tree_util.tree_map(lambda a: a[0], mj.kernel))
    if type(mj).__name__ == "MOVGP":
        template = agt.MOVGP.create(t64(mj.Z[0]), liks, kernel, inference, **kw)
    else:
        template = agt.MOSVGP.create(kernel, liks, inference, t64(mj.Z[0]), **kw)
    mt = model_from_numpy(dict(Z=np.array(mj.Z), A=np.array(mj.A), kernel=jax_kernel_leaves(mj.kernel),
                               likelihoods=list(params)), template)
    return mt, state_from_numpy(mo_state_arrays(sj, mj.A), "cpu", torch.float64)


def mo_close(mt, st, mj, sj, rtol, msg="", normwise=False):
    """eta, mu, Sigma, A, each task's local variables and likelihood
    parameters, and A's optimiser state at rtol (atol 1e-12); with
    ``normwise`` eta, mu and Sigma with atol rtol times the array's largest
    entry (a MOVGP, whose Kmm over its training inputs has a condition
    number ~1e5, rounds its small entries at ~1e-11 of the largest)."""
    for name in ("eta1", "eta2", "mu", "Sigma"):
        ref = np.array(getattr(sj, name))
        atol = rtol * np.abs(ref).max() if normwise else 1e-12
        close(getattr(st, name), ref, rtol=rtol, atol=atol, msg=f"{msg}{name}")
    close(mt.A, mj.A, rtol=rtol, msg=f"{msg}A")
    for t, (lt, lj, vt, vj) in enumerate(zip(mt.likelihoods, mj.likelihoods, st.local_vars, sj.local_vars)):
        locals_close(vt, vj, rtol, msg=f"{msg}task {t} ")
        lik_params_close(lt, lj, rtol=rtol)
    if sj.A_state is not None and getattr(sj.A_state[0], "mu", None) is not None:
        adam_close(st.A_state, sj.A_state, rtol, msg=f"{msg}A_state ")
