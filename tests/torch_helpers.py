"""Builds the same SVGP model in the JAX package and in the PyTorch port,
and carries the JAX model's parameters and state over, so that a test can
run both from identical states (the port's tests)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.training.train import init_state as jax_init_state
from agp_tpu.utils.opt import robbins_monro as jax_robbins_monro
from agp_tpu_torch.interop import LIKELIHOOD_PARAMS, model_from_numpy, state_from_numpy
from agp_tpu_torch.utils.opt import GradientTransformation
from chip_smoke import single_latent_labels, single_latent_lik


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


def adam_state_arrays(hyper_state):
    """The JAX package's hyperparameter state (optax's Adam state per group)
    as ``interop.state_from_numpy`` takes it: {"count", "mu", "nu"} per
    group, each moment a dict of leaves by field name (an array for Z)."""

    def tree(t):
        if isinstance(t, jax.Array):
            return np.array(t)
        return {f.name: np.array(getattr(t, f.name)) for f in dataclasses.fields(t)
                if isinstance(getattr(t, f.name), jax.Array)}

    return {group: {"count": np.array(s[0].count), "mu": tree(s[0].mu), "nu": tree(s[0].nu)}
            for group, s in hyper_state.items()}


def state_arrays(s):
    """The JAX TrainState's leaves the port's state holds, as numpy."""
    leaves = dict(
        eta1=s.eta1, eta2=s.eta2, mu=s.mu, Sigma=s.Sigma,
        local_vars=dict(s.local_vars), opt_state=s.opt_state, rho=s.rho,
        step=s.step, kmat=dict(s.kmat),
    )
    out = jax.tree_util.tree_map(lambda a: np.array(a), leaves)
    if s.hyper_state is not None:
        out["hyper_state"] = adam_state_arrays(s.hyper_state)
    return out


def port_likelihood(lik_j):
    """The port's counterpart of a JAX likelihood, with its parameters as
    ``model_from_numpy`` takes them."""
    name = type(lik_j).__name__
    if name == "LogisticSoftMaxLikelihood":
        return agt.LogisticSoftMaxLikelihood.create(lik_j.n_class), dict(
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


def port_from_jax(mj, sj, Xj, yj, dtype=torch.float64, device="cpu", optimiser=None):
    """The port's (model, state, X, y) carrying the JAX model's parameters
    and state; ``optimiser`` replaces the port's Robbins-Monro rule."""
    B = mj.inference.batchsize
    inference = agt.AnalyticSVI(B, optimiser=optimiser, minibatch_sampling=mj.inference.minibatch_sampling)
    X = torch.as_tensor(np.array(Xj), dtype=dtype, device=device)
    M = mj.Z.shape[1]
    lik, lik_params = port_likelihood(mj.likelihood)
    kernel = getattr(agt, type(mj.kernel).__name__)()
    mt = agt.SVGP.create(kernel, lik, inference, X[:M], optimiser=None)
    if type(mj.mean).__name__ == "ConstantMean":
        lik_params["mean_c"] = np.array(mj.mean.c)
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


def replay_steps(mj, sj, Xj, yj, steps):
    """``steps`` CAVI steps of the JAX model (mj, sj) and of the port's copy
    of it, on the JAX package's own draws, with its Robbins-Monro scales
    replayed: the states after each step and the final models."""
    from agp_tpu.training.train import _precomputed_draws, _vi_steps
    from agp_tpu_torch.training.train import vi_steps

    B = mj.inference.batchsize
    _, idx = _precomputed_draws(mj, sj, Xj, steps)
    mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(steps)))
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
        assert set(st.local_vars) == set(sj.local_vars)
        for name in sj.local_vars:
            close(st.local_vars[name], sj.local_vars[name], rtol=rtol, msg=f"step {step}: {name}")
        lik_params_close(mt.likelihood, mj.likelihood, rtol=rtol)
        assert int(st.opt_state) == int(sj.opt_state) == step + 1
        assert int(st.step) == int(sj.step) == step + 1


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
