"""Step-size rules and optimisers: the counterpart of ``ascent_update``,
``positive_ascent``, ``robbins_monro`` and ``alrsvi`` in
``agp_tpu/utils/opt.py`` and of ``optax.adam`` and ``optax.sgd``, the
reference's default hyperparameter and numerical-VI optimisers.

optax is JAX-only, so the port carries a minimal rule protocol of its own:
a rule is an (init, update) pair, ``init(params) -> state`` and
``update(updates, state) -> (scaled_updates, new_state)``, in optax's
descent convention (the returned updates are added to the parameters).
``robbins_monro`` and ``alrsvi`` take a tuple of tensors, ``adam`` a
tensor or a dict of them (``sgd`` takes those too).  Each rule is a pair of
module-level functions with its settings bound, so that a model holding
one pickles (``training/checkpoint.py``).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """``fn`` applied leaf by leaf to a tensor, a tuple or a dict of
    tensors, and to the trees of the same structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    return fn(tree, *rest)


def init_on(opt: GradientTransformation, params, device):
    """``opt.init(params)`` with every tensor of the state on ``device``: a
    group with no leaf (a ``ZeroMean``'s) gives its rule nothing to take
    the device from, and its count must live where the model's steps run
    (a captured graph replays no CPU op)."""
    return tree_map(lambda t: t.to(device), opt.init(params))


def ascent_update(opt: GradientTransformation, opt_state, params, grads):
    """Apply an ASCENT step (the ELBO is maximized): returns
    (new_opt_state, updates_to_add).  ``grads`` is a tuple of tensors (the
    natural-gradient rules), a tensor or a dict of them (``adam``)."""
    neg = tuple(-g for g in grads) if isinstance(grads, tuple) else tree_map(torch.neg, grads)
    updates, new_state = opt.update(neg, opt_state)
    return new_state, updates


def _tree_leaves(tree) -> list:
    """The tensors of a tensor, a tuple or a dict of them, in order."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tree_leaves(v)]
    if isinstance(tree, tuple):
        return [t for v in tree for t in _tree_leaves(v)]
    return [tree]


def positive_ascent(opt: GradientTransformation, opt_state, value, grad_wrt_value):
    """An ascent step on a positive parameter, taken in log space: value <-
    exp(log value + Delta), Delta the rule's update of the gradient with
    respect to log value (value * gradient).  Returns (new_opt_state,
    new_value)."""
    g_log = tree_map(lambda v, g: v * g, value, grad_wrt_value)
    new_state, updates = ascent_update(opt, opt_state, value, g_log)
    return new_state, tree_map(lambda v, u: torch.exp(torch.log(v) + u), value, updates)


def _rm_init(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _rm_update(kappa, tau, updates, state):
    # float32's (tau + n)^-kappa correctly rounded: the power in float64,
    # then rounded, which on the CPU equals torch's float32 power bit for
    # bit, where a float32 power on the card rounds an ulp off it at some n
    scale = ((tau + state.to(torch.float64)) ** (-kappa)).to(torch.float32)
    return tuple(-u * scale for u in updates), state + 1


def robbins_monro(kappa: float = 0.51, tau: float = 1.0) -> GradientTransformation:
    """Robbins-Monro schedule: Delta * (tau + n)^-kappa, n the step count.

    The scale is a float32 value whatever the parameters' dtype, as the
    reference's is; a float64 scale would move float64 trajectories apart
    from the reference's at about 1e-8.  It is the correctly rounded one
    on every device, so that a float64 run on the card follows the CPU's
    (the card's own float32 power moved them ~1e-8 apart by step 6)."""
    return GradientTransformation(_rm_init, partial(_rm_update, kappa, tau))


def _alrsvi_init(n_warmup, params):
    p0 = _tree_leaves(params)[0]
    return {
        "i": torch.zeros((), dtype=torch.int32, device=p0.device),
        "g": tree_map(torch.zeros_like, params),
        "h": torch.zeros((), dtype=p0.dtype, device=p0.device),
        "tau": torch.full((), float(n_warmup), dtype=p0.dtype, device=p0.device),
    }


def _sqnorm(tree):
    return sum(torch.sum(x**2) for x in _tree_leaves(tree))


def _alrsvi_update(n_warmup, rho0, updates, state):
    i = state["i"] + 1
    warm = i <= n_warmup
    h0, tau0 = state["h"], state["tau"]
    # the warm-up weight 1/i in float32, as the reference computes it
    w = torch.where(warm, (1.0 / i.to(torch.float32)).to(h0.dtype), 1.0 / tau0)
    g = tree_map(lambda m, u: (1.0 - w) * m + w * u, state["g"], updates)
    h = (1.0 - w) * h0 + w * _sqnorm(updates)
    rho = torch.where(warm, torch.full_like(h, rho0), _sqnorm(g) / torch.clamp(h, min=1e-30))
    tau = torch.where(warm, tau0, tau0 * (1.0 - rho) + 1.0)
    return tree_map(lambda u: -rho * u, updates), {"i": i, "g": g, "h": h, "tau": tau}


def alrsvi(n_warmup: int = 10, rho0: float = 0.1) -> GradientTransformation:
    """The adaptive learning rate for SVI (Ranganath et al.), as the
    reference re-derives it: running means g of the gradient and h of its
    squared norm, weighted 1/i over the n_warmup first steps (at rate rho0)
    and 1/tau after; then the rate rho = |g|^2 / h and the window tau <-
    tau (1 - rho) + 1.  The state is {"i": int32, "g": the running means
    (a tuple like the parameters), "h", "tau"}, on the parameters' device
    and in their dtype, the warm-up weight computed in float32 as the
    reference computes it."""
    return GradientTransformation(partial(_alrsvi_init, n_warmup), partial(_alrsvi_update, n_warmup, rho0))


def _sgd_init(params):
    return tree_map(torch.zeros_like, params)


def _sgd_update(lr, momentum, updates, state):
    trace = tree_map(lambda g, t: g + momentum * t, updates, state)
    return tree_map(lambda t: -lr * t, trace), trace


def sgd(lr: float, momentum: float = 0.0) -> GradientTransformation:
    """Stochastic gradient descent with heavy-ball momentum, with optax's
    semantics (``optax.sgd(lr, momentum)``, a ``trace`` chained with the
    learning rate): t <- g + momentum t, and the update -lr t.  The state
    is the traces, one per parameter (a tuple of tensors for a tuple of
    parameters), zeros at first, on the parameters' device.  The
    numerical engines' default is ``sgd(1e-5, 0.9)`` (quadrature) or
    ``sgd(1e-3, 0.9)`` (Monte Carlo)."""
    return GradientTransformation(_sgd_init, partial(_sgd_update, lr, momentum))


def _adam_init(params):
    leaves = list(params.values()) if isinstance(params, dict) else [params]
    device = leaves[0].device if leaves else None  # no leaf (ZeroMean): on the CPU until ``init_on`` moves it
    return {
        "count": torch.zeros((), dtype=torch.int32, device=device),
        "mu": tree_map(torch.zeros_like, params),
        "nu": tree_map(torch.zeros_like, params),
    }


def _adam_update(lr, b1, b2, eps, updates, state):
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates, state["nu"])
    count = state["count"] + 1

    def step(m, v):
        n = count.to(m.dtype)
        m_hat = m / (1 - torch.pow(b1, n))
        v_hat = v / (1 - torch.pow(b2, n))
        return -lr * (m_hat / (torch.sqrt(v_hat) + eps))

    return tree_map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """Adam with optax's semantics (``optax.adam(lr, b1, b2, eps)``):
    mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, the count n + 1,
    and the update -lr mu_hat / (sqrt(nu_hat) + eps) with the bias
    corrections mu_hat = mu / (1 - b1^n), nu_hat = nu / (1 - b2^n).  The
    state is {"count": int32, "mu": ..., "nu": ...}, all on the parameters'
    device; the corrections are computed there, in the moments' dtype (as
    optax under x64 computes them in float64), so a step reads nothing back
    to the host."""
    return GradientTransformation(_adam_init, partial(_adam_update, lr, b1, b2, eps))
