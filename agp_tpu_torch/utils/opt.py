"""Step-size rules and optimisers: the counterpart of ``ascent_update`` and
``robbins_monro`` in ``agp_tpu/utils/opt.py`` and of ``optax.adam``, the
reference's default hyperparameter optimiser.

optax is JAX-only, so the port carries a minimal rule protocol of its own:
a rule is an (init, update) pair, ``init(params) -> state`` and
``update(updates, state) -> (scaled_updates, new_state)``, in optax's
descent convention (the returned updates are added to the parameters).
``robbins_monro`` and ``sgd`` take a tuple of tensors, ``adam`` a tensor
or a dict of them (``sgd`` takes those too).
"""
from __future__ import annotations

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


def ascent_update(opt: GradientTransformation, opt_state, params, grads):
    """Apply an ASCENT step (the ELBO is maximized): returns
    (new_opt_state, updates_to_add).  ``grads`` is a tuple of tensors (the
    natural-gradient rules), a tensor or a dict of them (``adam``)."""
    neg = tuple(-g for g in grads) if isinstance(grads, tuple) else tree_map(torch.neg, grads)
    updates, new_state = opt.update(neg, opt_state)
    return new_state, updates


def robbins_monro(kappa: float = 0.51, tau: float = 1.0) -> GradientTransformation:
    """Robbins-Monro schedule: Delta * (tau + n)^-kappa, n the step count.

    The scale is computed in float32 whatever the parameters' dtype, as the
    reference does; a float64 scale would move float64 trajectories apart
    from the reference's at about 1e-8."""

    def init_fn(params):
        return torch.zeros((), dtype=torch.int32, device=params[0].device)

    def update_fn(updates, state):
        scale = (tau + state.to(torch.float32)) ** (-kappa)
        return tuple(-u * scale for u in updates), state + 1

    return GradientTransformation(init_fn, update_fn)


def sgd(lr: float, momentum: float = 0.0) -> GradientTransformation:
    """Stochastic gradient descent with heavy-ball momentum, with optax's
    semantics (``optax.sgd(lr, momentum)``, a ``trace`` chained with the
    learning rate): t <- g + momentum t, and the update -lr t.  The state
    is the traces, one per parameter (a tuple of tensors for a tuple of
    parameters), zeros at first, on the parameters' device.  The
    numerical engines' default is ``sgd(1e-5, 0.9)`` (quadrature) or
    ``sgd(1e-3, 0.9)`` (Monte Carlo)."""

    def init_fn(params):
        return tree_map(torch.zeros_like, params)

    def update_fn(updates, state):
        trace = tree_map(lambda g, t: g + momentum * t, updates, state)
        return tree_map(lambda t: -lr * t, trace), trace

    return GradientTransformation(init_fn, update_fn)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> GradientTransformation:
    """Adam with optax's semantics (``optax.adam(lr, b1, b2, eps)``):
    mu <- b1 mu + (1 - b1) g, nu <- b2 nu + (1 - b2) g^2, the count n + 1,
    and the update -lr mu_hat / (sqrt(nu_hat) + eps) with the bias
    corrections mu_hat = mu / (1 - b1^n), nu_hat = nu / (1 - b2^n).  The
    state is {"count": int32, "mu": ..., "nu": ...}, all on the parameters'
    device; the corrections are computed there, in the moments' dtype (as
    optax under x64 computes them in float64), so a step reads nothing back
    to the host."""

    def init_fn(params):
        leaves = list(params.values()) if isinstance(params, dict) else [params]
        device = leaves[0].device if leaves else None  # no leaf (ZeroMean): the count stays on the CPU
        return {
            "count": torch.zeros((), dtype=torch.int32, device=device),
            "mu": tree_map(torch.zeros_like, params),
            "nu": tree_map(torch.zeros_like, params),
        }

    def update_fn(updates, state):
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates, state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates, state["nu"])
        count = state["count"] + 1

        def step(m, v):
            n = count.to(m.dtype)
            m_hat = m / (1 - torch.pow(b1, n))
            v_hat = v / (1 - torch.pow(b2, n))
            return -lr * (m_hat / (torch.sqrt(v_hat) + eps))

        return tree_map(step, mu, nu), {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init_fn, update_fn)

