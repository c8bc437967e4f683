"""Step-size rules for the stochastic natural-gradient update: the
counterpart of ``ascent_update`` and ``robbins_monro`` in
``agp_tpu/utils/opt.py``.

optax is JAX-only, so the port carries a minimal rule protocol of its own:
a rule is an (init, update) pair, ``init(params) -> state`` and
``update(updates, state) -> (scaled_updates, new_state)``, in optax's
descent convention (the returned updates are added to the parameters).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def ascent_update(opt: GradientTransformation, opt_state, params, grads):
    """Apply an ASCENT step (the ELBO is maximized): returns
    (new_opt_state, updates_to_add)."""
    neg = tuple(-g for g in grads)
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
