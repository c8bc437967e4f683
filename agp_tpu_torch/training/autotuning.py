"""The hyperparameter step: the counterpart of
``agp_tpu/training/autotuning.py``.

One step takes the gradient of -ELBO on the CAVI step's minibatch, by
``torch.autograd.grad`` through the whole ELBO (the kernel matrices, their
Cholesky ladder, the kappa kernel's ``autograd.Function``, the Gaussian
KL), with respect to the kernel's unconstrained parameters (log, logit or
as they are: ``kernels.to_unconstrained``; a nested kernel's by path), the
prior mean's parameters and, when the model has a ``Zoptimiser``, the
inducing points.  The optimiser's updates are added (descent on -ELBO),
the kernel is mapped back, and the cached kernel matrices are recomputed.  A
full model's (VGP's) kernel matrices are over its training inputs, the
batch x of a full-batch step; its ELBO reads their Cholesky factor alone,
so the gradient's pass forms no inverse.  No value is read back to the host
(a full model's ladder reads one, ``ops/linalg.py``).  The exact GP's step
is ``training/train.py::_gp_hyper_step``.
"""
from __future__ import annotations

import torch

from ..inference import analytic_vi
from ..inference.objective import objective
from ..kernels import from_unconstrained, to_unconstrained
from ..training.state import TrainState
from ..utils.opt import init_on, tree_map
from ..utils.tensors import path_leaves, with_path_leaves


def _optimises_z(model) -> bool:
    return model.is_sparse and getattr(model, "Zoptimiser", None) is not None


def _kmat(model, x, inverse: bool = True):
    """The kernel matrices the ELBO takes: an online model's masked ones
    (with K^-1 always), else ``compute_kmat``."""
    if getattr(model, "is_online", False):
        from ..models.online_svgp import masked_kmat

        return masked_kmat(model)
    return analytic_vi.compute_kmat(model, x, inverse=inverse)


def hyper_gradients(model, state: TrainState, x, y):
    """(unconstrained kernel leaves by path (``utils.tensors.path_leaves``),
    gradients of -ELBO with respect to them, the mean's gradients, Z's
    gradient or None), the ELBO taken with
    ``kmat = _kmat`` of the candidate model (over x for a full model, the
    masked one for an online model, its extra KL included), as the
    reference's ``neg_elbo`` does."""
    log_k = {k: v.detach().requires_grad_(True) for k, v in path_leaves(to_unconstrained(model.kernel)).items()}
    mean = {k: v.detach().requires_grad_(True) for k, v in model.mean.leaves().items()}
    Z = model.Z.detach().requires_grad_(True) if _optimises_z(model) else None
    with torch.enable_grad():
        kernel = from_unconstrained(with_path_leaves(model.kernel, log_k))
        m2 = model.replace(kernel=kernel, mean=model.mean.replace(**mean))
        if Z is not None:
            m2 = m2.replace(Z=Z)
        kmat = _kmat(m2, x, inverse=m2.is_sparse)
        neg_elbo = -objective(m2, state, x, y, kmat=kmat)
        wanted = list(log_k.values()) + list(mean.values()) + ([Z] if Z is not None else [])
        grads = torch.autograd.grad(neg_elbo, wanted)
    n_k = len(log_k)
    g_k = dict(zip(log_k, grads[:n_k]))
    g_m = dict(zip(mean, grads[n_k:n_k + len(mean)]))
    return {k: v.detach() for k, v in log_k.items()}, g_k, g_m, grads[-1] if Z is not None else None


def hyper_step(model, state: TrainState, x, y):
    """One optimiser step on the kernel's log parameters, the prior mean's
    parameters (and Z under a ``Zoptimiser``) against -ELBO on (x, y), the
    batch whose local variables are in ``state``; returns (model, state)
    with the optimiser states and the kernel matrices updated."""
    log_k, g_k, g_m, g_z = hyper_gradients(model, state, x, y)
    hyper = dict(state.hyper_state)
    k_updates, hyper["kernel"] = model.optimiser.update(g_k, hyper["kernel"])
    new_log_k = tree_map(lambda p, u: p + u, log_k, k_updates)
    m_updates, hyper["mean"] = model.optimiser.update(g_m, hyper["mean"])
    new_mean = tree_map(lambda p, u: p + u, model.mean.leaves(), m_updates)
    model = model.replace(
        kernel=from_unconstrained(with_path_leaves(model.kernel, new_log_k)), mean=model.mean.replace(**new_mean)
    )
    if g_z is not None:
        z_update, hyper["Z"] = model.Zoptimiser.update(g_z, hyper["Z"])
        model = model.replace(Z=model.Z + z_update)
    return model, state.replace(hyper_state=hyper, kmat=_kmat(model, x))


def init_hyper_state(model):
    """The optimiser states of the hyperparameter groups ("kernel" on the
    log parameters, "mean", and "Z" under a ``Zoptimiser``), on Z's device
    (``utils.opt.init_on``), or None for fixed hyperparameters."""
    if model.optimiser is None:
        return None
    device = model.Z.device
    hyper = {
        "kernel": init_on(model.optimiser, path_leaves(to_unconstrained(model.kernel)), device),
        "mean": init_on(model.optimiser, model.mean.leaves(), device),
    }
    if _optimises_z(model):
        hyper["Z"] = init_on(model.Zoptimiser, model.Z, device)
    return hyper
