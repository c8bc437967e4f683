"""Carry parameters and training state over from the JAX package.

Both functions take numpy arrays (``np.asarray`` of the JAX model's and
state's leaves), so this module needs no JAX.  Starting both packages from
identical states is how the port is checked step for step against the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .inducing import algorithms
from .means import ConstantMean
from .training.state import TrainState


# the likelihoods' tensor parameters, by field name
LIKELIHOOD_PARAMS = ("sigma2", "nu", "sigma", "beta", "rho", "r", "lam")


def model_from_numpy(params: dict, template):
    """``template`` (a port model) with its parameters taken from ``params``:
    "Z" [L, M, D] (or [M, D]) for an SVGP (an online model's also
    "z_mask", "Za", "za_mask", "z_counts" and optionally its static fields,
    see ``_online_from_numpy``), "train_x" and "train_y" for a VGP, a GP or
    an MCGP, "lengthscale" and "variance" (latent-stacked, as the
    reference replicates them), for a constant mean "mean_c", and the
    likelihood's own: "sigma2" (Gaussian; its rule's state is the train
    state's), "nu" and "sigma" (Student-t), "beta" (Laplace), "rho"
    (Matern-3/2 noise), "r" (negative binomial), "lam" (Poisson,
    heteroscedastic), "n_class" and "class_mapping" (logistic-softmax,
    softmax).  A generic likelihood's callables do not cross: the
    template's likelihood is built from the same septuple.  A multi-output
    model (MOSVGP, MOVGP) takes "A" [R, Q] and "likelihoods", one such
    parameter dict per task, in place of the likelihood's own; a VStP its
    prior's degrees of freedom as "prior_nu" (its Student-t likelihood's
    stay "nu").  Tensors land on the template's device and dtype (its Z's,
    or its training inputs')."""
    like = template.Z if template.is_sparse else template.train_x
    dev, dt = like.device, like.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    if template.is_sparse:
        Z = t(params["Z"])
        if Z.ndim == 2:
            Z = Z.expand((template.n_latent,) + Z.shape).clone()
        template = template.replace(Z=Z)
        if getattr(template, "is_online", False):
            template = _online_from_numpy(params, template, t)
    else:
        y = torch.as_tensor(np.asarray(params["train_y"]), device=dev)
        template = template.replace(train_x=t(params["train_x"]), train_y=y.to(dt) if y.is_floating_point() else y)
    kernel = template.kernel.replace(
        lengthscale=t(params["lengthscale"]), variance=t(params["variance"])
    )
    mean = template.mean
    if "mean_c" in params:
        mean = ConstantMean(c=t(params["mean_c"]))
    template = template.replace(kernel=kernel, mean=mean)
    if getattr(template, "is_multioutput", False):
        liks = tuple(_likelihood_from_numpy(p, lik, t) for p, lik in zip(params["likelihoods"], template.likelihoods))
        return template.replace(likelihoods=liks, A=t(params["A"]))
    if getattr(template, "is_tprior", False):
        template = template.replace(nu=t(params["prior_nu"]))
    return template.replace(likelihood=_likelihood_from_numpy(params, template.likelihood, t))


def _likelihood_from_numpy(params: dict, lik, t):
    """``lik`` with the parameters of ``params`` that it takes."""
    lik = lik.replace(**{k: t(params[k]) for k in LIKELIHOOD_PARAMS if k in params})
    if "n_class" in params:
        lik = lik.replace(n_class=int(params["n_class"]))
    if params.get("class_mapping") is not None:
        lik = lik.replace(class_mapping=tuple(params["class_mapping"]))
    return lik


def _online_from_numpy(params: dict, template, t):
    """An online template's slot buffers and, where given, its static
    fields: "capacity", "rho_accept" and "Zalg" as (class name, {field:
    value}) of ``inducing.algorithms``."""
    dev = template.Z.device
    template = template.replace(
        z_mask=torch.as_tensor(np.asarray(params["z_mask"]), dtype=torch.bool, device=dev),
        Za=t(params["Za"]),
        za_mask=torch.as_tensor(np.asarray(params["za_mask"]), dtype=torch.bool, device=dev),
        z_counts=t(params["z_counts"]),
    )
    static = {k: params[k] for k in ("capacity", "rho_accept") if k in params}
    if params.get("Zalg") is not None:
        name, fields = params["Zalg"]
        static["Zalg"] = getattr(algorithms, name)(**fields)
    return template.replace(**static)


def state_from_numpy(arrays: dict, device, dtype) -> TrainState:
    """A TrainState from numpy arrays: "eta1", "eta2", "mu", "Sigma",
    "local_vars" (a dict; the Gaussian's noise rule's state
    "state_sigma2" as optax's Adam state {"count", "mu", "nu"}),
    "opt_state" (the Robbins-Monro step count; a numerical engine's sgd
    traces, optax's ``TraceState.trace``, as a tuple of arrays; or None),
    "rho", "step",
    "kmat" ({"L_K", "K_inv"} and, for a sparse model, "L_inv"), for an
    online model "previous" ({"invDa", "prev_eta1", "prev_L_a"}), for a GP
    "alpha" and "chol_Sigma" (and none of eta, moments or kmat), and
    optionally "hyper_state": for each group ("kernel", "mean", "Z")
    optax's Adam state as {"count", "mu", "nu"}, the moments a dict of the
    group's leaves by field name (an array for "Z"), as
    ``utils.opt.adam`` keeps it.  A multi-output model's "local_vars" is a
    list of per-task dicts, and its "A_state" optax's Adam state of A as
    {"count", "mu", "nu"}, sgd's trace as an array, or None; a VStP's
    "prior_state" is {"l2", "chi"}."""

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)

    def moments(m):
        return {k: f(v) for k, v in m.items()} if isinstance(m, dict) else f(m)

    def adam_state(s):
        return {"count": i32(s["count"]), "mu": moments(s["mu"]), "nu": moments(s["nu"])}

    def optional(name):
        return None if arrays.get(name) is None else f(arrays[name])

    opt = arrays.get("opt_state")
    if opt is not None:
        opt = tuple(f(a) for a in opt) if isinstance(opt, (tuple, list)) else i32(opt)
    hyper = arrays.get("hyper_state")
    if hyper is not None:
        hyper = {group: adam_state(s) for group, s in hyper.items()}

    def local(lv):
        return {k: adam_state(v) if isinstance(v, dict) else f(v) for k, v in lv.items()}

    local_vars = arrays["local_vars"]
    local_vars = [local(lv) for lv in local_vars] if isinstance(local_vars, (list, tuple)) else local(local_vars)
    A_state = arrays.get("A_state")
    if A_state is not None:
        A_state = adam_state(A_state) if isinstance(A_state, dict) else f(A_state)
    prior = arrays.get("prior_state")
    kmat = arrays.get("kmat")
    return TrainState(
        eta1=optional("eta1"),
        eta2=optional("eta2"),
        mu=optional("mu"),
        Sigma=optional("Sigma"),
        local_vars=local_vars,
        opt_state=opt,
        hyper_state=hyper,
        kmat=None if kmat is None else {k: f(v) for k, v in kmat.items()},
        rho=f(arrays["rho"]),
        step=i32(arrays["step"]),
        alpha=optional("alpha"),
        chol_Sigma=optional("chol_Sigma"),
        previous=None if arrays.get("previous") is None else {k: f(v) for k, v in arrays["previous"].items()},
        A_state=A_state,
        prior_state=None if prior is None else {k: f(v) for k, v in prior.items()},
    )
