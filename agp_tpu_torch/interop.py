"""Carry parameters and training state over from the JAX package.

Both functions take numpy arrays (``np.asarray`` of the JAX model's and
state's leaves), so this module needs no JAX.  Starting both packages from
identical states is how the port is checked step for step against the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from .means import ConstantMean
from .training.state import TrainState


# the likelihoods' tensor parameters, by field name
LIKELIHOOD_PARAMS = ("sigma2", "nu", "sigma", "beta", "rho", "r", "lam")


def model_from_numpy(params: dict, template):
    """``template`` (a port model) with its parameters taken from ``params``:
    "Z" [L, M, D] (or [M, D]), "lengthscale" and "variance" (latent-stacked,
    as the reference replicates them), for a constant mean "mean_c", and
    the likelihood's own: "sigma2" (Gaussian), "nu" and "sigma"
    (Student-t), "beta" (Laplace), "rho" (Matern-3/2 noise), "r"
    (negative binomial), "lam" (Poisson, heteroscedastic), "n_class" and
    "class_mapping" (multiclass).  Tensors land on template.Z's device and
    dtype."""
    dev, dt = template.Z.device, template.Z.dtype

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    Z = t(params["Z"])
    if Z.ndim == 2:
        Z = Z.expand((template.n_latent,) + Z.shape).clone()
    kernel = template.kernel.replace(
        lengthscale=t(params["lengthscale"]), variance=t(params["variance"])
    )
    mean = template.mean
    if "mean_c" in params:
        mean = ConstantMean(c=t(params["mean_c"]))
    lik = template.likelihood
    lik = lik.replace(**{k: t(params[k]) for k in LIKELIHOOD_PARAMS if k in params})
    if "n_class" in params:
        lik = lik.replace(n_class=int(params["n_class"]))
    if params.get("class_mapping") is not None:
        lik = lik.replace(class_mapping=tuple(params["class_mapping"]))
    return template.replace(Z=Z, kernel=kernel, mean=mean, likelihood=lik)


def state_from_numpy(arrays: dict, device, dtype) -> TrainState:
    """A TrainState from numpy arrays: "eta1", "eta2", "mu", "Sigma",
    "local_vars" (a dict), "opt_state" (the Robbins-Monro step count, or
    None), "rho", "step", "kmat" ({"L_K", "K_inv"} and optionally "L_inv")
    and optionally "hyper_state": for each group ("kernel", "mean", "Z")
    optax's Adam state as {"count", "mu", "nu"}, the moments a dict of the
    group's leaves by field name (an array for "Z"), as
    ``utils.opt.adam`` keeps it."""

    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)

    def moments(m):
        return {k: f(v) for k, v in m.items()} if isinstance(m, dict) else f(m)

    opt = arrays.get("opt_state")
    hyper = arrays.get("hyper_state")
    if hyper is not None:
        hyper = {
            group: {"count": i32(s["count"]), "mu": moments(s["mu"]), "nu": moments(s["nu"])}
            for group, s in hyper.items()
        }
    return TrainState(
        eta1=f(arrays["eta1"]),
        eta2=f(arrays["eta2"]),
        mu=f(arrays["mu"]),
        Sigma=f(arrays["Sigma"]),
        local_vars={k: f(v) for k, v in arrays["local_vars"].items()},
        opt_state=None if opt is None else i32(opt),
        hyper_state=hyper,
        kmat={k: f(v) for k, v in arrays["kmat"].items()},
        rho=f(arrays["rho"]),
        step=i32(arrays["step"]),
    )
