"""Carry parameters and training state over from the JAX package.

Both functions take numpy arrays (``np.asarray`` of the JAX model's and
state's leaves), so this module needs no JAX.  Starting both packages from
identical states is how the port is checked step for step against the
reference.
"""
from __future__ import annotations

import dataclasses

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


# ------------------------------------------- the reference's checkpoints
def _adam_paths(prefix, s, keys):
    """The reference's leaves of optax's Adam state (a chain: its
    ScaleByAdamState at [0]) against the port's {"count", "mu", "nu"}."""
    out = [("state", f"{prefix}[0].count", keys + ("count",), s["count"])]
    for part in ("mu", "nu"):
        m = s[part]
        if isinstance(m, dict):
            out += [("state", f"{prefix}[0].{part}.{k}", keys + (part, k), v) for k, v in m.items()]
        else:
            out.append(("state", f"{prefix}[0].{part}", keys + (part,), m))
    return out


def _is_adam(s) -> bool:
    return isinstance(s, dict) and set(s) == {"count", "mu", "nu"}


def reference_leaf_table(model, state):
    """The JAX package's flatten order of (model, state) for a port model
    and state of the same family, as [(which, path, keys, template)]:
    ``which`` "model" or "state", ``path`` the reference's leaf path as
    ``jax.tree_util.keystr`` writes it, ``keys`` where the leaf goes in the
    dicts :func:`model_from_numpy` and :func:`state_from_numpy` take (None
    for the reference's PRNG key, which the port has no place for), and
    the template's tensor there.  The order: flax fields in declaration
    order, dict keys sorted, None empty; optax's states are chains whose
    first member holds the leaves.  Families: SVGP, VGP, VStP, OnlineSVGP,
    MOSVGP, MOVGP and the GP, with closed-form engines (a numerical
    engine's optimiser state raises ``NotImplementedError``)."""
    table = []
    for f in dataclasses.fields(model):
        value = getattr(model, f.name)
        if f.name in ("kernel", "likelihood"):
            table += [("model", f".{f.name}.{k}", (k,), v) for k, v in value.leaves().items()]
        elif f.name == "likelihoods":
            table += [("model", f".likelihoods[{i}].{k}", ("likelihoods", i, k), v)
                      for i, lik in enumerate(value) for k, v in lik.leaves().items()]
        elif f.name == "mean":
            table += [("model", f".mean.{k}", ("mean_" + k,), v) for k, v in value.leaves().items()]
        elif isinstance(value, torch.Tensor):
            key = "prior_nu" if f.name == "nu" else f.name
            table.append(("model", f".{f.name}", (key,), value))
    for name in ("eta1", "eta2", "mu", "Sigma"):
        if getattr(state, name) is not None:
            table.append(("state", f".{name}", (name,), getattr(state, name)))
    lv = state.local_vars
    for i, d in (enumerate(lv) if isinstance(lv, (list, tuple)) else [(None, lv)]):
        for k in sorted(d):
            prefix = f".local_vars['{k}']" if i is None else f".local_vars[{i}]['{k}']"
            keys = ("local_vars", k) if i is None else ("local_vars", i, k)
            table += _adam_paths(prefix, d[k], keys) if _is_adam(d[k]) else [("state", prefix, keys, d[k])]
    if isinstance(state.opt_state, torch.Tensor):
        table.append(("state", ".opt_state", ("opt_state",), state.opt_state))
    elif state.opt_state is not None:
        raise NotImplementedError("a numerical engine's optimiser state has no reference mapping yet")
    for group in sorted(state.hyper_state or {}):
        table += _adam_paths(f".hyper_state['{group}']", state.hyper_state[group], ("hyper_state", group))
    for k in sorted(state.kmat or {}):
        table.append(("state", f".kmat['{k}']", ("kmat", k), state.kmat[k]))
    table += [("state", ".rho", ("rho",), state.rho), ("state", ".step", ("step",), state.step),
              ("state", ".key", None, None)]
    for name in ("alpha", "chol_Sigma"):
        if getattr(state, name) is not None:
            table.append(("state", f".{name}", (name,), getattr(state, name)))
    if state.A_state is not None:
        if not _is_adam(state.A_state):
            raise NotImplementedError("only Adam's state of A has a reference mapping")
        table += _adam_paths(".A_state", state.A_state, ("A_state",))
    for group in ("previous", "prior_state"):
        d = getattr(state, group)
        table += [("state", f".{group}['{k}']", (group, k), d[k]) for k in sorted(d or {})]
    return table


def from_reference_leaves(model_leaves, state_leaves, model_template, state_template):
    """(model, state) from the JAX package's flattened leaves (numpy
    arrays in its flatten order, as its checkpoints hold them), placed as
    ``model_template`` and ``state_template`` are (their device, their
    floating dtype): the leaves go by :func:`reference_leaf_table` into the
    dicts :func:`model_from_numpy` and :func:`state_from_numpy` take.  The
    reference's PRNG key is dropped."""
    table = reference_leaf_table(model_template, state_template)
    params = {"likelihoods": [{} for _ in getattr(model_template, "likelihoods", ())]}
    lv = state_template.local_vars
    arrays = {"local_vars": [{} for _ in lv] if isinstance(lv, (list, tuple)) else {}}
    for group, s in (state_template.hyper_state or {}).items():
        arrays.setdefault("hyper_state", {})[group] = {k: ({} if isinstance(v, dict) else None) for k, v in s.items()}
    leaves = {"model": iter(model_leaves), "state": iter(state_leaves)}
    for which, _, keys, _ in table:
        value = next(leaves[which])
        if keys is None:
            continue
        d = params if which == "model" else arrays
        for k in keys[:-1]:
            d = d.setdefault(k, {}) if isinstance(d, dict) else d[k]
        d[keys[-1]] = value
    if not params["likelihoods"]:
        del params["likelihoods"]
    ref = state_template.rho
    return model_from_numpy(params, model_template), state_from_numpy(arrays, ref.device, ref.dtype)
