"""Training loop: the counterpart of ``train`` in
``agp_tpu/training/train.py``: its fast path, its hyperparameter branch,
its callback, verbose and convergence options, and the exact GP's loop.

A step is: draw a minibatch, run ``variational_update`` (the analytic
one, or ``inference/numerical_vi.py``'s for a numerical engine), count the
step.  Minibatch indices come from an explicit ``torch.Generator`` on the
data's device, drawn for a whole chunk of steps at once; the steps then
run as a plain Python loop with no host sync.  ``vi_steps`` and ``train``
also take the indices from the caller (``draws``), so that a run can
replay another's minibatches; a Monte Carlo engine draws its normals
with the same generator, and ``vi_steps`` takes them from the caller
(``mc_draws``) too.  A model with an optimiser interleaves a
hyperparameter step (``training/autotuning.py``) on the same minibatch
after every ``atfrequency``-th CAVI step, as the reference does.  A VGP
trains on its own data; a GP takes one analytic refresh an iteration
(``models/gp.py``) and Adam on the marginal likelihood.
"""
from __future__ import annotations

import warnings

import torch

from ..inference import analytic_vi, numerical_vi
from ..inference.config import NUMERICAL
from ..inference.objective import objective
from ..kernels import from_unconstrained, to_unconstrained
from ..means import batch_call
from ..models.base import as_2d, check_card_dtype, match_dtype, to_tensor
from ..models.gp import GP, analytic_update, log_py, noisy_chol
from ..ops import linalg
from ..utils.opt import tree_map
from . import autotuning
from .state import TrainState, init_var_posterior

# steps whose minibatch indices are drawn in one call
_CHUNK = 2000


def init_state(model, X=None, y=None) -> TrainState:
    """The initial TrainState, on X's device and in X's dtype (a VGP's, a
    VStP's and a GP's own data when X is None; a Student-t process's prior
    scale at one).  Raises ``TypeError`` for a model or
    X that is not float32 on a CUDA device
    (``models.base.check_card_dtype``), as ``SVGP.create`` does for a
    model built there: this catches one moved to the card later."""
    if isinstance(model, GP):
        return model.init_state()
    X = model.train_x if X is None else X
    check_card_dtype(model.Z.device, model.Z.dtype)
    check_card_dtype(X.device, X.dtype, "data")
    dtype, device = X.dtype, X.device
    N = X.shape[0]
    inf = model.inference
    batch = inf.batchsize if inf.stochastic else N
    M = model.n_inducing if model.is_sparse else N
    post = init_var_posterior(model.n_latent, M, dtype, device)
    if inf.name in NUMERICAL:
        # no local variables; the optimiser steps (mu, Sigma), stochastic or not
        local_vars = {}
        opt_state = inf.optimiser.init((post["mu"], post["Sigma"]))
    else:
        local_vars = model.likelihood.init_local_vars(batch, dtype, device)
        opt_state = None
        if inf.stochastic and inf.optimiser is not None:
            opt_state = inf.optimiser.init((post["eta1"], post["eta2"]))
    prior_state = None
    if getattr(model, "is_tprior", False):
        ones = torch.ones((model.n_latent,), dtype=dtype, device=device)
        prior_state = {"l2": ones, "chi": ones.clone()}
    return TrainState(
        **post,
        local_vars=local_vars,
        opt_state=opt_state,
        hyper_state=autotuning.init_hyper_state(model),
        kmat=analytic_vi.compute_kmat(model, X),
        rho=torch.full((), N / batch if inf.stochastic else 1.0, dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        prior_state=prior_state,
    )


def block_tile(mode: str, b: int | None = None):
    """Tile height for "block"/"block:<n>" sampling.  Bare "block" is 64,
    halved until it divides the batchsize ``b`` when given.  None for a
    malformed or non-positive suffix (the caller falls back to "gather")."""
    if ":" not in mode:
        tile = 64
        if b is not None:
            while tile > 1 and b % tile:
                tile //= 2
        return tile
    try:
        tile = int(mode.split(":", 1)[1])
    except ValueError:
        return None
    return tile if tile >= 1 else None


def _tile_views(X, y, tile):
    """[T, tile, D] / [T, tile] aligned-tile views of the data for block
    sampling (views: nothing is copied)."""
    n_tiles = X.shape[0] // tile
    return (
        X[: n_tiles * tile].reshape(n_tiles, tile, X.shape[1]),
        y[: n_tiles * tile].reshape((n_tiles, tile) + y.shape[1:]),
    )


def _sampling_mode(model) -> str:
    """The engine's minibatch sampling; "gather" for an engine without the
    field (the numerical ones), as the reference reads it."""
    return getattr(model.inference, "minibatch_sampling", "gather")


def _block_mode_tile(model, b, n_rows):
    """Tile height when block sampling applies, else None."""
    mode = _sampling_mode(model)
    if not mode.startswith("block"):
        return None
    tile = block_tile(mode, b)
    if tile is not None and b % tile == 0 and n_rows >= tile:
        return tile
    return None


def _sampling(model, n_rows):
    """(mode, shape of one step's draw) for a stochastic model: "slice"
    draws a start row, "block" b/tile tile indices, "gather" b row
    indices."""
    b = model.inference.batchsize
    if _sampling_mode(model) == "slice":
        return "slice", ()
    tile = _block_mode_tile(model, b, n_rows)
    if tile is not None:
        return "block", (b // tile,)
    return "gather", (b,)


def _precomputed_draws(model, X, n: int, generator: torch.Generator):
    """The minibatch indices of n steps, drawn in one call on X's device:
    (mode, indices [n, ...]), or (None, None) for a non-stochastic model."""
    if not model.inference.stochastic:
        return None, None
    b = model.inference.batchsize
    N = X.shape[0]
    mode, shape = _sampling(model, N)
    if mode == "slice":
        high = N - b + 1
    elif mode == "block":
        high = N // (b // shape[0])  # number of aligned tiles
    else:
        high = N
    idx = torch.randint(0, high, (n,) + shape, generator=generator, device=X.device)
    return mode, idx


def _draw_from_idx(model, X, y, tiled, mode, idx, b=None):
    """Materialize one step's minibatch of ``b`` rows (the engine's
    batchsize when None) from its indices, on the device."""
    b = model.inference.batchsize if b is None else b
    if mode == "slice":
        rows = idx + torch.arange(b, device=X.device)
        return X.index_select(0, rows), y.index_select(0, rows)
    if mode == "block":
        Xt, yt = tiled
        return (
            Xt.index_select(0, idx).reshape(b, X.shape[1]),
            yt.index_select(0, idx).reshape((b,) + y.shape[1:]),
        )
    return X.index_select(0, idx), y.index_select(0, idx)


def _draw_batch(model, X, y, generator: torch.Generator, tiled=None):
    """One minibatch drawn with ``generator``."""
    mode, idx = _precomputed_draws(model, X, 1, generator)
    if mode == "block" and tiled is None:
        tiled = _tile_views(X, y, model.inference.batchsize // idx.shape[1])
    return _draw_from_idx(model, X, y, tiled, mode, idx[0])


def _default_generator(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _minibatches(model, X, y, n: int, draws=None, generator=None):
    """The minibatches (x_b, y_b) of n steps, in order: from ``draws``, one
    row per step on X's device ([n, B/tile] tile indices for "block"
    sampling, [n, B] row indices for "gather", [n] start rows for
    "slice"), or drawn with ``generator`` (a generator on X's device; seed
    0 when None) in one call; (X, y) itself for a non-stochastic model."""
    if not model.inference.stochastic:
        for _ in range(n):
            yield X, y
        return
    mode, shape = _sampling(model, X.shape[0])
    tiled = _tile_views(X, y, model.inference.batchsize // shape[0]) if mode == "block" else None
    if draws is None:
        gen = _default_generator(X.device) if generator is None else generator
        mode, draws = _precomputed_draws(model, X, n, gen)
    elif tuple(draws.shape) != (n,) + shape or draws.device != X.device:
        raise ValueError(
            f"draws for {mode!r} sampling must have shape {(n,) + shape} "
            f"on {X.device}; got {tuple(draws.shape)} on {draws.device}"
        )
    for i in range(n):
        yield _draw_from_idx(model, X, y, tiled, mode, draws[i])


def _vi_update(model, state: TrainState, x_b, y_b, generator, eps=None):
    """One step on a drawn batch, dispatched on the engine: a Monte Carlo
    one takes its normals ``eps``, or draws them with ``generator``."""
    if model.inference.name in NUMERICAL:
        return numerical_vi.variational_update(model, state, x_b, y_b, eps=eps, generator=generator)
    return analytic_vi.variational_update(model, state, x_b, y_b)


def vi_steps(model, state: TrainState, X, y, n: int, draws=None, generator=None, mc_draws=None):
    """n iterations of the model's engine; returns (model, state).
    ``draws`` and ``generator`` give the minibatches as ``_minibatches``
    takes them; a Monte Carlo engine's normals are ``mc_draws`` ([n, n_mc,
    L, B] on X's device) or are drawn with ``generator`` (seed 0 when
    None)."""
    gen = _default_generator(X.device) if generator is None else generator
    for i, (x_b, y_b) in enumerate(_minibatches(model, X, y, n, draws, gen)):
        eps = None if mc_draws is None else mc_draws[i]
        model, state = _vi_update(model, state, x_b, y_b, gen, eps)
        state = state.replace(step=state.step + 1)
    return model, state


def train(
    model,
    X=None,
    y=None,
    iterations: int = 100,
    state: TrainState | None = None,
    generator=None,
    draws=None,
    callback=None,
    verbose: int = 0,
    conv_eps: float = 0.0,
    conv_check_every: int = 10,
):
    """Train ``model`` for ``iterations`` steps of its engine on (X, y); returns
    (model, state) with the kernel matrices refreshed for prediction.

    X [N, D] and y [N] live on the device the run uses: arrays without a
    device (numpy, lists) go to the model's device (``model.Z``), floating
    ones in its dtype.  A VGP or a GP trains on its own data when X is
    None (given X and y replace a VGP's).  ``generator`` (on that device)
    draws the minibatches, seed 0 when None; ``draws`` ([iterations, ...],
    as ``vi_steps`` takes them) gives them instead.  A Monte Carlo engine
    draws its normals with ``generator`` too.

    With ``model.optimiser`` set, iteration i (from 1) is followed by a
    hyperparameter step on its own minibatch when i is a multiple of
    ``model.atfrequency``, i >= 3 and i is not the last, as the reference's
    loop does.  ``callback(model, state, i)`` runs after iteration i's
    CAVI step and before its hyperparameter step; ``verbose >= 2`` prints
    the ELBO after each iteration (on a fresh minibatch, drawn with
    ``generator``, when stochastic).  ``conv_eps > 0`` stops when the ELBO
    moves by less than ``conv_eps`` an iteration over a window of
    ``conv_check_every`` steps, on a fresh minibatch when stochastic; it is
    checked only without hyperparameter steps, callback or ``verbose >= 2``
    and costs one ELBO (a host read) a window.  Without any of these the
    steps run back to back with no host read.  Ctrl-C returns the model
    and state trained so far.  An online model raises ``TypeError``: it
    trains with ``online_train``; so does a multi-output one: ``mo_train``."""
    if isinstance(model, GP):
        return _train_gp(model, iterations, state, callback, verbose)
    if getattr(model, "is_multioutput", False):
        raise TypeError("multi-output models train with agp_tpu_torch.mo_train(model, X, ys, ...)")
    if getattr(model, "is_online", False):
        raise TypeError(
            "OnlineSVGP trains with agp_tpu_torch.online_train(model, X_batch, "
            "y_batch, state=state) -- thread the state across batches"
        )
    if X is None:
        X, y = getattr(model, "train_x", None), getattr(model, "train_y", None)
        if X is None:
            raise ValueError("this model needs X, y passed to train()")
    else:
        X = as_2d(X, like=model.Z)
        y_has_device = isinstance(y, torch.Tensor)
        y, lik = model.likelihood.treat_labels(y)
        if not y_has_device:
            y = y.to(X.device)
        y = match_dtype(y, X)
        if y.device != X.device:
            raise ValueError(f"y is on {y.device}, X on {X.device}")
        model = model.replace(likelihood=lik)
        if hasattr(model, "train_x"):
            model = model.replace(train_x=X, train_y=y)
    inf = model.inference
    if inf.stochastic and not 0 < inf.batchsize <= X.shape[0]:
        raise ValueError(f"batchsize {inf.batchsize} is not in (0, {X.shape[0]}]")
    if state is None:
        state = init_state(model, X, y)
    generator = _default_generator(X.device) if generator is None else generator
    do_hyper = model.optimiser is not None
    check = conv_eps > 0 and callback is None and verbose < 2 and not do_hyper and iterations > 1
    chunk = conv_check_every if check else _CHUNK
    prev = None
    # Ctrl-C keeps the partially trained (model, state)
    try:
        done = 0
        while done < iterations:
            n = min(chunk, iterations - done)
            rows = None if draws is None else draws[done:done + n]
            for i, (x_b, y_b) in enumerate(_minibatches(model, X, y, n, rows, generator), start=done + 1):
                model, state = _vi_update(model, state, x_b, y_b, generator)
                state = state.replace(step=state.step + 1)
                if callback is not None:
                    callback(model, state, i)
                if do_hyper and i % model.atfrequency == 0 and i >= 3 and i != iterations:
                    model, state = autotuning.hyper_step(model, state, x_b, y_b)
                if verbose >= 2:
                    e = objective(model, state, *_fresh_batch(model, X, y, generator))
                    print(f"iter {i}: ELBO = {float(e):.6f}")
            done += n
            if check:
                e = float(objective(model, state, *_fresh_batch(model, X, y, generator)))
                if prev is not None and abs(e - prev) / n < conv_eps:
                    break
                prev = e
    except KeyboardInterrupt:
        warnings.warn("training interrupted by user; returning current state")
    return model, state.replace(kmat=analytic_vi.compute_kmat(model, X))


def _fresh_batch(model, X, y, generator):
    """A minibatch drawn with ``generator`` for a stochastic model, else
    (X, y): where ``train`` reads the ELBO."""
    if model.inference.stochastic:
        return _draw_batch(model, X, y, generator)
    return X, y


def _train_gp(model, iterations, state, callback, verbose):
    """The exact GP's loop: an analytic refresh an iteration, with Adam on
    the kernel and the mean after iterations atfrequency, 2 atfrequency,
    ... from the third, never the last; ``callback(model, state, i)`` after
    both, ``verbose >= 2`` prints log p(y); then one refresh more, so the
    posterior matches the final hyperparameters."""
    if state is None:
        state = model.init_state()
    for i in range(1, iterations + 1):
        model, state = analytic_update(model, state)
        if model.optimiser is not None and i % model.atfrequency == 0 and i >= 3 and i != iterations:
            model, state = _gp_hyper_step(model, state)
        if callback is not None:
            callback(model, state, i)
        if verbose >= 2:
            print(f"iter {i}: log p(y) = {float(log_py(model, state)):.6f}")
    return analytic_update(model, state)


@linalg._highest_precision
def _gp_hyper_step(model, state: TrainState):
    """One optimiser step on the kernel's log parameters and the mean's
    against -log p(y) + const = 1/2 ((y - mu0)^T Sigma^-1 (y - mu0) +
    logdet Sigma), by autograd through the N x N Cholesky (the noise held
    fixed); returns (model, state) with the optimiser states updated."""
    log_k = {k: v.detach().requires_grad_(True) for k, v in to_unconstrained(model.kernel).leaves().items()}
    mean = {k: v.detach().requires_grad_(True) for k, v in model.mean.leaves().items()}
    with torch.enable_grad():
        L = noisy_chol(model, from_unconstrained(model.kernel.replace(**log_k)))
        r = model.train_y - batch_call(model.mean.replace(**mean), model.train_x, 1)[0]
        neg_logpy = 0.5 * (linalg.invquad(L, r) + linalg.chol_logdet(L))
        grads = torch.autograd.grad(neg_logpy, list(log_k.values()) + list(mean.values()))
    hyper = dict(state.hyper_state)
    k_up, hyper["kernel"] = model.optimiser.update(dict(zip(log_k, grads[: len(log_k)])), hyper["kernel"])
    m_up, hyper["mean"] = model.optimiser.update(dict(zip(mean, grads[len(log_k):])), hyper["mean"])
    new_log_k = tree_map(lambda p, u: p.detach() + u, log_k, k_up)
    new_mean = tree_map(lambda p, u: p + u, model.mean.leaves(), m_up)
    model = model.replace(
        kernel=from_unconstrained(model.kernel.replace(**new_log_k)), mean=model.mean.replace(**new_mean)
    )
    return model, state.replace(hyper_state=hyper)


def elbo(model, state: TrainState, X=None, y=None):
    """ELBO on (X, y) (labels as ``train`` treats them), the batch whose
    local variables are in ``state``; arrays without a device go to the
    model's device.  A VGP's own data when X is None; a GP's log p(y)."""
    if isinstance(model, GP):
        return log_py(model, state)
    if X is None:
        return objective(model, state, model.train_x, model.train_y)
    X = as_2d(X, like=model.Z)
    return objective(model, state, X, match_dtype(to_tensor(y, like=X), X))
