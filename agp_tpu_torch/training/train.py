"""Training loop: the counterpart of ``train`` in
``agp_tpu/training/train.py``: its fast path and its hyperparameter branch.

A step is: draw a minibatch, run ``variational_update``, count the step.
Minibatch indices come from an explicit ``torch.Generator`` on the data's
device, drawn for a whole chunk of steps at once; the steps then run as a
plain Python loop with no host sync.  ``vi_steps`` and ``train`` also take
the indices from the caller (``draws``), so that a run can replay
another's minibatches.  A model with an optimiser interleaves a
hyperparameter step (``training/autotuning.py``) on the same minibatch
after every ``atfrequency``-th CAVI step, as the reference does.
"""
from __future__ import annotations

import warnings

import torch

from ..inference import analytic_vi
from ..models.base import as_2d, check_card_dtype, match_dtype, to_tensor
from . import autotuning
from .state import TrainState, init_var_posterior

# steps whose minibatch indices are drawn in one call
_CHUNK = 2000


def init_state(model, X, y=None) -> TrainState:
    """The initial TrainState, on X's device and in X's dtype.  Raises
    ``TypeError`` for a model or X that is not float32 on a CUDA device
    (``models.base.check_card_dtype``), as ``SVGP.create`` does for a
    model built there: this catches one moved to the card later."""
    check_card_dtype(model.Z.device, model.Z.dtype)
    check_card_dtype(X.device, X.dtype, "data")
    dtype, device = X.dtype, X.device
    N = X.shape[0]
    inf = model.inference
    batch = inf.batchsize if inf.stochastic else N
    post = init_var_posterior(model.n_latent, model.n_inducing, dtype, device)
    opt_state = None
    if inf.stochastic and inf.optimiser is not None:
        opt_state = inf.optimiser.init((post["eta1"], post["eta2"]))
    return TrainState(
        **post,
        local_vars=model.likelihood.init_local_vars(batch, dtype, device),
        opt_state=opt_state,
        hyper_state=autotuning.init_hyper_state(model),
        kmat=analytic_vi.compute_kmat(model, X),
        rho=torch.full((), N / batch if inf.stochastic else 1.0, dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
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


def _block_mode_tile(model, b, n_rows):
    """Tile height when block sampling applies, else None."""
    mode = model.inference.minibatch_sampling
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
    if model.inference.minibatch_sampling == "slice":
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


def _draw_from_idx(model, X, y, tiled, mode, idx):
    """Materialize one step's minibatch from its indices, on the device."""
    b = model.inference.batchsize
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


def vi_steps(model, state: TrainState, X, y, n: int, draws=None, generator=None):
    """n CAVI iterations; returns (model, state).  ``draws`` and
    ``generator`` give the minibatches as ``_minibatches`` takes them."""
    for x_b, y_b in _minibatches(model, X, y, n, draws, generator):
        model, state = analytic_vi.variational_update(model, state, x_b, y_b)
        state = state.replace(step=state.step + 1)
    return model, state


def train(model, X, y, iterations: int = 100, state: TrainState | None = None, generator=None, draws=None):
    """Train ``model`` for ``iterations`` CAVI steps on (X, y); returns
    (model, state) with the kernel matrices refreshed for prediction.

    X [N, D] and y [N] live on the device the run uses: arrays without a
    device (numpy, lists) go to the model's device (``model.Z``), floating
    ones in its dtype.  ``generator`` (on that device) draws the
    minibatches, seed 0 when None; ``draws`` ([iterations, ...], as
    ``vi_steps`` takes them) gives them instead.

    With ``model.optimiser`` set, iteration i (from 1) is followed by a
    hyperparameter step on its own minibatch when i is a multiple of
    ``model.atfrequency``, i >= 3 and i is not the last, as the reference's
    loop does; without one, the steps run back to back."""
    X = as_2d(X, like=model.Z)
    y_has_device = isinstance(y, torch.Tensor)
    y, lik = model.likelihood.treat_labels(y)
    if not y_has_device:
        y = y.to(X.device)
    y = match_dtype(y, X)
    if y.device != X.device:
        raise ValueError(f"y is on {y.device}, X on {X.device}")
    model = model.replace(likelihood=lik)
    inf = model.inference
    if inf.stochastic and not 0 < inf.batchsize <= X.shape[0]:
        raise ValueError(f"batchsize {inf.batchsize} is not in (0, {X.shape[0]}]")
    if state is None:
        state = init_state(model, X, y)
    generator = _default_generator(X.device) if generator is None else generator
    # Ctrl-C keeps the partially trained (model, state)
    try:
        done = 0
        while done < iterations:
            n = min(_CHUNK, iterations - done)
            chunk = None if draws is None else draws[done:done + n]
            for i, (x_b, y_b) in enumerate(_minibatches(model, X, y, n, chunk, generator), start=done + 1):
                model, state = analytic_vi.variational_update(model, state, x_b, y_b)
                state = state.replace(step=state.step + 1)
                if model.optimiser is not None and i % model.atfrequency == 0 and i >= 3 and i != iterations:
                    model, state = autotuning.hyper_step(model, state, x_b, y_b)
            done += n
    except KeyboardInterrupt:
        warnings.warn("training interrupted by user; returning current state")
    return model, state.replace(kmat=analytic_vi.compute_kmat(model, X))


def elbo(model, state: TrainState, X, y):
    """ELBO on (X, y) (labels as ``train`` treats them), the batch whose
    local variables are in ``state``; arrays without a device go to the
    model's device."""
    X = as_2d(X, like=model.Z)
    return analytic_vi.elbo(model, state, X, match_dtype(to_tensor(y, like=X), X))
