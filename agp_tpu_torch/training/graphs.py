"""Runs of training iterations as replays of captured CUDA graphs: the
counterpart of the ``lax.scan`` in ``agp_tpu/training/train.py::_vi_steps``
and of ``train``'s calls of its ``_vi_step`` and ``_hyper_step``
programs, of ``mo_train``'s ``_mo_steps``, ``_mo_step`` and
``_mo_hyper_step`` (``agp_tpu/models/multioutput.py``), and of the online
drivers' ``_online_steps``, ``_online_batch`` and ``_online_stream_scan``
(``agp_tpu/models/online_svgp.py``).

The reference runs a chunk of n CAVI steps as one device program, with the
chunk's minibatch indices drawn before the scan, and, with hyperparameters
to learn, each iteration as one program and each hyperparameter step as
another.  Here ``run`` takes a chunk whose indices are drawn
(``training/train.py`` and ``models/multioutput.py`` draw them in one call)
and, on a CUDA tensor, replays a captured graph of ``STEPS_PER_GRAPH`` (k)
steps, then a one-step graph for the remainder.  ``run_hyper`` takes the
chunk's iterations with their marks, each a CAVI step followed, where it is
marked, by a hyperparameter step on the same minibatch (the host lays the
reference's schedule over the run), and replays graphs of marked
iterations.  ``run_batch`` takes one streaming batch
(``models/online_svgp.py``): the whole batch each iteration, its data
copied into the capture, a later batch's prologue replayed as a graph of
its own (``("prologue", fn)``), the iterations in windows of k, with Adam
the batch's end inside the last window's graph (``("tail", fn,
pattern)``); ``run_stream`` takes the batches of a pre-buffered stream on
one carry, each copied into the capture in turn, with no host read and
no copy of the carry between batches.  The host makes one graph launch
for the iterations of a graph in place of every op of every step (91-164
launches a CAVI step on the paths ``PERF.md`` §5 lists, 540-876 an
iteration with a hyperparameter step).

* Patterns.  A graph's body is a fixed sequence of iterations, each marked
  with or without a hyperparameter step; a graph is keyed by this pattern,
  written as the number of its iterations where none is marked, else as
  the tuple of their marks.  A capture holds at most three graphs: its
  large pattern (``large_pattern``), and the one-iteration patterns with
  and without a mark.  The large one is k unmarked steps without
  hyperparameter steps or at an ``atfrequency`` a above k; at a <= k, it is
  k // a periods of a - 1 unmarked iterations and one marked (at a = 1, k
  marked iterations).  At each iteration the host replays the large
  pattern where the marks ahead equal it, else the one-iteration graph of
  the iteration's mark; so at a = 1 a run takes the unmarked graph for
  iterations 1-2 and its last, the marked one next to the last and near
  the end of a chunk, and the large one for the rest.  ``run_batch`` has
  no large pattern: once a graph with a hyperparameter step may be
  captured (below), or where no iteration ahead is marked, it replays the
  pattern of the next k iterations' marks (fewer at the end), so that a
  streaming batch of n iterations whose carry fits takes ceil(n / k)
  replays, each batch of a stream the same patterns.
* The static carry.  A graph reads and writes the addresses it was
  captured with, so every tensor a step reads lives in a buffer of the
  capture:
  - carried: the leaves a step rewrites, the TrainState's (eta1, eta2, mu,
    Sigma, the local variables, opt_state, step, a Student-t prior's
    scale, a multi-output model's ``A_state``, an online model's
    ``previous``, which its step reads and returns as it is) and the
    model's fields of ``_step_fields``: the likelihood's (Poisson's lambda,
    a learnt Gaussian noise and its rule's state, the heteroscedastic
    lambda), or a multi-output model's ``likelihoods``, one a task, each
    with such leaves, and its mixing matrix ``A``, which the A step
    (``models/multioutput.py::mo_update_A``) steps and projects in every
    CAVI step under an ``Aoptimiser`` (held, both would be read stale at
    every replay), or an online model's slots, their mask and counts, the
    previous batch's slots and mask and the kmat, which its prologue
    rewrites (``_PROLOGUE_FIELDS``); and, where a hyperparameter step
    runs, the kernel's and
    the mean's leaves, Z under a ``Zoptimiser``, the kmat and the
    optimisers' states (``hyper_state``), each in the layout (strides) a
    step gives its result.  The captured body ends by copying its results
    into them, so each replay goes on from the last; a call returns copies
    of them;
  - held: the rest of the model (the kernel, the mean and Z where no
    hyperparameter step runs), the kmat and ``hyper_state`` likewise, rho,
    each in the caller's layout (part of the key), copied in at each
    call;
  - X and y (a tensor, or a multi-output model's tuple of one a task),
    read in place by ``run`` and ``run_hyper``: the key holds each
    tensor's address and strides and the capture a reference to them, so
    that no copy of the data is made; copied in by ``run_batch``, whose
    batches are new tensors at each call: the capture holds buffers of
    their shapes, dtypes and layouts (the key), copied into at each call,
    so that a stream of equal batches takes one capture;
  - the minibatch indices of a replay's steps ([k, ...]), copied from the
    chunk's before each replay; a Monte Carlo engine's normals, given by
    the caller, likewise, or else drawn inside the graph from the caller's
    generator, registered with the graph, so that a replay draws what the
    eager loop draws from it.
* The first step.  A product's kernel, and so its rounding, follows its
  operands' layout, so a replay reads the carry in the layout the eager
  loop's next step would read.  Where the caller's carried leaves have
  another layout than the buffers (a fresh state; a new capture), the
  call's first iteration (a streaming batch's prologue before it) runs
  eagerly on the caller's own tensors, as the eager loop's does, on the
  chunks' side stream; its results, in the
  step's layout, are copied into the carry (into new buffers, in their
  layouts, for a new capture).  Before a new capture this step is the
  warm-up: it loads the kernels' library, sets their shared-memory
  attributes, fills the wrappers' caches (the constants, the statistics
  plan, the quadrature nodes) and cuBLAS's and cuSOLVER's handles, so that
  a capture records kernels only.
* The prologue's warm-up.  A streaming batch's prologue is captured at
  its first later batch, where no eager step ran it: before that capture
  its body runs once eagerly on copies of the carry (on the side stream),
  its results dropped, so that the kernels it reaches (an accept walk's)
  are loaded and their caches filled before they are recorded.  Its
  launches count as any eager launch does.
* The hyperparameter warm-up.  A graph that holds a hyperparameter step
  is captured only after an iteration with one ran eagerly on the carry
  (on the side stream): the first marked iteration of a capture runs so
  (at ``atfrequency`` 1, iteration 3).  It fills what the ELBO's forward
  and backward and the optimiser reach (the kernels' saved-tensor paths,
  the plain vjps' and the ladder's differentiable rung's constants, the
  handles), so that its capture too records kernels only.  The forward,
  ``torch.autograd.grad`` and the optimiser are captured on the side
  stream, where the backward runs too.
* Reuse.  A capture serves every later chunk of the structure it was made
  for: every non-tensor field of the model and the state, every tensor's
  shape, dtype and device, the held leaves' layouts, X's and y's
  addresses, the sampling, the normals' source, ``STEPS_PER_GRAPH``, the
  hyperparameter step and the large pattern (the model's
  ``atfrequency``, its optimisers) and the run-time settings the kernels
  read (``STATS_F64_MMA_K``, the preferred linear-algebra library).  The ``_CACHE_SIZE`` latest are
  kept.  Code that puts another function in a module's attribute the step
  reaches (a plain version in a kernel's place) calls ``clear()`` when it
  does and when it puts the function back.
* Precision.  A capture records the kernels each op picks under the
  settings its code enters (``ops/linalg.py::_highest_precision`` turns
  TF32 off around the online model's algebra and the multi-output
  mixing); a replay launches those kernels and changes no setting.
* Launch counts.  ``cuda_kernels.CapturedLaunches`` takes back the counts
  a capture adds and credits them at each replay; ``tally`` counts the
  iterations run eagerly, the replays, the graphs captured and the static
  carries made, since the process started.
* No fallback.  A capture or a replay that fails raises; nothing re-runs
  on the eager loop.

On a CPU tensor the same body runs at each replay (``_EagerGraph``),
through the same carry, from copies of it (so that a (model, state) a step
returned keeps its values once a later replay rewrites the carry, as the
eager loop's do), so that the CPU tests hold it to the reference.
``takes`` is the rule, by the model's kind, for what ``train`` and
``vi_steps`` run here; the multi-output and online models run here by
their own drivers (``mo_train``, ``online_train``,
``online_train_stream``); the rest runs on the eager loops.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict

import torch

from ..inference import analytic_vi, numerical_vi
from ..ops import cuda_kernels, linalg
from ..utils import batch_sums
from ..utils.tensors import Params, map_named, named_leaves

# steps a captured graph holds (k).  At the flagship on an H100 (PERF.md
# §6, chip_smoke.py phase 56) k = 10 replays as fast as k = 50 (4,362 and
# 4,333 it/s; k = 1 4,143) for a fifth of the capture time (27 against
# 128 ms)
STEPS_PER_GRAPH = 10
# captures kept, the latest used last
_CACHE_SIZE = 4
_CACHE: OrderedDict = OrderedDict()
# the TrainState's fields a CAVI step reads and never writes
_HELD_STATE = ("kmat", "rho", "hyper_state")
# since the process started: iterations run eagerly (a call's first, the
# hyperparameter warm-up), graph replays, graphs captured, static carries
# made, prologues warmed on copies of the carry; a caller reads differences
tally = {"eager": 0, "replays": 0, "graphs": 0, "carries": 0, "warm": 0}


def takes(model) -> bool:
    """Whether ``vi_steps`` and ``train``'s fast path run the model's chunks
    here: a sparse model that is neither online nor multi-output, outside a
    sharded step.  The multi-output and online models run here by their own
    drivers (``mo_train`` through ``run`` and ``run_hyper``, the streaming
    drivers through ``run_batch``); the dense VGP, VStP and GP (their lazy
    rungs read the host) stay on ``train``'s eager loop, and a sharded
    step (``batch_sums.active()``, or ``mesh=`` of more than one process:
    its collectives) on its driver's."""
    return (
        getattr(model, "is_sparse", False)
        and not getattr(model, "is_online", False)
        and not getattr(model, "is_multioutput", False)
        and batch_sums.active() is None
    )


def drives(model) -> bool:
    """Whether the multi-output and online models' own drivers
    (``mo_train`` and ``mo_steps``, ``online_train`` and
    ``online_train_stream``) run the model's iterations here: outside a
    sharded step (``batch_sums.active()``; an online batch split over a
    mesh of more than one process is refused by its driver before)."""
    return batch_sums.active() is None


def _hyper_fields(model) -> tuple:
    """The fields of the model and the state that a hyperparameter step
    rewrites besides a CAVI step's: the kernel, the mean, Z under a
    ``Zoptimiser``, the kmat and the optimisers' states."""
    z = ("Z",) if getattr(model, "Zoptimiser", None) is not None else ()
    return ("kernel", "mean") + z + ("kmat", "hyper_state")


# an online model's fields that its prologue rewrites between batches
# (save-old's Za and za_mask, the inducing update's Z, z_mask and z_counts,
# the masked kmat): carried, so that the prologue runs inside the capture
_PROLOGUE_FIELDS = ("Z", "z_mask", "z_counts", "Za", "za_mask", "kmat")


def _step_fields(model) -> tuple:
    """The model's fields a CAVI step rewrites (module docstring, "The
    static carry"): a multi-output model's likelihoods and its mixing
    matrix A, any other model's likelihood; an online model's prologue
    fields (``_PROLOGUE_FIELDS``) beside its likelihood."""
    if getattr(model, "is_multioutput", False):
        return ("likelihoods", "A")
    if getattr(model, "is_online", False):
        return ("likelihood",) + _PROLOGUE_FIELDS
    return ("likelihood",)


def _fields(model, hyper) -> tuple:
    """The model's carried fields and the held state fields an iteration
    rewrites: ``_step_fields``, and ``_hyper_fields`` where a
    hyperparameter step is given."""
    return _step_fields(model) + (() if hyper is None else _hyper_fields(model))


def _carried(path: str, fields: tuple = ("likelihood",)) -> bool:
    """Whether an iteration rewrites the leaf at ``path`` ("model...." or
    "state...."): the model's and the state's fields in ``fields``
    (``_fields``) and every state field but the held ones."""
    root, field = path.split(".")[:2]
    return field in fields or (root == "state" and field not in _HELD_STATE)


def marks(pattern) -> tuple:
    """The marks of a graph's iterations (True: with a hyperparameter
    step) from its pattern: a number of unmarked iterations, or the tuple
    of their marks."""
    return (False,) * pattern if isinstance(pattern, int) else tuple(pattern)


def _role(key) -> str | None:
    """"prologue" or "tail" for a graph's key of that kind (``("prologue",
    fn)``, ``("tail", fn, pattern)``), None for a pattern."""
    return key[0] if isinstance(key, tuple) and key and isinstance(key[0], str) else None


def iterations_of(key) -> int | tuple:
    """The pattern of the iterations a graph's key runs: the key itself
    for a window of iterations, the window of a ("tail", fn, pattern) key,
    0 (none) for a ("prologue", fn) key."""
    role = _role(key)
    return key if role is None else key[2] if role == "tail" else 0


def describe(key) -> str:
    """A graph's key in words: its iterations and what runs around them."""
    pattern, role = iterations_of(key), _role(key)
    m = marks(pattern)
    what = f"{pattern} CAVI step(s)" if isinstance(pattern, int) else \
        f"{len(m)} iteration(s) with {sum(m)} hyperparameter step(s)"
    return {None: what, "prologue": "a streaming batch's prologue", "tail": f"{what} and a batch's end"}[role]


def pattern_of(flags) -> int | tuple:
    """The pattern of iterations with these marks: their number where none
    is marked, else the tuple of the marks."""
    flags = tuple(bool(f) for f in flags)
    return flags if any(flags) else len(flags)


def large_pattern(atfrequency: int | None) -> int | tuple:
    """The largest graph's pattern (module docstring): k unmarked steps
    without hyperparameter steps (``atfrequency`` None) or at an
    ``atfrequency`` a above k, else k // a periods of a - 1 unmarked
    iterations and a marked one."""
    k = STEPS_PER_GRAPH
    if atfrequency is None or atfrequency > k:
        return k
    return ((False,) * (atfrequency - 1) + (True,)) * (k // atfrequency)


def _structure(value):
    """A hashable image of ``value``: each tensor by its shape, dtype and
    device, ``Params`` by their fields, dicts, tuples and lists by their
    items, any other value (a number, a string, a function, a frozen
    config) as itself."""
    if isinstance(value, torch.Tensor):
        return ("tensor", tuple(value.shape), value.dtype, value.device)
    if isinstance(value, Params):
        fields = dataclasses.fields(value)
        return (type(value),) + tuple((f.name, _structure(getattr(value, f.name))) for f in fields if f.init)
    if isinstance(value, dict):
        return (dict,) + tuple((k, _structure(v)) for k, v in value.items())
    if type(value) in (tuple, list):
        return (type(value),) + tuple(_structure(v) for v in value)
    return value


def _layout(t: torch.Tensor) -> tuple:
    """The strides of ``t``'s copy by ``empty_like`` (a buffer of the
    carry): its own where it is dense; made with no memory."""
    return torch.empty_like(t, device="meta").stride()


def _leaves(model, state) -> list:
    return named_leaves(model, "model") + named_leaves(state, "state")


def _tensors(value) -> tuple:
    """The data's tensors: y itself, or a multi-output model's tuple of
    labels."""
    return tuple(value) if type(value) in (tuple, list) else (value,)


def _data_key(value, copied: bool) -> tuple:
    """The key of the data X or y: each tensor's address and strides where
    the capture reads it in place, its buffer's layout where it is copied
    in (shapes and dtypes are in ``_structure``)."""
    return tuple(_layout(t) if copied else (t.data_ptr(), t.stride()) for t in _tensors(value))


def _buffers(value):
    """Buffers of the data's layouts, in its form (a tensor or a tuple)."""
    out = tuple(torch.empty_like(t) for t in _tensors(value))
    return out if type(value) in (tuple, list) else out[0]


def _whole_batch(model, X, y, mode, idx):
    """A streaming iteration's draw: the whole batch."""
    return X, y


def _row(t, i):
    return None if t is None else t[i]


def _iteration(model, state, X, y, mode, idx, eps, rng, draw, update, hyper=None):
    """One iteration: the minibatch ``draw(model, X, y, mode, idx)``,
    ``update`` on it, ``step + 1``, then ``hyper(model, state, x_b, y_b)``
    on the same minibatch where ``hyper`` is given."""
    x_b, y_b = draw(model, X, y, mode, idx)
    model, state = update(model, state, x_b, y_b, rng, eps)
    state = state.replace(step=state.step + 1)
    if hyper is not None:
        model, state = hyper(model, state, x_b, y_b)
    return model, state


class _EagerGraph:
    """The CPU's stand-in for a CUDA graph: the captured body runs at each
    replay."""

    def __init__(self, device, generator=None, stream=None):
        self.fn = None

    def capture(self, fn, carried):
        self.fn = fn

    def replay(self):
        self.fn()


class _CudaGraph:
    """A CUDA graph of the body, captured on the chunks' stream (where the
    warm-up step ran), with the generator whose draws it makes
    registered."""

    def __init__(self, device, generator=None, stream=None):
        self.graph = torch.cuda.CUDAGraph()
        self.stream = stream
        if generator is not None:
            self.graph.register_generator_state(generator)

    def capture(self, fn, carried):
        with torch.cuda.graph(self.graph, stream=self.stream):
            fn()

    def replay(self):
        self.graph.replay()


def _graph_class(device):
    return _CudaGraph if device.type == "cuda" else _EagerGraph


@functools.lru_cache(maxsize=None)
def _stream(device: torch.device):
    """The side stream on which the chunks on ``device`` take their eager
    first steps and are captured."""
    return torch.cuda.Stream(device)


def _on_stream(device, fn):
    """``fn()`` on the chunks' stream, ordered after and before the
    current stream's work; its value."""
    if device.type != "cuda":
        return fn()
    stream, current = _stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        out = fn()
    current.wait_stream(stream)
    return out


class _Chunks:
    """One capture: the static carry (``buf``, by leaf path, and the
    indices and normals of a replay), the model and state built on it, the
    data it reads in place (or, with ``copied``, its buffers of the data),
    the graphs by their patterns and the launches each records.  Built from
    a (model, state) that an iteration returned, so that each carried
    buffer takes the step's layout.  ``hyper`` is the hyperparameter step
    (None: CAVI steps alone), ``large`` the largest graph's pattern (None:
    windows of k, ``run_batch``'s), ``warm`` whether an iteration with a
    hyperparameter step ran eagerly on the carry."""

    def __init__(self, model, state, X, y, mode, idx, mc_draws, rng, draw, update, hyper, large, copied=False):
        self.device, self.mode, self.rng, self.draw, self.update = X.device, mode, rng, draw, update
        self.hyper, self.large, self.warm, self.copied = hyper, large, False, copied
        self.fields = _fields(model, hyper)
        tally["carries"] += 1
        leaves = _leaves(model, state)
        self.buf = {p: torch.empty_like(t) for p, t in leaves}
        self.carried = [p for p, _ in leaves if _carried(p, self.fields)]
        self._ids = {id(b) for b in self.buf.values()}
        self.model = map_named(lambda p, t: self.buf[p], model, "model")
        self.state = map_named(lambda p, t: self.buf[p], state, "state")
        self.X, self.y = (_buffers(X), _buffers(y)) if copied else (X, y)
        k = STEPS_PER_GRAPH
        like = dict(device=self.device)
        # zeros: valid indices before the first replay fills them
        self.idx = None if idx is None else torch.zeros((k,) + tuple(idx.shape[1:]), dtype=idx.dtype, **like)
        self.eps = None if mc_draws is None else torch.zeros((k,) + tuple(mc_draws.shape[1:]), dtype=mc_draws.dtype,
                                                             **like)
        self.graphs, self.launches, self.capture_seconds = {}, {}, {}

    def fits(self, model, state) -> bool:
        """Whether the carried leaves of (model, state) have their buffers'
        shapes, dtypes and layouts."""
        carried = {p: t for p, t in _leaves(model, state) if _carried(p, self.fields)}
        return carried.keys() == set(self.carried) and all(
            (t.shape, t.dtype, _layout(t)) == (b.shape, b.dtype, b.stride())
            for p, t in carried.items() for b in (self.buf[p],))

    def load(self, model, state, X, y):
        """Copies the call's model and state into the carry, and its data
        into the data's buffers where they are ``copied``."""
        leaves = _leaves(model, state)
        dst, src = [self.buf[p] for p, _ in leaves], [t for _, t in leaves]
        if self.copied:
            dst += list(_tensors(self.X) + _tensors(self.y))
            src += list(_tensors(X) + _tensors(y))
        torch._foreach_copy_(dst, src)

    def load_data(self, X, y):
        """Copies a batch into the data's buffers (``copied``): the next
        batch of a stream, on the carry as the last one left it."""
        torch._foreach_copy_(list(_tensors(self.X) + _tensors(self.y)), list(_tensors(X) + _tensors(y)))

    def unload(self, model, state):
        """The call's (model, state) with copies of the carried leaves."""
        carried = set(self.carried)

        def out(p, t):
            return self.buf[p].clone() if p in carried else t

        return map_named(out, model, "model"), map_named(out, state, "state")

    def _body(self, key, keep=True):
        """What ``key`` runs, from the carry, its results copied back into
        it (without ``keep``, run on copies of the carry and dropped): a
        batch's prologue (``("prologue", fn)``: ``fn(model, state, X)``), or
        the iterations of a pattern, then, for ``("tail", fn, pattern)``,
        ``fn(model, state)``."""
        model, state = self.model, self.state
        if self.device.type != "cuda" or not keep:  # a step's results outlive the next replay
            model, state = map_named(lambda p, t: t.clone(), model, "model"), map_named(lambda p, t: t.clone(),
                                                                                       state, "state")
        role = _role(key)
        if role == "prologue":
            model, state = key[1](model, state, self.X)
        for j, hyper in enumerate(marks(iterations_of(key))):
            model, state = _iteration(model, state, self.X, self.y, self.mode, _row(self.idx, j), _row(self.eps, j),
                                      self.rng, self.draw, self.update, self.hyper if hyper else None)
        if role == "tail":
            model, state = key[1](model, state)
        out = dict(_leaves(model, state))
        changed = [p for p in out if _carried(p, self.fields) and p not in self.buf] + [
            p for p in self.carried
            if p not in out or out[p].shape != self.buf[p].shape or out[p].dtype != self.buf[p].dtype
        ]
        if changed:
            raise TypeError(f"a step changed its carry's structure ({', '.join(changed)}): a captured chunk needs "
                            "the leaves, shapes and dtypes it starts with")
        if not keep:
            return
        dst, src = [], []
        for p in self.carried:
            t, b = out[p], self.buf[p]
            if t is not b:
                dst.append(b)
                src.append(t.clone() if id(t) in self._ids else t)  # another leaf's buffer, about to change
        torch._foreach_copy_(dst, src)

    def _fill(self, steps, idx, eps, at):
        if self.idx is not None:
            self.idx[:steps].copy_(idx[at:at + steps])
        if self.eps is not None:
            self.eps[:steps].copy_(eps[at:at + steps])

    def _graph(self, key):
        """The graph of ``key`` (a pattern, or a prologue's or a tail's key:
        ``_body``), captured at its first use."""
        graph = self.graphs.get(key)
        if graph is not None:
            return graph
        if _role(key) == "prologue":  # the prologue's warm-up (module docstring)
            _on_stream(self.device, lambda: self._body(key, keep=False))
            tally["warm"] += 1
        stream = _stream(self.device) if self.device.type == "cuda" else None
        graph = _graph_class(self.device)(self.device, self.rng, stream)
        t0 = time.perf_counter()
        with cuda_kernels.CapturedLaunches() as launches:
            try:
                graph.capture(functools.partial(self._body, key), [self.buf[p] for p in self.carried])
            except Exception as err:
                raise RuntimeError(f"capturing {describe(key)} of a {type(self.model).__name__} failed; a model of "
                                   "a captured kind does not run on the eager loop") from err
        self.capture_seconds[key] = time.perf_counter() - t0
        self.graphs[key], self.launches[key] = graph, launches
        tally["graphs"] += 1
        return graph

    def next(self, flags, at):
        """The pattern to replay at iteration ``at`` of a chunk whose
        iterations are marked ``flags``: the large one where the marks
        ahead equal it (without a large one, the marks of the next k
        iterations), where it holds a hyperparameter step once one ran
        eagerly here; else the one-iteration pattern of ``flags[at]``; None
        for a marked iteration before that: it runs eagerly."""
        ahead = marks(self.large) if self.large is not None else tuple(flags[at:at + STEPS_PER_GRAPH])
        if tuple(flags[at:at + len(ahead)]) == ahead and (self.warm or not any(ahead)):
            return pattern_of(ahead)
        if flags[at] and not self.warm:
            return None
        return pattern_of(flags[at:at + 1])

    def eager(self, flags, idx, eps, at):
        """Iteration ``at`` run eagerly on the carry, on the chunks'
        stream: the hyperparameter warm-up."""
        self._fill(1, idx, eps, at)
        _on_stream(self.device, lambda: self._body(pattern_of(flags[at:at + 1])))
        self.warm |= bool(flags[at])
        tally["eager"] += 1

    def replay(self, key, idx=None, eps=None, at=0):
        """One replay of ``key``'s graph: iterations ``at`` .. ``at +
        len(marks(iterations_of(key))) - 1`` of the chunk (with a tail's
        key, then the batch's end), or a batch's prologue."""
        graph = self._graph(key)
        self._fill(len(marks(iterations_of(key))), idx, eps, at)
        graph.replay()
        self.launches[key].replayed()
        tally["replays"] += 1

    def iterate(self, flags, idx, eps, at, tail=None):
        """Iterations ``at`` .. of a chunk marked ``flags`` (``next``'s
        patterns), then ``tail(model, state)`` on the carry: inside the
        last window's graph, or eagerly where the last iteration ran
        eagerly."""
        n = len(flags)
        while at < n:
            pattern = self.next(flags, at)
            if pattern is None:
                self.eager(flags, idx, eps, at)
                at += 1
                continue
            steps = len(marks(pattern))
            if at + steps == n and tail is not None:
                self.replay(("tail", tail, pattern), idx, eps, at)
                tail = None
            else:
                self.replay(pattern, idx, eps, at)
            at += steps
        if tail is not None:
            _on_stream(self.device, lambda: self._body(("tail", tail, 0)))


def _key(model, state, X, y, mode, idx, mc_draws, rng, draw, update, hyper, large, copied):
    fields = _fields(model, hyper)
    return (
        _structure(model), _structure(state),
        tuple(_layout(t) for p, t in _leaves(model, state) if not _carried(p, fields)),
        _structure(X), _structure(y), _data_key(X, copied), _data_key(y, copied), copied, mode,
        None if idx is None else (tuple(idx.shape[1:]), idx.dtype),
        None if mc_draws is None else (tuple(mc_draws.shape[1:]), mc_draws.dtype),
        rng, draw, update, hyper, large, STEPS_PER_GRAPH,
        cuda_kernels.STATS_F64_MMA_K, torch.backends.cuda.preferred_linalg_library(),
    )


def _drop(chunks):
    """Forgets a capture; on the card after the replays in flight."""
    if chunks.device.type == "cuda":
        torch.cuda.synchronize(chunks.device)


def clear() -> None:
    """Forgets every capture (their graphs, memory pools and references to
    the data go with the last reference)."""
    while _CACHE:
        _drop(_CACHE.popitem()[1])


def latest():
    """The capture the latest chunk ran on, or None: its ``graphs``,
    ``launches`` (``CapturedLaunches``) and ``capture_seconds``, each by
    pattern."""
    return next(reversed(_CACHE.values()), None)


def _run(model, state, X, y, flags, mode, idx, generator, mc_draws, rng, draw, update, hyper, large, copied=False,
         prologue=None, tail=None, more=()):
    """The iterations marked ``flags`` (module docstring); with
    ``prologue``, ``prologue(model, state, X)`` before them, and with
    ``tail``, ``tail(model, state)`` after them; then, for each (X, y) of
    ``more`` (``copied`` data), the same on that batch."""
    n = len(flags)
    if n < 1:
        return model, state
    gen = generator if rng else None
    key = _key(model, state, X, y, mode, idx, mc_draws, gen, draw, update, hyper, large, copied)
    chunks = _CACHE.pop(key, None)
    at = 0
    if chunks is not None and chunks.fits(model, state):
        chunks.load(model, state, X, y)
        if prologue is not None:
            chunks.replay(("prologue", prologue))
    else:
        old = chunks

        def first():
            m, s = (model, state) if prologue is None else prologue(model, state, X)
            m, s = _iteration(m, s, X, y, mode, _row(idx, 0), _row(mc_draws, 0), gen, draw, update,
                              hyper if flags[0] else None)
            c = old if old is not None and old.fits(m, s) else _Chunks(m, s, X, y, mode, idx, mc_draws, gen, draw,
                                                                        update, hyper, large, copied)
            c.load(m, s, X, y)
            c.warm |= bool(flags[0])
            return c

        chunks, at = _on_stream(X.device, first), 1
        tally["eager"] += 1
        if old is not None and old is not chunks:
            _drop(old)
    while len(_CACHE) >= _CACHE_SIZE:
        _drop(_CACHE.popitem(last=False)[1])
    _CACHE[key] = chunks
    chunks.iterate(flags, idx, mc_draws, at, tail)
    for Xb, yb in more:
        chunks.load_data(Xb, yb)
        chunks.replay(("prologue", prologue))
        chunks.iterate(flags, idx, mc_draws, 0, tail)
    return chunks.unload(model, state)


def run(model, state, X, y, n, mode, idx, generator=None, mc_draws=None, rng=False, *, draw, update):
    """n steps of ``update(model, state, x_b, y_b, generator, eps)`` on the
    minibatches ``draw(model, X, y, mode, idx[i])`` (``idx`` [n, ...], or
    None for a full batch), each followed by ``step + 1``; returns (model,
    state).  ``mc_draws`` [n, ...] gives a Monte Carlo engine's normals;
    ``rng`` says that the step draws them from ``generator`` instead.  The
    first step runs eagerly where the carry's layouts or the capture are
    new; the rest are replays of k steps, then of one (module
    docstring)."""
    return _run(model, state, X, y, (False,) * n, mode, idx, generator, mc_draws, rng, draw, update, None,
                large_pattern(None))


def run_hyper(model, state, X, y, flags, mode, idx, generator=None, rng=False, *, draw, update, hyper):
    """The iterations of a chunk of ``train``'s with hyperparameters to
    learn: iteration i a step as ``run`` takes it, then, where ``flags[i]``
    is true, ``hyper(model, state, x_b, y_b)`` on its minibatch; returns
    (model, state).  The first iteration runs eagerly where the carry's
    layouts or the capture are new, the first marked one where no graph
    with a hyperparameter step was captured yet; the rest are replays of
    the patterns of the model's ``atfrequency`` (module docstring)."""
    return _run(model, state, X, y, tuple(bool(f) for f in flags), mode, idx, generator, None, rng, draw, update,
                hyper, large_pattern(model.atfrequency))


def run_batch(model, state, X, y, flags, *, update, hyper=None, prologue=None, tail=None):
    """One streaming batch (X, y): ``prologue(model, state, X)`` where
    given, then the iterations, each on the whole batch: iteration i
    ``update(model, state, X, y, None, None)`` and ``step + 1``, then,
    where ``flags[i]`` is true, ``hyper(model, state, X, y)``; then
    ``tail(model, state)`` where given; returns (model, state).  X and y
    are copied into the capture's buffers at each call, so that every batch
    of their shapes, dtypes and layouts replays one capture.  The prologue
    is a graph of its own, the tail part of the last window's graph.  The
    first iteration runs eagerly where the carry's layouts or the capture
    are new (the prologue with it), the first marked one where no graph
    with a hyperparameter step was captured yet; the rest are replays of
    the next k iterations' marks (module docstring)."""
    return _run(model, state, X, y, tuple(bool(f) for f in flags), None, None, None, None, False, _whole_batch,
                update, hyper, None, copied=True, prologue=prologue, tail=tail)


def run_stream(model, state, X_stream, y_stream, flags, *, update, prologue):
    """``run_batch`` (no hyperparameter step, no tail) over the batches
    X_stream [n, B, ...], y_stream [n, B, ...] in order, on one carry: the
    first as ``run_batch`` runs it, each later one copied into the data's
    buffers, then its prologue's graph and its windows replayed, with no
    copy of the carry between batches and no host read; returns (model,
    state) after the last."""
    flags = tuple(bool(f) for f in flags)
    more = zip(X_stream[1:], y_stream[1:])
    return _run(model, state, X_stream[0], y_stream[0], flags, None, None, None, None, False, _whole_batch, update,
                None, None, copied=True, prologue=prologue, more=more)
