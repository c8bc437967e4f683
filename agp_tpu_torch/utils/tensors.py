"""Frozen dataclasses of tensors: the port's stand-in for the reference's
Flax ``PyTreeNode``s (kernels, means, likelihoods, models, the train state).

Fields that hold tensors, or dicts of tensors, are the "leaves"; every other
field is static configuration.  ``replace`` returns a new instance, as
``PyTreeNode.replace`` does, and ``map`` applies a function to every leaf,
recursing into nested ``Params``.
"""
from __future__ import annotations

import copy
import dataclasses
import re

import torch


def map_leaves(fn, value):
    """Apply ``fn`` to every tensor in ``value`` (a tensor, a ``Params``, or
    a dict, tuple or list of them: a multi-output model's likelihoods, its
    state's per-task local variables); anything else passes through."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, Params):
        return value.map(fn)
    if isinstance(value, dict):
        return {k: map_leaves(fn, v) for k, v in value.items()}
    if type(value) in (tuple, list):  # not a NamedTuple (an optimiser's functions)
        return type(value)(map_leaves(fn, v) for v in value)
    return value


@dataclasses.dataclass(frozen=True)
class Params:
    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def leaves(self) -> dict:
        """{field name: tensor} of the tensor fields (what an optimiser
        updates); ``replace(**leaves)`` puts them back."""
        return {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.init and isinstance(getattr(self, f.name), torch.Tensor)
        }

    def map(self, fn):
        """A copy with ``fn`` applied to every tensor leaf."""
        return dataclasses.replace(
            self,
            **{
                f.name: map_leaves(fn, getattr(self, f.name))
                for f in dataclasses.fields(self)
                if f.init
            },
        )

    def to(self, device=None, dtype=None):
        """A copy with every floating leaf moved to ``device`` and cast to
        ``dtype`` (integer leaves only move)."""

        def move(t):
            if t.is_floating_point():
                return t.to(device=device, dtype=dtype)
            return t.to(device=device)

        return self.map(move)


def map_named(fn, value, path: str, leaf=torch.Tensor):
    """``value`` with ``fn(path, x)`` in place of each ``leaf`` x (a tensor,
    or another type such as a checkpoint skeleton's leaf marker), walking
    ``Params`` fields in declaration order, dicts in their order and tuples
    and lists by index (what ``map_leaves`` walks); a leaf's path is
    ``path`` and its field names, keys and indices joined by dots.  The
    copies skip ``__post_init__``, so a field may take any value."""
    if isinstance(value, leaf):
        return fn(path, value)
    if isinstance(value, Params):
        out = copy.copy(value)
        for f in dataclasses.fields(value):
            if f.init:
                object.__setattr__(out, f.name, map_named(fn, getattr(value, f.name), f"{path}.{f.name}", leaf))
        return out
    if isinstance(value, dict):
        return {k: map_named(fn, v, f"{path}.{k}", leaf) for k, v in value.items()}
    if type(value) in (tuple, list):
        return type(value)(map_named(fn, v, f"{path}.{i}", leaf) for i, v in enumerate(value))
    return value


def named_leaves(tree, name: str) -> list:
    """[(path, tensor)] of ``tree`` in walk order, paths rooted at ``name``."""
    out = []
    map_named(lambda p, t: out.append((p, t)), tree, name)
    return out


def path_leaves(tree) -> dict:
    """{path: tensor} of a nested ``Params`` tree in declaration order, the
    paths relative to the tree ("lengthscale", "left.inner.lengthscale",
    "transform.transforms.1.v"): the leaves an optimiser or autograd takes
    from a kernel.  :func:`with_path_leaves` puts them back."""
    return {p[1:]: t for p, t in named_leaves(tree, "")}


def with_path_leaves(tree, leaves: dict):
    """``tree`` with the tensor at each path of ``leaves`` (as
    :func:`path_leaves` names them) replaced by its value there."""
    return map_named(lambda p, t: leaves.get(p[1:], t), tree, "")


def keystr(path: str) -> str:
    """A :func:`path_leaves` path as ``jax.tree_util.keystr`` writes the
    same leaf of the reference's pytree: ".left.inner.lengthscale",
    ".transform.transforms[1].v"."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"[\1]", "." + path)


def host_read(t: torch.Tensor):
    """``t.item()``: the one way the samplers read the device back to
    decide how to go on (a rejection loop's "all lanes done", the
    Polya-Gamma draw's unit count, CG's "any system active", NUTS's "all
    chains done"; the warm eta -> moments conversions' branch).  Each read waits for the device; ``host_read.reads``
    counts them, so that a caller can count the reads of a sweep or a
    step."""
    host_read.reads += 1
    return t.item()


host_read.reads = 0


# the rejection loops read "every lane done" once every this many trips
CHECK_EVERY = 4


def run_trips(trip, max_trips: int) -> int:
    """The port of a masked ``lax.while_loop`` whose exit test is "every
    lane done": ``trip()`` runs one trip over the whole batch (a trip on a
    finished lane must be a no-op) and returns the [batch] ``done`` mask.
    The mask is read on the host once every ``CHECK_EVERY`` trips, never
    past ``max_trips`` trips in all, so the loop may run up to
    ``CHECK_EVERY - 1`` masked trips more than the reference's, which
    changes no lane.  Returns the trips run; ``run_trips.trips`` adds them
    up."""
    trips = 0
    while trips < max_trips:
        for _ in range(min(CHECK_EVERY, max_trips - trips)):
            done = trip()
            trips += 1
        if host_read(done.all()):
            break
    run_trips.trips += trips
    return trips


run_trips.trips = 0
