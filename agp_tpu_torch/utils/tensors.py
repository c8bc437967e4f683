"""Frozen dataclasses of tensors: the port's stand-in for the reference's
Flax ``PyTreeNode``s (kernels, means, likelihoods, models, the train state).

Fields that hold tensors, or dicts of tensors, are the "leaves"; every other
field is static configuration.  ``replace`` returns a new instance, as
``PyTreeNode.replace`` does, and ``map`` applies a function to every leaf,
recursing into nested ``Params``.
"""
from __future__ import annotations

import dataclasses

import torch


def map_leaves(fn, value):
    """Apply ``fn`` to every tensor in ``value`` (a tensor, a ``Params`` or
    a dict of them); anything else passes through."""
    if isinstance(value, torch.Tensor):
        return fn(value)
    if isinstance(value, Params):
        return value.map(fn)
    if isinstance(value, dict):
        return {k: map_leaves(fn, v) for k, v in value.items()}
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
