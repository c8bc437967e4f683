"""Inference-engine configurations: the counterpart of ``Analytic``,
``AnalyticVI`` and ``AnalyticSVI`` in ``agp_tpu/inference/config.py``.  Everything here is static
configuration; the dynamic parts (rho, the step counter, the optimiser
state, the local variables) live in the TrainState."""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..utils.opt import robbins_monro

SAMPLING_MODES = ("gather", "slice", "block")


@dataclasses.dataclass(frozen=True)
class InferenceConfig:
    stochastic: bool = False
    batchsize: int = 0

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Analytic(InferenceConfig):
    """Exact conjugate solve for ``GP``."""

    stochastic: bool = False
    batchsize: int = 0


@dataclasses.dataclass(frozen=True)
class AnalyticVI(InferenceConfig):
    """Blockwise CAVI with closed-form natural-gradient updates.

    minibatch_sampling: "gather" draws b iid row indices; "slice" takes a
    contiguous window at a random offset; "block" (or "block:<n>") draws
    b/n random aligned n-row tiles (default n=64, halved until it divides
    b), a block bootstrap over pre-shuffled rows, falling back to "gather"
    when b is not a multiple of n."""

    stochastic: bool = False
    batchsize: int = 0
    optimiser: Optional[Any] = None
    minibatch_sampling: str = "gather"

    def __post_init__(self):
        if self.minibatch_sampling.split(":", 1)[0] not in SAMPLING_MODES:
            raise ValueError(
                f"minibatch_sampling must be one of {SAMPLING_MODES} "
                f"(or 'block:<n>'), got {self.minibatch_sampling!r}"
            )

    @property
    def name(self):
        return "AnalyticVI"


def AnalyticSVI(batchsize: int, optimiser=None, minibatch_sampling: str = "gather") -> AnalyticVI:
    """Stochastic AnalyticVI on minibatches with Robbins-Monro steps."""
    if optimiser is None:
        optimiser = robbins_monro()
    return AnalyticVI(
        stochastic=True,
        batchsize=batchsize,
        optimiser=optimiser,
        minibatch_sampling=minibatch_sampling,
    )
