"""Inducing-point selection: the counterpart of ``agp_tpu/inducing``."""
from .algorithms import (
    GreedyVariance,
    KmeansAlg,
    OIPS,
    RandomSubset,
    StreamKmeans,
    UniGrid,
    UniGridOnline,
    Webscale,
    inducingpoints,
)

__all__ = [
    "GreedyVariance",
    "KmeansAlg",
    "OIPS",
    "RandomSubset",
    "StreamKmeans",
    "UniGrid",
    "UniGridOnline",
    "Webscale",
    "inducingpoints",
]
