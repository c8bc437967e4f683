"""Model helpers: the counterpart of ``agp_tpu/models/base.py``."""
from __future__ import annotations

import torch

from .. import kernels as K
from .. import means as Mn


def check_implemented(likelihood, inference) -> None:
    """Compatibility gate between a likelihood and an inference engine."""
    if inference.name not in type(likelihood).implemented():
        raise ValueError(
            f"{type(likelihood).__name__} is not implemented/compatible with "
            f"{inference.name}"
        )


def prepare_components(kernel, likelihood, mean, n_latent):
    """Replicate the kernel's and the mean's fields over the latent axis."""
    return K.replicate(kernel, n_latent), Mn.replicate(Mn.as_mean(mean), n_latent)


def as_2d(X, obsdim: int = 1) -> torch.Tensor:
    """Coerce inputs to [N, D].  obsdim=2: columns are observations."""
    X = torch.as_tensor(X)
    if X.ndim == 1:
        X = X[:, None]
    elif obsdim == 2:
        X = X.T
    return X


def match_dtype(y, X) -> torch.Tensor:
    """Cast float labels to the input dtype (label treatment works in
    float64 on the host)."""
    y = torch.as_tensor(y)
    if y.is_floating_point() and y.dtype != X.dtype:
        y = y.to(X.dtype)
    return y
