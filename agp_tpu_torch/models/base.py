"""Model helpers: the counterpart of ``agp_tpu/models/base.py``."""
from __future__ import annotations

import torch

from .. import kernels as K
from .. import means as Mn
from ..config import default_device


def check_implemented(likelihood, inference) -> None:
    """Compatibility gate between a likelihood and an inference engine."""
    if inference.name not in type(likelihood).implemented():
        raise ValueError(
            f"{type(likelihood).__name__} is not implemented/compatible with "
            f"{inference.name}"
        )


# the dtypes a model runs in on the card: float32 everywhere; float64 on
# kernels 4-7's float64 form (a sparse model; the fused kernels 1-3 are
# float32-only, so it takes the split pairs) and in the models that run no
# kernel of the port (the exact GP, the VGP, the VStP, the MCGP and the
# samplers), as the reference runs every model under x64
CARD_DTYPES = (torch.float32, torch.float64)


def check_card_dtype(device, dtype, what: str = "model") -> None:
    """Refuse, when it is built, a model or data on a CUDA device in a
    dtype for which the port has no path there (float16, bfloat16: no
    kernel of the port and none of its dense algebra takes them), which
    would raise at its first step.  float32 and float64 pass
    (``CARD_DTYPES``).  Raises ``TypeError`` naming the ways out."""
    if torch.device(device).type == "cuda" and dtype not in CARD_DTYPES:
        raise TypeError(
            f"the {what} is {dtype} on {device}, and the port runs float32 or float64 on the card: "
            "use float32 or float64 there, or run on the CPU "
            '(CPU tensors, or agp_tpu_torch.config.set_default_device("cpu") for arrays without a device)'
        )


def prepare_components(kernel, likelihood, mean, n_latent):
    """Replicate the kernel's and the mean's fields over the latent axis."""
    return K.replicate(kernel, n_latent), Mn.replicate(Mn.as_mean(mean), n_latent)


def to_tensor(a, like: torch.Tensor | None = None) -> torch.Tensor:
    """A tensor stays as it is.  An array without a device (numpy, a list)
    goes to ``like``'s device, floating values in its dtype; without
    ``like``, to ``config.default_device()``, floating values in torch's
    default dtype (as the reference's arrays take JAX's default float)."""
    if isinstance(a, torch.Tensor):
        return a
    t = torch.as_tensor(a)
    device = default_device() if like is None else like.device
    dtype = (torch.get_default_dtype() if like is None else like.dtype) if t.is_floating_point() else t.dtype
    return t.to(device=device, dtype=dtype)


def as_2d(X, obsdim: int = 1, like: torch.Tensor | None = None) -> torch.Tensor:
    """Coerce inputs to [N, D] (placed as ``to_tensor`` places them).
    obsdim=2: columns are observations."""
    X = to_tensor(X, like)
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


def model_repr(model) -> str:
    """A model's compact summary: its name, likelihood, inference engine,
    latent count and, for a sparse model, its inducing count."""
    parts = []
    lik = getattr(model, "likelihood", None)
    if lik is not None:
        parts.append(f"likelihood={type(lik).__name__}")
    inf = getattr(model, "inference", None)
    if inf is not None:
        parts.append(f"inference={inf.name}")
    parts.append(f"n_latent={model.n_latent}")
    if getattr(model, "is_sparse", False):
        parts.append(f"n_inducing={model.n_inducing}")
    return f"{type(model).__name__}({', '.join(parts)})"
