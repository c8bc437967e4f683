"""The training state: the counterpart of ``TrainState`` and
``init_var_posterior`` in ``agp_tpu/training/state.py``.

Per-latent quantities are stacked on a leading latent axis L:
  eta1 [L, M]      first natural parameter Sigma^-1 mu
  eta2 [L, M, M]   second natural parameter -1/2 Sigma^-1 (init -1/2 I)
  mu [L, M], Sigma [L, M, M]   moment parameters
An online model's state also carries ``previous``, the posterior of the
batch before (models/online_svgp.py); a multi-output model's the mixing
matrix's optimiser state ``A_state`` (models/multioutput.py); a
Student-t process's the inverse-Gamma scale of each latent
``prior_state`` (models/vstp.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..utils.tensors import Params


@dataclasses.dataclass(frozen=True)
class TrainState(Params):
    # variational posterior (natural + moment parameterizations)
    eta1: Any = None
    eta2: Any = None
    mu: Any = None
    Sigma: Any = None
    # likelihood local variables (augmentation E-step state)
    local_vars: Any = None
    # optimiser state of the stochastic natural-gradient steps
    opt_state: Any = None
    # optimiser states of the hyperparameter groups {"kernel", "mean"[, "Z"]}
    # (training/autotuning.py), None for fixed hyperparameters
    hyper_state: Any = None
    # cached kernel matrices {"L_K", "K_inv", "L_inv"}, each [L, M, M]
    # (a full model: {"L_K", "K_inv"} over its training inputs, [L, N, N])
    kmat: Any = None
    # minibatch scaling rho = N / batchsize
    rho: Any = None
    # iteration counter
    step: Any = None
    # exact GP: alpha = (K + sigma^2 I)^-1 (y - mu0) [N] and the Cholesky
    # factor of K + sigma^2 I [N, N]
    alpha: Any = None
    chol_Sigma: Any = None
    # online (streaming) model: the previous batch's posterior,
    # {"invDa" [L, Mc, Mc], "prev_eta1" [L, Mc], "prev_L_a" [L]}
    previous: Any = None
    # multi-output model (MOSVGP, MOVGP): the mixing matrix A's optimiser
    # state, None when A is fixed
    A_state: Any = None
    # Student-t process (VStP): the inverse-Gamma scale of each latent,
    # {"l2" [L] (its beta), "chi" [L] (E[1/s])}
    prior_state: Any = None


def init_var_posterior(n_latent: int, M: int, dtype=torch.float32, device=None):
    """eta2 = -1/2 I, Sigma = I, mu = eta1 = 0."""
    eye = torch.eye(M, dtype=dtype, device=device).expand(n_latent, M, M).clone()
    return dict(
        eta1=torch.zeros((n_latent, M), dtype=dtype, device=device),
        eta2=-0.5 * eye,
        mu=torch.zeros((n_latent, M), dtype=dtype, device=device),
        Sigma=eye,
    )
