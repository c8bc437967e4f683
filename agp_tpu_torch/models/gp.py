"""GP: exact Gaussian-process regression with a Gaussian likelihood, the
counterpart of ``agp_tpu/models/gp.py``.

The posterior is kept as alpha = (K + sigma^2 I)^-1 (y - mu0) and the
Cholesky factor of Sigma = K + sigma^2 I, refreshed once an iteration by
``analytic_update``, which also takes one step of the noise's closed-form
gradient when the likelihood learns its noise.  Everything is N x N dense
algebra at full FP32 (cuSOLVER and cuBLAS on the card); no CUDA kernel of
the port runs, as no Pallas kernel runs in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from ..inference.config import Analytic
from ..kernels import batch_gram, to_unconstrained
from ..likelihoods.regression import GaussianLikelihood
from ..means import PriorMean, ZeroMean, batch_call
from ..ops import linalg
from ..training.state import TrainState
from ..utils.opt import adam, ascent_update, init_on
from ..utils.tensors import Params, path_leaves
from .base import as_2d, check_card_dtype, match_dtype, model_repr
from .svgp import _check_ported, _place


@dataclasses.dataclass(frozen=True, repr=False)
class GP(Params):
    kernel: Any
    likelihood: GaussianLikelihood
    mean: PriorMean
    train_x: torch.Tensor  # [N, D]
    train_y: torch.Tensor  # [N]
    inference: Analytic
    n_latent: int = 1
    atfrequency: int = 1
    optimiser: Optional[Any] = None

    is_sparse = False
    is_multioutput = False
    is_online = False

    @classmethod
    def create(cls, X, y, kernel, noise: float = 1e-1, opt_noise=True, mean=None, optimiser="default",
               atfrequency: int = 1):
        """The exact GP on (X, y).  ``opt_noise`` as
        ``GaussianLikelihood.create`` takes it (True: ``adam(0.05)`` on log
        sigma^2); ``optimiser`` learns the kernel's log parameters and the
        mean's ("default": ``adam(0.01)``, None: fixed).  X without a
        device goes to ``config.default_device()``, y to X's device in X's
        dtype; X on a CUDA device that is neither float32 nor float64 raises
        ``TypeError`` (the GP runs no kernel of the port)."""
        if optimiser == "default":
            optimiser = adam(0.01)
        likelihood = GaussianLikelihood.create(noise, opt_noise=opt_noise)
        _check_ported(kernel, likelihood, mean, optimiser)
        X = as_2d(X)
        check_card_dtype(X.device, X.dtype)
        y = match_dtype(torch.as_tensor(y).to(X.device), X)
        mean = ZeroMean() if mean is None else mean
        kernel, likelihood, mean = _place(kernel, likelihood, mean, 1, X)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            train_x=X,
            train_y=y,
            inference=Analytic(),
            optimiser=optimiser,
            atfrequency=atfrequency,
        )

    def init_state(self) -> TrainState:
        """alpha = 0, chol_Sigma = I, the noise rule's and the
        hyperparameter rules' states, on the data's device and dtype."""
        check_card_dtype(self.train_x.device, self.train_x.dtype)
        N = self.train_x.shape[0]
        dtype, device = self.train_x.dtype, self.train_x.device
        local = {}
        if self.likelihood.opt_noise is not None:
            local["state_sigma2"] = self.likelihood.opt_noise.init(torch.zeros((), dtype=dtype, device=device))
        hyper_state = None
        if self.optimiser is not None:
            hyper_state = {
                "kernel": init_on(self.optimiser, path_leaves(to_unconstrained(self.kernel)), device),
                "mean": init_on(self.optimiser, self.mean.leaves(), device),
            }
        return TrainState(
            alpha=torch.zeros((N,), dtype=dtype, device=device),
            chol_Sigma=torch.eye(N, dtype=dtype, device=device),
            local_vars=local,
            hyper_state=hyper_state,
            step=torch.zeros((), dtype=torch.int32, device=device),
            rho=torch.ones((), dtype=dtype, device=device),
        )

    __repr__ = model_repr


def noisy_chol(model: GP, kernel=None) -> torch.Tensor:
    """The Cholesky factor of Sigma = K + sigma^2 I over the training inputs
    (``kernel`` in the model's place when given), with no jitter ladder:
    sigma^2 regularizes the diagonal."""
    K = batch_gram(model.kernel if kernel is None else kernel, model.train_x)[0]
    return linalg.cholesky_or_nan(K + model.likelihood.sigma2 * torch.eye(K.shape[0], dtype=K.dtype, device=K.device))


@linalg._highest_precision
def analytic_update(model: GP, state: TrainState):
    """alpha = Sigma^-1 (y - mu0) with Sigma = K + sigma^2 I; with noise
    learning, one ascent step of the noise's rule on log sigma^2 along
    sigma^2 (|alpha|^2 - tr(Sigma^-1)) / 2, tr(Sigma^-1) from the full
    inverse as the reference forms it.  Returns (model, state); nothing is
    read back to the host."""
    L = noisy_chol(model)
    mu0 = batch_call(model.mean, model.train_x, 1)[0]
    alpha = linalg.chol_solve(L, model.train_y - mu0)
    local = dict(state.local_vars)
    lik = model.likelihood
    if lik.opt_noise is not None:
        g = (torch.sum(alpha**2) - torch.diagonal(linalg.chol_inv(L)).sum()) / 2.0
        log_s2 = torch.log(lik.sigma2)
        local["state_sigma2"], delta = ascent_update(lik.opt_noise, local["state_sigma2"], log_s2, g * lik.sigma2)
        model = model.replace(likelihood=lik.replace(sigma2=torch.exp(log_s2 + delta)))
    return model, state.replace(alpha=alpha, chol_Sigma=L, local_vars=local)


def log_py(model: GP, state: TrainState) -> torch.Tensor:
    """The marginal log-likelihood -1/2 (y - mu0)^T Sigma^-1 (y - mu0)
    - 1/2 logdet Sigma - N/2 log 2 pi, from the state's alpha and factor."""
    y = model.train_y
    mu0 = batch_call(model.mean, model.train_x, 1)[0]
    quad = torch.sum((y - mu0) * state.alpha)
    return -0.5 * (quad + linalg.chol_logdet(state.chol_Sigma) + y.shape[0] * math.log(2 * math.pi))
