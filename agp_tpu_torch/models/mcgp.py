"""MCGP: the Monte-Carlo GP, its posterior held as samples of the latent
values at the training inputs: the counterpart of
``agp_tpu/models/mcgp.py``.

``sample`` runs every chain of blocked Gibbs sampling at once (the chains
a leading tensor axis), or dispatches to NUTS or HMC for an
``HMCSampling`` model; on a mesh, each process runs its share of the
chains.  ``predict_f_samples`` pushes samples through the
predictive mean map k* K^-1 f, and ``proba_y_mc`` averages the link over
them.  All dense N x N algebra runs at full FP32 (cuSOLVER and cuBLAS on
the card) and no kernel of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import jitter
from ..inference.config import GibbsSampling, InferenceConfig
from ..kernels import batch_gram
from ..likelihoods.base import Likelihood
from ..likelihoods.multiclass import MultiClassLikelihood
from ..means import PriorMean, ZeroMean
from ..ops import linalg
from ..utils.tensors import Params
from .base import as_2d, check_card_dtype, check_implemented, match_dtype, model_repr
from .svgp import _check_ported, _place


@dataclasses.dataclass(frozen=True, repr=False)
class MCGP(Params):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    train_x: torch.Tensor  # [N, D]
    train_y: torch.Tensor
    inference: InferenceConfig
    n_latent: int = 1

    is_sparse = False
    is_multioutput = False
    is_online = False

    @classmethod
    def create(cls, X, y, kernel, likelihood, inference=None, mean=None):
        """The model on (X, y), the labels treated by the likelihood, with
        ``GibbsSampling()`` by default.  X without a device goes to
        ``config.default_device()``, y to X's device; the kernel's, the
        likelihood's and the mean's parameters to X's device and dtype.  X
        on a CUDA device that is neither float32 nor float64 raises
        ``TypeError``, as for the other models (the samplers run no kernel
        of the port)."""
        inference = GibbsSampling() if inference is None else inference
        _check_ported(kernel, likelihood, mean, None)
        check_implemented(likelihood, inference)
        X = as_2d(X)
        check_card_dtype(X.device, X.dtype)
        y, likelihood = likelihood.treat_labels(y)
        y = match_dtype(y.to(X.device), X)
        n_latent = likelihood.n_latent
        mean = ZeroMean() if mean is None else mean
        kernel, likelihood, mean = _place(kernel, likelihood, mean, n_latent, X)
        return cls(kernel=kernel, likelihood=likelihood, mean=mean, train_x=X, train_y=y, inference=inference,
                   n_latent=n_latent)

    @property
    def Z(self):
        """The training inputs as [L, N, D] (a view)."""
        return self.train_x.expand((self.n_latent,) + self.train_x.shape)

    __repr__ = model_repr


def _default_generator(model, generator):
    """``generator``, or one seeded 0 on the model's device (the
    reference's default key is PRNGKey(0))."""
    return torch.Generator(device=model.train_x.device).manual_seed(0) if generator is None else generator


def prior_chol(model) -> torch.Tensor:
    """[L, N, N] Cholesky factors of the prior K + jitter I over the
    training inputs (the jitter ladder's rungs factored lazily: one host
    read)."""
    K = batch_gram(model.kernel, model.train_x)
    return linalg.safe_cholesky(K, jitter(K.dtype), lazy_rungs=True)


def sample(model: MCGP, n_samples: int, generator=None, n_chains: int = 1, mesh=None):
    """Posterior samples of f: Gibbs for a ``GibbsSampling`` model, NUTS or
    HMC for an ``HMCSampling`` one (its ``algorithm``).  Returns
    [n_chains, n_samples, L, N], the chain axis squeezed when n_chains is
    1.  ``generator`` (on the model's device; seed 0 when None) makes
    every draw.

    With ``mesh`` (a ``parallel.mesh.Mesh``) the chains are split over its
    data axis (the reference's chain-parallel Gibbs): each process runs
    its n_chains / n chains from its own ``generator`` (default seeded by
    its data index), with no collective in a sweep, and the kept samples
    are all-gathered in the axis's order at the end: process i's block is
    the one-process ``sample`` with its generator and n_chains / n chains.
    Every process must call it alike."""
    if mesh is not None and mesh.data.size > 1:
        axis = mesh.data
        if n_chains % axis.size:
            raise ValueError(f"{n_chains} chains do not split over a data axis of {axis.size} processes")
        if generator is None:
            generator = torch.Generator(device=model.train_x.device).manual_seed(axis.rank)
        own = n_chains // axis.size
        kept = sample(model, n_samples, generator, own)
        return torch.cat(axis.all_gather((kept[None] if own == 1 else kept).contiguous()))
    generator = _default_generator(model, generator)
    inf = model.inference
    if inf.name == "HMCSampling":
        from ..inference import hmc

        if getattr(inf, "algorithm", "nuts") == "nuts":
            return hmc.sample_nuts(model, n_samples, generator=generator, n_chains=n_chains,
                                   max_depth=getattr(inf, "max_depth", 8))
        return hmc.sample_hmc(model, n_samples, generator=generator, n_chains=n_chains)
    kept = _gibbs_chains(model, generator, n_samples, inf.n_burnin, inf.thinning, n_chains)
    return kept[:, 0] if n_chains == 1 else kept.movedim(1, 0)


def gibbs_setup(model):
    """The chains' shared matrices: {"L_K", "K_inv"}, each [L, N, N]."""
    L_K = prior_chol(model)
    return {"L_K": L_K, "K_inv": linalg.chol_inv(L_K)}


def _gibbs_chains(model, generator, n_samples, n_burnin, thinning, n_chains):
    """Every Gibbs chain at once: [n_samples, C, L, N]."""
    from ..inference.gibbs import run_chain

    local0 = model.likelihood.init_local_vars(model.train_x.shape[0], model.train_x.dtype, model.train_x.device)
    kept, _, _ = run_chain(model, gibbs_setup(model), generator, n_samples, n_burnin, thinning, local0,
                           n_chains=n_chains)
    return kept


@linalg._highest_precision
def predict_f_samples(model: MCGP, samples, X_test):
    """The samples pushed through the predictive mean map k* K^-1 f:
    samples [S, L, N] -> [S, L, n*]."""
    L_K = prior_chol(model)
    k_star = batch_gram(model.kernel, as_2d(X_test, like=model.train_x), model.train_x)  # [L, n, N]
    proj = linalg.chol_solve(L_K, k_star.mT).mT
    return torch.einsum("lnm,slm->sln", proj, samples)


def proba_y_mc(model: MCGP, samples, X_test):
    """The Monte Carlo predictive: the link's mean (and variance, where
    the likelihood gives one) over the samples pushed to X_test,
    deterministic given the samples.  Multiclass: [n, K]."""
    f_pred = predict_f_samples(model, samples, X_test)  # [S, L, n]
    lik = model.likelihood
    if isinstance(lik, MultiClassLikelihood):
        return torch.mean(lik.link(f_pred.movedim(1, 0)), dim=1).T
    if lik.n_latent == 1:
        vals = lik.compute_proba(f_pred[:, 0], torch.zeros_like(f_pred[:, 0]))
        if isinstance(vals, tuple):
            return torch.mean(vals[0], dim=0), torch.mean(vals[1], dim=0)
        return torch.mean(vals, dim=0)
    raise NotImplementedError(f"proba_y_mc does not take {type(lik).__name__}")
