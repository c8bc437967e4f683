"""AnalyticVI / AnalyticSVI: blockwise CAVI with natural-gradient updates,
the counterpart of ``agp_tpu/inference/analytic_vi.py``.

One CAVI iteration:

  kernel matrices -> (kappa, Ktilde) -> mean_f/var_f -> likelihood E-step ->
  natural gradient -> eta -> (mu, Sigma)

Update equations:
  sparse: d_eta1 = kappa^T (rho gmu) + K^-1 mu0 - eta1
          d_eta2 = -(rho kappa^T Diag(gs) kappa + K^-1/2) - eta2
  stochastic: eta += RobbinsMonro-scaled d_eta; else eta += d_eta.
  dense (VGP, Z = X): eta1 = gmu + K^-1 mu0, eta2 = -(Diag(gs) + K^-1/2),
          the latent moments being mu and diag(Sigma) themselves.

A dense model runs no CUDA kernel of the port, as the reference's reaches
no Pallas kernel: its gram, factorizations and solves are plain PyTorch
(cuSOLVER and cuBLAS on the card) at full FP32.

Dispatch, for a sparse, not online model with a squared-exponential or
Matern kernel (``kernels.FUSED_KINDS``); each function of
``ops/cuda_kernels.py`` is its CUDA kernel on a CUDA tensor and its plain
version on a CPU tensor:

* fused when it fits: when ``cuda_kernels.fused_fits`` holds for the
  model's (latents, D, M) and dtype (float32, M <= 128, any D), an
  unweighted batch takes
  one fused statistics pass: ``fused_cavi_stats`` for the eight
  single-latent likelihoods it covers, ``fused_cavi_stats_multiclass``
  for the logistic-softmax one, ``fused_cavi_stats_het`` for the
  heteroscedastic one;
* else a split pair around the likelihood's own ``local_updates`` and
  gradients, as the reference lays it out:
  - one latent: ``latent_moments`` takes ``fused_kappa`` (kappa, Ktilde),
    then mf = kappa mu and vf = Ktilde + rowsum((kappa Sigma) o kappa) by
    plain products, and ``apply_natural_gradient`` takes ``cavi_stats``;
  - several latents: ``latent_moments`` takes
    ``fused_kappa_moments_batched`` (kappa, mf, vf) and
    ``apply_natural_gradient`` ``cavi_stats_batched``.
  So do every row-weighted batch, ``elbo`` and the hyperparameter step,
  whose gradient runs through the kappa kernel's ``autograd.Function``,
  and every float64 model on the card: the fused passes are float32-only,
  and kernels 4-7 take float64 in a form of their own (the launch counts
  show which ran: ``launches`` or ``launches_f64``).  On the CPU the
  wrappers run their plain versions in any dtype, and a float64 model
  takes the float32 route (``_route_dtype``).

Any other kernel (a sum, a product, a kernel over transformed inputs, the
rest of ``kernels.py``) takes the reference's plain branch: its own gram
and kappa = Knm K^-1 by plain products (``_plain_moments``), gradients by
autograd through them; the statistics stay on ``cavi_stats`` (one latent)
or ``cavi_stats_batched`` (several).

The reference's TPU shape gates (``_pallas_kind_batched``: M >= 512,
B >= 16,384; ``_pallas_kind_kappa_only``: forced only) are not carried
over.  The reference runs its single-latent fused kernel up to M=512 (its
VMEM holds K^-1 and Sigma there); here one latent beyond the fused range
takes the single-latent split pair.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..config import jitter
from ..kernels import batch_diag, batch_gram, batch_gram_zz, fused_kind, latent, lengthscale_2d
from ..likelihoods.classification import BayesianSVM, LogisticLikelihood
from ..likelihoods.event import NegBinomialLikelihood, PoissonLikelihood
from ..likelihoods.heteroscedastic import HeteroscedasticLikelihood
from ..likelihoods.multiclass import LogisticSoftMaxLikelihood
from ..likelihoods.regression import GaussianLikelihood, LaplaceLikelihood, Matern32Likelihood, StudentTLikelihood
from ..means import batch_call
from ..models.vstp import local_prior_updates
from ..ops import cuda_kernels, linalg
from ..ops.kl import gaussian_kl
from ..ops.quadrature import expectation
from ..ops.special import safe_expcosh
from ..training.state import TrainState
from ..utils.batch_sums import batch_sum
from ..utils.opt import ascent_update


# --------------------------------------------------------------- kernel mats
@linalg._highest_precision
def compute_kmat(model, X=None, inverse: bool = True) -> Dict[str, torch.Tensor]:
    """Cholesky factor "L_K", inverse "K_inv" and, for a sparse model,
    triangular inverse "L_inv" of the prior covariance over the inducing
    inputs Z [L, M, D], or over the training inputs X [N, D] for a full
    model.  A full model holds no L_inv, as the reference holds none: only
    the sparse kernels read it, and at [L, N, N] it would cost an N^3 solve
    and half as much memory again.  ``inverse=False`` leaves out K_inv
    too (the dense hyperparameter step's ELBO reads L_K alone)."""
    if model.is_sparse:
        K = batch_gram_zz(model.kernel, model.Z)
        L_K = linalg.safe_cholesky(K, jitter(K.dtype))
    else:
        K = batch_gram(model.kernel, X)
        L_K = linalg.safe_cholesky(K, jitter(K.dtype), lazy_rungs=True)
    out = {"L_K": L_K}
    if inverse:
        out["K_inv"] = linalg.chol_inv(L_K)
    if model.is_sparse:
        eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand(K.shape)
        out["L_inv"] = torch.linalg.solve_triangular(L_K, eye, upper=False)
    return out


def kmat_l_inv(kmat):
    """kmat["L_inv"], computed from L_K when absent."""
    if "L_inv" in kmat:
        return kmat["L_inv"]
    L_K = kmat["L_K"]
    eye = torch.eye(L_K.shape[-1], dtype=L_K.dtype, device=L_K.device).expand(L_K.shape)
    return torch.linalg.solve_triangular(L_K, eye, upper=False)


def _pair_kind(model):
    """Gram kind when the step's moments and statistics take the batched
    pair: a sparse, not online model with a kernel of ``FUSED_KINDS``."""
    if not model.is_sparse or model.is_online:
        return None
    return fused_kind(model.kernel)


def latent_moments(model, state: TrainState, x, kmat):
    """mean_f/var_f [L, B] of the latent function at the batch, and kappa
    [L, B, M]: by ``cuda_kernels.fused_kappa`` and plain products for one
    latent, by ``cuda_kernels.fused_kappa_moments_batched`` for several;
    for a kernel outside ``FUSED_KINDS`` by plain products
    (``_plain_moments``).
    Differentiable in the kernel's parameters, Z and the kmat.  A full
    model's are mu and diag(Sigma) over its training inputs, kappa None; an
    online model's are plain products over its masked slots
    (``models/online_svgp.py::latent_moments``)."""
    if not model.is_sparse:
        return state.mu, torch.diagonal(state.Sigma, dim1=-2, dim2=-1), None
    if model.is_online:
        from ..models import online_svgp

        return online_svgp.latent_moments(model, state, x, kmat)
    kind = _pair_kind(model)
    if kind is None:
        return _plain_moments(model, state, x, kmat)
    if model.n_latent == 1:
        kappa, ktilde = cuda_kernels.fused_kappa(
            x.contiguous(),
            model.Z[0].contiguous(),
            kmat_l_inv(kmat)[0].mT,
            model.kernel.lengthscale[0],
            model.kernel.variance[0],
            jitter(x.dtype),
            kind,
        )
        mu_f, var_f = _single_moments(kappa, ktilde, state.mu[0], state.Sigma[0])
        return mu_f[None], var_f[None], kappa[None]
    kappa, mu_f, var_f = cuda_kernels.fused_kappa_moments_batched(
        x.contiguous(),
        model.Z.contiguous(),
        kmat_l_inv(kmat).mT,
        lengthscale_2d(model.kernel, x.shape[-1]),
        model.kernel.variance,
        state.mu.contiguous(),
        state.Sigma.contiguous(),
        jitter(x.dtype),
        kind,
    )
    return mu_f, var_f, kappa


@linalg._highest_precision
def _plain_moments(model, state: TrainState, x, kmat):
    """(mean_f, var_f, kappa) of a kernel outside ``FUSED_KINDS``, the
    reference's plain branch: the kernel's own gram Knm [L, B, M], kappa =
    Knm K^-1 by a matmul at full FP32 (outside any kernel in the reference
    too), Ktilde = diag + jitter - rowsum(kappa o Knm) clamped at 1e-12,
    mf = kappa mu and vf = Ktilde + rowsum((kappa Sigma) o kappa), vf not
    clamped (the reference clamps it only after its fused kappa).  The
    statistics that follow stay on kernels 7 and 5."""
    K_inv = kmat["K_inv"]
    if model.n_latent == 1:
        kernel = latent(model.kernel, 0)
        Knm = kernel.gram(x, model.Z[0])  # [B, M]
        kappa = Knm @ K_inv[0]
        ktilde = torch.clamp(kernel.diag(x) + jitter(Knm.dtype) - torch.sum(kappa * Knm, dim=1), min=1e-12)
        mu_f = kappa @ state.mu[0]
        var_f = ktilde + torch.sum((kappa @ state.Sigma[0]) * kappa, dim=1)
        return mu_f[None], var_f[None], kappa[None]
    Knm = batch_gram(model.kernel, x, model.Z)  # [L, B, M]
    kappa = Knm @ K_inv
    ktilde = batch_diag(model.kernel, x) + jitter(Knm.dtype) - linalg.diag_ABt(kappa, Knm)
    ktilde = torch.clamp(ktilde, min=1e-12)
    mu_f = (kappa @ state.mu.unsqueeze(-1)).squeeze(-1)
    var_f = ktilde + linalg.diag_ABt(kappa @ state.Sigma, kappa)
    return mu_f, var_f, kappa


@linalg._highest_precision
def _single_moments(kappa, ktilde, mu, Sigma):
    """mf = kappa mu and vf = max(Ktilde + rowsum((kappa Sigma) o kappa),
    1e-12) [B] at full FP32, outside the kernel, as the reference forms
    them after its fused_kappa."""
    return kappa @ mu, torch.clamp(ktilde + torch.sum((kappa @ Sigma) * kappa, dim=-1), min=1e-12)


def _fused_lik_spec(lik):
    """(lik, p0, p1, c_key) of ``fused_cavi_stats`` for a single-latent
    likelihood, or None; c_key names the local variable the kernel's c
    fills (None: theta only)."""
    if isinstance(lik, LogisticLikelihood):
        return "logistic", 0.0, 0.0, "c"
    if isinstance(lik, GaussianLikelihood) and lik.opt_noise is None:
        # a learnt noise takes the split pair: its step sums over the batch
        return "gaussian", lik.sigma2, 0.0, None
    if isinstance(lik, StudentTLikelihood):
        return "studentt", lik.nu, lik.sigma**2, "c"
    if isinstance(lik, LaplaceLikelihood):
        return "laplace", lik.a, 0.0, "b"
    if isinstance(lik, BayesianSVM):
        return "bayesiansvm", 0.0, 0.0, "c"
    if isinstance(lik, Matern32Likelihood):
        return "matern32", lik.rho, 0.0, "c"
    if isinstance(lik, NegBinomialLikelihood):
        return "negbinomial", lik.r, 0.0, "c"
    if isinstance(lik, PoissonLikelihood):
        # lam is read by the kernel and rewritten by the step's epilogue
        return "poisson", lik.lam, 0.0, "c"
    return None


def _route_dtype(model):
    """The dtype the fused dispatch is decided for: the model's on a CUDA
    device, where the fused kernels 1-3 take float32 alone (a float64
    model there takes the split pairs, kernels 4-7's float64 form);
    float32 on the CPU, where every wrapper runs its plain version in any
    dtype, so that a float64 CPU run replays the card's float32 route (the
    port's parity tests against the reference)."""
    return model.Z.dtype if model.Z.device.type == "cuda" else torch.float32


def _fused_spec(model):
    """(kind, lik, p0, p1, c_key) when the step takes the fused statistics
    pass: single-latent sparse model, a shape and dtype within
    ``fused_fits`` (``_route_dtype``: a float64 model on the card takes the
    split pair), a kernel of ``FUSED_KINDS`` and a likelihood of
    ``_fused_lik_spec``.  No other shape gate: the reference's were
    measured on a TPU."""
    if model.n_latent != 1 or not model.is_sparse or model.is_online:
        return None
    if not cuda_kernels.fused_fits(1, model.Z.shape[-1], model.n_inducing, _route_dtype(model)):
        return None
    kind = fused_kind(model.kernel)
    lik = _fused_lik_spec(model.likelihood)
    if kind is None or lik is None:
        return None
    return (kind, *lik)


def _fused_multi_kind(model, likelihood_type, n_latent_ok):
    """Kernel kind when the step takes a fused multi-latent pass: sparse,
    not online, not multi-output, a likelihood of ``likelihood_type``, a
    shape and dtype within ``fused_fits`` (``_route_dtype``: a float64
    model on the card takes the batched pair).  No other shape gate (the
    reference's were measured on a TPU)."""
    if (
        n_latent_ok(model.n_latent)
        and model.is_sparse
        and not model.is_online
        and not model.is_multioutput
        and isinstance(model.likelihood, likelihood_type)
        and cuda_kernels.fused_fits(model.n_latent, model.Z.shape[-1], model.n_inducing, _route_dtype(model))
    ):
        return fused_kind(model.kernel)
    return None


def _fused_mc_spec(model):
    """Kernel kind when the step takes the fused multiclass
    (logistic-softmax) pass."""
    return _fused_multi_kind(model, LogisticSoftMaxLikelihood, lambda n: n > 1)


def _fused_het_spec(model):
    """Kernel kind when the step takes the fused heteroscedastic pass (2
    latents)."""
    return _fused_multi_kind(model, HeteroscedasticLikelihood, lambda n: n == 2)


def _fused_multi_args(model, state, x, y):
    """The arguments the multi-latent fused passes share, as they take
    them: dense operands, [L, D] lengthscales, the [L] variances, the
    jitter and rho."""
    return (
        x.contiguous(),
        y.contiguous(),
        model.Z.contiguous(),
        kmat_l_inv(state.kmat).mT,
        state.mu.contiguous(),
        state.Sigma.contiguous(),
        lengthscale_2d(model.kernel, x.shape[-1]),
        model.kernel.variance,
        jitter(x.dtype),
        state.rho,
    )


def _fused_scaled_inputs(model, x):
    """(x', Z', ls) for the fused pass.  An isotropic lengthscale passes
    through; an ARD ([D]) lengthscale is folded into the coordinates
    (x/ls, Z/ls, with ls = 1 in the kernel)."""
    ls0 = model.kernel.lengthscale[0]  # strip the [L=1] latent axis
    if ls0.ndim == 0:
        return x, model.Z[0], ls0
    return x / ls0, model.Z[0] / ls0, torch.ones((), dtype=x.dtype, device=x.device)


# ----------------------------------------------------------------- CAVI step
def variational_update(model, state: TrainState, x, y, w=None, fused=None):
    """One blockwise coordinate-ascent update (E-step + natural gradient +
    global update); returns (model, state).

    ``w`` ([B] of 0/1, optional) zero-weights rows out of every cross-batch
    statistic; a weighted batch takes the unfused path.  ``fused`` None
    takes the dispatch above; False the split pair whatever the shape;
    True kernel 1's fused pass, and ``ValueError`` when it cannot take the
    model or the batch is weighted.  A Student-t process (``is_tprior``)
    first updates its prior's scale
    (``models/vstp.py::local_prior_updates``).  Every sum over the batch
    goes through ``utils.batch_sums.batch_sum``, so that a sharded step
    sums it over its processes."""
    kmat = state.kmat
    if getattr(model, "is_tprior", False):
        state = local_prior_updates(model, state, x)
    unweighted = w is None and fused is not False
    spec = _fused_spec(model) if unweighted else None
    if fused and spec is None:
        raise ValueError(
            "no fused statistics kernel (kernel 1) takes this step: it needs one latent, a kernel of "
            "FUSED_KINDS, a likelihood of its eight, M <= 128, float32 on the card and an unweighted batch; use "
            "fused=None or False"
        )
    if spec is not None:
        kind, lik_name, p0, p1, c_key = spec
        xs, zs, ls = _fused_scaled_inputs(model, x)
        # the kernel takes dense row-major operands (a no-op when they are)
        s1, S2, c, theta, mf, vf = cuda_kernels.fused_cavi_stats(
            xs.contiguous(),
            y.contiguous(),
            zs.contiguous(),
            kmat_l_inv(kmat)[0].T,
            state.mu[0].contiguous(),
            state.Sigma[0].contiguous(),
            ls,
            model.kernel.variance[0],
            jitter(x.dtype),
            state.rho,
            lik_p0=p0,
            lik_p1=p1,
            kind=kind,
            lik=lik_name,
        )
        c = c.to(x.dtype)
        local = dict(state.local_vars)
        local["theta"] = theta.to(x.dtype)
        if c_key in local:
            local[c_key] = c
        if lik_name == "poisson":
            # the Poisson E-step's epilogue on the kernel's moments, on the
            # device: gamma with the old lam (as the kernel used it), then
            # the rate's closed form lam <- sum y / sum E[sigma(f)]
            lik = model.likelihood
            mf, vf = mf.to(x.dtype), vf.to(x.dtype)
            local["gamma"] = lik.lam * safe_expcosh(-mf / 2.0, c / 2.0) / 2.0
            sum_y, sum_es = batch_sum(torch.sum(y), torch.sum(expectation(torch.sigmoid, mf, vf)))
            model = model.replace(likelihood=lik.replace(lam=sum_y / sum_es))
        state = _nat_update_from_stats(
            model, state.replace(local_vars=local), s1.to(x.dtype)[None], S2.to(x.dtype)[None], x
        )
        return model, state

    kind = _fused_mc_spec(model) if unweighted else None
    if kind is not None:
        s1, S2, c, theta, gamma, alpha = cuda_kernels.fused_cavi_stats_multiclass(
            *_fused_multi_args(model, state, x, y),
            state.local_vars["alpha"].contiguous(),
            state.local_vars["beta"].contiguous(),
            kind=kind,
        )
        local = dict(state.local_vars)
        local.update(c=c.to(x.dtype), theta=theta.to(x.dtype), gamma=gamma.to(x.dtype), alpha=alpha.to(x.dtype))
        state = _nat_update_from_stats(
            model, state.replace(local_vars=local), s1.to(x.dtype), S2.to(x.dtype), x
        )
        return model, state

    kind = _fused_het_spec(model) if unweighted else None
    if kind is not None:
        lik = model.likelihood
        s1, S2, c, phi, gamma, theta, sigg = cuda_kernels.fused_cavi_stats_het(
            *_fused_multi_args(model, state, x, y), lik.lam, kind=kind
        )
        phi, sigg = phi.to(x.dtype), sigg.to(x.dtype)
        local = dict(state.local_vars)
        local.update(c=c.to(x.dtype), phi=phi, gamma=gamma.to(x.dtype), theta=theta.to(x.dtype), sigg=sigg)
        # lambda's closed-form update, on the device.  The kernel's E-step
        # used the old lambda, as local_updates does; f's gradients take the
        # new one, a batch-wide sum, as a scalar factor the kernel left out.
        n, s = batch_sum(x.shape[0], torch.sum(phi * (1.0 - sigg)))
        new_lam = torch.maximum(n / (2.0 * s), lik.lam)
        model = model.replace(likelihood=lik.replace(lam=new_lam))
        scale = torch.stack([new_lam.to(x.dtype), torch.ones((), dtype=x.dtype, device=x.device)])
        s1 = s1.to(x.dtype) * scale[:, None]
        S2 = S2.to(x.dtype) * scale[:, None, None]
        state = _nat_update_from_stats(model, state.replace(local_vars=local), s1, S2, x)
        return model, state

    mu_f, var_f, kappa = latent_moments(model, state, x, kmat)
    lik, local = model.likelihood.local_updates(y, mu_f, var_f, state.local_vars, w=w)
    model = model.replace(likelihood=lik)
    gmu = lik.grad_e_mu(y, local)  # [L, B]
    gs = lik.grad_e_sigma(y, local)  # [L, B]
    if w is not None:
        gmu = gmu * w
        gs = gs * w
    state = apply_natural_gradient(model, state.replace(local_vars=local), kappa, gmu, gs, x)
    return model, state


def apply_natural_gradient(model, state: TrainState, kappa, gmu, gs, x) -> TrainState:
    """Natural-gradient + global update from the gradient expectations
    gmu/gs [L, B] and kappa [L, B, M]: sparse, the statistics by
    ``cuda_kernels.cavi_stats`` for one latent, ``cavi_stats_batched`` for
    several; dense, the coordinate-ascent optimum itself."""
    if not model.is_sparse:
        return _dense_update(model, state, gmu, gs, x)
    rho = state.rho
    g, theta = (rho * gmu).contiguous(), (rho * gs).contiguous()
    if model.n_latent == 1:
        s1, stat2 = cuda_kernels.cavi_stats(kappa[0].contiguous(), g[0], theta[0])
        return _nat_update_from_stats(model, state, s1[None], stat2[None], x)
    s1, stat2 = cuda_kernels.cavi_stats_batched(kappa, g, theta)
    return _nat_update_from_stats(model, state, s1, stat2, x)


@linalg._highest_precision
def _dense_update(model, state: TrainState, gmu, gs, x) -> TrainState:
    """eta1 = gmu + K^-1 mu0 and eta2 = -(Diag(gs) + K^-1/2) over the
    training inputs [L, N], then the moments."""
    K_inv = prior_precision(model, state)
    mu0 = prior_mean_stack(model, x)
    eta1 = gmu + (K_inv @ mu0.unsqueeze(-1)).squeeze(-1)
    eta2 = linalg.symmetrize(-(torch.diag_embed(gs) + 0.5 * K_inv))
    return state.replace(eta1=eta1, eta2=eta2, **_moments_kw(model, eta1, eta2))


@linalg._highest_precision
def _nat_update_from_stats(model, state: TrainState, s1, stat2, x) -> TrainState:
    """Sparse natural-gradient global update given the two cross-data
    statistics s1 = kappa^T (rho gmu) [L, M] and
    stat2 = kappa^T diag(rho gs) kappa [L, M, M], summed over the processes
    of a sharded step in one all-reduce."""
    s1, stat2 = batch_sum(s1, stat2)
    K_inv = prior_precision(model, state)
    mu0 = prior_mean_stack(model, x)
    Kinv_mu0 = (K_inv @ mu0.unsqueeze(-1)).squeeze(-1)
    nat1_target = s1 + Kinv_mu0
    nat2_target = -(stat2 + 0.5 * K_inv)
    if model.inference.stochastic:
        opt_state, (u1, u2) = ascent_update(
            model.inference.optimiser,
            state.opt_state,
            (state.eta1, state.eta2),
            (nat1_target - state.eta1, nat2_target - state.eta2),
        )
        eta1 = state.eta1 + u1
        eta2 = linalg.symmetrize(state.eta2 + u2)
        state = state.replace(opt_state=opt_state)
    else:
        eta1 = nat1_target
        eta2 = linalg.symmetrize(nat2_target)
    return state.replace(eta1=eta1, eta2=eta2, **_moments_kw(model, eta1, eta2))


def prior_precision(model, state: TrainState):
    """K^-1 [L, M, M] of the step's update; chi K^-1 for a Student-t process
    (its prior covariance is K / chi, ``models/vstp.py``)."""
    K_inv = state.kmat["K_inv"]
    if getattr(model, "is_tprior", False):
        K_inv = state.prior_state["chi"][:, None, None] * K_inv
    return K_inv


def _moments_kw(model, eta1, eta2):
    """(mu, Sigma) by the exact Cholesky path, the one the reference runs
    off-TPU.  ``linalg.nat_to_moments_warm`` is ported but not wired in: it
    reads its branch on the host every call, and a step holds no host
    read (PERF.md has its times against this path)."""
    mu, Sigma = linalg.nat_to_moments(eta1, eta2, lazy_rungs=not model.is_sparse)
    return dict(mu=mu, Sigma=Sigma)


def prior_mean_stack(model, x):
    """[L, M] prior mean over the inducing inputs (Z for a sparse model,
    zero on an online model's inactive slots; the batch x for a full
    one)."""
    if model.is_sparse:
        mu0 = batch_call(model.mean, model.Z, model.n_latent)
        return mu0 * model.z_mask if model.is_online else mu0
    return batch_call(model.mean, x, model.n_latent)


# ---------------------------------------------------------------------- ELBO
@linalg._highest_precision
def elbo(model, state: TrainState, x, y, kmat=None) -> torch.Tensor:
    """ELBO = rho E[log p(y|f,omega)] - GaussianKL - rho AugmentedKL, on the
    batch (x, y) whose local variables are in ``state``; ``kmat`` (default
    ``state.kmat``) gives the prior's matrices, so that the hyperparameter
    step differentiates through kernel matrices made from its parameters.
    The augmented KL is left out of the gradient, as the reference does.
    An online model's ELBO also subtracts the streaming extra KL, made with
    the same ``kmat``.  A Student-t process's KL takes its prior covariance
    K / chi: the Cholesky factor L_K / sqrt(chi)."""
    kmat = state.kmat if kmat is None else kmat
    mu_f, var_f, _ = latent_moments(model, state, x, kmat)
    rho = state.rho if model.is_sparse else torch.ones((), dtype=mu_f.dtype, device=mu_f.device)
    tot = rho * model.likelihood.expec_loglik(y, mu_f, var_f, state.local_vars)
    mu0 = prior_mean_stack(model, x)
    L_K = kmat["L_K"]
    if getattr(model, "is_tprior", False) and state.prior_state is not None:
        L_K = L_K / torch.sqrt(state.prior_state["chi"])[:, None, None]
    kl = torch.stack([gaussian_kl(state.mu[l], mu0[l], state.Sigma[l], L_K[l]) for l in range(model.n_latent)])
    tot = tot - torch.sum(kl)
    tot = tot - (rho * model.likelihood.aug_kl(state.local_vars, y)).detach()
    if getattr(model, "is_online", False) and state.previous is not None:
        from ..models import online_svgp

        tot = tot - online_svgp.online_extra_kl(model, state, kmat)
    return tot
