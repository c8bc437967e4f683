"""Multi-output models: MOSVGP and MOVGP, the linear model of
coregionalization, the counterparts of ``agp_tpu/models/multioutput.py``.

T tasks share Q latent GPs through a mixing matrix A [R, Q] over the
"output rows" r = (task, row of the task's likelihood), R the sum of the
tasks' ``n_latent``; its rows are unit vectors, learnt by gradient steps
and projected back after each.  Tasks may have different likelihoods (a
tuple, each with its own local variables, a list in the state).

One step (``mo_variational_update``):

  latent moments (mu_q, var_q [Q, B]) -> rows mu_r = A mu_q,
  var_r = A^2 var_q -> each task's E-step on its rows -> the rows'
  gradient expectations (gmu_r, gs_r [R, B]) mixed back onto the latents
  -> the shared natural-gradient update -> the A step.

The moments and the statistics are the sparse model's own: kernels 4 + 5
for Q > 1 latents (``fused_kappa_moments_batched``, ``cavi_stats_batched``),
kernels 6 + 7 for one (``fused_kappa``, ``cavi_stats``), or for a kernel
outside ``FUSED_KINDS`` the plain kappa and kernel 5 or 7; a multi-output
model never takes a fused pass.  The mixing, the E-steps and the A step are
plain PyTorch at full FP32.  A step reads nothing back to the host.

``mo_train``'s fast path (no callback, ``verbose < 2``) runs its CAVI
steps, and with hyperparameters to learn its iterations, through
``training/graphs.py``, the counterpart of the reference's ``_mo_steps``
scan and its ``_mo_step`` / ``_mo_hyper_step`` programs: on the card as
replays of captured CUDA graphs, kernels 4 + 5 (or 6 + 7) inside, the A
step and each task's likelihood carried from one replay to the next.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Optional, Tuple

import torch

from ..inference import analytic_vi
from ..inference.config import AnalyticVI, InferenceConfig
from ..means import PriorMean, ZeroMean
from ..ops import linalg
from ..ops.kl import gaussian_kl
from ..training import autotuning, graphs
from ..training.predictions import _chunk_map, _predict_f_var
from ..training.state import TrainState, init_var_posterior
from ..training.train import _CHUNK, _hyper_marks, _hyper_update
from ..utils.batch_sums import batch_sum
from ..utils.opt import adam, ascent_update
from ..utils.tensors import Params
from .base import as_2d, check_card_dtype, check_implemented, match_dtype, model_repr, prepare_components
from .svgp import _check_ported


@dataclasses.dataclass(frozen=True, repr=False)
class MOSVGP(Params):
    kernel: Any  # [Q]-stacked
    likelihoods: Tuple  # one per task
    mean: PriorMean  # [Q]-stacked
    Z: torch.Tensor  # [Q, M, D]
    A: torch.Tensor  # [R, Q] mixing matrix, unit-norm rows
    inference: InferenceConfig
    n_latent: int  # Q
    n_tasks: int = 1
    rows_per_task: Tuple[int, ...] = (1,)
    atfrequency: int = 1
    optimiser: Optional[Any] = None
    Zoptimiser: Optional[Any] = None
    Aoptimiser: Optional[Any] = None

    is_sparse = True
    is_multioutput = True
    is_online = False

    @classmethod
    def create(
        cls,
        kernel,
        likelihoods,
        inference,
        Z,
        n_latent: int,
        mean=None,
        optimiser="default",
        Zoptimiser=None,
        Aoptimiser="default",
        atfrequency: int = 1,
        generator=None,
    ):
        """Data-free constructor; data is given to ``mo_train``.  Z [M, D]
        (shared by the Q latents) or [Q, M, D]; without a device it goes to
        ``config.default_device()``, and the components follow it, as
        ``SVGP.create`` places them.  A is drawn standard normal with
        ``generator`` (on Z's device; seed 0 when None) and its rows
        normalized: the reference draws it from ``PRNGKey(0)``, so a
        default A differs between the packages (``interop`` carries one
        across).  ``optimiser`` and ``Zoptimiser`` as ``SVGP.create`` takes
        them; ``Aoptimiser`` ("default": Adam(0.01); None keeps A fixed)
        steps A after every CAVI step.

        Raises ``ValueError`` for an inference that is not AnalyticVI, as
        the reference does.  A model on a CUDA device that is neither
        float32 nor float64 raises ``TypeError``; any M runs there (kernels
        4 and 6 take any M: a MOVGP's M is its N)."""
        if not isinstance(inference, AnalyticVI):
            raise ValueError("multi-output models support AnalyticVI only")
        if optimiser == "default":
            optimiser = adam(0.01)
        if Aoptimiser == "default":
            Aoptimiser = adam(0.01)
        likelihoods = tuple(likelihoods)
        for lik in likelihoods:
            _check_ported(kernel, lik, mean, optimiser, Zoptimiser, Aoptimiser)
            check_implemented(lik, inference)
        rows_per_task = tuple(lik.n_latent for lik in likelihoods)
        Q = n_latent
        Z = as_2d(Z)
        check_card_dtype(Z.device, Z.dtype)
        to = dict(device=Z.device, dtype=Z.dtype)
        kernel, mean = prepare_components(kernel, likelihoods[0], ZeroMean() if mean is None else mean, Q)
        kernel, mean = kernel.to(**to), mean.to(**to)
        likelihoods = tuple(lik.to(**to) for lik in likelihoods)
        if Z.ndim == 2:
            Z = Z.expand((Q,) + Z.shape).clone()
        generator = torch.Generator(device=Z.device).manual_seed(0) if generator is None else generator
        A = torch.randn((sum(rows_per_task), Q), generator=generator, **to)
        return cls(
            kernel=kernel,
            likelihoods=likelihoods,
            mean=mean,
            Z=Z,
            A=A / torch.linalg.norm(A, dim=1, keepdim=True),
            inference=inference,
            n_latent=Q,
            n_tasks=len(likelihoods),
            rows_per_task=rows_per_task,
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zoptimiser=Zoptimiser,
            Aoptimiser=Aoptimiser,
        )

    @property
    def n_inducing(self):
        return self.Z.shape[1]

    def row_slices(self):
        """(start, end) of each task's rows of A."""
        out, start = [], 0
        for r in self.rows_per_task:
            out.append((start, start + r))
            start += r
        return out

    __repr__ = model_repr


class MOVGP(MOSVGP):
    """The full multi-output VGP: MOSVGP with Z fixed to the training inputs
    (kappa = I up to the jitter), as the reference shares the sparse path."""

    @classmethod
    def create(cls, X, likelihoods, kernel, inference, n_latent, **kw):
        return super().create(kernel, likelihoods, inference, as_2d(X), n_latent, **kw)


# ------------------------------------------------------------------- the step
@linalg._highest_precision
def mo_mean_var_f(model, mu_q, var_q):
    """The latent moments [Q, B] mixed into the output rows [R, B]:
    mu_r = sum_q A_rq mu_q, var_r = sum_q A_rq^2 var_q."""
    return model.A @ mu_q, (model.A**2) @ var_q


def mo_local_updates(model, ys, mu_f, var_f, local_list, w=None):
    """Each task's E-step on its own rows of (mu_f, var_f), with the row
    mask ``w``: (the tasks' likelihoods, their local variables) as a tuple
    and a list."""
    new_liks, new_locals = [], []
    for lik, y_t, lv, (s, e) in zip(model.likelihoods, ys, local_list, model.row_slices()):
        lik2, lv2 = lik.local_updates(y_t, mu_f[s:e], var_f[s:e], lv, w=w)
        new_liks.append(lik2)
        new_locals.append(lv2)
    return tuple(new_liks), new_locals


def mo_grad_rows(model, ys, local_list):
    """The rows' gradient expectations stacked over the tasks: (gmu_r,
    gs_r), [R, B] each."""
    gmu = [lik.grad_e_mu(y_t, lv) for lik, y_t, lv in zip(model.likelihoods, ys, local_list)]
    gs = [lik.grad_e_sigma(y_t, lv) for lik, y_t, lv in zip(model.likelihoods, ys, local_list)]
    return torch.cat(gmu, dim=0), torch.cat(gs, dim=0)


def _cross(A, mu_q):
    """sum_{q' != q} A_rq' mu_q' = (A mu)_r - A_rq mu_q, [R, Q, B]."""
    return (A @ mu_q)[:, None, :] - A[:, :, None] * mu_q[None, :, :]


@linalg._highest_precision
def mo_grad_latents(model, gmu_r, gs_r, mu_q):
    """The row gradients mixed back onto the Q latents, [Q, B] each:
    grad_mu_q = sum_r A_rq (gmu_r - 2 gs_r sum_{q' != q} A_rq' mu_q') and
    grad_sig_q = sum_r A_rq^2 gs_r."""
    A = model.A
    g1 = torch.einsum("rq,rqb->qb", A, gmu_r[:, None, :] - 2.0 * gs_r[:, None, :] * _cross(A, mu_q))
    return g1, (A**2).T @ gs_r


@linalg._highest_precision
def mo_update_A(model, state: TrainState, ys, mu_q, var_q, local_list, grads=None):
    """One ascent step of ``model.Aoptimiser`` on A, then each row
    projected back to unit norm, on the device: gA = x1 - 2 A o x2 with
    x1 = gmu_r mu_q^T - 2 sum_b gs_r mu_q cross and
    x2 = gs_r (mu_q^2 + var_q)^T, from the latent moments before the
    natural-gradient update.  ``grads`` passes (gmu_r, gs_r), masked by a
    row weight where the step had one; else they are formed from
    ``local_list``.  Returns (model, state) with A and ``A_state`` stepped
    (unchanged when A is fixed)."""
    if model.Aoptimiser is None:
        return model, state
    gmu_r, gs_r = mo_grad_rows(model, ys, local_list) if grads is None else grads
    A = model.A
    x1 = gmu_r @ mu_q.T - 2.0 * torch.einsum("rb,qb,rqb->rq", gs_r, mu_q, _cross(A, mu_q))
    x2 = gs_r @ (mu_q**2 + var_q).T
    x1, x2 = batch_sum(x1, x2)
    A_state, dA = ascent_update(model.Aoptimiser, state.A_state, A, x1 - 2.0 * A * x2)
    A = A + dA
    return model.replace(A=A / torch.linalg.norm(A, dim=1, keepdim=True)), state.replace(A_state=A_state)


def mo_variational_update(model, state: TrainState, x, ys, w=None):
    """One multi-output CAVI step on the batch x [B, D] and the tasks'
    labels ``ys``: the latent moments (kernel 4, or 6 and its products),
    the tasks' E-steps on their rows, the rows' gradients mixed onto the
    latents, the shared natural-gradient update (kernel 5 or 7), then the
    A step on the moments from before the update.  ``w`` ([B] of 0/1)
    zero-weights rows out of every cross-batch contraction, the A
    gradient's too.  Returns (model, state)."""
    mu_q, var_q, kappa = analytic_vi.latent_moments(model, state, x, state.kmat)
    mu_f, var_f = mo_mean_var_f(model, mu_q, var_q)
    liks, local_list = mo_local_updates(model, ys, mu_f, var_f, state.local_vars, w=w)
    model = model.replace(likelihoods=liks)
    state = state.replace(local_vars=local_list)
    gmu_r, gs_r = mo_grad_rows(model, ys, local_list)
    if w is not None:
        gmu_r, gs_r = gmu_r * w, gs_r * w
    g1, g2 = mo_grad_latents(model, gmu_r, gs_r, mu_q)
    state = analytic_vi.apply_natural_gradient(model, state, kappa, g1, g2, x)
    return mo_update_A(model, state, ys, mu_q, var_q, local_list, grads=(gmu_r, gs_r))


@linalg._highest_precision
def mo_elbo(model, state: TrainState, x, ys, kmat=None):
    """The multi-output ELBO on the batch (x, ys) whose local variables are
    in ``state``: rho times each task's expected log-likelihood on its rows,
    minus the latents' Gaussian KL and rho times each task's augmented KL
    (left out of the gradient); ``kmat`` (default ``state.kmat``) gives the
    prior's matrices, so that the hyperparameter step differentiates
    through them."""
    kmat = state.kmat if kmat is None else kmat
    if kmat is not state.kmat:
        state = state.replace(kmat=kmat)
    mu_q, var_q, _ = analytic_vi.latent_moments(model, state, x, kmat)
    mu_f, var_f = mo_mean_var_f(model, mu_q, var_q)
    rho = state.rho
    tot = 0.0
    for lik, y_t, lv, (s, e) in zip(model.likelihoods, ys, state.local_vars, model.row_slices()):
        tot = tot + rho * lik.expec_loglik(y_t, mu_f[s:e], var_f[s:e], lv)
        tot = tot - (rho * lik.aug_kl(lv, y_t)).detach()
    mu0 = analytic_vi.prior_mean_stack(model, x)
    kl = [gaussian_kl(state.mu[l], mu0[l], state.Sigma[l], kmat["L_K"][l]) for l in range(model.n_latent)]
    return tot - torch.sum(torch.stack(kl))


# ---------------------------------------------------------------- predictions
@linalg._highest_precision
def _mo_predict_f_core(model, state, X_test, diag=True):
    if diag:
        mu_q, var_q = _predict_f_var(model, state, X_test, diag=True)
        return mo_mean_var_f(model, mu_q, var_q)
    mu_q, cov_q = _predict_f_var(model, state, X_test, diag=False, full_cov=True)
    return model.A @ mu_q, torch.einsum("rq,qnp->rnp", model.A**2, cov_q)


def mo_predict_f(model, state, X_test, diag: bool = True, chunk_size=None):
    """Task-space predictive moments, the latent predictive mixed through A:
    ([R, n] mean, [R, n] variance) with diag=True, ([R, n] mean, [R, n, n]
    covariances) with diag=False (cov_r = sum_q A_rq^2 cov_q under
    independent latents).  Inputs without a device go to the model's.
    ``chunk_size`` evaluates the test set in slices of that many rows
    (diagonal only: ``ValueError`` with diag=False)."""
    X_test = as_2d(X_test, like=model.Z)
    call = lambda xc: _mo_predict_f_core(model, state, xc, diag=diag)
    if chunk_size is not None and X_test.shape[0] > chunk_size:
        if not diag:
            raise ValueError("chunk_size is incompatible with diag=False")
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def _per_task(model, state, X_test, chunk_size, fn):
    """``fn(lik, mu, var)`` of each task on its rows of the diagonal
    predictive ([n] for a one-row task, [r, n] else), as a tuple; in
    chunks of ``chunk_size`` rows when given."""
    X_test = as_2d(X_test, like=model.Z)

    def call(xc):
        mu_r, var_r = _mo_predict_f_core(model, state, xc)
        return tuple(fn(lik, mu_r[s] if r == 1 else mu_r[s:e], var_r[s] if r == 1 else var_r[s:e])
                     for lik, r, (s, e) in zip(model.likelihoods, model.rows_per_task, model.row_slices()))

    if chunk_size is not None and X_test.shape[0] > chunk_size:
        return _chunk_map(call, X_test, int(chunk_size), axis=-1)
    return call(X_test)


def mo_proba_y(model, state, X_test, chunk_size=None):
    """Each task's predictive distribution of y (its likelihood's
    ``compute_proba`` on its rows), as a tuple; ``chunk_size`` as
    ``mo_predict_f``."""
    return _per_task(model, state, X_test, chunk_size, lambda lik, mu, var: lik.compute_proba(mu, var))


def mo_predict_y(model, state, X_test, chunk_size=None):
    """Each task's label prediction (its likelihood's ``predict_y`` on its
    rows' mean), as a tuple; ``chunk_size`` as ``mo_predict_f``."""
    return _per_task(model, state, X_test, chunk_size, lambda lik, mu, var: lik.predict_y(mu))


# ------------------------------------------------------------------- training
def mo_init_state(model, X, ys=None) -> TrainState:
    """The initial TrainState of a multi-output model on X's device and in
    its dtype: one dict of local variables per task, A's optimiser state,
    the kernel matrices over Z.  Raises ``TypeError`` for a model or X
    in a dtype the card has no path for (``base.check_card_dtype``)."""
    check_card_dtype(model.Z.device, model.Z.dtype)
    check_card_dtype(X.device, X.dtype, "data")
    dtype, device = X.dtype, X.device
    N = X.shape[0]
    inf = model.inference
    batch = inf.batchsize if inf.stochastic else N
    post = init_var_posterior(model.n_latent, model.n_inducing, dtype, device)
    opt_state = None
    if inf.stochastic and inf.optimiser is not None:
        opt_state = inf.optimiser.init((post["eta1"], post["eta2"]))
    return TrainState(
        **post,
        local_vars=[lik.init_local_vars(batch, dtype, device) for lik in model.likelihoods],
        opt_state=opt_state,
        hyper_state=autotuning.init_hyper_state(model),
        kmat=analytic_vi.compute_kmat(model, X),
        rho=torch.full((), N / batch if inf.stochastic else 1.0, dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        A_state=None if model.Aoptimiser is None else model.Aoptimiser.init(model.A),
    )


def _mo_draws(model, X, n: int, draws=None, generator=None):
    """The row indices [n, B] of n stochastic steps: iid with replacement,
    whatever the engine's ``minibatch_sampling``, as the reference's
    ``_mo_draw_batch`` draws them: ``draws`` ([n, B] on X's device),
    checked, or drawn with ``generator`` in one call; None for a
    full-batch model."""
    if not model.inference.stochastic:
        return None
    b = model.inference.batchsize
    if draws is None:
        return torch.randint(0, X.shape[0], (n, b), generator=generator, device=X.device)
    if tuple(draws.shape) != (n, b) or draws.device != X.device:
        raise ValueError(f"draws must have shape {(n, b)} on {X.device}; got {tuple(draws.shape)} on {draws.device}")
    return draws


def _mo_batch(model, X, ys, mode, idx):
    """One step's minibatch (x_b, ys_b) from its row indices, or (X, ys)
    itself for a full-batch model (``mode`` None): the draw of a captured
    step."""
    if mode is None:
        return X, ys
    return X.index_select(0, idx), tuple(y.index_select(0, idx) for y in ys)


def _mo_batches(model, X, ys, n: int, draws=None, generator=None):
    """The minibatches (x_b, ys_b) of n steps, in order, from the indices of
    ``_mo_draws``; (X, ys) itself for a full-batch model."""
    idx = _mo_draws(model, X, n, draws, generator)
    mode = None if idx is None else "gather"
    for i in range(n):
        yield _mo_batch(model, X, ys, mode, None if idx is None else idx[i])


def _mo_update(model, state, x_b, ys_b, generator=None, eps=None):
    """A captured step's update: ``mo_variational_update``."""
    return mo_variational_update(model, state, x_b, ys_b)


def mo_steps(model, state, X, ys, n: int, draws=None, generator=None, marks=None):
    """n iterations of a multi-output model on treated labels ``ys`` (as
    ``mo_train`` treats them), without ``mo_train``'s set-up and its final
    kmat; returns (model, state).  ``draws`` and ``generator`` give the
    minibatches as ``_mo_draws`` takes them.  ``marks`` (n booleans, for a
    model with hyperparameters to learn) says which iterations take a
    hyperparameter step after their CAVI step, on their minibatch.
    Outside a sharded step (``graphs.drives``) the iterations run through
    ``graphs.run``, or with ``marks`` through ``graphs.run_hyper``: replays
    of captured CUDA graphs on the card; a sharded step runs them as a
    Python loop."""
    idx = _mo_draws(model, X, n, draws, generator)
    mode = None if idx is None else "gather"
    if graphs.drives(model):
        if marks is not None:
            return graphs.run_hyper(model, state, X, ys, marks, mode, idx, draw=_mo_batch, update=_mo_update,
                                    hyper=_hyper_update)
        return graphs.run(model, state, X, ys, n, mode, idx, draw=_mo_batch, update=_mo_update)
    for i in range(n):
        x_b, ys_b = _mo_batch(model, X, ys, mode, None if idx is None else idx[i])
        model, state = mo_variational_update(model, state, x_b, ys_b)
        state = state.replace(step=state.step + 1)
        if marks is not None and marks[i]:
            model, state = autotuning.hyper_step(model, state, x_b, ys_b)
    return model, state


def mo_train(
    model,
    Xs,
    ys,
    iterations: int = 100,
    state: TrainState | None = None,
    generator=None,
    draws=None,
    callback=None,
    verbose: int = 0,
    conv_eps: float = 0.0,
    conv_check_every: int = 10,
):
    """Train a multi-output model for ``iterations`` CAVI steps; every task
    shares the inputs Xs [N, D], ``ys`` holds each task's labels.  Returns
    (model, state) with the kernel matrices refreshed for prediction.

    Arrays without a device go to the model's device (``model.Z``), the
    labels as each task's likelihood treats them.  A stochastic step draws
    its B rows iid with replacement, with ``generator`` (on that device;
    seed 0 when None), or takes them from ``draws`` ([iterations, B]).
    With ``model.optimiser`` set, iteration i (from 1) is followed by a
    hyperparameter step on that iteration's own batch when i is a multiple
    of ``model.atfrequency``, i >= 3 and i is not the last; A steps inside
    every CAVI step.  ``callback(model, state, i)`` runs after iteration
    i's CAVI step, before its hyperparameter step; ``verbose >= 2`` prints
    the ELBO after each iteration and ``conv_eps > 0`` stops when the ELBO
    moves by less than ``conv_eps`` an iteration over ``conv_check_every``
    steps (checked only without hyperparameter steps, callback or
    ``verbose >= 2``), both on a fresh batch drawn with ``generator`` when
    stochastic.  Without a callback or ``verbose >= 2`` (the fast path,
    for more than one iteration) the iterations run back to back with no
    host read, in chunks of ``_CHUNK`` (or of ``conv_check_every``),
    through ``mo_steps``: on the card as replays of captured CUDA graphs
    (``graphs.run``, or ``graphs.run_hyper`` with hyperparameter steps),
    the same minibatches as the loop draws.  Ctrl-C returns the model and
    state trained so far."""
    X = as_2d(Xs, like=model.Z)
    new_ys, liks = [], []
    for lik, y_t in zip(model.likelihoods, ys):
        y_has_device = isinstance(y_t, torch.Tensor)
        y2, lik2 = lik.treat_labels(y_t)
        if not y_has_device:
            y2 = y2.to(X.device)
        if y2.device != X.device:
            raise ValueError(f"a task's labels are on {y2.device}, X on {X.device}")
        new_ys.append(match_dtype(y2, X))
        liks.append(lik2)
    ys = tuple(new_ys)
    model = model.replace(likelihoods=tuple(liks))
    inf = model.inference
    if inf.stochastic and not 0 < inf.batchsize <= X.shape[0]:
        raise ValueError(f"batchsize {inf.batchsize} is not in (0, {X.shape[0]}]")
    if state is None:
        state = mo_init_state(model, X, ys)
    generator = torch.Generator(device=X.device).manual_seed(0) if generator is None else generator
    do_hyper = model.optimiser is not None
    fast = callback is None and verbose < 2 and iterations > 1
    check = conv_eps > 0 and fast and not do_hyper
    chunk = conv_check_every if check else _CHUNK
    prev = None
    try:
        done = 0
        while done < iterations:
            n = min(chunk, iterations - done)
            rows = None if draws is None else draws[done:done + n]
            marks = _hyper_marks(model, done + 1, n, iterations) if do_hyper else None
            if fast:
                model, state = mo_steps(model, state, X, ys, n, rows, generator, marks)
                done += n
                if check:
                    e = float(mo_elbo(model, state, *_fresh(model, X, ys, generator)))
                    if prev is not None and abs(e - prev) / n < conv_eps:
                        break
                    prev = e
                continue
            for i, (x_b, ys_b) in enumerate(_mo_batches(model, X, ys, n, rows, generator), start=done + 1):
                model, state = mo_variational_update(model, state, x_b, ys_b)
                state = state.replace(step=state.step + 1)
                if callback is not None:
                    callback(model, state, i)
                if do_hyper and marks[i - done - 1]:
                    model, state = autotuning.hyper_step(model, state, x_b, ys_b)
                if verbose >= 2:
                    print(f"iter {i}: ELBO = {float(mo_elbo(model, state, *_fresh(model, X, ys, generator))):.6f}")
            done += n
    except KeyboardInterrupt:
        warnings.warn("training interrupted by user; returning current state")
    return model, state.replace(kmat=analytic_vi.compute_kmat(model, X))


def _fresh(model, X, ys, generator):
    """A batch drawn with ``generator`` for a stochastic model, else
    (X, ys): where ``mo_train`` reads the ELBO."""
    return next(_mo_batches(model, X, ys, 1, generator=generator))
