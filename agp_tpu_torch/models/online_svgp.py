"""OnlineSVGP: the streaming sparse variational GP (Bui et al. '17 style),
the counterpart of ``agp_tpu/models/online_svgp.py``.

The inducing set lives in a fixed-capacity slot buffer Z [L, Mc, D] with an
active mask; inactive slots carry identity prior and posterior blocks, so
every factorization stays well-posed, and every statistic is masked.  The
set grows by flipping mask bits (OIPS, StreamKmeans) or moves in place
(UniGridOnline, Webscale): ``inducing/algorithms.py``.

Streaming update equations (the reference's analyticVI.jl:183-203,
onlinetraining.jl:164-180):
  save-old:  invDa  = -2 eta2 - K^-1         (Sigma_a^-1 - K_a^-1)
             prev_eta1 = eta1
             prev_L_a  = (-logdet Sigma + logdet K - mu . eta1)/2
  update:    eta1 = K^-1 mu0 + kappa^T gmu + kappa_a^T prev_eta1
             eta2 = -(kappa^T Diag(gs) kappa + kappa_a^T invDa kappa_a / 2
                      + K^-1/2)
  extraKL (KLdivergences.jl:37-54):
     prev_L_a - 1/2 tr(invDa (Ktilde_a + kappa_a Sigma kappa_a^T))
     + prev_eta1 . (kappa_a mu) - 1/2 (kappa_a mu)^T invDa (kappa_a mu)

The products are plain PyTorch at full FP32 (TF32 off), which the
reference asks for too: invDa = Sigma^-1 - K^-1 cancels, and at lower
precision the stream loses positive-definiteness within a few batches.
The moments always take the zero-first ladder
(``linalg.nat_to_moments_safe``), the reference's path off the TPU.  A
batch is its set-up (the first: the selection on the host, as the
reference's) or its prologue (save-old, the inducing update, the masked
kernel matrices, fresh local variables: the reference's
``_online_prologue``), then its CAVI iterations, with the hyperparameter
step interleaved as ``train`` interleaves it.  The inducing update reads
nothing back: OIPS's and StreamKmeans' accept walks are the port's CUDA
kernels (``ops/cuda_kernels.py::oips_accept``, ``streamkmeans_pass``), the
counterparts of the reference's ``lax.scan``s.  A batch runs through
``training/graphs.py::run_batch``, the counterpart of the reference's
``_online_steps``, ``_online_batch`` and ``_online_stream_scan`` programs
(and, with an optimiser, of its ``_online_step_jit`` / ``_online_hyper_jit``
calls): on the card as replays of captured CUDA graphs, a later batch's
prologue one graph, its iterations windows of k, the batch's data copied
into the capture, so that one capture serves every batch of a stream of
equal batches; a graph records the full-FP32 kernels the algebra picks
with TF32 off, and a replay changes no setting.

On a mesh (``mesh=``, the reference's batch rows sharded over "data") each
process takes its rows of every batch as ``parallel.mesh.shard_batch``
cuts them, the pad row's mask threaded through; the inducing-set selection
runs on the whole batch on process 0 alone, which broadcasts Z, its mask
and its counts, so that the processes' sets cannot part; kappa^T g_mu,
kappa^T diag(g_Sigma) kappa and the likelihood's batch sums go through
``utils.batch_sums.batch_sum``; the streaming correction stays replicated.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from ..config import default_device, jitter
from ..inducing.algorithms import (
    OIPS,
    StreamKmeans,
    UniGridOnline,
    Webscale,
    inducingpoints,
    oips_update_latents,
    streamkmeans_update_latents,
    unigrid_update,
    webscale_update,
)
from ..inference import analytic_vi
from ..inference.config import AnalyticVI, InferenceConfig
from ..kernels import batch_diag, batch_gram, batch_gram_zz, latent
from ..likelihoods.base import Likelihood
from ..means import PriorMean, ZeroMean, batch_call
from ..ops import linalg
from ..training import autotuning, graphs
from ..training.state import TrainState, init_var_posterior
from ..utils import batch_sums
from ..utils.opt import adam
from ..utils.tensors import Params
from .base import as_2d, check_implemented, match_dtype, model_repr, to_tensor
from .svgp import _check_ported, _place


@dataclasses.dataclass(frozen=True, repr=False)
class OnlineSVGP(Params):
    kernel: Any
    likelihood: Likelihood
    mean: PriorMean
    Z: torch.Tensor  # [L, Mc, D] slot buffer
    z_mask: torch.Tensor  # [L, Mc] active flags
    Za: torch.Tensor  # [L, Mc, D] the previous batch's inducing set
    za_mask: torch.Tensor  # [L, Mc]
    z_counts: torch.Tensor  # [L, Mc] per-centre absorb counts (k-means algorithms)
    inference: InferenceConfig
    n_latent: int
    capacity: int = 128
    rho_accept: float = 0.8
    atfrequency: int = 1
    optimiser: Optional[Any] = None
    # the online selection algorithm; None is OIPS(rho_accept, capacity)
    Zalg: Optional[Any] = None

    is_sparse = True
    is_multioutput = False
    is_online = True

    @classmethod
    def create(
        cls,
        kernel,
        likelihood,
        inference=None,
        Zalg=None,
        n_dim: int = 1,
        capacity: int = 128,
        mean=None,
        optimiser="default",
        atfrequency: int = 1,
        dtype=None,
        device=None,
    ):
        """An empty model: the buffers on ``device`` (default
        ``config.default_device()``: the CUDA card unless the CPU was
        chosen) in ``dtype`` (default torch's), the kernel's, likelihood's
        and mean's parameters with them.  The capacity grows to the
        algorithm's own active-set size (UniGridOnline's grid, Webscale's k,
        StreamKmeans's capacity).  ``optimiser`` as ``SVGP.create`` takes
        it: "default" is Adam(0.01) on the kernel and the mean."""
        inference = AnalyticVI() if inference is None else inference
        if not isinstance(inference, AnalyticVI):
            raise ValueError("OnlineSVGP supports AnalyticVI only")
        if optimiser == "default":
            optimiser = adam(0.01)
        _check_ported(kernel, likelihood, mean, optimiser)
        check_implemented(likelihood, inference)
        Zalg = OIPS(capacity=capacity) if Zalg is None else Zalg
        if isinstance(Zalg, UniGridOnline):
            capacity = max(capacity, Zalg.points_per_dim**n_dim)
        elif isinstance(Zalg, Webscale):
            capacity = max(capacity, Zalg.k)
        elif isinstance(Zalg, StreamKmeans):
            # the buffer holds the algorithm's cap; growth stays bounded by it
            capacity = max(capacity, Zalg.capacity)
        L = likelihood.n_latent
        like = torch.zeros((), dtype=dtype or torch.get_default_dtype(),
                           device=default_device() if device is None else device)
        mean = ZeroMean() if mean is None else mean
        kernel, likelihood, mean = _place(kernel, likelihood, mean, L, like)
        Z = torch.zeros((L, capacity, n_dim), dtype=like.dtype, device=like.device)
        z_mask = torch.zeros((L, capacity), dtype=torch.bool, device=like.device)
        return cls(
            kernel=kernel,
            likelihood=likelihood,
            mean=mean,
            Z=Z,
            z_mask=z_mask,
            Za=Z,
            za_mask=z_mask,
            z_counts=torch.zeros((L, capacity), dtype=like.dtype, device=like.device),
            inference=inference,
            n_latent=L,
            capacity=capacity,
            rho_accept=getattr(Zalg, "rho", 0.8),
            atfrequency=atfrequency,
            optimiser=optimiser,
            Zalg=Zalg,
        )

    @property
    def n_inducing(self):
        return self.capacity

    __repr__ = model_repr


# ----------------------------------------------------------- masked kernels
@linalg._highest_precision
def masked_kmat(model: OnlineSVGP):
    """{"L_K", "K_inv"} of the masked prior covariance: identity blocks on
    the inactive slots, the dtype's jitter ladder on the whole (no L_inv:
    no kernel of the port reads this model's matrices)."""
    K = batch_gram_zz(model.kernel, model.Z)
    m = model.z_mask
    K = torch.where(m[:, :, None] & m[:, None, :], K, torch.zeros_like(K)) + torch.diag_embed((~m).to(K.dtype))
    L_K = linalg.safe_cholesky(K, jitter(K.dtype))
    return {"L_K": L_K, "K_inv": linalg.chol_inv(L_K)}


@linalg._highest_precision
def masked_kappa(model: OnlineSVGP, x, kmat):
    """(Knm, kappa = Knm K^-1, Ktilde) [L, B, Mc] / [L, B], Knm's inactive
    columns zero."""
    Knm = batch_gram(model.kernel, x, model.Z) * model.z_mask[:, None, :]
    kappa = Knm @ kmat["K_inv"]
    Ktilde = batch_diag(model.kernel, x) + jitter(Knm.dtype) - linalg.diag_ABt(kappa, Knm)
    return Knm, kappa, torch.clamp(Ktilde, min=1e-12)


@linalg._highest_precision
def masked_kappa_a(model: OnlineSVGP, kmat):
    """kappa_a = K(Za, Z) K^-1 and Ktilde_a = K_a - kappa_a K(Za, Z)^T, both
    masked [L, Mc, Mc] (Za the previous batch's set)."""
    Kab = torch.stack([latent(model.kernel, l).gram(model.Za[l], model.Z[l]) for l in range(model.n_latent)])
    Kab = torch.where(model.za_mask[:, :, None] & model.z_mask[:, None, :], Kab, torch.zeros_like(Kab))
    kappa_a = Kab @ kmat["K_inv"]
    Ka = batch_gram_zz(model.kernel, model.Za)
    Ka = torch.where(model.za_mask[:, :, None] & model.za_mask[:, None, :], Ka, torch.zeros_like(Ka))
    Ka = Ka + torch.diag_embed(model.za_mask.to(Ka.dtype) * jitter(Ka.dtype))
    return kappa_a, Ka - kappa_a @ Kab.mT


def masked_mu0(model: OnlineSVGP):
    """[L, Mc] prior mean over the slots, zero on the inactive ones."""
    return batch_call(model.mean, model.Z, model.n_latent) * model.z_mask


@linalg._highest_precision
def latent_moments(model: OnlineSVGP, state, x, kmat):
    """mean_f, var_f [L, B] and kappa [L, B, Mc] at the batch x: the
    online branch of ``analytic_vi.latent_moments``."""
    _, kappa, Ktilde = masked_kappa(model, x, kmat)
    mu_f = (kappa @ state.mu.unsqueeze(-1)).squeeze(-1)
    var_f = Ktilde + linalg.diag_ABt(kappa @ state.Sigma, kappa)
    return mu_f, var_f, kappa


# ------------------------------------------------------------ streaming ops
@linalg._highest_precision
def save_old_parameters(model: OnlineSVGP, state):
    """Za <- Z and the previous posterior: invDa = -2 eta2 - K^-1,
    prev_eta1, prev_L_a (the reference's onlinetraining.jl:164-180).  With
    the identity convention on inactive slots, invDa is exactly zero
    there."""
    kmat = state.kmat
    invDa = linalg.symmetrize(-2.0 * state.eta2 - kmat["K_inv"])
    L_S = linalg.psd_safe_cholesky(linalg.symmetrize(state.Sigma))
    ld = -linalg.chol_logdet(L_S) + linalg.chol_logdet(kmat["L_K"])
    prev_L_a = (ld - torch.sum(state.mu * state.eta1, dim=-1)) / 2.0
    model = model.replace(Za=model.Z, za_mask=model.z_mask)
    return model, state.replace(previous={"invDa": invDa, "prev_eta1": state.eta1, "prev_L_a": prev_L_a})


def update_Z(model: OnlineSVGP, x):
    """The batch's inducing-set update by the model's algorithm:
    OIPS and StreamKmeans grow the masked buffer (one walk over the batch
    for every latent: ``cuda_kernels.oips_accept`` or
    ``streamkmeans_pass``), UniGridOnline and Webscale move a fixed active
    set, latent by latent.  Nothing is read back to the host."""
    alg, L = model.Zalg, model.n_latent
    Z, m, c = model.Z, model.z_mask, model.z_counts
    if isinstance(alg, UniGridOnline):
        outs = [unigrid_update(Z[l], m[l], x, alg.points_per_dim) for l in range(L)]
        Z, m = (torch.stack(parts) for parts in zip(*outs))
    elif isinstance(alg, Webscale):
        outs = [webscale_update(Z[l], m[l], c[l], x, alg.k) for l in range(L)]
        Z, m, c = (torch.stack(parts) for parts in zip(*outs))
    elif isinstance(alg, StreamKmeans):
        Z, m, c = streamkmeans_update_latents(Z, m, c, x, alg.radius2, alg.capacity)
    else:
        Z, m = oips_update_latents([latent(model.kernel, l) for l in range(L)], Z, m, x, model.rho_accept)
    return model.replace(Z=Z, z_mask=m, z_counts=c)


@linalg._highest_precision
def online_variational_update(model: OnlineSVGP, state, x, y, w=None):
    """One streaming CAVI iteration: the likelihood's E-step at the batch,
    then eta from the statistics, the prior and the previous posterior's
    correction, the inactive slots reset to eta1 = 0, eta2 = -I/2 (the
    ladder would otherwise factor a singular matrix), and the moments.
    ``w`` ([B] of 0/1, optional) zero-weights pad rows out of the
    statistics, which a sharded step sums over its processes."""
    kmat = state.kmat
    mu_f, var_f, kappa = latent_moments(model, state, x, kmat)
    lik, local = model.likelihood.local_updates(y, mu_f, var_f, state.local_vars, w=w)
    model = model.replace(likelihood=lik)
    gmu = lik.grad_e_mu(y, local)  # [L, B]
    gs = lik.grad_e_sigma(y, local)
    if w is not None:
        gmu, gs = gmu * w, gs * w
    K_inv = kmat["K_inv"]
    kappa_a, _ = masked_kappa_a(model, kmat)
    prev = state.previous

    def matvec(A, v):
        return (A @ v.unsqueeze(-1)).squeeze(-1)

    s1, stat2 = batch_sums.batch_sum(matvec(kappa.mT, gmu), kappa.mT @ (gs.unsqueeze(-1) * kappa))
    eta1 = matvec(K_inv, masked_mu0(model)) + s1 + matvec(kappa_a.mT, prev["prev_eta1"])
    corr2 = kappa_a.mT @ prev["invDa"] @ kappa_a / 2.0
    eta2 = linalg.symmetrize(-(stat2 + corr2 + 0.5 * K_inv))
    inact = ~model.z_mask
    eta1 = torch.where(inact, torch.zeros_like(eta1), eta1)
    eye = torch.eye(model.capacity, dtype=eta2.dtype, device=eta2.device)
    eta2 = torch.where(inact[:, :, None] | inact[:, None, :], (-0.5 * eye).expand(eta2.shape), eta2)
    mu, Sigma = linalg.nat_to_moments_safe(eta1, eta2)
    return model, state.replace(eta1=eta1, eta2=eta2, mu=mu, Sigma=Sigma, local_vars=local)


@linalg._highest_precision
def online_extra_kl(model: OnlineSVGP, state, kmat=None):
    """The KL term between the previous and the current posteriors (the
    reference's functions/KLdivergences.jl:37-54), with ``kmat`` (default
    ``state.kmat``) the matrices the rest of the ELBO uses."""
    prev = state.previous
    kmat = state.kmat if kmat is None else kmat
    kappa_a, Ktilde_a = masked_kappa_a(model, kmat)
    invDa = prev["invDa"]
    ka_mu = (kappa_a @ state.mu.unsqueeze(-1)).squeeze(-1)
    kSk = kappa_a @ state.Sigma @ kappa_a.mT
    kl = prev["prev_L_a"] - 0.5 * (torch.sum(invDa * Ktilde_a, dim=(-2, -1)) + torch.sum(invDa * kSk, dim=(-2, -1)))
    kl = kl + torch.sum(prev["prev_eta1"] * ka_mu, dim=-1)
    kl = kl - 0.5 * torch.sum(ka_mu * (invDa @ ka_mu.unsqueeze(-1)).squeeze(-1), dim=-1)
    return torch.sum(kl)


# -------------------------------------------------------------- driver
def _decided(mesh, model: OnlineSVGP):
    """The inducing set (Z, its mask and its counts) as process 0 of
    ``mesh`` holds it, on every process; the model itself without a mesh
    of several processes."""
    if mesh is None or mesh.size == 1:
        return model
    mask = mesh.broadcast(model.z_mask.to(torch.uint8)).to(torch.bool)
    return model.replace(Z=mesh.broadcast(model.Z), z_mask=mask, z_counts=mesh.broadcast(model.z_counts))


def _selects(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _first_batch(model: OnlineSVGP, X, rows=None, mesh=None):
    """The inducing set selected from the first batch X on the host (with
    latent 0's kernel; on process 0 of ``mesh``, then broadcast), copied
    into every latent's first slots, and the initial state with the local
    variables of ``rows`` rows (X's by default)."""
    if _selects(mesh):
        alg = model.Zalg if model.Zalg is not None else OIPS(rho=model.rho_accept, capacity=model.capacity)
        Z0 = inducingpoints(alg, X, kernel=latent(model.kernel, 0))
        k0 = min(Z0.shape[0], model.capacity)
        Z, z_mask, counts = model.Z.clone(), model.z_mask.clone(), model.z_counts.clone()
        Z[:, :k0] = Z0[:k0].to(Z.dtype)
        z_mask[:, :k0] = True
        counts[:, :k0] = 1.0
        model = model.replace(Z=Z, z_mask=z_mask, z_counts=counts)
    model = _decided(mesh, model)
    L, Mc, dtype, device = model.n_latent, model.capacity, X.dtype, X.device
    state = TrainState(
        **init_var_posterior(L, Mc, dtype, device),
        local_vars=model.likelihood.init_local_vars(X.shape[0] if rows is None else rows, dtype, device),
        hyper_state=autotuning.init_hyper_state(model),
        kmat=masked_kmat(model),
        rho=torch.ones((), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        previous={
            "invDa": torch.zeros((L, Mc, Mc), dtype=dtype, device=device),
            "prev_eta1": torch.zeros((L, Mc), dtype=dtype, device=device),
            "prev_L_a": torch.zeros((L,), dtype=dtype, device=device),
        },
    )
    return model, state


def _online_prologue(model: OnlineSVGP, state, X, rows=None, mesh=None):
    """Between batches: save-old, the inducing update (on process 0 of
    ``mesh``, then broadcast), the masked kernel matrices, fresh local
    variables of ``rows`` rows (X's by default)."""
    model, state = save_old_parameters(model, state)
    if _selects(mesh):
        model = update_Z(model, X)
    model = _decided(mesh, model)
    rows = X.shape[0] if rows is None else rows
    return model, state.replace(
        kmat=masked_kmat(model), local_vars=model.likelihood.init_local_vars(rows, X.dtype, X.device)
    )


def _update(model: OnlineSVGP, state, x, y, generator=None, eps=None):
    """A captured iteration's update: ``online_variational_update``."""
    return online_variational_update(model, state, x, y)


def _refresh_kmat(model: OnlineSVGP, state):
    """The end of a batch with hyperparameters to learn: the kernel
    matrices of the model as its last step left it."""
    return model, state.replace(kmat=masked_kmat(model))


def _captures(model: OnlineSVGP, mesh, iterations: int) -> bool:
    """Whether a batch runs through ``graphs.run_batch``: outside a
    sharded step and a mesh of several processes, with iterations to
    run."""
    return iterations > 0 and not (mesh is not None and mesh.size > 1) and graphs.drives(model)


def _train_batch(model: OnlineSVGP, state, X, y, iterations: int, mesh=None):
    """One streaming batch (labels treated): its set-up or prologue, then
    ``iterations`` CAVI iterations; with an optimiser, a hyperparameter step
    after iteration i when i is a multiple of ``atfrequency``, i >= 3 and i
    is not the last, and the kernel matrices refreshed at the end.  A
    later batch runs through ``graphs.run_batch`` (captured CUDA graphs on
    the card): its prologue, its iterations and the refresh, with no host
    read; the first batch's set-up selects on the host, then its
    iterations run there too.  On a mesh of several processes, or inside a
    sharded step, each process runs the prologue and iterates eagerly on
    its rows of the batch (``parallel.mesh.shard_batch``), the selection
    made on the whole."""
    xs, ys, w = X, y, None
    split = mesh is not None and mesh.size > 1
    if split:
        from ..parallel.mesh import _n_pad, shard_batch

        xs, ys, mask = shard_batch(mesh, X, y, with_mask=True)
        w = mask if _n_pad(mesh, X.shape[0]) else None
    captured, prologue = _captures(model, mesh, iterations), None
    if state is None:
        model, state = _first_batch(model, X, xs.shape[0], mesh)
    elif captured:
        prologue = _online_prologue
    else:
        model, state = _online_prologue(model, state, X, xs.shape[0], mesh)
    do_hyper = model.optimiser is not None
    marks = [do_hyper and i % model.atfrequency == 0 and i >= 3 and i != iterations for i in range(1, iterations + 1)]
    if captured:
        return graphs.run_batch(model, state, X, y, marks, update=_update,
                                hyper=autotuning.hyper_step if do_hyper else None, prologue=prologue,
                                tail=_refresh_kmat if do_hyper else None)
    for i in range(iterations):
        with batch_sums.sharded(mesh) if split else contextlib.nullcontext():
            model, state = online_variational_update(model, state, xs, ys, w)
        state = state.replace(step=state.step + 1)
        if marks[i]:
            model, state = autotuning.hyper_step(model, state, X, y)
    if do_hyper:
        model, state = _refresh_kmat(model, state)
    return model, state


def _check_mesh(model: OnlineSVGP, mesh):
    """``mesh`` as the streaming drivers take it: None, or a mesh whose
    data axis splits the batches (``TypeError`` on a latent axis; a
    hyperparameter step on a mesh is refused with ``ValueError``)."""
    if mesh is None:
        return None
    if mesh.latent.size > 1:
        analytic_vi.check_latent_axis(model, mesh.latent.size)
    if model.optimiser is not None and mesh.size > 1:
        raise ValueError("a sharded stream requires optimiser=None: the hyperparameter step's gradient is not "
                         "summed over the processes")
    return mesh


def online_train(model: OnlineSVGP, X, y, state: TrainState | None = None, iterations: int = 20, mesh=None):
    """Train on one streaming batch; thread (model, state) across batches
    (the reference's onlinetraining.jl:36-145).  The first batch
    (``state`` None) selects the inducing set.  X and y without a device go
    to the model's device, X in its dtype.  The batch's iterations are
    replays of captured CUDA graphs on the card (``graphs.run_batch``): a
    later call with a batch of the same shape replays the same capture.
    With ``mesh`` (a ``parallel.mesh.Mesh``; every process passes the
    whole batch) each process iterates eagerly on its rows, as the
    module's docstring says; the state's local variables are its rows'."""
    mesh = _check_mesh(model, mesh)
    X = as_2d(X, like=model.Z)
    y, lik = model.likelihood.treat_labels(y)
    y = match_dtype(y.to(X.device), X)
    return _train_batch(model.replace(likelihood=lik), state, X, y, iterations, mesh)


def _flat(y):
    return y.reshape(-1) if isinstance(y, torch.Tensor) else torch.as_tensor(y).reshape(-1)


def online_train_stream(model: OnlineSVGP, X_stream, y_stream, state: TrainState | None = None,
                        iterations: int = 20, mesh=None):
    """Train on a pre-buffered stream of equal batches, X_stream
    [n_batches, B, D] and y_stream [n_batches, B]: the same batches as
    ``online_train`` called once a batch, the labels treated once for the
    stream (the reference's ``_online_stream_scan``).  The first batch's
    set-up (state None) runs on the host; every later batch replays the
    one capture of the stream (``graphs.run_stream``): its data copied into
    the capture, its prologue's graph, its windows of iterations, with no
    host read and no copy of the carry between batches.  ``mesh`` as
    ``online_train`` takes it (a mesh of several processes: batch by batch,
    eagerly).  Requires optimiser=None (a stream with hyperparameter
    learning goes batch by batch, as the reference's)."""
    mesh = _check_mesh(model, mesh)
    if model.optimiser is not None:
        raise ValueError(
            "online_train_stream requires optimiser=None; interleaved "
            "hyperopt streams with per-batch online_train calls"
        )
    X_stream = to_tensor(X_stream, like=model.Z)
    if X_stream.ndim == 2:
        X_stream = X_stream[:, :, None]
    lead = tuple(X_stream.shape[:2])
    y_flat, lik = model.likelihood.treat_labels(_flat(y_stream))
    model = model.replace(likelihood=lik)
    # treat_labels may add label dimensions (multiclass: [N] -> [N, K]);
    # restore the (n_batches, B) layout in front of them
    y_stream = match_dtype(y_flat.reshape(lead + tuple(y_flat.shape[1:])).to(X_stream.device), X_stream)
    if state is None and lead[0]:  # the first batch's set-up, then its iterations
        model, state = _train_batch(model, state, X_stream[0], y_stream[0], iterations, mesh)
        X_stream, y_stream = X_stream[1:], y_stream[1:]
    if len(X_stream) and _captures(model, mesh, iterations):
        return graphs.run_stream(model, state, X_stream, y_stream, [False] * iterations, update=_update,
                                 prologue=_online_prologue)
    for Xb, yb in zip(X_stream, y_stream):
        model, state = _train_batch(model, state, Xb, yb, iterations, mesh)
    return model, state


def online_elbo(model: OnlineSVGP, state, x, y):
    """The ELBO on the batch (x, y) whose local variables are in ``state``,
    with the streaming extra KL term."""
    x = as_2d(x, like=model.Z)
    return analytic_vi.elbo(model, state, x, match_dtype(to_tensor(y, like=x), x))
