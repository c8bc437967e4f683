"""Data-parallel CAVI over ``torch.distributed``: the counterpart of
``agp_tpu/parallel/mesh.py``.

The reference is one controller over a device mesh, and GSPMD turns the
step's contractions over the sharded batch into psums.  The port is SPMD:
one process per device, each holding one shard of the data (its rows of
X and y, and the local variables of those rows) and a replica of the model
and of the global state (eta, mu, Sigma, the kernel matrices).  A step
runs the single-device update on the process's own rows; every sum over
the batch goes through ``utils.batch_sums.batch_sum``, which inside
``batch_sums.sharded(mesh)`` all-reduces it: s1 and S2 as one flat buffer
(one collective a step), and the likelihood's batch sums where it has them
(the Poisson rate, the Gaussian noise rule, the heteroscedastic lambda and
the multi-output A step).  The replicated update then runs on every
process alike.

* The step's kernels are the single-device dispatch's, on each process's
  shard: kernel 1 (or 2-3 for a multiclass or heteroscedastic model) when
  it fits and the batch is unweighted, else the split pair (kernels 6 + 7
  for one latent, 4 + 5 for several).  ``fused=False`` takes the split
  pair, ``fused=True`` kernel 1 or ``ValueError``.
* Padding: when N does not divide the world size, ``shard_batch`` pads the
  last shard by repeating row 0 and the full-batch trainers thread the 0/1
  row mask through the update; the minibatch draws keep below the last
  shard's valid count, so pad rows are never drawn.
* Draws: each process draws its own minibatch from its shard, with a
  ``torch.Generator`` seeded by (seed, rank); the reference's threefry
  chain is not reproduced.  Every SVI entry point also takes ``draws``, the
  process's index rows ([n, 1] slice starts, [n, B/tile] tile indices or
  [n, B] row indices), such as the reference's ``gen_idx`` output.
* A mesh of one process (``make_mesh()`` with no initialised group, or a
  group of one) runs no all-reduce in a step: ``batch_sum`` returns its
  values, as the reference's one-device mesh runs no psum.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..config import default_device
from ..inference import analytic_vi
from ..models.base import as_2d, match_dtype
from ..training import train as _train
from ..utils import batch_sums
from ..utils.tensors import map_leaves


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The processes of a data-parallel run: the process group (None for
    one process with no collective), this process's rank, the world size,
    this process's device and the group's backend."""

    group: Any
    rank: int
    size: int
    device: torch.device
    backend: str | None = None

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes, in place."""
        if self.group is not None:
            dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """A copy of process 0's ``t`` on this process's device, in ``t``'s
        layout (the card's products round by their operands' layout, so a
        world of one stays bit-equal to one process)."""
        t = t.to(self.device)
        out = torch.empty_like(t)
        if self.group is None:
            return out.copy_(t)
        buf = t.clone(memory_format=torch.contiguous_format)
        dist.broadcast(buf, src=0, group=self.group)
        return out.copy_(buf)

    def all_gather(self, t: torch.Tensor) -> list:
        """Every process's ``t`` (same shape on each), in rank order."""
        if self.group is None:
            return [t]
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out


def _rank_device(device, rank: int) -> torch.device:
    """``device``, or ``config.default_device()``; a CUDA device without an
    index is cuda:LOCAL_RANK (LOCAL_RANK defaults to the rank modulo the
    card count)."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def make_mesh(device=None) -> Mesh:
    """The mesh of the initialised process group's world, on ``device``
    (default cuda:LOCAL_RANK, or the CPU when it is the default device);
    without an initialised group, a mesh of this one process with no
    collective (the reference's ``make_mesh(1)``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(None, 0, 1, _rank_device(device, 0))
    group = dist.group.WORLD
    rank = dist.get_rank(group)
    return Mesh(group, rank, dist.get_world_size(group), _rank_device(device, rank), dist.get_backend(group))


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None, backend=None,
                           device=None) -> Mesh:
    """Join the process group and return its mesh: ``coordinator_address``
    "host:port" (a TCP rendezvous), any init-method URL ("file://...",
    "tcp://..."), or None for the environment's (MASTER_ADDR, MASTER_PORT,
    WORLD_SIZE, RANK).  The backend is NCCL for a CUDA device and gloo for
    the CPU unless ``backend`` names one."""
    rank = 0 if process_id is None else int(process_id)
    device = _rank_device(device, rank)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if coordinator_address is None:
        init = "env://"
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes, rank=process_id)
    return make_mesh(device)


def _n_pad(mesh: Mesh, n: int) -> int:
    return (-n) % mesh.size


def shard_batch(mesh: Mesh, *arrays, with_mask: bool = False):
    """This process's rows of the arrays (each [N, ...], the same N), on
    the mesh's device: the tail padded to a multiple of the world size by
    repeating row 0, then the rank's contiguous block.  ``with_mask`` adds
    the rank's [rows] 0/1 mask (1 on real rows) in the first array's
    floating dtype (torch's default for an integer array)."""
    arrays = [a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a)) for a in arrays]
    lead = {a.shape[0] for a in arrays}
    if len(lead) != 1:
        raise ValueError(f"arrays disagree on the leading (data) dim: {lead}")
    n0 = lead.pop()
    pad = _n_pad(mesh, n0)
    rows = (n0 + pad) // mesh.size
    lo = mesh.rank * rows
    out = []
    for a in arrays:
        if pad:
            a = torch.cat([a, a[:1].expand((pad,) + a.shape[1:])])
        out.append(a[lo:lo + rows].to(mesh.device).contiguous())
    if with_mask:
        dtype = arrays[0].dtype if arrays[0].is_floating_point() else torch.get_default_dtype()
        idx = torch.arange(lo, lo + rows, device=mesh.device)
        out.append((idx < n0).to(dtype))
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh: Mesh, tree):
    """Every tensor of ``tree`` (a model, a state, or a tuple of them) as
    process 0 holds it, on the mesh's device."""
    return map_leaves(mesh.broadcast, tree)


def gather_local_vars(mesh: Mesh, local_vars):
    """The global local variables of the processes' shards ([..., rows]
    each, a dict or a multi-output model's list of dicts), concatenated
    along the batch axis in rank order, which is the reference's device
    order; 0-d entries (an optimiser state) are process 0's.  Every
    process must call it."""
    def gather(t):
        if t.ndim == 0:  # the noise rule's optimiser state
            return mesh.broadcast(t)
        return torch.cat(mesh.all_gather(t.contiguous()), dim=-1)

    return map_leaves(gather, local_vars)


def _replicated_state(mesh: Mesh, state):
    """The state with its global part broadcast from process 0 and its local
    variables this process's own."""
    local = map_leaves(lambda t: t.to(mesh.device), state.local_vars)
    return replicate(mesh, state.replace(local_vars=None)).replace(local_vars=local)


def _check_model(model, caller: str):
    if not getattr(model, "is_sparse", False):
        raise TypeError(
            f"{caller} supports sparse (inducing-point) models; a dense model's [N]-sized posterior cannot be "
            "replicated across the data mesh"
        )
    if getattr(model, "is_online", False):
        raise TypeError(f"{caller} does not take an online model: it trains with online_train")
    if model.inference.name not in ("AnalyticVI", "AnalyticSVI"):
        raise TypeError(f"{caller} runs closed-form CAVI (AnalyticVI, AnalyticSVI); got {model.inference.name}")


def _treated(model, X, y, mesh: Mesh):
    """(model, X, y): X [N, D] on the mesh's device in Z's dtype, the
    labels treated by the likelihood and cast as ``train`` casts them."""
    X = as_2d(X, like=model.Z).to(mesh.device)
    y, lik = model.likelihood.treat_labels(y)
    return model.replace(likelihood=lik), X, match_dtype(y.to(mesh.device), X)


# --------------------------------------------------------- full-batch CAVI
def data_parallel_step(mesh: Mesh):
    """A data-parallel CAVI step ``step(model, state, x, y, w=None)`` on this
    process's shard (x, y) and row mask ``w`` (None when N divides the
    world size), its batch sums all-reduced over the mesh."""

    def step(model, state, x, y, w=None):
        with batch_sums.sharded(mesh):
            model, state = analytic_vi.variational_update(model, state, x, y, w=w)
        return model, state.replace(step=state.step + 1)

    return step


def sharded_train(model, X, y, iterations: int, mesh: Mesh | None = None, state=None):
    """Full-batch CAVI over the sharded dataset: each process runs
    ``iterations`` steps on its rows of X [N, D] and y (every process passes
    the whole arrays), the mask threaded through when N does not divide
    the world size.  Returns (model, state); the state's local variables
    are this process's rows (``gather_local_vars`` collects them).  A
    dense, online, stochastic or numerical model is refused."""
    _check_model(model, "sharded_train")
    mesh = make_mesh(model.Z.device) if mesh is None else mesh
    if model.inference.stochastic:
        raise TypeError("sharded_train runs full-batch CAVI (AnalyticVI); use sharded_svi_train for AnalyticSVI")
    from ..training.train import init_state

    model, X, y = _treated(model, X, y, mesh)
    Xs, ys, mask = shard_batch(mesh, X, y, with_mask=True)
    w = mask if _n_pad(mesh, X.shape[0]) else None
    if state is None:
        state = init_state(model, Xs, ys)
    model = replicate(mesh, model)
    state = _replicated_state(mesh, state)
    step = data_parallel_step(mesh)
    for _ in range(iterations):
        model, state = step(model, state, Xs, ys, w)
    return model, state


def mo_data_parallel_step(mesh: Mesh):
    """A data-parallel multi-output CAVI step ``step(model, state, x, ys,
    w=None)``: the statistics and the A step's contractions all-reduced."""
    from ..models.multioutput import mo_variational_update

    def step(model, state, x, ys, w=None):
        with batch_sums.sharded(mesh):
            model, state = mo_variational_update(model, state, x, ys, w=w)
        return model, state.replace(step=state.step + 1)

    return step


def mo_sharded_train(model, X, ys, iterations: int, mesh: Mesh | None = None, state=None):
    """Full-batch multi-output CAVI (MOSVGP, MOVGP) over the sharded dataset:
    every task shares X [N, D]; ``ys`` holds each task's labels.  Returns
    (model, state) with this process's local variables."""
    from ..models.multioutput import mo_init_state

    mesh = make_mesh(model.Z.device) if mesh is None else mesh
    if model.inference.stochastic:
        raise TypeError("mo_sharded_train runs full-batch CAVI (AnalyticVI)")
    X = as_2d(X, like=model.Z).to(mesh.device)
    new_ys, liks = [], []
    for lik, y_t in zip(model.likelihoods, ys):
        y2, lik2 = lik.treat_labels(y_t)
        new_ys.append(match_dtype(y2.to(mesh.device), X))
        liks.append(lik2)
    model = model.replace(likelihoods=tuple(liks))
    sharded = shard_batch(mesh, X, *new_ys, with_mask=True)
    Xs, yss, mask = sharded[0], tuple(sharded[1:-1]), sharded[-1]
    w = mask if _n_pad(mesh, X.shape[0]) else None
    if state is None:
        state = mo_init_state(model, Xs, yss)
    model = replicate(mesh, model)
    state = _replicated_state(mesh, state)
    step = mo_data_parallel_step(mesh)
    for _ in range(iterations):
        model, state = step(model, state, Xs, yss, w)
    return model, state


# ------------------------------------------------------- minibatched (SVI)
@dataclasses.dataclass(frozen=True)
class DrawPlan:
    """One process's minibatch draw: ``mode`` ("slice", "block" or
    "gather"), ``shape`` of one step's index row ([1] start, [B/tile] tile
    indices, [B] row indices), ``high`` (indices drawn in [0, high)), the
    ``tile`` height of block draws and the per-process batch ``b``."""

    mode: str
    shape: tuple
    high: int
    tile: int | None
    b: int


def draw_plan(mesh: Mesh, sampling: str, batch_per_device: int, rows: int, n_pad: int) -> DrawPlan:
    """The draw of one process with a shard of ``rows`` rows, the last
    process's ``n_pad`` of them padding: its indices stay below the shard's
    valid count (whole valid tiles for block draws), so pad rows are never
    drawn."""
    b = batch_per_device
    valid = rows - (n_pad if mesh.rank == mesh.size - 1 else 0)
    if sampling == "slice":
        return DrawPlan("slice", (1,), valid - b + 1, None, b)
    if sampling.startswith("block"):
        tile = _train.block_tile(sampling, b)
        if tile is not None and b % tile == 0 and rows - n_pad >= tile:
            return DrawPlan("block", (b // tile,), valid // tile, tile, b)
    return DrawPlan("gather", (b,), valid, None, b)


def rank_generator(mesh: Mesh, seed: int = 0) -> torch.Generator:
    """The generator of this process's draws, on its device, seeded by
    (seed, rank)."""
    return torch.Generator(device=mesh.device).manual_seed(seed * 65_536 + mesh.rank)


def sharded_svi_step(mesh: Mesh, batch_per_device: int, n_pad: int = 0, sampling: str = "gather",
                     fused: bool | None = False):
    """A minibatched data-parallel CAVI step ``step(model, state, Xs, ys,
    idx, tiled=None)`` on this process's minibatch, taken from its shard
    (Xs, ys) by its index row ``idx`` (the plan's shape; ``tiled`` the
    shard's tile views for block draws), its batch sums all-reduced.
    ``fused`` False takes the split pair (kernels 6 + 7, or 4 + 5), None the
    single-device dispatch, True kernel 1.  ``step.plan(rows)`` gives the
    draw of a shard of ``rows`` rows."""

    def step(model, state, Xs, ys, idx, tiled=None):
        plan = step.plan(Xs.shape[0])
        x_b, y_b = _train._draw_from_idx(model, Xs, ys, tiled, plan.mode, idx, b=plan.b)
        with batch_sums.sharded(mesh):
            model, state = analytic_vi.variational_update(model, state, x_b, y_b, fused=fused)
        return model, state.replace(step=state.step + 1)

    step.plan = lambda rows: draw_plan(mesh, sampling, batch_per_device, rows, n_pad)
    return step


def sharded_fused_svi_step(mesh: Mesh, model_template, batch_per_device: int, n_pad: int = 0,
                           sampling: str = "gather"):
    """The step of :func:`sharded_svi_step` with kernel 1 (the fused
    statistics pass) on every process's shard; ``ValueError`` when kernel 1
    cannot take ``model_template``."""
    if analytic_vi._fused_spec(model_template) is None:
        raise ValueError(
            "no fused statistics kernel (kernel 1) for this model: it needs one latent, a kernel of "
            "FUSED_KINDS, a likelihood of its eight, M <= 128 and float32 on the card; use sharded_svi_step"
        )
    return sharded_svi_step(mesh, batch_per_device, n_pad, sampling, fused=True)


def build_svi_trainer(model, X, y, mesh: Mesh | None = None, batch_per_device: int | None = None, state=None,
                      fused: bool | None = None):
    """The sharded SVI pieces: (steps, model, state, Xs, ys), where
    ``steps(model, state, Xs, ys, n, draws=None, generator=None)`` runs n
    steps on this process's shard, its index rows from ``draws`` ([n, ...]
    as the plan's shape, on the shard's device) or drawn with
    ``generator``.  The global batch is batch_per_device x world size (the
    model's engine batchsize divided over the processes when None) and
    rho = N / that; each process's state holds the local variables of its
    batch_per_device rows.  ``fused`` as :func:`sharded_svi_step`'s, None
    by default (the single-device dispatch)."""
    from ..training.train import init_state

    _check_model(model, "build_svi_trainer")
    mesh = make_mesh(model.Z.device) if mesh is None else mesh
    if batch_per_device is None:
        batch_per_device = max(model.inference.batchsize // mesh.size, 1)
    model, X, y = _treated(model, X, y, mesh)
    n = X.shape[0]
    Xs, ys = shard_batch(mesh, X, y)
    n_pad = _n_pad(mesh, n)
    rows = Xs.shape[0]
    if batch_per_device > rows - n_pad:
        raise ValueError(f"batch_per_device {batch_per_device} exceeds the smallest shard's {rows - n_pad} valid rows")
    inf = dataclasses.replace(model.inference, batchsize=batch_per_device * mesh.size)
    model = model.replace(inference=inf)
    if state is None:
        local = model.replace(inference=dataclasses.replace(inf, batchsize=batch_per_device))
        state = init_state(local, Xs, ys)
        state = state.replace(rho=torch.full((), n / (batch_per_device * mesh.size), dtype=X.dtype, device=X.device))
    sampling = _train._sampling_mode(model)
    if fused:
        step = sharded_fused_svi_step(mesh, model, batch_per_device, n_pad, sampling)
    else:
        step = sharded_svi_step(mesh, batch_per_device, n_pad, sampling, fused=fused)
    plan = step.plan(rows)
    tiled = _train._tile_views(Xs, ys, plan.tile) if plan.mode == "block" else None
    model = replicate(mesh, model)
    state = _replicated_state(mesh, state)

    def steps(model, state, Xs, ys, n_steps, draws=None, generator=None):
        if draws is None:
            gen = rank_generator(mesh) if generator is None else generator
            draws = torch.randint(0, plan.high, (n_steps,) + plan.shape, generator=gen, device=Xs.device)
        elif tuple(draws.shape) != (n_steps,) + plan.shape:
            raise ValueError(f"draws for {plan.mode!r} sampling must have shape {(n_steps,) + plan.shape}; "
                             f"got {tuple(draws.shape)}")
        for i in range(n_steps):
            model, state = step(model, state, Xs, ys, draws[i], tiled)
        return model, state

    return steps, model, state, Xs, ys


def sharded_svi_train(model, X, y, iterations: int, mesh: Mesh | None = None, batch_per_device: int | None = None,
                      state=None, fused: bool | None = None, draws=None, generator=None, seed: int = 0):
    """Minibatched data-parallel CAVI: ``iterations`` steps, each process on
    its own batch_per_device rows drawn from its shard (with ``generator``,
    default ``rank_generator(mesh, seed)``, in chunks; or from ``draws``,
    this process's [iterations, ...] index rows).  Every process passes the
    whole X [N, D] and y.  ``fused``: None the single-device dispatch (the
    fused pass when it fits, else the split pair), True kernel 1 (or
    ``ValueError``), False the split pair.  Returns (model, state) with this
    process's local variables."""
    mesh = make_mesh(model.Z.device) if mesh is None else mesh
    steps, model, state, Xs, ys = build_svi_trainer(model, X, y, mesh, batch_per_device, state, fused)
    gen = rank_generator(mesh, seed) if generator is None else generator
    done = 0
    while done < iterations:
        n = min(_train._CHUNK, iterations - done)
        rows = None if draws is None else torch.as_tensor(draws[done:done + n], device=Xs.device)
        model, state = steps(model, state, Xs, ys, n, draws=rows, generator=gen)
        done += n
    return model, state
