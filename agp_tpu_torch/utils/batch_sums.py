"""The reduction seams of a sharded CAVI step.

Under a data-parallel step (``parallel/mesh.py``) each process holds one
shard of the batch, so every sum over the batch must be summed over the
processes too.  The reference gets those sums from GSPMD; here the step's
code calls :func:`batch_sum` on each one:

* the natural-gradient statistics s1 [L, M] and S2 [L, M, M], before the
  global update (``inference/analytic_vi.py::_nat_update_from_stats``);
* the Poisson rate's sums (``likelihoods/event.py`` and the fused pass's
  epilogue), the Gaussian noise rule's (``likelihoods/regression.py``),
  the heteroscedastic lambda's and its row count
  (``likelihoods/heteroscedastic.py`` and the fused pass);
* the mixing matrix's gradient contractions x1, x2
  (``models/multioutput.py::mo_update_A``).

* the ELBO's data terms (``inference/analytic_vi.py::elbo``).

Outside a sharded step :func:`batch_sum` returns its arguments as they are:
no copy, no extra op.  Inside one (``with sharded(mesh):``) it sums them
over the mesh's data axis in one all-reduce of a flat buffer (the values
in one dtype: s1 and S2, or a likelihood's sums): over every process on a
one-axis mesh, over the processes that hold the same latents on a
(data, latent) mesh, where each latent rank's s1 and S2 belong to its own
classes.

The second seam, :func:`latent_sum`, sums per-row quantities over the
latent axis of a (data, latent) mesh, on which each process holds a
contiguous block of the K logistic-softmax latents (``mesh.shard_latents``):
the coupled E-step's alpha = 1 + sum_k gamma_k, the likelihood's class-wise
ELBO terms and the Gaussian KL.  The terms that do not depend on the class
are counted on the latent axis's first process alone (:func:`latent_lead`),
and each process reads its own columns of the one-hot labels
(:func:`own_latents`).  Outside a sharded step, or on a latent axis of one
process, the three are the identity, True and the identity.  A mesh of one process,
with a group or none, has nothing to sum and runs no collective, as the
reference's one-device mesh runs no psum: its host cost (an NCCL
all-reduce of a group of one takes 32-143 us of host time a call on an
H100's host) made a world-1 step 0.57-0.82 times ``train``'s rate.
"""
from __future__ import annotations

import contextlib

import torch

# the meshes of the sharded steps being run, innermost last
_ACTIVE = []


@contextlib.contextmanager
def sharded(mesh):
    """Within this block :func:`batch_sum` sums over ``mesh``'s data axis
    and :func:`latent_sum` over its latent axis (a ``parallel.mesh.Mesh``;
    an axis of a single process sums over itself)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active():
    """The mesh of the sharded step being run, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _summed(axis, values):
    """``values`` summed over the processes of ``axis`` (a mesh) in one
    all-reduce of a flat buffer in the first tensor's dtype."""
    like = next(v for v in values if isinstance(v, torch.Tensor))
    parts = [v if isinstance(v, torch.Tensor) else torch.full((), v, dtype=like.dtype, device=like.device)
             for v in values]
    flat = torch.cat([p.reshape(-1) for p in parts])
    axis.all_reduce(flat)
    out, start = [], 0
    for p in parts:
        out.append(flat[start:start + p.numel()].view(p.shape))
        start += p.numel()
    return out[0] if len(out) == 1 else tuple(out)


def batch_sum(*values):
    """Each value (a tensor or a number) summed over the data axis of the
    sharded step being run, in one all-reduce of a flat buffer in the first
    tensor's dtype, on its device; outside a sharded step, or on a data
    axis of a single process, the values themselves.  One value comes back
    alone, several as a tuple.  ``batch_sum.calls`` counts the
    all-reduces."""
    mesh = active()
    if mesh is None or mesh.data.size == 1:  # one process: nothing to sum
        return values[0] if len(values) == 1 else values
    batch_sum.calls += 1
    return _summed(mesh.data, values)


batch_sum.calls = 0


def latent_axis():
    """The latent axis (a mesh) of the sharded step being run when it
    spans several processes, else None."""
    mesh = active()
    axis = None if mesh is None else mesh.latent_axis
    return axis if axis is not None and axis.size > 1 else None


def latent_sum(*values):
    """Each value summed over the latent axis of the sharded step being
    run, in one all-reduce (as :func:`batch_sum`); outside a sharded step,
    or on a latent axis of one process, the values themselves.
    ``latent_sum.calls`` counts the all-reduces."""
    axis = latent_axis()
    if axis is None:
        return values[0] if len(values) == 1 else values
    latent_sum.calls += 1
    return _summed(axis, values)


latent_sum.calls = 0


def latent_lead() -> bool:
    """Whether this process counts the terms that do not depend on the
    class: the latent axis's first process, or any process outside a
    latent-sharded step."""
    axis = latent_axis()
    return axis is None or axis.rank == 0


def own_latents(t, dim: int = 0):
    """This process's block of ``t``'s ``dim`` (all K classes) on a
    latent-sharded step, as ``mesh.shard_latents`` cuts the latents (a
    view); ``t`` itself outside one."""
    axis = latent_axis()
    if axis is None:
        return t
    lo, hi = axis.block(t.shape[dim])
    return t.narrow(dim, lo, hi - lo)
