"""The reduction seam of a sharded CAVI step.

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

Outside a sharded step :func:`batch_sum` returns its arguments as they are:
no copy, no extra op.  Inside one (``with sharded(mesh):``) it sums them
over the mesh's processes in one all-reduce of a flat buffer (the values
in one dtype: s1 and S2, or a likelihood's sums).  A mesh of one process,
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
    """Within this block :func:`batch_sum` sums over ``mesh``'s processes
    (a ``parallel.mesh.Mesh``; one of a single process sums over itself)."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active():
    """The mesh of the sharded step being run, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def batch_sum(*values):
    """Each value (a tensor or a number) summed over the processes of the
    sharded step being run, in one all-reduce of a flat buffer in the first
    tensor's dtype, on its device; outside a sharded step, or in one of a
    single process, the values themselves.  One value comes back alone,
    several as a tuple.  ``batch_sum.calls`` counts the all-reduces."""
    mesh = active()
    if mesh is None or mesh.size == 1:  # one process: nothing to sum
        return values[0] if len(values) == 1 else values
    like = next(v for v in values if isinstance(v, torch.Tensor))
    parts = [v if isinstance(v, torch.Tensor) else torch.full((), v, dtype=like.dtype, device=like.device)
             for v in values]
    flat = torch.cat([p.reshape(-1) for p in parts])
    mesh.all_reduce(flat)
    batch_sum.calls += 1
    out, start = [], 0
    for p in parts:
        out.append(flat[start:start + p.numel()].view(p.shape))
        start += p.numel()
    return out[0] if len(out) == 1 else tuple(out)


batch_sum.calls = 0
