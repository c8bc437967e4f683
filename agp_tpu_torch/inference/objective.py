"""The training objective's dispatch: the counterpart of
``agp_tpu/inference/objective.py``.  The numerical engines take the
numerical ELBO of ``inference/numerical_vi.py``, every other engine the
analytic ELBO of ``inference/analytic_vi.py``, a multi-output model its
own (``models/multioutput.py::mo_elbo``)."""
from __future__ import annotations

from . import analytic_vi, numerical_vi
from .config import NUMERICAL


def objective(model, state, x, y, kmat=None):
    """The ELBO of ``model`` on the batch (x, y) whose local variables are
    in ``state``, with the prior's matrices ``kmat`` (default
    ``state.kmat``)."""
    if getattr(model, "is_multioutput", False):
        from ..models.multioutput import mo_elbo

        return mo_elbo(model, state, x, y, kmat=kmat)
    if model.inference.name in NUMERICAL:
        return numerical_vi.elbo(model, state, x, y, kmat=kmat)
    return analytic_vi.elbo(model, state, x, y, kmat=kmat)
