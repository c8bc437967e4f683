"""The training objective's dispatch: the counterpart of
``agp_tpu/inference/objective.py``.  The port runs the analytic ELBO of
``inference/analytic_vi.py``; the numerical and multi-output objectives
are not ported yet."""
from __future__ import annotations

from . import analytic_vi


def objective(model, state, x, y, kmat=None):
    """The ELBO of ``model`` on the batch (x, y) whose local variables are
    in ``state``, with the prior's matrices ``kmat`` (default
    ``state.kmat``)."""
    if getattr(model, "is_multioutput", False) or model.inference.name != "AnalyticVI":
        raise NotImplementedError(
            f"the port's objective is the analytic ELBO; {model.inference.name} is not ported yet"
        )
    return analytic_vi.elbo(model, state, x, y, kmat=kmat)
