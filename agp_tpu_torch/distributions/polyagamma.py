"""Polya-Gamma sampling, exact: the counterpart of
``agp_tpu/distributions/polyagamma.py``.

* ``sample_pg1(generator, c)``: omega ~ PG(1, c) by the Polson-Scott-Windle
  alternating-series rejection sampler, as one masked loop over the whole
  batch.  Each trip every lane not yet accepted draws one proposal (a
  truncated exponential on (t, inf) or one attempt at a truncated inverse
  Gaussian on (0, t]) and runs the alternating partial-sum accept test over
  ``n_terms`` terms at once.  The loop reads "all lanes done" on the host
  once every few trips (``utils.tensors.run_trips``), never past
  ``max_trips`` trips; a lane that never drains keeps 2/pi^2, as the
  reference's does.
* ``sample_pg(generator, b, c)``: PG additivity in b.  The first
  min(floor(b), int_cap) units are exact PG(1, c) draws, made by one
  ``sample_pg1`` call over a leading [int_cap] axis; the residual (the
  fractional part, and any excess above the cap) is the truncated Gamma
  series with a closed-form tail-mean correction.

Moments: E[PG(b, c)] = b tanh(c/2) / (2c),
Var[PG(b, c)] = b (sinh(c) - c) / (4 c^3 cosh^2(c/2)).
"""
from __future__ import annotations

import math

import torch

from ..utils.tensors import host_read, run_trips

TWO_PI_SQ = 2.0 * math.pi**2
_T = 0.64  # PSW threshold between the inverse-Gaussian body and the exponential tail


def _work_dtype(*dtypes):
    out = torch.float32
    for d in dtypes:
        out = torch.promote_types(out, d)
    return out


def _coef_a(n, x):
    """Alternating-series coefficient a_n(x) of the J*(1, z) density, in its
    piecewise form around the threshold t; n broadcasts against x."""
    k = (n + 0.5) * math.pi
    right = k * torch.exp(-(k**2) * x / 2.0)  # x > t
    safe_x = torch.clamp(x, min=1e-30)
    # x <= t: (2/(pi x))^{3/2} k exp(-2 (n+1/2)^2 / x)
    left = torch.exp(-1.5 * (math.log(math.pi / 2.0) + torch.log(safe_x)) + torch.log(k) - 2.0 * (n + 0.5) ** 2 / safe_x)
    return torch.where(x > _T, right, left)


def _mass_texpon(z, K):
    """Probability of the truncated-exponential mixture component."""
    sqrt_inv_t = 1.0 / math.sqrt(_T)
    b = sqrt_inv_t * (_T * z - 1.0)
    a = -sqrt_inv_t * (_T * z + 1.0)
    x0 = torch.log(K) + K * _T
    xb = x0 - z + torch.special.log_ndtr(b)
    xa = x0 + z + torch.special.log_ndtr(a)
    qdivp = (4.0 / math.pi) * (torch.exp(xb) + torch.exp(xa))
    return 1.0 / (1.0 + qdivp)


def _series_accept(u, x, n_terms: int):
    """The alternating-sum squeeze test: accept x with probability
    f(x) / a_0(x), given u ~ U[0, 1).  The partial sums S_n bracket the
    density; the first n that decides (odd n: u a_0 <= S_n accepts, even n:
    u a_0 > S_n rejects) is the decision, as the reference's sequential
    loop takes it.  Undecided after ``n_terms`` terms counts as rejected."""
    n = torch.arange(n_terms + 1, dtype=x.dtype, device=x.device).reshape((-1,) + (1,) * x.ndim)
    signs = 1.0 - 2.0 * torch.remainder(n, 2.0)
    S = torch.cumsum(signs * _coef_a(n, x.unsqueeze(0)), dim=0)  # [n_terms + 1, ...]
    y = u * S[0]
    odd = signs[1:] < 0
    decides = torch.where(odd, y <= S[1:], y > S[1:])
    first = torch.argmax(decides.to(torch.int8), dim=0)
    return decides.any(0) & (torch.remainder(first, 2) == 0)  # n = first + 1 is odd


def sample_pg1(generator, c, n_terms: int = 12, max_trips: int = 64, skip=None):
    """omega ~ PG(1, c) elementwise, exact; c any shape, on the generator's
    device.  Returns c's dtype.  Lanes where ``skip`` (a bool tensor of c's
    shape) holds count as done from the start: the loop does not wait for
    them, and their values are to be discarded."""
    c = torch.as_tensor(c)
    dtype = _work_dtype(c.dtype)
    z = torch.abs(c.to(dtype)) / 2.0  # sample J*(1, z) / 4
    shape, device = z.shape, z.device
    K = math.pi**2 / 8.0 + z**2 / 2.0
    r = _mass_texpon(z, K)
    mu = 1.0 / torch.clamp(z, min=1e-30)  # the IG mean (z = 0: improper, the body path)
    big_mu = mu > _T
    x = torch.full(shape, 2.0 / math.pi**2, dtype=dtype, device=device)  # ~E[J*(1, 0)] fallback
    done = torch.zeros(shape, dtype=torch.bool, device=device) if skip is None else skip.clone()
    pending = torch.zeros(shape, dtype=torch.bool, device=device)

    def trip():
        nonlocal x, done, pending
        U = torch.rand((7,) + tuple(shape), generator=generator, dtype=dtype, device=device)
        nu = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        u_choice, u_tail, u_e1, u_e2, u_thin, u_flip, u_ser = U
        # the branch is drawn again only when NOT part-way through the body
        # sampler's inner rejection: a lane committed to the body keeps
        # retrying the truncated IG (choosing again there would favour the
        # tail and bias the law)
        tail = u_choice < r
        use_tail = (~pending) & tail
        body = pending | ((~pending) & ~tail)

        # tail: x = t + Exp/K on (t, inf), always a valid proposal
        x_tail = _T - torch.log1p(-u_tail) / K

        # body, mu > t: the chi-square method and exp(-z^2 x / 2) thinning
        E1, E2 = -torch.log1p(-u_e1), -torch.log1p(-u_e2)
        x_chi = _T / (1.0 + _T * E1) ** 2
        ok_chi = (E1**2 <= 2.0 * E2 / _T) & (u_thin <= torch.exp(-(z**2) * x_chi / 2.0))
        # body, mu <= t: one Michael-Schucany-Haas IG(mu, 1) draw, kept if <= t
        muY = mu * nu**2
        x_ig = mu + mu * muY / 2.0 - mu / 2.0 * torch.sqrt(4.0 * muY + muY**2)
        x_ig = torch.where(u_flip <= mu / (mu + x_ig), x_ig, mu**2 / torch.clamp(x_ig, min=1e-30))
        x_body = torch.where(big_mu, x_chi, x_ig)
        ok_body = torch.where(big_mu, ok_chi, x_ig <= _T)

        proposal = torch.where(use_tail, x_tail, x_body)
        valid = use_tail | (body & ok_body)
        newly = (~done) & valid & _series_accept(u_ser, proposal, n_terms)
        x = torch.where(newly, proposal, x)
        # committed to the body until it yields a valid draw; a valid draw
        # that the series rejects starts the outer cycle again
        pending = (~done) & body & (~ok_body)
        done = done | newly
        return done

    run_trips(trip, max_trips)
    return (x / 4.0).to(c.dtype)


def sample_pg(generator, b, c, n_terms: int = 64, int_cap: int = 16):
    """omega ~ PG(b, c) elementwise for any b >= 0 (b and c broadcast; b
    may be data, e.g. y + gamma in the Poisson, negative binomial and
    multiclass Gibbs draws).  The units are one ``sample_pg1`` call over a
    leading axis as long as the largest unit count of the batch (one host
    read), each lane's units past its own count skipped."""
    b, c = torch.as_tensor(b), torch.as_tensor(c)
    b, c = torch.broadcast_tensors(b, c)
    dtype = _work_dtype(b.dtype, c.dtype)
    bw, cw = b.to(dtype), c.to(dtype)
    n_int = torch.clamp(torch.floor(bw), max=float(int_cap))  # exact units
    resid = torch.clamp(bw - n_int, min=0.0)
    total = torch.zeros(b.shape, dtype=dtype, device=b.device)
    n_units = int(host_read(n_int.max()))
    if n_units > 0:
        idx = torch.arange(n_units, dtype=dtype, device=b.device).reshape((-1,) + (1,) * b.ndim)
        skip = idx >= n_int
        units = sample_pg1(generator, cw.expand((n_units,) + tuple(b.shape)), skip=skip)  # one call
        total = torch.sum(torch.where(skip, 0.0, units), dim=0)
    total = total + _series_residual(generator, resid, cw, n_terms)
    out_dtype = torch.promote_types(b.dtype, c.dtype)
    return torch.where(bw <= 0.0, 0.0, total).to(out_dtype)


def _series_residual(generator, e, c, n_terms: int):
    """The truncated Gamma-series draw of PG(e, c) plus the closed-form
    mean of the dropped tail sum_{k > n_terms} E[g_k] / d_k."""
    dtype = e.dtype
    k = torch.arange(1, n_terms + 1, dtype=dtype, device=e.device)
    w = (c / (2.0 * math.pi)) ** 2
    shape = tuple(e.shape) + (n_terms,)
    g = torch._standard_gamma(torch.clamp(e, min=1e-12)[..., None].expand(shape).contiguous(), generator=generator)
    series = torch.sum(g / ((k - 0.5) ** 2 + w[..., None]), dim=-1) / TWO_PI_SQ
    sqrt_w = torch.sqrt(torch.clamp(w, min=1e-12))
    tail_sum = (math.pi / 2.0 - torch.atan((n_terms + 0.5) / sqrt_w)) / sqrt_w
    tail_sum = torch.where(w < 1e-10, 1.0 / (n_terms + 0.5), tail_sum)
    tail = e * tail_sum / TWO_PI_SQ
    return torch.where(e <= 0.0, 0.0, series + tail)


def sample_pg_series(generator, b, c, n_terms: int = 64):
    """The fully-series sampler (mean-exact, its variance slightly low from
    the truncation), kept for comparison with the exact path."""
    b, c = torch.broadcast_tensors(torch.as_tensor(b), torch.as_tensor(c))
    dtype = _work_dtype(b.dtype, c.dtype)
    return _series_residual(generator, b.to(dtype), c.to(dtype), n_terms).to(torch.promote_types(b.dtype, c.dtype))


def pg_mean(b, c):
    """E[PG(b, c)] = b tanh(c/2) / (2c), with the c -> 0 limit b/4."""
    c = torch.as_tensor(c, dtype=torch.float64) if not isinstance(c, torch.Tensor) else c
    small = torch.abs(c) < 1e-6
    safe_c = torch.where(small, 1.0, c)
    return torch.where(small, b / 4.0, b * torch.tanh(safe_c / 2.0) / (2.0 * safe_c))


def pg_var(b, c):
    """Var[PG(b, c)] = b (sinh(c) - c) / (4 c^3 cosh^2(c/2)), with the
    c -> 0 limit b/24."""
    c = torch.as_tensor(c, dtype=torch.float64) if not isinstance(c, torch.Tensor) else c
    small = torch.abs(c) < 1e-4
    safe_c = torch.where(small, 1.0, c)
    val = b * (torch.sinh(safe_c) - safe_c) / (4.0 * safe_c**3 * torch.cosh(safe_c / 2.0) ** 2)
    return torch.where(small, b / 24.0, val)
