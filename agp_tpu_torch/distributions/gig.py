"""Generalized-inverse-Gaussian sampling for any p: the counterpart of
``agp_tpu/distributions/gig.py``.  Density f(x) proportional to
x^{p-1} exp(-(a x + b / x) / 2).

* |p| = 1/2 (a number) takes the exact, rejection-free inverse-Gaussian
  route (Michael-Schucany-Haas): one normal and one uniform a lane.
* Any other p: standardize to Y ~ GIG(lam=|p|, omega, omega) with
  omega = sqrt(ab) (X = sqrt(b/a) Y, and 1/Y for p < 0), then choose per
  lane among Hormann-Leydold's three regimes: the shifted
  ratio-of-uniforms (lam >= 1 or omega > 1; its box from the cubic's roots
  in the trigonometric Cardano form), the plain ratio-of-uniforms, and a
  Gamma proposal for small omega and lam < 1.  One masked loop over the
  batch (``utils.tensors.run_trips``), at most ``max_trips`` trips; the
  envelopes carry a 1e-4 relative margin so that rounding never makes one
  invalid.
"""
from __future__ import annotations

import math

import torch

from ..utils.tensors import run_trips


def sample_inverse_gaussian(generator, mu, lam):
    """Michael-Schucany-Haas: exact and rejection-free."""
    mu, lam = torch.broadcast_tensors(torch.as_tensor(mu), torch.as_tensor(lam))
    nu = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    y = nu**2
    x = mu + mu**2 * y / (2.0 * lam) - mu / (2.0 * lam) * torch.sqrt(4.0 * mu * lam * y + (mu * y) ** 2)
    u = torch.rand(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return torch.where(u <= mu / (mu + x), x, mu**2 / torch.clamp(x, min=1e-30))


def _log_g(y, lam, omega):
    """log of the unnormalized standardized density
    g(y) = y^(lam-1) exp(-(omega/2)(y + 1/y))."""
    y = torch.clamp(y, min=1e-30)
    return (lam - 1.0) * torch.log(y) - 0.5 * omega * (y + 1.0 / y)


def _gig_mode(lam, omega):
    """argmax of g: ((lam-1) + sqrt((lam-1)^2 + omega^2)) / omega, in the
    conjugate form omega / (sqrt((lam-1)^2 + omega^2) + (1 - lam)) for
    lam < 1, where the first form cancels (to a 0 mode in float32 when
    omega << 1 - lam)."""
    lm1 = lam - 1.0
    root = torch.sqrt(lm1**2 + omega**2)
    return torch.where(lm1 >= 0.0, (lm1 + root) / omega, omega / (root - lm1))


def _cubic_roots(p2, p1, p0):
    """The three real roots of x^3 + p2 x^2 + p1 x + p0 (trigonometric
    Cardano; the shifted ratio-of-uniforms cubic has three real roots),
    unordered."""
    q = p1 - p2**2 / 3.0
    r = p0 + (2.0 * p2**3 - 9.0 * p2 * p1) / 27.0
    mq3 = torch.sqrt(torch.clamp(-q / 3.0, min=1e-30))
    arg = torch.clamp(3.0 * r / (2.0 * q * mq3 + 1e-30), -1.0, 1.0)
    theta = torch.arccos(arg)
    shift = -p2 / 3.0
    return tuple(2.0 * mq3 * torch.cos((theta - 2.0 * math.pi * k) / 3.0) + shift for k in (0.0, 1.0, 2.0))


def _sample_gig_std(generator, lam, omega, max_trips: int = 256):
    """Y ~ GIG(lam, omega, omega) elementwise, lam >= 0, omega > 0."""
    lam, omega = torch.broadcast_tensors(torch.as_tensor(lam), torch.as_tensor(omega))
    dtype = torch.promote_types(torch.promote_types(lam.dtype, omega.dtype), torch.float32)
    lam, omega = lam.to(dtype), torch.clamp(omega.to(dtype), min=1e-12)
    shape, device = lam.shape, lam.device
    margin = 1.0 + 1e-4

    m = _gig_mode(lam, omega)
    log_gm = _log_g(m, lam, omega)  # normalized by g(m), so v+ = 1

    # the regimes (Hormann-Leydold 2014)
    r1 = (lam >= 1.0) | (omega > 1.0)
    small = omega < torch.clamp((2.0 / 3.0) * torch.sqrt(torch.clamp(1.0 - lam, min=0.0)), max=0.5)
    r3 = (~r1) & small & (lam > 1e-3)
    r2 = (~r1) & (~r3)

    # R1: the u-extrema from the cubic
    # x^3 - (m + 2(lam+1)/omega) x^2 + (2(lam-1)m/omega - 1) x + m = 0
    p2 = -(m + 2.0 * (lam + 1.0) / omega)
    p1 = 2.0 * (lam - 1.0) * m / omega - 1.0
    roots = torch.stack(_cubic_roots(p2, p1, m))
    # x- the largest root in (0, m), x+ the smallest above m
    xm = torch.where((roots < m) & (roots > 0.0), roots, -math.inf).amax(0)
    xp = torch.where(roots > m, roots, math.inf).amin(0)
    xm = torch.minimum(torch.clamp(xm, min=1e-12), m)  # guard degenerate cubics
    xp = torch.maximum(xp, m)
    u_lo = (xm - m) * torch.exp(0.5 * (_log_g(xm, lam, omega) - log_gm)) * margin
    u_hi = (xp - m) * torch.exp(0.5 * (_log_g(xp, lam, omega) - log_gm)) * margin

    # R2: sup x sqrt(g) at xr = ((lam+1) + sqrt((lam+1)^2 + omega^2)) / omega
    lp1 = lam + 1.0
    xr = (lp1 + torch.sqrt(lp1**2 + omega**2)) / omega
    u2_hi = xr * torch.exp(0.5 * (_log_g(xr, lam, omega) - log_gm)) * margin

    # R3: a Gamma(lam, omega/2) proposal (T = (omega/2) X ~ Gamma(lam, 1) by
    # Ahrens-Dieter's two pieces split at t = 1), the remaining GIG factor
    # exp(-omega^2 / (4T)) in the same accept test
    lam3 = torch.clamp(lam, min=1e-3)
    A1 = 1.0 / lam3
    p_piece1 = A1 / (A1 + math.exp(-1.0))

    y = m
    done = torch.zeros(shape, dtype=torch.bool, device=device)

    def trip():
        nonlocal y, done
        u1, u2, u3 = torch.rand((3,) + tuple(shape), generator=generator, dtype=dtype, device=device)
        log_v = torch.log(torch.clamp(u2, min=1e-30))
        # R1: shifted ratio-of-uniforms
        X1 = (u_lo + u1 * (u_hi - u_lo)) / torch.clamp(u2, min=1e-30) + m
        acc1 = (X1 > 0.0) & (2.0 * log_v <= _log_g(X1, lam, omega) - log_gm)
        # R2: plain ratio-of-uniforms
        X2 = u1 * u2_hi / torch.clamp(u2, min=1e-30)
        acc2 = 2.0 * log_v <= _log_g(X2, lam, omega) - log_gm
        # R3: the Gamma proposal's pieces and the GIG thinning
        use1 = u1 < p_piece1
        log_u3 = torch.log(torch.clamp(u3, min=1e-30))
        Ta = torch.clamp(u2 ** (1.0 / lam3), min=1e-30)  # t^(lam-1) body on (0, 1]
        acc_a = log_u3 <= -Ta - omega**2 / (4.0 * Ta)
        Tb = 1.0 - log_v  # e^-t tail on (1, inf)
        acc_b = log_u3 <= (lam3 - 1.0) * torch.log(Tb) - omega**2 / (4.0 * Tb)
        X3 = 2.0 * torch.where(use1, Ta, Tb) / omega
        acc3 = torch.where(use1, acc_a, acc_b)

        X = torch.where(r1, X1, torch.where(r2, X2, X3))
        acc = torch.where(r1, acc1, torch.where(r2, acc2, acc3))
        newly = (~done) & acc
        y = torch.where(newly, X, y)
        done = done | newly
        return done

    run_trips(trip, max_trips)
    return y


def sample_gig(generator, a, b, p, max_trips: int = 256):
    """X ~ GIG(a, b, p) elementwise; a, b broadcast; p a number or a
    tensor.  |p| = 1/2 as a number takes the inverse-Gaussian route; every
    other p the standardized three-regime sampler (the Matern-3/2 Gibbs
    draws take p = 3/2)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    shape = torch.broadcast_shapes(a.shape, b.shape, torch.as_tensor(p).shape)
    a = torch.clamp(a, min=1e-12).expand(shape)
    b = torch.clamp(b, min=1e-12).expand(shape)
    if isinstance(p, (int, float)):
        if p == -0.5:
            return sample_inverse_gaussian(generator, torch.sqrt(b / a), b)
        if p == 0.5:
            # 1/X ~ GIG(b, a, -1/2) = InverseGaussian(sqrt(a/b), a)
            return 1.0 / sample_inverse_gaussian(generator, torch.sqrt(a / b), a)
    p_t = torch.as_tensor(p, dtype=a.dtype, device=a.device).expand(shape)
    y = _sample_gig_std(generator, torch.abs(p_t), torch.sqrt(a * b), max_trips=max_trips)
    scale = torch.sqrt(b / a)
    return torch.where(p_t >= 0.0, scale * y, scale / y)


def _tensor(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float64)


def gig_mean(a, b, p):
    """E[X] = sqrt(b/a) K_{p+1}(omega) / K_p(omega), in closed form for
    |p| in {1/2, 3/2}."""
    a, b = _tensor(a), _tensor(b)
    sab, scale = torch.sqrt(a * b), torch.sqrt(b / a)
    if isinstance(p, (int, float)) and abs(abs(p) - 0.5) < 1e-12:
        # K_{3/2}/K_{1/2} = 1 + 1/z; K_{1/2}/K_{-1/2} = 1
        return scale * (1.0 + 1.0 / sab) if p == 0.5 else scale
    if isinstance(p, (int, float)) and abs(abs(p) - 1.5) < 1e-12:
        # K_{3/2}(z) = K_{1/2}(z)(1 + 1/z); K_{5/2}(z) = K_{1/2}(z)(1 + 3/z + 3/z^2)
        if p == 1.5:
            return scale * (1.0 + 3.0 / sab + 3.0 / sab**2) / (1.0 + 1.0 / sab)
        return scale / (1.0 + 1.0 / sab)
    raise NotImplementedError("the closed-form gig_mean covers |p| in {1/2, 3/2}")


def gig_mean_inv(a, b, p):
    """E[1/X] = sqrt(a/b) K_{p-1}(omega) / K_p(omega), in closed form for
    |p| in {1/2, 3/2}."""
    a, b = _tensor(a), _tensor(b)
    sab, scale = torch.sqrt(a * b), torch.sqrt(a / b)
    if isinstance(p, (int, float)) and abs(abs(p) - 0.5) < 1e-12:
        return scale * (1.0 + 1.0 / sab) if p == -0.5 else scale
    if isinstance(p, (int, float)) and abs(abs(p) - 1.5) < 1e-12:
        if p == 1.5:
            return scale / (1.0 + 1.0 / sab)
        return scale * (1.0 + 3.0 / sab + 3.0 / sab**2) / (1.0 + 1.0 / sab)
    raise NotImplementedError("the closed-form gig_mean_inv covers |p| in {1/2, 3/2}")
