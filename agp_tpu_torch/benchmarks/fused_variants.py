"""The design-sweep variants of the fused statistics pass (kernels 8 and 9 of
the port), their plain versions and the sweep's bar: the counterparts of
``benchmarks/fused_variants.py`` in the JAX package.

Both variants compute kernel 1's pass (``ops/cuda_kernels.py::
fused_cavi_stats``) for the RBF gram and the logistic likelihood, and
differ in how they form kappa:

* ``direct_stats``: kappa = Knm K^-1, with K^-1 = L^-T L^-1 formed outside
  the kernel, and Ktilde = var + jitt - rowsum(kappa o Knm).  Its
  ``variant`` is "transpose", "nt" or "packed".  The first two differ only
  in how the TPU's matrix unit is fed S2; on the card they are one kernel.
  "packed" puts mu beside Sigma, so that one product gives kappa Sigma
  and mf.
* ``two_factor_nt``: W = Knm L^-T, Ktilde = var + jitt - rowsum(W o W)
  (a sum of squares, which does not cancel against Knm), kappa = W L^-1.

Each takes the reference's arguments, xb [B, D], yb [B] (+-1), Z [M, D],
L_invT = (chol(Kmm)^-1)^T [M, M], mu [M], Sigma [M, M] and the numbers
(or 1-element tensors) ls, var, jitt, rho, and returns (s1 [M],
S2 [M, M], c [B], theta [B], mf [B], vf [B]) with s1 = kappa^T (rho y/2)
and S2 = kappa^T diag(rho theta/2) kappa.  ``tile_b`` is taken for the
reference's signature and changes nothing: the card's tile is the
kernel's own and its ragged last tile is masked.  (The reference pads B
up to a multiple of ``tile_b`` and does not mask the padded rows, whose
theta reaches S2; here the B rows given are the rows summed.)

On a CPU tensor a wrapper runs its ``*_reference``, the same function in
plain PyTorch (any float dtype).  On a CUDA tensor it launches its kernel
(``csrc/fused_variants.cu``: float32, any B, D >= 1 and M up to
``variant_max_m``, 2,392 on an H100; kappa and kappa Sigma in 3xTF32 on
the tensor cores, kernel 9's W in four TF32 passes, then kernels 5 and
7's statistics tiles) or raises; there is no fallback.  Each wrapper
counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import functools

import torch

from ..ops import cuda_kernels as ck
from ..ops.linalg import _highest_precision

VARIANTS = ("transpose", "nt", "packed")
# the kernel's forms, in the order of their codes in csrc/fused_variants.cu
# (Form): "transpose" and "nt" are the direct form
_FORMS = ("direct", "packed", "two_factor")
# the kernels' row tiles, in the order of csrc/fused_variants.cu::
# with_variant_tile: (rows, columns of an output tile, rows of a stage of
# the ring, warp columns).  The first, the narrow tile, is taken where
# kappa's M columns fit its output tile (on an H100 at the sweep's M=128
# it beat the next by 27 % in "nt", 18 % in "packed", whose 136-column
# operand takes two of its output tiles, and 37 % in the two-factor form;
# PERF.md); the others are kernel 4's (ops/cuda_kernels.py::
# _KAPPA_TILES), the largest that fits.
_VARIANT_TILES = ((64, 128, 16, 4), (64, 256, 16, 8), (32, 256, 16, 8), (16, 128, 8, 8))


def variant_cols(form: str, M: int) -> int:
    """Columns of the Sigma operand form ``form`` (of ``_FORMS``) streams
    at M: M, or for "packed" [Sigma | mu ...] (mu repeated in the padding),
    M + 1 rounded up to whole 8-column steps."""
    return -(-(M + 1) // 8) * 8 if form == "packed" else M


def variant_smem_bytes(M: int, tile: tuple) -> int:
    """Shared memory of kernels 8-9 at M with a row tile of
    ``_VARIANT_TILES``: the [TB, M] slab (row stride M rounded up to 8,
    + 4), the ring (3 stages of KB rows of NT + 8 floats) or the gram's
    staging of 8 features (8 (TB + M + 2) floats), whichever is larger, and
    three row sums of WARPS_N x TB.  A Python copy of
    ``agp_fused_variant_smem_bytes`` (which names this function): change
    them together."""
    rows, cols, stage_rows, warps_n = tile
    ring = 3 * stage_rows * (cols + 8)
    staging = 8 * (rows + M + 2)
    return 4 * (rows * (-(-M // 8) * 8 + 4) + max(ring, staging) + 3 * warps_n * rows)


@functools.lru_cache(maxsize=None)
def variant_tile(M: int, limit: int = ck.SMEM_OPTIN):
    """The row tile (of ``_VARIANT_TILES``) kernels 8-9 take at M, every
    form alike: the narrow tile where M fits its output tile, else the
    first of the others whose ``variant_smem_bytes`` fits ``limit`` bytes
    (by default what a block may opt into on an H100); None beyond the
    range.  The same answer on the CPU and on the card."""
    narrow, *others = _VARIANT_TILES
    tiles = _VARIANT_TILES if M <= narrow[1] else others
    return next((t for t in tiles if M >= 1 and variant_smem_bytes(M, t) <= limit), None)


def variant_max_m(limit: int = ck.SMEM_OPTIN) -> int:
    """The largest M kernels 8-9 take within ``limit`` bytes of shared
    memory a block."""
    lo, hi = 0, 1 << 16  # variant_smem_bytes grows with M
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if variant_tile(mid, limit) else (lo, mid)
    return lo


def _check_variant(variant):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; the variants are {VARIANTS}")


def direct_stats_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, variant="nt", tile_b=1024):
    """Plain PyTorch version of :func:`direct_stats`, in the inputs' dtype,
    on their device: kernel 1's plain version for the RBF gram and the
    logistic likelihood, which forms kappa the same way.  Every variant
    computes the same function."""
    _check_variant(variant)
    return ck.fused_cavi_stats_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, kind="rbf",
                                         lik="logistic")


@_highest_precision
def two_factor_nt_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, tile_b=1024):
    """Plain PyTorch version of :func:`two_factor_nt`, in the inputs' dtype,
    on their device: W = Knm L^-T, Ktilde = max(var + jitt - rowsum(W o W),
    1e-12), kappa = W L^-1, then kernel 1's moments, logistic E-step and
    statistics.  The gram by direct differences (``_sq_dist_chunked``)."""
    ls = torch.as_tensor(ls, dtype=xb.dtype, device=xb.device)
    var = torch.as_tensor(var, dtype=xb.dtype, device=xb.device).reshape(1)
    knm = ck._gram_from_r2(ck._sq_dist_chunked((xb / ls)[None], (Z / ls)[None]), var[:, None, None], "rbf")[0]
    W = knm @ L_invT
    ktilde = torch.clamp(var + jitt - torch.sum(W * W, dim=-1), min=1e-12)
    kappa = W @ L_invT.T
    mf = kappa @ mu
    vf = torch.clamp(ktilde + torch.sum((kappa @ Sigma) * kappa, dim=-1), min=1e-12)
    c, theta, gmu, gs = ck._estep_reference("logistic", mf, vf, yb, 0.0, 0.0)
    s1, S2 = ck.cavi_stats_reference(kappa, rho * gmu, rho * gs)
    return s1, S2, c, theta, mf, vf


@_highest_precision
def xla_stats_reference(X, y, Z, Kinv, mu, Sigma, ls, var, rho):
    """The sweep's bar (``xla_stats`` in the reference's
    ``benchmarks/fused_variants.py::main``) in PyTorch: the same statistics
    (s1 [M], S2 [M, M]) as a chain of plain tensor ops from K^-1, with the
    gram by the expanded |x|^2 + |z|^2 - 2 x.z, the sweep's jitter 1e-4
    and vf unfloored, as there."""
    x, z = X / ls, Z / ls
    r2 = torch.clamp(torch.sum(x * x, 1)[:, None] + torch.sum(z * z, 1)[None, :] - 2.0 * x @ z.T, min=0.0)
    knm = var * torch.exp(-0.5 * r2)
    kappa = knm @ Kinv
    ktilde = torch.clamp(var + 1e-4 - torch.sum(kappa * knm, 1), min=1e-12)
    mf = kappa @ mu
    vf = ktilde + torch.sum((kappa @ Sigma) * kappa, 1)
    c = torch.sqrt(mf * mf + vf)
    theta = torch.tanh(c / 2.0) / (2.0 * c)
    s1 = kappa.T @ (rho * (y / 2.0))
    S2 = (kappa * (rho * theta / 2.0)[:, None]).T @ kappa
    return s1, S2


def _params(dev, D, jitt, rho, var, ls):
    """The kernels' float32 scalar buffer on the card, (jitter, rho, 0,
    var, ls [D]) (``ops/cuda_kernels.py::_multi_params``' layout, one
    latent): one host-to-device copy where all are numbers, else made
    there from the 1-element tensors, with no host read either way."""
    vals = (jitt, rho, 0.0, var, ls)
    if not any(isinstance(v, torch.Tensor) for v in vals):
        host = torch.tensor([float(v) for v in vals[:4]] + [float(ls)] * D, dtype=torch.float32)
        return host.to(dev, non_blocking=True)
    scalars = [ck._device_scalar(v, dev) for v in vals]
    return torch.stack(scalars[:4] + scalars[4:] * D)


def _variant_launch(name, form, xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, tile=None):
    """Checks, operands, scratch and the launches of kernel 8 ("direct",
    "packed") or 9 ("two_factor") on CUDA tensors, with the row tile
    ``variant_tile`` picks, or ``tile`` (of ``_VARIANT_TILES``: a
    measurement's choice).  Returns (s1, S2, c, theta, mf, vf)."""
    B, D = xb.shape
    M = Z.shape[0]
    ck._check_tensors(xb, {"xb": (xb, (B, D)), "yb": (yb, (B,)), "Z": (Z, (M, D)), "mu": (mu, (M,)),
                           "Sigma": (Sigma, (M, M))})
    dev = xb.device
    limit = ck._smem_limit(dev.index) if dev.type == "cuda" else ck.SMEM_OPTIN
    tile = tile or variant_tile(M, limit)
    if B < 1 or D < 1 or tile is None:
        raise ValueError(f"the CUDA {name} takes B, D >= 1 and 1 <= M <= {variant_max_m(limit)} (one [TB, M] slab "
                         f"a block within {limit} bytes of shared memory); got B={B}, D={D}, M={M}")
    if L_invT.device != dev or tuple(L_invT.shape) != (M, M):
        raise ValueError(f"L_invT must be [{M}, {M}] on {dev}")
    lib = ck._library()
    L_invT = L_invT.to(torch.float32)
    if form == "two_factor":  # W = Knm L^-T, then kappa = W L^-1 from L^-1's rows
        a, linv = L_invT.contiguous(), L_invT.T.contiguous()
    else:
        a = linv = ck._kinv(L_invT)
    sig, ns = Sigma, variant_cols(form, M)
    if form == "packed":  # [Sigma | mu ...]: kappa Sigma's column M is mf; no column past it is read
        sig = torch.cat([Sigma, mu[:, None].expand(M, ns - M)], 1)
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        params = _params(dev, D, jitt, rho, var, ls)
        nchunks, rows = ck._stats_plan(B, M, 1, ck._stats_slots(dev.index or 0), lib.agp_cavi_stats_tile())
        kappa = torch.empty((B, M), **f32)
        c, theta, mf, vf, wg, ws = torch.empty((6, B), **f32).unbind(0)
        s1_part, s2_part = torch.empty((nchunks, M), **f32), torch.empty((nchunks, M, M), **f32)
        s1, S2 = torch.empty((M,), **f32), torch.empty((M, M), **f32)
        err = lib.agp_fused_variant_stats(
            *(t.data_ptr() for t in (xb, yb, Z, a, linv, mu, sig, params, c, theta, mf, vf, kappa, wg, ws, s1_part,
                                     s2_part, s1, S2)),
            B, D, M, ns, _FORMS.index(form), tile[0], tile[1], nchunks, rows,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise ck._cuda_error(name, lib, err)
    return s1, S2, c, theta, mf, vf


def direct_stats(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, variant="nt", tile_b=1024):
    """Kernel 1's pass with kappa = Knm K^-1 (kernel 8, the port of the
    reference's ``direct_stats``); ``variant`` of ``VARIANTS``, arguments
    and returns as the module says.

    A CPU tensor runs :func:`direct_stats_reference`.  A CUDA tensor
    launches the kernel ("transpose" and "nt" the same form, "packed"
    streaming [Sigma | mu ...]) and adds one to
    ``direct_stats.launches``."""
    _check_variant(variant)
    if xb.device.type == "cpu":
        return direct_stats_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, variant=variant)
    if xb.device.type != "cuda":
        raise ValueError(f"direct_stats runs on CPU or CUDA tensors, got {xb.device}")
    out = _variant_launch("direct_stats", "packed" if variant == "packed" else "direct",
                          xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho)
    direct_stats.launches += 1
    return out


direct_stats.launches = 0


def two_factor_nt(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, tile_b=1024):
    """Kernel 1's pass with kappa in the two-factor form W = Knm L^-T,
    kappa = W L^-1 (kernel 9, the port of the reference's
    ``two_factor_nt``); it takes L^-T and forms no K^-1.  Arguments and
    returns as the module says.

    A CPU tensor runs :func:`two_factor_nt_reference`.  A CUDA tensor
    launches the kernel and adds one to ``two_factor_nt.launches``."""
    if xb.device.type == "cpu":
        return two_factor_nt_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho)
    if xb.device.type != "cuda":
        raise ValueError(f"two_factor_nt runs on CPU or CUDA tensors, got {xb.device}")
    out = _variant_launch("two_factor_nt", "two_factor", xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho)
    two_factor_nt.launches += 1
    return out


two_factor_nt.launches = 0
