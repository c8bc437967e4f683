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
(``csrc/fused_variants.cu``; float32, the shapes of
``cuda_kernels.fused_fits(1, D, M)``, so M <= 128) or raises; there is no
fallback.  Each wrapper counts its launches in ``<wrapper>.launches``.
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


@functools.lru_cache(maxsize=None)
def _resident_blocks(device_index: int, D: int, M: int, form: str) -> int:
    """Blocks of the form's kernel the card holds at once at (D, M): the
    bound of its grid."""
    with torch.cuda.device(device_index):
        per_sm = ck._library().agp_fused_variant_blocks_per_sm(D, M, _FORMS.index(form))
        sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    if per_sm < 1:
        raise RuntimeError(f"the fused variants' {form} kernel fits no block on an SM at D={D}, M={M}")
    return per_sm * sms


def _variant_launch(name, form, xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho):
    """Checks, scratch and the launch of kernel 8 ("direct", "packed") or 9
    ("two_factor") on CUDA tensors.  Returns (s1, S2, c, theta, mf, vf)."""
    B, D = xb.shape
    M = Z.shape[0]
    ck._check_tensors(xb, {"xb": (xb, (B, D)), "yb": (yb, (B,)), "Z": (Z, (M, D)), "mu": (mu, (M,)),
                           "Sigma": (Sigma, (M, M))})
    if B < 1 or D < 1 or not ck.fused_fits(1, D, M):
        raise ValueError(f"the CUDA {name} takes B, D >= 1 and the shapes of fused_fits(1, D, M) "
                         f"(1 <= M <= {ck.MAX_M}); got B={B}, D={D}, M={M}")
    dev = xb.device
    if L_invT.device != dev or tuple(L_invT.shape) != (M, M):
        raise ValueError(f"L_invT must be [{M}, {M}] on {dev}")
    lib = ck._library()
    L_invT = L_invT.to(torch.float32)
    a = L_invT.contiguous() if form == "two_factor" else ck._kinv(L_invT)
    with torch.cuda.device(dev):
        limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", ck.SMEM_OPTIN)
        smem = lib.agp_fused_variant_smem_bytes(D, M)
        if smem > limit:
            raise ValueError(f"{name} at D={D}, M={M} needs {smem} bytes of shared memory; "
                             f"this card allows {limit} per block")
        params = torch.stack([ck._device_scalar(v, dev) for v in (ls, var, jitt, rho)])
        nb = min(-(-B // lib.agp_fused_variant_tile_rows()), _resident_blocks(dev.index or 0, D, M, form))
        f32 = dict(dtype=torch.float32, device=dev)
        s1_part, s2_part = torch.empty((nb, M), **f32), torch.empty((nb, M, M), **f32)
        s1, S2 = torch.empty((M,), **f32), torch.empty((M, M), **f32)
        c, theta, mf, vf = (torch.empty((B,), **f32) for _ in range(4))
        err = lib.agp_fused_variant_stats(
            *(t.data_ptr() for t in (xb, yb, Z, a, mu, Sigma, params, c, theta, mf, vf, s1_part, s2_part, s1, S2)),
            B, D, M, _FORMS.index(form), nb, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise ck._cuda_error(name, lib, err)
    return s1, S2, c, theta, mf, vf


def direct_stats(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, variant="nt", tile_b=1024):
    """Kernel 1's pass with kappa = Knm K^-1 (kernel 8, the port of the
    reference's ``direct_stats``); ``variant`` of ``VARIANTS``, arguments
    and returns as the module says.

    A CPU tensor runs :func:`direct_stats_reference`.  A CUDA tensor
    launches the kernel ("transpose" and "nt" the same instance, "packed"
    with [Sigma | mu] in shared memory) and adds one to
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
