"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

``fused_cavi_stats`` is the counterpart of
``agp_tpu/ops/pallas_kernels.py::fused_cavi_stats``: the whole statistics
pass of one single-latent CAVI step (gram -> kappa -> latent moments ->
E-step -> s1, S2) in one kernel.  Its source is ``csrc/fused_cavi_stats.cu``.

* On a CPU tensor the wrapper runs ``fused_cavi_stats_reference``, the same
  function in plain PyTorch (any float dtype, the four stationary kinds).
* On a CUDA tensor it launches the kernel (float32, ``kind="rbf"``,
  ``lik="logistic"``) or raises; there is no fallback.

The kernel is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at the
first CUDA call, into ``agp_tpu_torch/_build/<hash of the sources>/``;
importing this module never calls ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .linalg import _highest_precision

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "fused_cavi_stats.cu",)
_BUILD_ROOT = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# largest inducing set the CUDA kernel takes (shared-memory residency of
# K^-1 and Sigma; see the note at the head of the .cu file)
MAX_M = 128


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels' shared library unless a build of the same
    sources exists.  Returns {"path", "seconds", "log"}; ``log`` holds
    ``nvcc``'s output (registers, shared memory, spills per kernel), empty
    when the library was already built."""
    out_dir = _BUILD_ROOT / _source_hash()
    lib = out_dir / "libagp_tpu_torch_cuda.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        tmp_lib = Path(tmp) / lib.name
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp_lib), *map(str, _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp_lib, lib)  # atomic: a concurrent build never sees half a file
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "log": proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.agp_fused_cavi_stats_rbf_logistic
    fn.argtypes = [p] * 15 + [i, i, i, p]
    fn.restype = i
    lib.agp_fused_cavi_smem_bytes.argtypes = [i, i]
    lib.agp_fused_cavi_smem_bytes.restype = ctypes.c_size_t
    lib.agp_fused_cavi_tile_rows.argtypes = []
    lib.agp_fused_cavi_tile_rows.restype = i
    lib.agp_cuda_error_string.argtypes = [i]
    lib.agp_cuda_error_string.restype = ctypes.c_char_p
    return lib


@_highest_precision
def _kinv(L_invT: torch.Tensor) -> torch.Tensor:
    """K^-1 = L^-T L^-1 from the stored triangular inverse, at full FP32,
    outside the kernel (as the reference's ``_kinv``)."""
    return (L_invT @ L_invT.mT).contiguous()


def _gram_from_r2(r2, variance, kind):
    if kind == "rbf":
        return variance * torch.exp(-0.5 * r2)
    if kind == "matern32":
        r = torch.sqrt(torch.clamp(3.0 * r2, min=1e-36))
        return variance * (1.0 + r) * torch.exp(-r)
    if kind == "matern52":
        r = torch.sqrt(torch.clamp(5.0 * r2, min=1e-36))
        return variance * (1.0 + r + r * r / 3.0) * torch.exp(-r)
    if kind == "matern12":
        r = torch.sqrt(torch.clamp(r2, min=1e-36))
        return variance * torch.exp(-r)
    raise ValueError(f"unknown kernel kind {kind!r}")


@_highest_precision
def fused_cavi_stats_reference(
    xb, yb, Z, L_invT, mu, Sigma, lengthscale, variance, jitt, rho,
    lik_p0=0.0, lik_p1=0.0, kind="rbf", lik="logistic",
):
    """Plain PyTorch version of :func:`fused_cavi_stats`, in the inputs'
    dtype, on their device.  Kinds: rbf, matern12, matern32, matern52;
    likelihood: logistic."""
    if lik != "logistic":
        raise NotImplementedError(f"likelihood {lik!r} is not ported yet")
    kinv = _kinv(L_invT)
    x = xb / lengthscale
    z = Z / lengthscale
    diff = x[:, None, :] - z[None, :, :]
    knm = _gram_from_r2(torch.sum(diff * diff, dim=-1), variance, kind)  # [B, M]
    kappa = knm @ kinv
    ktilde = torch.clamp(variance + jitt - torch.sum(kappa * knm, dim=1), min=1e-12)
    mf = kappa @ mu
    vf = torch.clamp(ktilde + torch.sum((kappa @ Sigma) * kappa, dim=1), min=1e-12)
    c = torch.sqrt(mf * mf + vf)
    theta = torch.tanh(c / 2.0) / (2.0 * c)
    gmu = rho * (yb / 2.0)
    gs = rho * (theta / 2.0)
    s1 = kappa.T @ gmu
    S2 = (kappa * gs[:, None]).T @ kappa
    return s1, S2, c, theta, mf, vf


def _device_scalar(v, device) -> torch.Tensor:
    """A 0-d float32 tensor on ``device``, made there (no host-to-device
    copy, no sync) when ``v`` is a Python number."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.numel() != 1:
            raise ValueError(f"scalar argument must be a 1-element tensor on {device}")
        return v.reshape(()).to(torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def _check_cuda_args(xb, yb, Z, mu, Sigma, kind, lik):
    if (kind, lik) != ("rbf", "logistic"):
        raise NotImplementedError(
            f"the CUDA fused_cavi_stats takes kind='rbf', lik='logistic'; got {kind!r}, {lik!r}"
        )
    B, D = xb.shape
    M = Z.shape[0]
    shapes = {"yb": (yb, (B,)), "Z": (Z, (M, D)), "mu": (mu, (M,)), "Sigma": (Sigma, (M, M))}
    for name, (t, shape) in {"xb": (xb, (B, D)), **shapes}.items():
        if t.device != xb.device:
            raise ValueError(f"{name} is on {t.device}, xb on {xb.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32 on CUDA, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B < 1 or D < 1 or not 1 <= M <= MAX_M:
        raise ValueError(f"the CUDA fused_cavi_stats takes B, D >= 1 and 1 <= M <= {MAX_M}; got B={B}, D={D}, M={M}")


def fused_cavi_stats(
    xb, yb, Z, L_invT, mu, Sigma, lengthscale, variance, jitt, rho,
    lik_p0=0.0, lik_p1=0.0, kind="rbf", lik="logistic",
):
    """Fused kappa-basis statistics of one CAVI step (single latent GP).

    xb [B, D], yb [B] (+-1), Z [M, D], L_invT = (chol(Kmm)^-1)^T [M, M],
    mu [M], Sigma [M, M]; lengthscale (scalar: ARD is folded into xb and Z
    by the caller), variance, jitt, rho as numbers or 1-element tensors.
    Returns (s1 [M], S2 [M, M], c [B], theta [B], mf [B], vf [B]) with
    s1 = kappa^T (rho y/2) and S2 = kappa^T diag(rho theta/2) kappa.

    A CPU tensor runs :func:`fused_cavi_stats_reference`.  A CUDA tensor
    launches the kernel and adds one to ``fused_cavi_stats.launches``."""
    if xb.device.type == "cpu":
        return fused_cavi_stats_reference(
            xb, yb, Z, L_invT, mu, Sigma, lengthscale, variance, jitt, rho,
            lik_p0=lik_p0, lik_p1=lik_p1, kind=kind, lik=lik,
        )
    if xb.device.type != "cuda":
        raise ValueError(f"fused_cavi_stats runs on CPU or CUDA tensors, got {xb.device}")
    _check_cuda_args(xb, yb, Z, mu, Sigma, kind, lik)
    dev = xb.device
    B, D = xb.shape
    M = Z.shape[0]
    lib = _library()
    with torch.cuda.device(dev):
        smem = lib.agp_fused_cavi_smem_bytes(D, M)
        limit = getattr(torch.cuda.get_device_properties(dev), "shared_memory_per_block_optin", 232448)
        if smem > limit:
            raise ValueError(
                f"fused_cavi_stats at D={D}, M={M} needs {smem} bytes of shared memory; "
                f"this card allows {limit} per block"
            )
        if L_invT.device != dev or L_invT.shape != (M, M):
            raise ValueError(f"L_invT must be [{M}, {M}] on {dev}")
        kinv = _kinv(L_invT.to(torch.float32))
        params = torch.stack([_device_scalar(v, dev) for v in (lengthscale, variance, jitt, rho)])
        nb = -(-B // lib.agp_fused_cavi_tile_rows())
        f32 = dict(dtype=torch.float32, device=dev)
        s1_part = torch.empty((nb, M), **f32)
        s2_part = torch.empty((nb, M, M), **f32)
        s1, S2 = torch.empty((M,), **f32), torch.empty((M, M), **f32)
        c, theta, mf, vf = (torch.empty((B,), **f32) for _ in range(4))
        err = lib.agp_fused_cavi_stats_rbf_logistic(
            *(t.data_ptr() for t in (xb, yb, Z, kinv, mu, Sigma, params, c, theta, mf, vf,
                                     s1_part, s2_part, s1, S2)),
            B, D, M, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_cavi_stats launch failed: CUDA error {err} "
            f"({lib.agp_cuda_error_string(err).decode()})"
        )
    fused_cavi_stats.launches += 1
    return s1, S2, c, theta, mf, vf


fused_cavi_stats.launches = 0
