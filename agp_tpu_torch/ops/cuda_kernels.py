"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each is the counterpart of the function of the same name in
``agp_tpu/ops/pallas_kernels.py``.  Two tiers compute a CAVI step's
statistics:

* the fused statistics passes (gram -> kappa -> latent moments -> E-step
  -> s1, S2 in one call), for 1 <= M <= ``MAX_M`` (``fused_fits``):
  - ``fused_cavi_stats``: one latent, the E-steps of eight likelihoods
    (``LIKS``), any D; ``csrc/fused_cavi_stats.cu`` (3xTF32 tensor-core
    tiles on the split pairs' device code);
  - ``fused_cavi_stats_multiclass``: K latents, the logistic-softmax
    E-step; ``fused_cavi_stats_het``: the two latents of the
    heteroscedastic likelihood; both in ``csrc/fused_cavi_stats_multi.cu``
    (kernel 1's moments pass over a (row tile, latent) grid, then the
    coupled E-step and kernel 5's statistics tiles), any D;
* the split pairs, which leave the E-step to the caller:
  - the batched pair, for several latents and any M:
    ``fused_kappa_moments_batched`` (kappa, mf, vf; differentiable) and
    ``cavi_stats_batched`` (s1, S2 from kappa); ``csrc/batched_pair.cu``;
  - the single-latent split pair: ``fused_kappa`` (kappa, Ktilde;
    differentiable; the caller forms mf and vf) and ``cavi_stats``;
    ``csrc/kappa_single.cu``.
  Both share their device code (``csrc/pair_core.cuh``).  Kernels 4 and 6
  take one of two forms by a fixed rule (``kappa_route``): in float32,
  where one block's shared memory holds a [TB, M] row slab (M up to 2,392
  and 2,406 on an H100), and in float64 at M <= 128, the slab form; past
  it, the column-blocked form (``csrc/kappa_cols.cuh``: [128, 128] output
  tiles, both operands streamed, no M ceiling).

All take the four stationary gram kinds of ``KINDS``, whose formula the
CUDA kernels share (``csrc/gram.cuh``).  The same library holds the
kernels of the port's benchmark path, whose wrappers live in
``agp_tpu_torch/benchmarks/``: the design-sweep variants of the fused
pass (``direct_stats``, ``two_factor_nt``; ``csrc/fused_variants.cu``,
which runs the split pairs' device code) and the tile gather
(``gather_row_tiles``; ``csrc/gather_tiles.cu``).  On a CPU tensor a
wrapper runs its ``*_reference``, the same function in plain PyTorch (any
float dtype).  On a CUDA tensor it launches its kernel or raises; there is
no fallback.  The kernels take float32; the split pairs (kernels 4-7) also
take float64, in a form of their own (FP64 tensor-core tiles, the same
sources), and the fused passes (kernels 1-3, ``fused_fits``) and the
bench's kernels raise ``TypeError`` on it.  Each wrapper counts its
float32 kernel's launches in ``<wrapper>.launches``, and kernels 4-7
their float64 form's in ``<wrapper>.launches_f64``.

The kernels are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``: one
``nvcc -c`` per source of ``_SOURCES`` (``fused_cavi_stats.cu``,
``fused_cavi_stats_multi.cu``, ``batched_pair.cu``, ``kappa_single.cu``,
``fused_variants.cu``, ``gather_tiles.cu``), all started together.  The
build happens at the first CUDA call, into
``agp_tpu_torch/_build/<hash of the sources>/``; importing this module
never calls ``nvcc``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from .linalg import _highest_precision
from .special import LOG2, logcosh

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = tuple(
    _PKG / "csrc" / name
    for name in ("fused_cavi_stats.cu", "fused_cavi_stats_multi.cu", "batched_pair.cu", "kappa_single.cu",
                 "fused_variants.cu", "gather_tiles.cu")
)
# headers the sources include: part of the build's hash
_HEADERS = tuple(_PKG / "csrc" / name
                 for name in ("gram.cuh", "kappa_cols.cuh", "pair_core.cuh", "stats_tc.cuh", "tf32_mma.cuh"))
_BUILD_ROOT = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# largest inducing set the fused kernels take: their row tile has one
# output tile of 128 columns (csrc/fused_cavi_stats.cu, kernels 2-3 alike)
MAX_M = 128
# shared memory a block may opt into on an H100 (bytes)
SMEM_OPTIN = 232448
# the fused kernels' row tile (Tile in csrc/fused_cavi_stats*.cu): its
# rows (TB), the rows of a stage of its ring (KB) and its warp columns
# (WARPS_N), over one output tile of MAX_M columns
_FUSED_TILE_ROWS, _FUSED_STAGE_ROWS, _FUSED_WARPS_N = 64, 16, 4
# features per chunk of the plain versions' direct-difference r2, and the
# fewest a gram pass of kernels 4 and 6 stages (DC in csrc/pair_core.cuh)
_FEATURE_CHUNK = 8
# row tiles of kernels 4 and 6, largest first (KTile<TB> in
# csrc/pair_core.cuh), each with the rows of a stage of its ring (KB), its
# warp columns (WARPS_N) and the columns of its output tiles (NT); the ring
# holds _KAPPA_STAGES stages of KB rows of NT + 8 floats
_KAPPA_TILES = {64: (16, 8, 256), 32: (16, 8, 256), 16: (8, 8, 128)}
# the same of their float64 form (KTile<TB, double>), whose ring's rows are
# NT + 4 doubles
_KAPPA_TILES_F64 = {64: (16, 8, 128), 32: (16, 8, 128), 16: (8, 8, 128)}
_KAPPA_STAGES = 3
# the column-blocked form of kernels 4 and 6 (ColTile<E> in
# csrc/kappa_cols.cuh), by dtype: the block tile's rows (TB) and columns
# (TN), its k-chunk (KC), the stages of its ring and the pads of the ring's
# A rows (KC + pad) and B rows (TN + pad)
_COL_TILES = {torch.float32: (128, 128, 32, 4, 8, 4), torch.float64: (128, 128, 32, 3, 8, 2)}
# float64 calls at M up to this take the row-slab form: at M=64 and 128 its
# device time beat the column-blocked form's on an H100 (PERF.md)
_F64_SLAB_MAX_M = 128
# the dtypes kernels 4-7 take on the card (the others: float32 alone)
PAIR_DTYPES = (torch.float32, torch.float64)
# rows of a stage of kernels 5 and 7 (KB in csrc/stats_tc.cuh): a chunk of
# rows is a whole number of stages and, where B allows, _STATS_MIN_ROWS rows
# or more, so that few rows do not spread over more partials than their
# reduction repays
_STATS_STAGE_ROWS, _STATS_MIN_ROWS = 32, 128
# the mma depth of the geometry kernels 5 and 7's float64 form takes (their
# entry points' mma_k): 8, FP64 m16n8k8 tiles (StatsF64K8 in
# csrc/stats_tc.cuh), at every M; 4 names the m8n8k4 geometry (StatsF64K4),
# which only a yardstick beside it takes
STATS_F64_MMA_K = 8
# gram kinds and single-latent likelihoods, in the order of their codes in
# csrc/gram.cuh (GramKind) and csrc/fused_cavi_stats.cu (Lik)
KINDS = ("rbf", "matern12", "matern32", "matern52")
LIKS = ("logistic", "gaussian", "studentt", "laplace", "bayesiansvm", "matern32", "negbinomial", "poisson")


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
    for src in _SOURCES + _HEADERS:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build() -> dict:
    """Compile the kernels' shared library unless a build of the same
    sources exists: one ``nvcc -c`` per source, all started together, then
    one link.  Returns {"path", "seconds", "log"}; ``log`` holds ``nvcc``'s
    output (registers, shared memory, spills per kernel), empty when the
    library was already built."""
    out_dir = _BUILD_ROOT / _source_hash()
    lib = out_dir / "libagp_tpu_torch_cuda.so"
    if lib.exists():
        return {"path": str(lib), "seconds": 0.0, "log": ""}
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in _SOURCES]
        jobs = []
        for src, obj in zip(_SOURCES, objs):
            cmd = [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = "", []
        for cmd, proc in jobs:  # wait for every compiler before reporting
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp_lib), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_lib, lib)  # atomic: a concurrent build never sees half a file
    return {"path": str(lib), "seconds": time.perf_counter() - t0, "log": log + proc.stdout + proc.stderr}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.agp_fused_cavi_stats.argtypes = [p] * 18 + [i] * 7 + [p]
    lib.agp_fused_cavi_stats.restype = i
    lib.agp_fused_cavi_smem_bytes.argtypes = [i]
    lib.agp_fused_cavi_smem_bytes.restype = ctypes.c_size_t
    lib.agp_cuda_error_string.argtypes = [i]
    lib.agp_cuda_error_string.restype = ctypes.c_char_p
    lib.agp_fused_cavi_stats_multiclass.argtypes = [p] * 22 + [i] * 7 + [p]
    lib.agp_fused_cavi_stats_multiclass.restype = i
    lib.agp_fused_cavi_stats_het.argtypes = [p] * 21 + [i] * 6 + [p]
    lib.agp_fused_cavi_stats_het.restype = i
    lib.agp_multi_smem_bytes.argtypes = [i]
    lib.agp_multi_smem_bytes.restype = ctypes.c_size_t
    lib.agp_kappa_moments_smem_bytes.argtypes = [i, i]
    lib.agp_kappa_moments_smem_bytes.restype = ctypes.c_size_t
    lib.agp_fused_kappa_moments_batched.argtypes = [p] * 9 + [i] * 6 + [p]
    lib.agp_fused_kappa_moments_batched.restype = i
    lib.agp_cavi_stats_tile.argtypes = []
    lib.agp_cavi_stats_tile.restype = i
    lib.agp_cavi_stats_blocks_per_sm.argtypes = []
    lib.agp_cavi_stats_blocks_per_sm.restype = i
    lib.agp_cavi_stats_batched.argtypes = [p] * 7 + [i] * 5 + [p]
    lib.agp_cavi_stats_batched.restype = i
    lib.agp_fused_kappa_smem_bytes.argtypes = [i, i]
    lib.agp_fused_kappa_smem_bytes.restype = ctypes.c_size_t
    lib.agp_fused_kappa.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.agp_fused_kappa.restype = i
    lib.agp_cavi_stats.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.agp_cavi_stats.restype = i
    lib.agp_kappa_cols_smem_bytes.argtypes = []
    lib.agp_kappa_cols_smem_bytes.restype = ctypes.c_size_t
    lib.agp_kappa_cols_scratch.argtypes = [i] * 4
    lib.agp_kappa_cols_scratch.restype = ctypes.c_size_t
    lib.agp_fused_kappa_cols.argtypes = [p] * 7 + [i] * 4 + [p]
    lib.agp_fused_kappa_cols.restype = i
    lib.agp_kappa_moments_cols.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.agp_kappa_moments_cols.restype = i
    # the float64 forms of kernels 4-7: the same signatures
    for name in ("agp_kappa_moments_smem_bytes", "agp_fused_kappa_moments_batched", "agp_cavi_stats_tile",
                 "agp_cavi_stats_blocks_per_sm", "agp_cavi_stats_batched", "agp_fused_kappa_smem_bytes",
                 "agp_fused_kappa", "agp_cavi_stats", "agp_kappa_cols_smem_bytes", "agp_kappa_cols_scratch",
                 "agp_fused_kappa_cols", "agp_kappa_moments_cols"):
        fn, fn64 = getattr(lib, name), getattr(lib, name + "_f64")
        fn64.argtypes, fn64.restype = fn.argtypes, fn.restype
    # ... but kernels 5 and 7's float64 form takes the mma depth of its geometry
    lib.agp_cavi_stats_blocks_per_sm_f64.argtypes = [i]
    for name in ("agp_cavi_stats_f64", "agp_cavi_stats_batched_f64"):
        fn = getattr(lib, name)
        fn.argtypes = fn.argtypes[:-1] + [i, p]
    lib.agp_fused_variant_smem_bytes.argtypes = [i, i, i]
    lib.agp_fused_variant_smem_bytes.restype = ctypes.c_size_t
    lib.agp_fused_variant_stats.argtypes = [p] * 19 + [i] * 9 + [p]
    lib.agp_fused_variant_stats.restype = i
    ll = ctypes.c_longlong
    lib.agp_gather_row_tiles.argtypes = [p, p, i, p, ll, ll, p]
    lib.agp_gather_row_tiles.restype = i
    return lib


def fused_fits(n_latent: int, D: int, M: int, dtype: torch.dtype = torch.float32) -> bool:
    """Whether the fused statistics kernels take a model of ``n_latent``
    latents, D features and M inducing points in ``dtype``: float32,
    1 <= M <= MAX_M and the rows pass's shared memory within
    ``SMEM_OPTIN``.  Kernels 1-3 share one row tile and its footprint,
    which neither D nor the latents enter: the slab, the ring or the gram's
    staging, three row sums (a Python mirror of ``agp_fused_cavi_smem_bytes``
    and ``agp_multi_smem_bytes``, ``pair_core.cuh::rows_smem``, which name
    this function: change them together).  They are float32-only, so a
    float64 model on the card takes the split pairs (kernels 4-7;
    ``analytic_vi._route_dtype``).  The same answer on the CPU and on the
    card."""
    if dtype != torch.float32 or D < 1 or not 1 <= M <= MAX_M:
        return False
    tb = _FUSED_TILE_ROWS
    ring = _KAPPA_STAGES * _FUSED_STAGE_ROWS * (MAX_M + 8)
    words = tb * (-(-M // 8) * 8 + 4) + max(ring, _FEATURE_CHUNK * (tb + M + 2)) + 3 * _FUSED_WARPS_N * tb
    return 4 * words <= SMEM_OPTIN


def kappa_smem_bytes(which: str, M: int, tile_rows: int, dtype: torch.dtype = torch.float32) -> int:
    """Shared memory of kernel 4 (``which="moments"``) or kernel 6
    (``"single"``) at M with row tiles of ``tile_rows`` (64, 32 or 16), in
    ``dtype`` (float32, or float64 for their float64 form): the [TB, M]
    slab (the gram; in kernel 4 kappa's rows after it), the ring or the
    gram's staging of 8 features or more, whichever is larger, and the row
    sums (kernel 4: three), each an element of ``dtype``.  A Python copy of
    ``agp_kappa_moments_smem_bytes`` and ``agp_fused_kappa_smem_bytes`` and
    their ``_f64`` twins (each names this function): change them together."""
    if which not in ("moments", "single"):
        raise ValueError(f"which is 'moments' (kernel 4) or 'single' (kernel 6), got {which!r}")
    if dtype not in PAIR_DTYPES:
        raise TypeError(f"kernels 4-7 take float32 or float64, got {dtype}")
    f64 = dtype == torch.float64
    stage_rows, warps_n, cols = (_KAPPA_TILES_F64 if f64 else _KAPPA_TILES)[tile_rows]
    ring = _KAPPA_STAGES * stage_rows * (cols + (4 if f64 else 8))
    staging = _FEATURE_CHUNK * (tile_rows + M + 2)
    sums = (3 if which == "moments" else 1) * warps_n * tile_rows
    return (8 if f64 else 4) * (tile_rows * (-(-M // 8) * 8 + 4) + max(ring, staging) + sums)


def kappa_tile_rows(which: str, M: int, limit: int = SMEM_OPTIN, dtype: torch.dtype = torch.float32) -> int | None:
    """The row tile kernel 4 (``"moments"``) or 6 (``"single"``) takes at M
    in ``dtype``: the largest of 64, 32 and 16 whose ``kappa_smem_bytes``
    fits ``limit`` bytes (by default what a block may opt into on an
    H100), or None beyond the kernel's range.  The same answer on the CPU
    and on the card."""
    return next((t for t in _KAPPA_TILES if kappa_smem_bytes(which, M, t, dtype) <= limit), None)


def kappa_max_m(which: str, limit: int = SMEM_OPTIN, dtype: torch.dtype = torch.float32) -> int:
    """The largest M kernel 4 (``"moments"``) or 6 (``"single"``) takes
    within ``limit`` bytes of shared memory a block, in ``dtype``: on an
    H100 2,392 and 2,406 in float32, 1,184 and 1,192 in float64 (its slab of
    doubles)."""
    lo, hi = 0, 1 << 16  # kappa_smem_bytes grows with M
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if kappa_tile_rows(which, mid, limit, dtype) else (lo, mid)
    return lo


def kappa_cols_smem_bytes(dtype: torch.dtype = torch.float32) -> int:
    """Shared memory a block of the column-blocked form of kernels 4 and 6
    takes in ``dtype`` (float32 or float64), whatever M: the ring of its
    stages, each an A chunk [TB, KC + pad] and a B chunk [KC, TN + pad].
    A Python copy of ``agp_kappa_cols_smem_bytes`` and its ``_f64`` twin
    (``ColShape::SMEM`` in csrc/kappa_cols.cuh): change them together."""
    if dtype not in PAIR_DTYPES:
        raise TypeError(f"kernels 4-7 take float32 or float64, got {dtype}")
    tb, tn, kc, stages, pad_a, pad_b = _COL_TILES[dtype]
    return (8 if dtype == torch.float64 else 4) * stages * (tb * (kc + pad_a) + kc * (tn + pad_b))


def kappa_cols_scratch(which: str, B: int, M: int, L: int = 1, dtype: torch.dtype = torch.float32) -> int:
    """Elements of the scratch a call of the column-blocked kernel 4
    (``"moments"``) or 6 (``"single"``) takes: the gram Knm [L, B, M], then
    the row partials [L, column tiles, B] of Ktilde and, for kernel 4, of mf
    and vf.  A Python copy of ``agp_kappa_cols_scratch`` and its ``_f64``
    twin (``cols_scratch`` in csrc/kappa_cols.cuh): change them together."""
    if which not in ("moments", "single"):
        raise ValueError(f"which is 'moments' (kernel 4) or 'single' (kernel 6), got {which!r}")
    tn = _COL_TILES[dtype][1]
    return L * B * M + (3 if which == "moments" else 1) * L * -(-M // tn) * B


def kappa_route(which: str, M: int, dtype: torch.dtype = torch.float32, limit: int = SMEM_OPTIN) -> tuple:
    """The form kernel 4 (``"moments"``) or 6 (``"single"``) takes at M in
    ``dtype``: ("slab", rows) where the row slab fits ``limit`` bytes in
    float32 (``kappa_tile_rows``: M up to 2,392 and 2,406 on an H100) or
    M <= ``_F64_SLAB_MAX_M`` in float64, else ("cols", None), the
    column-blocked form of csrc/kappa_cols.cuh, which takes any M.  A fixed
    rule by M and dtype, the same on the CPU and on the card."""
    if dtype not in PAIR_DTYPES:
        raise TypeError(f"kernels 4-7 take float32 or float64, got {dtype}")
    slab = dtype == torch.float32 or M <= _F64_SLAB_MAX_M
    tb = kappa_tile_rows(which, M, limit, dtype) if slab else None
    return ("slab", tb) if tb else ("cols", None)


@_highest_precision
def _kinv(L_invT: torch.Tensor) -> torch.Tensor:
    """K^-1 = L^-T L^-1 from the stored triangular inverse, at full FP32
    (or in float64), outside the kernel (as the reference's ``_kinv``)."""
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
    raise ValueError(f"unknown kernel kind {kind!r}; the kinds are {KINDS}")


class _SqDistChunked(torch.autograd.Function):
    """r2 [L, B, M] = sum_d (x[l, b, d] - z[l, m, d])^2 by direct
    differences, accumulated over feature chunks of ``_FEATURE_CHUNK`` as
    the kernels do, so the forward holds [L, B, M, _FEATURE_CHUNK] whatever
    D.  Its gradient is the closed form of r2's, with G the cotangent:
    dx = 2 (rowsum(G) x - G z), dz = 2 (colsum(G) z - G^T x), so the
    backward holds [L, B, M] and keeps no difference."""

    @staticmethod
    def forward(ctx, x, z):
        ctx.save_for_backward(x, z)
        r2 = None
        for lo in range(0, x.shape[-1], _FEATURE_CHUNK):
            diff = x[:, :, None, lo:lo + _FEATURE_CHUNK] - z[:, None, :, lo:lo + _FEATURE_CHUNK]
            part = torch.sum(diff * diff, dim=-1)
            r2 = part if r2 is None else r2 + part
        return r2

    @staticmethod
    @_highest_precision
    def backward(ctx, G):
        x, z = ctx.saved_tensors
        dx = 2.0 * (G.sum(-1, keepdim=True) * x - G @ z) if ctx.needs_input_grad[0] else None
        dz = 2.0 * (G.sum(-2)[..., None] * z - G.mT @ x) if ctx.needs_input_grad[1] else None
        return dx, dz


def _sq_dist_chunked(x, z):
    """r2 [L, B, M] of x [L, B, D] against z [L, M, D]: ``_SqDistChunked``."""
    return _SqDistChunked.apply(x, z)


def _kappa_ktilde(x, z, kinv, var, jitt, kind):
    """(kappa [L, B, M], Ktilde [L, B], Knm [L, B, M]) from the scaled inputs
    x [L, B, D], z [L, M, D], K^-1 [L, M, M] and the variances var [L]: the
    plain math of kernels 4 and 6."""
    knm = _gram_from_r2(_sq_dist_chunked(x, z), var[:, None, None], kind)
    kappa = knm @ kinv
    ktilde = torch.clamp(var[:, None] + jitt - torch.sum(kappa * knm, dim=-1), min=1e-12)
    return kappa, ktilde, knm


@_highest_precision
def fused_kappa_moments_batched_reference(X, Z, L_invT, ls, var, mu, Sigma, jitt, kind="rbf"):
    """Plain PyTorch version of :func:`fused_kappa_moments_batched`, in the
    inputs' dtype, on their device: (kappa [L, B, M], mf [L, B],
    vf [L, B]) of every latent, with per-latent lengthscales ls ([L, D], or
    broadcastable to it) and variances var [L].  The gram is formed by
    direct differences over feature chunks (``_sq_dist_chunked``)."""
    L, _, D = Z.shape
    ls2 = torch.broadcast_to(torch.as_tensor(ls, dtype=X.dtype, device=X.device).reshape(L, -1), (L, D))
    var = torch.broadcast_to(torch.as_tensor(var, dtype=X.dtype, device=X.device).reshape(-1), (L,))
    x = X[None] / ls2[:, None, :]  # [L, B, D]
    z = Z / ls2[:, None, :]  # [L, M, D]
    kappa, ktilde, _ = _kappa_ktilde(x, z, _kinv(L_invT), var, jitt, kind)
    mf = (kappa @ mu[..., None])[..., 0]
    vf = torch.clamp(ktilde + torch.sum((kappa @ Sigma) * kappa, dim=-1), min=1e-12)
    return kappa, mf, vf


@_highest_precision
def cavi_stats_batched_reference(kappa, g, theta):
    """Plain PyTorch version of :func:`cavi_stats_batched`:
    s1 [L, M] = kappa^T g and S2 [L, M, M] = kappa^T diag(theta) kappa."""
    s1 = (kappa.mT @ g[..., None])[..., 0]
    S2 = (kappa * theta[..., None]).mT @ kappa
    return s1, S2


def _estep_reference(lik, mf, vf, yb, p0, p1):
    """(c, theta, g_mu, g_s) of one row's E-step for likelihood ``lik``
    (``LIKS``), with its parameters p0, p1: the kernel's formulas."""
    if lik == "logistic":
        c = torch.sqrt(mf * mf + vf)
        theta = torch.tanh(c / 2.0) / (2.0 * c)
        return c, theta, yb / 2.0, theta / 2.0
    if lik in ("gaussian", "laplace", "matern32"):
        c = torch.sqrt(torch.clamp((mf - yb) ** 2 + vf, min=1e-30))
        if lik == "gaussian":  # p0 = sigma2
            theta = torch.ones_like(mf) / p0
            return c, theta, yb / p0, theta / 2.0
        if lik == "laplace":  # p0 = a = 1/beta^2; c is the local "b"
            theta = p0**0.5 / c
            return c, theta, theta * yb, theta / 2.0
        theta = 3.0 / (2.0 * math.sqrt(3.0) * c * p0 + 2.0 * p0 * p0)  # p0 = rho
        return c, theta, 2.0 * theta * yb, theta
    if lik == "studentt":  # p0 = nu, p1 = sigma^2
        c = ((mf - yb) ** 2 + vf + p1 * p0) / 2.0
        theta = ((p0 + 1.0) / 2.0) / c
        return c, theta, theta * yb, theta / 2.0
    if lik == "bayesiansvm":
        c = (1.0 - yb * mf) ** 2 + vf
        theta = 1.0 / torch.sqrt(torch.clamp(c, min=1e-30))
        return c, theta, yb * (theta + 1.0), theta / 2.0
    if lik in ("negbinomial", "poisson"):
        c = torch.sqrt(torch.clamp(mf * mf + vf, min=1e-30))
        if lik == "negbinomial":  # p0 = r
            theta = (yb + p0) * torch.tanh(c / 2.0) / (2.0 * c)
            return c, theta, (yb - p0) / 2.0, theta / 2.0
        # p0 = lam; gamma = lam e^{-mf/2} / (2 cosh(c/2))
        logcosh_half = c / 2.0 + torch.log1p(torch.exp(-c)) - LOG2
        gamma = p0 * torch.exp(-mf / 2.0 - logcosh_half) / 2.0
        theta = (yb + gamma) * torch.tanh(c / 2.0) / (2.0 * c)
        return c, theta, (yb - gamma) / 2.0, theta / 2.0
    raise ValueError(f"unknown likelihood {lik!r}; the likelihoods are {LIKS}")


def fused_cavi_stats_reference(
    xb, yb, Z, L_invT, mu, Sigma, lengthscale, variance, jitt, rho,
    lik_p0=0.0, lik_p1=0.0, kind="rbf", lik="logistic",
):
    """Plain PyTorch version of :func:`fused_cavi_stats`, in the inputs'
    dtype, on their device: every kind of ``KINDS`` and likelihood of
    ``LIKS``."""
    if lik not in LIKS:
        raise ValueError(f"unknown likelihood {lik!r}; the likelihoods are {LIKS}")
    kappa, mf, vf = fused_kappa_moments_batched_reference(
        xb, Z[None], L_invT[None], lengthscale, variance, mu[None], Sigma[None], jitt, kind
    )
    c, theta, gmu, gs = _estep_reference(lik, mf[0], vf[0], yb, lik_p0, lik_p1)
    s1, S2 = cavi_stats_batched_reference(kappa, (rho * gmu)[None], (rho * gs)[None])
    return s1[0], S2[0], c, theta, mf[0], vf[0]


def _device_scalar(v, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d tensor of ``dtype`` on ``device``: a 1-element tensor there
    as it is, a Python number as ``_device_number``'s (no host-to-device
    copy, no sync).  Every caller only reads it."""
    if isinstance(v, torch.Tensor):
        if v.device != device or v.numel() != 1:
            raise ValueError(f"scalar argument must be a 1-element tensor on {device}")
        return v.reshape(()).to(dtype)
    return _device_number(float(v), device, dtype)


@functools.lru_cache(maxsize=64)
def _device_number(v: float, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """The 0-d tensor v of ``dtype`` on ``device``, made there once per
    value, device and dtype: a constant argument (the jitter, an unused
    likelihood parameter) then costs a step no launch."""
    return torch.full((), v, dtype=dtype, device=device)


def _check_tensors(xb, tensors: dict, dtypes=(torch.float32,)):
    """Device, dtype (one of ``dtypes``, and the first tensor's), shape and
    contiguity of a CUDA kernel's tensor arguments; ``tensors`` maps a name
    to (tensor, expected shape), xb first."""
    for name, (t, shape) in tensors.items():
        if t.device != xb.device:
            raise ValueError(f"{name} is on {t.device}, xb on {xb.device}")
        if t.dtype not in dtypes:
            names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
            raise TypeError(f"{name} must be {names} on CUDA, got {t.dtype}")
        if t.dtype != xb.dtype:
            raise TypeError(f"{name} is {t.dtype} where {next(iter(tensors))} is {xb.dtype}: the kernel takes one dtype")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_kind(name, kind):
    if kind not in KINDS:
        raise ValueError(f"the CUDA {name} takes the kinds {KINDS}; got {kind!r}")


def _check_cuda_args(xb, yb, Z, mu, Sigma, kind, lik):
    _check_kind("fused_cavi_stats", kind)
    if lik not in LIKS:
        raise ValueError(f"the CUDA fused_cavi_stats takes the likelihoods {LIKS}; got {lik!r}")
    B, D = xb.shape
    M = Z.shape[0]
    _check_tensors(xb, {"xb": (xb, (B, D)), "yb": (yb, (B,)), "Z": (Z, (M, D)), "mu": (mu, (M,)),
                        "Sigma": (Sigma, (M, M))})
    if B < 1 or D < 1 or not 1 <= M <= MAX_M:
        raise ValueError(f"the CUDA fused_cavi_stats takes B, D >= 1 and 1 <= M <= {MAX_M}; got B={B}, D={D}, M={M}")


def fused_cavi_stats(
    xb, yb, Z, L_invT, mu, Sigma, lengthscale, variance, jitt, rho,
    lik_p0=0.0, lik_p1=0.0, kind="rbf", lik="logistic",
):
    """Fused kappa-basis statistics of one CAVI step (single latent GP).

    xb [B, D], yb [B] (the treated labels), Z [M, D],
    L_invT = (chol(Kmm)^-1)^T [M, M], mu [M], Sigma [M, M]; lengthscale
    (scalar: ARD is folded into xb and Z by the caller), variance, jitt,
    rho and the likelihood's parameters lik_p0, lik_p1 (see
    ``analytic_vi._fused_lik_spec``) as numbers or 1-element tensors; kind
    of ``KINDS``, lik of ``LIKS``.  Returns (s1 [M], S2 [M, M], c [B],
    theta [B], mf [B], vf [B]) with s1 = kappa^T (rho g_mu) and
    S2 = kappa^T diag(rho g_s) kappa, (g_mu, g_s) the likelihood's
    natural-gradient inputs.

    A CPU tensor runs :func:`fused_cavi_stats_reference`.  A CUDA tensor
    launches the kernel (float32, any B, D >= 1, 1 <= M <= ``MAX_M``: the
    gram, kappa and the moments in 3xTF32 tensor-core tiles of 64 rows,
    one thread a row for the E-step, then kernel 7's statistics tiles;
    ``csrc/fused_cavi_stats.cu``) and adds one to
    ``fused_cavi_stats.launches``; its scalars reach it in a device buffer,
    so a parameter that changes every step costs no host read.  S2 comes
    out exactly symmetric."""
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
    if L_invT.device != dev or L_invT.shape != (M, M):
        raise ValueError(f"L_invT must be [{M}, {M}] on {dev}")
    lib = _library()
    with torch.cuda.device(dev):
        kinv = _kinv(L_invT.to(torch.float32))
        # the kernel's scalars (jitter, rho, p0, var, p1, ls [D]), made on the
        # card with no host read
        scalars = [_device_scalar(v, dev).reshape(1) for v in (jitt, rho, lik_p0, variance, lik_p1, lengthscale)]
        params = torch.cat(scalars[:5] + [scalars[5].expand(D)])
        nchunks, rows = _stats_plan(B, M, 1, _stats_slots(dev.index), lib.agp_cavi_stats_tile())
        f32 = dict(dtype=torch.float32, device=dev)
        c, theta, mf, vf, wg, ws = torch.empty((6, B), **f32).unbind(0)
        s1, S2 = torch.empty((M,), **f32), torch.empty((M, M), **f32)
        # one scratch: kappa [B, M] first (16-byte aligned), then the chunk
        # partials of s1 [nchunks, M] and S2 [nchunks, M, M]
        scratch = torch.empty((B * M + nchunks * M * (M + 1),), **f32)
        kappa = scratch.data_ptr()
        s1_part = kappa + 4 * B * M
        s2_part = s1_part + 4 * nchunks * M
        err = lib.agp_fused_cavi_stats(
            *(t.data_ptr() for t in (xb, yb, Z, kinv, mu, Sigma, params, c, theta, mf, vf)),
            kappa, wg.data_ptr(), ws.data_ptr(), s1_part, s2_part, s1.data_ptr(), S2.data_ptr(),
            B, D, M, KINDS.index(kind), LIKS.index(lik), nchunks, rows, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _cuda_error("fused_cavi_stats", lib, err)
    fused_cavi_stats.launches += 1
    return s1, S2, c, theta, mf, vf


fused_cavi_stats.launches = 0


# ------------------------------------------------ multi-latent statistics
def _multiclass_estep(mf, vf, y_onehot, alpha0, beta0):
    """Kernel 2's logistic-softmax E-step in plain PyTorch, from the
    latents' moments mf, vf [K, B]: (c, theta, gamma [K, B], alpha [B],
    g_mu, g_s [K, B]), gamma and alpha in two rounds with
    ``torch.special.digamma``."""
    yT = y_onehot.T
    c = torch.sqrt(mf * mf + vf)
    expcosh = torch.exp(-mf / 2.0 - logcosh(c / 2.0))
    alpha = alpha0
    for _ in range(2):
        gamma = torch.exp(torch.special.digamma(alpha))[None, :] * expcosh / (2.0 * beta0[None, :])
        alpha = 1.0 + torch.sum(gamma, dim=0)
    theta = (yT + gamma) * torch.tanh(c / 2.0) / (2.0 * c)
    return c, theta, gamma, alpha, (yT - gamma) / 2.0, theta / 2.0


def _het_estep(m, v, yb, lam):
    """Kernel 3's heteroscedastic E-step in plain PyTorch, with the old
    ``lam``, from the moments m, v [2, B] of f and g: (c, phi, gamma,
    theta, sigg [B], g_mu, g_s [2, B]), f's without the lambda factor."""
    phi = ((m[0] - yb) ** 2 + v[0]) / 2.0
    c = torch.sqrt(m[1] * m[1] + v[1])
    sigg = torch.exp(-m[1] / 2.0 - logcosh(c / 2.0)) / 2.0
    gamma = lam * phi * sigg
    theta = (0.5 + gamma) * torch.tanh(c / 2.0) / (2.0 * c)
    gmu = torch.stack([yb * sigg / 2.0, (0.5 - gamma) / 2.0])
    gs = torch.stack([sigg / 2.0, theta / 2.0])
    return c, phi, gamma, theta, sigg, gmu, gs


def fused_cavi_stats_multiclass_reference(
    xb, y_onehot, Z, L_invT, mu, Sigma, ls, var, jitt, rho, alpha0, beta0, kind="rbf",
):
    """Plain PyTorch version of :func:`fused_cavi_stats_multiclass`, in the
    inputs' dtype, on their device.  Kinds: rbf, matern12, matern32,
    matern52.  The digamma is ``torch.special.digamma``."""
    kappa, mf, vf = fused_kappa_moments_batched_reference(xb, Z, L_invT, ls, var, mu, Sigma, jitt, kind)
    c, theta, gamma, alpha, gmu, gs = _multiclass_estep(mf, vf, y_onehot, alpha0, beta0)
    s1, S2 = cavi_stats_batched_reference(kappa, rho * gmu, rho * gs)
    return s1, S2, c, theta, gamma, alpha


def fused_cavi_stats_het_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, lam, kind="rbf"):
    """Plain PyTorch version of :func:`fused_cavi_stats_het`, in the inputs'
    dtype, on their device.  Kinds: rbf, matern12, matern32, matern52."""
    kappa, m, v = fused_kappa_moments_batched_reference(xb, Z, L_invT, ls, var, mu, Sigma, jitt, kind)
    c, phi, gamma, theta, sigg, gmu, gs = _het_estep(m, v, yb, lam)
    s1, S2 = cavi_stats_batched_reference(kappa, rho * gmu, rho * gs)
    return s1, S2, c, phi, gamma, theta, sigg


def _check_multi_args(name, xb, Z, mu, Sigma, per_row: dict, kind):
    """The CUDA multi-latent kernels' range: float32, a kind of ``KINDS``,
    1 <= M <= MAX_M, B, D >= 1."""
    _check_kind(name, kind)
    B, D = xb.shape
    L, M = Z.shape[0], Z.shape[1]
    _check_tensors(xb, {"xb": (xb, (B, D)), "Z": (Z, (L, M, D)), "mu": (mu, (L, M)),
                        "Sigma": (Sigma, (L, M, M)), **per_row})
    if B < 1 or D < 1 or L < 1 or not 1 <= M <= MAX_M:
        raise ValueError(
            f"the CUDA {name} takes B, D, L >= 1 and 1 <= M <= {MAX_M}; got B={B}, D={D}, L={L}, M={M}"
        )


def _multi_params(xb, L, jitt, rho, lam, ls, var):
    """The kernels' scalar buffer on the device, in xb's dtype: (jitter,
    rho, lam, var [L], ls [L, D]), made there with no host read."""
    dev, D = xb.device, xb.shape[1]
    like = dict(dtype=xb.dtype, device=dev)
    ls2 = torch.broadcast_to(torch.as_tensor(ls, **like).reshape(L, -1), (L, D))
    var = torch.broadcast_to(torch.as_tensor(var, **like).reshape(-1), (L,))
    head = torch.stack([_device_scalar(v, dev, xb.dtype) for v in (jitt, rho, lam)])
    return torch.cat([head, var, ls2.reshape(-1)])


def _multi_launch(name, lib_fn, xb, Z, L_invT, mu, Sigma, params, inputs, outputs, ints):
    """Scratch and the ctypes call of one multi-latent kernel: ``inputs``
    (the labels first) and ``outputs`` are the tensors around params in the
    C signature, ``ints`` its sizes before the chunk plan of the statistics
    (``_stats_plan``).  Returns (s1, S2)."""
    dev = xb.device
    B = xb.shape[0]
    L, M = Z.shape[0], Z.shape[1]
    lib = _library()
    if L_invT.device != dev or tuple(L_invT.shape) != (L, M, M):
        raise ValueError(f"L_invT must be [{L}, {M}, {M}] on {dev}")
    f32 = dict(dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        kinv = _kinv(L_invT.to(torch.float32))
        nchunks, rows = _stats_plan(B, M, L, _stats_slots(dev.index), lib.agp_cavi_stats_tile())
        mf, vf, wg, ws = torch.empty((4, L, B), **f32).unbind(0)
        s1, S2 = torch.empty((L, M), **f32), torch.empty((L, M, M), **f32)
        # one scratch: kappa [L, B, M] first (16-byte aligned), then the chunk
        # partials of s1 [L, nchunks, M] and S2 [L, nchunks, M, M]
        scratch = torch.empty((L * (B * M + nchunks * M * (M + 1)),), **f32)
        kappa = scratch.data_ptr()
        s1_part = kappa + 4 * L * B * M
        s2_part = s1_part + 4 * L * nchunks * M
        err = lib_fn(
            *(t.data_ptr() for t in (xb, inputs[0], Z, kinv, mu, Sigma, params, *inputs[1:], *outputs)),
            kappa, *(t.data_ptr() for t in (mf, vf, wg, ws)), s1_part, s2_part, s1.data_ptr(), S2.data_ptr(),
            *ints, nchunks, rows, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise _cuda_error(name, lib, err)
    return s1, S2


def fused_cavi_stats_multiclass(
    xb, y_onehot, Z, L_invT, mu, Sigma, ls, var, jitt, rho, alpha0, beta0, kind="rbf",
):
    """Fused statistics of one multiclass (logistic-softmax) CAVI step: all
    K latents and the coupled E-step.

    xb [B, D]; y_onehot [B, K]; Z [K, M, D]; L_invT [K, M, M]; mu [K, M];
    Sigma [K, M, M]; ls [K, D] (per-latent ARD, or broadcastable); var [K];
    jitt and rho numbers or 1-element tensors; alpha0, beta0 [B] the carried
    Gamma local variables.  Returns (s1 [K, M], S2 [K, M, M], c [K, B],
    theta [K, B], gamma [K, B], alpha [B]).

    A CPU tensor runs :func:`fused_cavi_stats_multiclass_reference`.  A CUDA
    tensor launches the kernel (float32, any B, D >= 1, 1 <= M <=
    ``MAX_M``: kernel 1's 3xTF32 moments pass for each (row tile, latent),
    one thread a row for the coupled E-step, then kernel 5's statistics
    tiles; ``csrc/fused_cavi_stats_multi.cu``) and adds one to
    ``fused_cavi_stats_multiclass.launches``.  S2 comes out exactly
    symmetric."""
    if xb.device.type == "cpu":
        return fused_cavi_stats_multiclass_reference(
            xb, y_onehot, Z, L_invT, mu, Sigma, ls, var, jitt, rho, alpha0, beta0, kind=kind
        )
    if xb.device.type != "cuda":
        raise ValueError(f"fused_cavi_stats_multiclass runs on CPU or CUDA tensors, got {xb.device}")
    B = xb.shape[0]
    K = Z.shape[0]
    _check_multi_args("fused_cavi_stats_multiclass", xb, Z, mu, Sigma, {
        "y_onehot": (y_onehot, (B, K)), "alpha0": (alpha0, (B,)), "beta0": (beta0, (B,))}, kind)
    params = _multi_params(xb, K, jitt, rho, 0.0, ls, var)
    f32 = dict(dtype=torch.float32, device=xb.device)
    c, theta, gamma = (torch.empty((K, B), **f32) for _ in range(3))
    alpha = torch.empty((B,), **f32)
    s1, S2 = _multi_launch(
        "fused_cavi_stats_multiclass", _library().agp_fused_cavi_stats_multiclass,
        xb, Z, L_invT, mu, Sigma, params, (y_onehot, alpha0, beta0), (c, theta, gamma, alpha),
        (B, xb.shape[1], Z.shape[1], K, KINDS.index(kind)),
    )
    fused_cavi_stats_multiclass.launches += 1
    return s1, S2, c, theta, gamma, alpha


fused_cavi_stats_multiclass.launches = 0


def fused_cavi_stats_het(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, lam, kind="rbf"):
    """Fused statistics of one heteroscedastic CAVI step: both latents (f
    the mean, g the log-precision) and their coupled E-step with the old
    ``lam``.

    xb [B, D]; yb [B]; Z [2, M, D]; L_invT [2, M, M]; mu [2, M];
    Sigma [2, M, M]; ls [2, D] (or broadcastable); var [2]; jitt, rho and
    lam numbers or 1-element tensors.  Returns (s1 [2, M], S2 [2, M, M],
    c, phi, gamma, theta, sigg [B]); f's statistics s1[0], S2[0] are
    without the lambda factor, which the caller applies once the batch's
    new lambda is known.

    A CPU tensor runs :func:`fused_cavi_stats_het_reference`.  A CUDA tensor
    launches the kernel (as :func:`fused_cavi_stats_multiclass`'s, with the
    heteroscedastic E-step) and adds one to
    ``fused_cavi_stats_het.launches``."""
    if xb.device.type == "cpu":
        return fused_cavi_stats_het_reference(xb, yb, Z, L_invT, mu, Sigma, ls, var, jitt, rho, lam, kind=kind)
    if xb.device.type != "cuda":
        raise ValueError(f"fused_cavi_stats_het runs on CPU or CUDA tensors, got {xb.device}")
    B = xb.shape[0]
    if Z.shape[0] != 2:
        raise ValueError(f"fused_cavi_stats_het takes 2 latents, got Z of shape {tuple(Z.shape)}")
    _check_multi_args("fused_cavi_stats_het", xb, Z, mu, Sigma, {"yb": (yb, (B,))}, kind)
    params = _multi_params(xb, 2, jitt, rho, lam, ls, var)
    outs = tuple(torch.empty((B,), dtype=torch.float32, device=xb.device) for _ in range(5))
    s1, S2 = _multi_launch(
        "fused_cavi_stats_het", _library().agp_fused_cavi_stats_het,
        xb, Z, L_invT, mu, Sigma, params, (yb,), outs, (B, xb.shape[1], Z.shape[1], KINDS.index(kind)),
    )
    fused_cavi_stats_het.launches += 1
    return (s1, S2) + outs


fused_cavi_stats_het.launches = 0


# ------------------------------------------------------- the batched pair
def _cuda_error(name, lib, err):
    return RuntimeError(f"{name} launch failed: CUDA error {err} ({lib.agp_cuda_error_string(err).decode()})")


def _pair_fn(lib, name, dtype):
    """The C entry point ``name`` of kernels 4-7, or its float64 form's."""
    return getattr(lib, name + "_f64" if dtype == torch.float64 else name)


def _count(wrapper, dtype):
    """One more launch of kernel 4-7's float32 kernel, or of its float64
    form (``launches_f64``)."""
    if dtype == torch.float64:
        wrapper.launches_f64 += 1
    else:
        wrapper.launches += 1


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """Shared memory a block may opt into on the card (bytes), read once a
    device."""
    props = torch.cuda.get_device_properties(device_index)
    return getattr(props, "shared_memory_per_block_optin", SMEM_OPTIN)


def _cols_scratch(which, B, M, L, dev, dtype):
    """The column-blocked form's scratch (``kappa_cols_scratch``) at any B."""
    return torch.empty((kappa_cols_scratch(which, B, M, L, dtype),), dtype=dtype, device=dev)


def _kappa_moments_launch(X, Z, L_invT, ls2, var, mu, Sigma, jitt, kind):
    """Checks and launches kernel 4 on CUDA tensors; ls2 [L, D] and var [L]
    are tensors.  Returns (kappa, mf, vf)."""
    name = "fused_kappa_moments_batched"
    _check_kind(name, kind)
    B, D = X.shape
    L, M = Z.shape[0], Z.shape[1]
    _check_tensors(X, {"X": (X, (B, D)), "Z": (Z, (L, M, D)), "mu": (mu, (L, M)), "Sigma": (Sigma, (L, M, M))},
                   PAIR_DTYPES)
    if B < 1 or D < 1 or L < 1 or M < 1:
        raise ValueError(f"the CUDA {name} takes B, D, L, M >= 1; got B={B}, D={D}, L={L}, M={M}")
    if L_invT.device != X.device or tuple(L_invT.shape) != (L, M, M):
        raise ValueError(f"L_invT must be [{L}, {M}, {M}] on {X.device}")
    dev, dtype = X.device, X.dtype
    lib = _library()
    form, tb = kappa_route("moments", M, dtype, _smem_limit(dev.index))
    params = _multi_params(X, L, jitt, 0.0, 0.0, ls2, var)
    kinv = _kinv(L_invT.to(dtype))
    like = dict(dtype=dtype, device=dev)
    kappa = torch.empty((L, B, M), **like)
    mf, vf = torch.empty((L, B), **like), torch.empty((L, B), **like)
    with torch.cuda.device(dev):
        args = [t.data_ptr() for t in (X, Z, kinv, mu, Sigma, params, kappa, mf, vf)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "slab":
            err = _pair_fn(lib, "agp_fused_kappa_moments_batched", dtype)(
                *args, B, D, M, L, KINDS.index(kind), tb, stream)
        else:
            scratch = _cols_scratch("moments", B, M, L, dev, dtype)
            err = _pair_fn(lib, "agp_kappa_moments_cols", dtype)(
                *args, scratch.data_ptr(), B, D, M, L, KINDS.index(kind), stream)
    if err != 0:
        raise _cuda_error(name, lib, err)
    _count(fused_kappa_moments_batched, dtype)
    return kappa, mf, vf


def _plain_vjp(ctx, plain, cts, n_static):
    """The backward of a kernel's ``torch.autograd.Function``: the vjp of its
    plain version ``plain`` at the saved inputs, as the reference's
    custom_vjp runs through its XLA twin; ``n_static`` trailing arguments
    (the jitter, the kind) get no gradient."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        outs = plain(*inputs, *ctx.static)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(outs, wanted, cts, allow_unused=True))
    return tuple(next(grads) if t.requires_grad else None for t in inputs) + (None,) * n_static


class _KappaMomentsBatched(torch.autograd.Function):
    """Kernel 4 forward; the backward is the vjp of the plain version."""

    @staticmethod
    def forward(ctx, X, Z, L_invT, ls2, var, mu, Sigma, jitt, kind):
        ctx.save_for_backward(X, Z, L_invT, ls2, var, mu, Sigma)
        ctx.static = (jitt, kind)
        return _kappa_moments_launch(X, Z, L_invT, ls2, var, mu, Sigma, jitt, kind)

    @staticmethod
    def backward(ctx, *cts):
        return _plain_vjp(ctx, fused_kappa_moments_batched_reference, cts, 2)


def fused_kappa_moments_batched(X, Z, L_invT, ls, var, mu, Sigma, jitt, kind="rbf"):
    """kappa = Knm K^-1 [L, B, M] and the latent moments mf, vf [L, B] of
    every latent (kernel 4 of the batched pair).

    X [B, D]; Z [L, M, D]; L_invT [L, M, M] = per-latent (chol(Kmm)^-1)^T;
    ls [L, D] (per-latent ARD, or broadcastable to it); var [L]; mu [L, M];
    Sigma [L, M, M]; jitt a number; kind of ``KINDS``.  Differentiable in
    every tensor argument.

    A CPU tensor runs :func:`fused_kappa_moments_batched_reference`.  A
    CUDA tensor launches the kernel (float32, any L, B, D, M >= 1; kappa
    and kappa Sigma in 3xTF32 on the tensor cores: the row-slab form of
    ``csrc/batched_pair.cu`` where ``kappa_route`` gives it, M up to
    2,392 on an H100, else the column-blocked form of
    ``csrc/kappa_cols.cuh``, four launches) and adds one to
    ``fused_kappa_moments_batched.launches``; float64 tensors launch its
    float64 form (FP64 tensor-core tiles; the same two forms, the slab at
    M <= 128) and add one to ``fused_kappa_moments_batched.launches_f64``:
    one a call.
    Its backward runs the plain version's vjp."""
    if X.device.type == "cpu":
        return fused_kappa_moments_batched_reference(X, Z, L_invT, ls, var, mu, Sigma, jitt, kind)
    if X.device.type != "cuda":
        raise ValueError(f"fused_kappa_moments_batched runs on CPU or CUDA tensors, got {X.device}")
    L, D = Z.shape[0], X.shape[1]
    ls2 = torch.broadcast_to(torch.as_tensor(ls, dtype=X.dtype, device=X.device).reshape(L, -1), (L, D))
    var = torch.broadcast_to(torch.as_tensor(var, dtype=X.dtype, device=X.device).reshape(-1), (L,))
    args = (X, Z, L_invT, ls2, var, mu, Sigma)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _KappaMomentsBatched.apply(*args, jitt, kind)
    return _kappa_moments_launch(*args, jitt, kind)


fused_kappa_moments_batched.launches = 0
fused_kappa_moments_batched.launches_f64 = 0


def _stats_plan(B: int, M: int, L: int, slots: int, tile: int) -> tuple[int, int]:
    """(nchunks, rows) of kernels 5 and 7: chunks of ``rows`` rows (a whole
    number of ``_STATS_STAGE_ROWS``-row stages, ``_STATS_MIN_ROWS`` or
    more where B allows; the last chunk may be shorter, never empty) such
    that the grid of upper tiles x chunks x L latents is one wave of the
    ``slots`` blocks the card holds at once, or one chunk where the tiles
    alone fill more.  Depends on the card and M, not on B beyond that."""
    nt = -(-M // tile)
    blocks = nt * (nt + 1) // 2 * L
    nchunks = max(1, min(-(-B // _STATS_MIN_ROWS), slots // blocks))
    rows = -(-B // nchunks)
    rows = -(-rows // _STATS_STAGE_ROWS) * _STATS_STAGE_ROWS
    return -(-B // rows), rows


@functools.lru_cache(maxsize=None)
def _stats_slots(device_index: int, dtype=torch.float32, mma_k: int = 8) -> int:
    """Blocks of kernels 5 and 7 (of their float64 form for ``dtype``
    float64, in the geometry of mma depth ``mma_k``) that the card holds at
    once (occupancy API x SMs)."""
    lib = _library()
    with torch.cuda.device(device_index):
        if dtype == torch.float64:
            per_sm = lib.agp_cavi_stats_blocks_per_sm_f64(mma_k)
        else:
            per_sm = lib.agp_cavi_stats_blocks_per_sm()
        if per_sm < 1:
            raise RuntimeError("the CUDA statistics kernel fits no SM of this card")
        return per_sm * torch.cuda.get_device_properties(device_index).multi_processor_count


def _stats_launch(name, kappa, g, theta, L):
    """Kernels 5 and 7's statistics of kappa [L, B, M] (the batched C entry
    point, L latents) or of kappa [B, M] (kernel 7's, one latent), g and
    theta of kappa's leading shape, float32 or float64 (the entry point's
    float64 form): checks, the chunk plan (``_stats_plan``), the scratch,
    the launch.  Returns (s1, S2) of the leading shape."""
    lead = tuple(kappa.shape[:-1])
    B, M = lead[-1], kappa.shape[-1]
    _check_tensors(kappa, {"kappa": (kappa, lead + (M,)), "g": (g, lead), "theta": (theta, lead)}, PAIR_DTYPES)
    if B < 1 or M < 1 or L < 1:
        raise ValueError(f"the CUDA {name} takes L, B, M >= 1; got L={L}, B={B}, M={M}")
    dev, dtype = kappa.device, kappa.dtype
    lib = _library()
    tile = _pair_fn(lib, "agp_cavi_stats_tile", dtype)()
    mma_k = STATS_F64_MMA_K
    nchunks, rows = _stats_plan(B, M, L, _stats_slots(dev.index, dtype, mma_k), tile)
    like = dict(dtype=dtype, device=dev)
    s1_part, s2_part = torch.empty((L, nchunks, M), **like), torch.empty((L, nchunks, M, M), **like)
    s1, S2 = torch.empty(lead[:-1] + (M,), **like), torch.empty(lead[:-1] + (M, M), **like)
    ints = ((B, M, L) if len(lead) == 2 else (B, M)) + (nchunks, rows) + ((mma_k,) if dtype == torch.float64 else ())
    lib_fn = _pair_fn(lib, "agp_cavi_stats_batched" if len(lead) == 2 else "agp_cavi_stats", dtype)
    with torch.cuda.device(dev):
        err = lib_fn(*(t.data_ptr() for t in (kappa, g, theta, s1_part, s2_part, s1, S2)), *ints,
                     torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise _cuda_error(name, lib, err)
    return s1, S2


def cavi_stats_batched(kappa, g, theta):
    """s1[l] = kappa[l]^T g[l] [L, M] and S2[l] = kappa[l]^T diag(theta[l])
    kappa[l] [L, M, M] of every latent (kernel 5 of the batched pair).
    kappa [L, B, M], g and theta [L, B].

    A CPU tensor runs :func:`cavi_stats_batched_reference`.  A CUDA tensor
    launches the kernel (float32, any L, B, M >= 1; 3xTF32 tensor-core
    tiles over S2's upper triangle, ``csrc/stats_tc.cuh``) and adds one to
    ``cavi_stats_batched.launches``; float64 tensors launch its float64
    form (FP64 tensor-core tiles) and add one to
    ``cavi_stats_batched.launches_f64``.  S2 comes out exactly symmetric."""
    if kappa.device.type == "cpu":
        return cavi_stats_batched_reference(kappa, g, theta)
    if kappa.device.type != "cuda":
        raise ValueError(f"cavi_stats_batched runs on CPU or CUDA tensors, got {kappa.device}")
    if kappa.ndim != 3:
        raise ValueError(f"kappa must be [L, B, M], got shape {tuple(kappa.shape)}")
    out = _stats_launch("cavi_stats_batched", kappa, g, theta, kappa.shape[0])
    _count(cavi_stats_batched, kappa.dtype)
    return out


cavi_stats_batched.launches = 0
cavi_stats_batched.launches_f64 = 0


# ------------------------------------------------ the single-latent split pair
@_highest_precision
def _fused_kappa_from_kinv(X, Z, kinv, ls, var, jitt, kind):
    """(kappa [B, M], Ktilde [B]) from K^-1 [M, M]: the plain math of
    kernel 6, with ls a number, [] or [D] and var a number or []."""
    ls = torch.as_tensor(ls, dtype=X.dtype, device=X.device)
    var = torch.as_tensor(var, dtype=X.dtype, device=X.device).reshape(1)
    kappa, ktilde, _ = _kappa_ktilde((X / ls)[None], (Z / ls)[None], kinv[None], var, jitt, kind)
    return kappa[0], ktilde[0]


def fused_kappa_reference(X, Z, L_invT, lengthscale, variance, jitt, kind="rbf"):
    """Plain PyTorch version of :func:`fused_kappa`, in the inputs' dtype, on
    their device: the reference's ``_kappa_xla_twin`` with the gram by
    direct differences over feature chunks (``_sq_dist_chunked``)."""
    return _fused_kappa_from_kinv(X, Z, _kinv(L_invT), lengthscale, variance, jitt, kind)


def _fused_kappa_launch(X, Z, kinv, ls, var, jitt, kind):
    """Checks and launches kernel 6 on CUDA tensors; ls [D] and var [] are
    tensors.  Returns (kappa, Ktilde)."""
    name = "fused_kappa"
    _check_kind(name, kind)
    B, D = X.shape
    M = Z.shape[0]
    _check_tensors(X, {"X": (X, (B, D)), "Z": (Z, (M, D)), "K^-1": (kinv, (M, M))}, PAIR_DTYPES)
    if B < 1 or D < 1 or M < 1:
        raise ValueError(f"the CUDA {name} takes B, D, M >= 1; got B={B}, D={D}, M={M}")
    dev, dtype = X.device, X.dtype
    lib = _library()
    form, tb = kappa_route("single", M, dtype, _smem_limit(dev.index))
    params = _multi_params(X, 1, jitt, 0.0, 0.0, ls, var)
    like = dict(dtype=dtype, device=dev)
    kappa, ktilde = torch.empty((B, M), **like), torch.empty((B,), **like)
    with torch.cuda.device(dev):
        args = [t.data_ptr() for t in (X, Z, kinv, params, kappa, ktilde)]
        stream = torch.cuda.current_stream(dev).cuda_stream
        if form == "slab":
            err = _pair_fn(lib, "agp_fused_kappa", dtype)(*args, B, D, M, KINDS.index(kind), tb, stream)
        else:
            scratch = _cols_scratch("single", B, M, 1, dev, dtype)
            err = _pair_fn(lib, "agp_fused_kappa_cols", dtype)(
                *args, scratch.data_ptr(), B, D, M, KINDS.index(kind), stream)
    if err != 0:
        raise _cuda_error(name, lib, err)
    _count(fused_kappa, dtype)
    return kappa, ktilde


class _FusedKappa(torch.autograd.Function):
    """Kernel 6 forward from K^-1 (so that autograd carries K^-1's gradient
    on to L^-T through ``_kinv``); the backward is the plain version's vjp."""

    @staticmethod
    def forward(ctx, X, Z, kinv, ls, var, jitt, kind):
        ctx.save_for_backward(X, Z, kinv, ls, var)
        ctx.static = (jitt, kind)
        return _fused_kappa_launch(X, Z, kinv, ls, var, jitt, kind)

    @staticmethod
    def backward(ctx, *cts):
        return _plain_vjp(ctx, _fused_kappa_from_kinv, cts, 2)


def fused_kappa(X, Z, L_invT, lengthscale, variance, jitt, kind="rbf"):
    """kappa = Knm K^-1 [B, M] and Ktilde = max(var + jitt - rowsum(kappa o
    Knm), 1e-12) [B] of one latent (kernel 6, the first of the
    single-latent split pair).

    X [B, D]; Z [M, D]; L_invT [M, M] = (chol(Kmm)^-1)^T; lengthscale a
    number, [] or [D] (ARD); variance a number or []; jitt a number; kind of
    ``KINDS``.  Differentiable in every tensor argument.

    A CPU tensor runs :func:`fused_kappa_reference`.  A CUDA tensor launches
    the kernel (float32, any B, D, M >= 1; kappa in 3xTF32 on the tensor
    cores: the row-slab form of ``csrc/kappa_single.cu`` where
    ``kappa_route`` gives it, M up to 2,406 on an H100, else the
    column-blocked form of ``csrc/kappa_cols.cuh``, three launches) and
    adds one to ``fused_kappa.launches``; float64 tensors launch its
    float64 form (FP64 tensor-core tiles; the same two forms, the slab at
    M <= 128) and add one to ``fused_kappa.launches_f64``: one a call.  ls, var and the
    jitter reach it in a device buffer, so a changing lengthscale costs no
    host read.  Its backward runs the plain version's vjp."""
    if X.device.type == "cpu":
        return fused_kappa_reference(X, Z, L_invT, lengthscale, variance, jitt, kind)
    if X.device.type != "cuda":
        raise ValueError(f"fused_kappa runs on CPU or CUDA tensors, got {X.device}")
    if L_invT.device != X.device or L_invT.ndim != 2:
        raise ValueError(f"L_invT must be [M, M] on {X.device}")
    ls = torch.broadcast_to(torch.as_tensor(lengthscale, dtype=X.dtype, device=X.device).reshape(-1), X.shape[1:])
    var = torch.as_tensor(variance, dtype=X.dtype, device=X.device).reshape(())
    args = (X, Z, _kinv(L_invT), ls, var)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return _FusedKappa.apply(*args, jitt, kind)
    return _fused_kappa_launch(*args, jitt, kind)


fused_kappa.launches = 0
fused_kappa.launches_f64 = 0


@_highest_precision
def cavi_stats_reference(kappa, g, theta):
    """Plain PyTorch version of :func:`cavi_stats`: s1 [M] = kappa^T g and
    S2 [M, M] = kappa^T diag(theta) kappa."""
    return kappa.T @ g, (kappa * theta[:, None]).T @ kappa


def cavi_stats(kappa, g, theta):
    """s1 = kappa^T g [M] and S2 = kappa^T diag(theta) kappa [M, M] of one
    latent (kernel 7, the second of the single-latent split pair).
    kappa [B, M], g and theta [B].

    A CPU tensor runs :func:`cavi_stats_reference`.  A CUDA tensor launches
    the kernel (float32, any B, M >= 1: kernel 5's 3xTF32 tensor-core
    tiles with one latent, its partial sums added in a fixed order, no
    atomics) and adds one to ``cavi_stats.launches``; float64 tensors
    launch its float64 form (kernel 5's FP64 tiles) and add one to
    ``cavi_stats.launches_f64``.  S2 comes out exactly symmetric."""
    if kappa.device.type == "cpu":
        return cavi_stats_reference(kappa, g, theta)
    if kappa.device.type != "cuda":
        raise ValueError(f"cavi_stats runs on CPU or CUDA tensors, got {kappa.device}")
    if kappa.ndim != 2:
        raise ValueError(f"kappa must be [B, M], got shape {tuple(kappa.shape)}")
    out = _stats_launch("cavi_stats", kappa, g, theta, 1)
    _count(cavi_stats, kappa.dtype)
    return out


cavi_stats.launches = 0
cavi_stats.launches_f64 = 0
