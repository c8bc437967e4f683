"""The tile gather of the "block" minibatch draw (kernel 10 of the port),
its plain version and the reference's tile height: the counterparts of
``gather_row_tiles`` and ``gather_tile_rows`` in the JAX package's
``benchmarks/gather_modes.py``.

The training driver's draws stay ``index_select`` on the tile view
(``training/train.py::_draw_from_idx``), as the reference's stay
``jnp.take``: its own measurement kept the DMA gather off the production
path.  ``agp_tpu_torch.bench gather`` times this kernel beside that call.
"""
from __future__ import annotations

import math

import torch

from ..ops import cuda_kernels as ck


def gather_tile_rows(D, lanes=128):
    """The reference's tile height: the smallest number of rows of width D
    whose float32 size is a whole number of 128-lane rows (D=20 -> 32 rows,
    D=8 -> 16).  The card needs no such alignment; the same call gives the
    same rows as in the reference."""
    return lanes // math.gcd(D, lanes)


def _tile_rows(D, tile_rows):
    tr = gather_tile_rows(D) if tile_rows is None else int(tile_rows)
    if tr < 1:
        raise ValueError(f"tile_rows must be >= 1, got {tile_rows}")
    return tr


def gather_row_tiles_reference(X, tidx, tile_rows=None, tiles_per_step=64):
    """Plain PyTorch version of :func:`gather_row_tiles`: ``index_select``
    of the tile indices on the [N // tr, tr, D] view of X's first
    N // tr * tr rows (the view of ``training/train.py::_tile_views``),
    flattened to [T tr, D]."""
    N, D = X.shape
    tr = _tile_rows(D, tile_rows)
    n_tiles = N // tr
    return X[: n_tiles * tr].reshape(n_tiles, tr, D).index_select(0, tidx).reshape(-1, D)


def gather_row_tiles(X, tidx, tile_rows=None, tiles_per_step=64):
    """out[j tr : (j+1) tr] = X[tidx[j] tr : (tidx[j]+1) tr] for the T tile
    indices tidx (kernel 10, the port of the reference's
    ``gather_row_tiles``).  X [N, D]; tidx [T], int32 or int64, each below
    N // tr; tile_rows tr, ``gather_tile_rows(D)`` when None.  Returns
    [T tr, D].

    The reference needs tile_rows * D % 128 == 0 and views X as
    [N D / 128, 128], because Mosaic's DMA slices must be 128-lane aligned;
    the card needs neither, so any tr >= 1 is taken.  ``tiles_per_step``
    (the reference's DMAs in flight per grid step) is taken for the
    signature and changes nothing.

    A CPU tensor runs :func:`gather_row_tiles_reference`.  A CUDA tensor
    launches the kernel (``csrc/gather_tiles.cu``; float32 X) and adds one
    to ``gather_row_tiles.launches``.  Out-of-range indices are the
    caller's to avoid, as in the reference: the wrapper checks tidx's dtype,
    shape and device, not its values, which it could read only with a host
    sync."""
    if X.device.type == "cpu":
        return gather_row_tiles_reference(X, tidx, tile_rows)
    if X.device.type != "cuda":
        raise ValueError(f"gather_row_tiles runs on CPU or CUDA tensors, got {X.device}")
    if X.ndim != 2:
        raise ValueError(f"X must be [N, D], got shape {tuple(X.shape)}")
    N, D = X.shape
    tr = _tile_rows(D, tile_rows)
    ck._check_tensors(X, {"X": (X, (N, D))})
    if tidx.device != X.device:
        raise ValueError(f"tidx is on {tidx.device}, X on {X.device}")
    if tidx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"tidx must be int32 or int64, got {tidx.dtype}")
    if tidx.ndim != 1 or not tidx.is_contiguous() or tidx.shape[0] < 1:
        raise ValueError(f"tidx must be a contiguous [T] array with T >= 1, got shape {tuple(tidx.shape)}")
    if N < tr:
        raise ValueError(f"X has {N} rows, fewer than one tile of {tr}")
    T = tidx.shape[0]
    out = torch.empty((T * tr, D), dtype=torch.float32, device=X.device)
    lib = ck._library()
    with torch.cuda.device(X.device):
        err = lib.agp_gather_row_tiles(X.data_ptr(), tidx.data_ptr(), tidx.element_size(), out.data_ptr(), T,
                                       tr * D, torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        raise ck._cuda_error("gather_row_tiles", lib, err)
    gather_row_tiles.launches += 1
    return out


gather_row_tiles.launches = 0
