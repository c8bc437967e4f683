"""The port's tile gather (agp_tpu_torch/benchmarks/gather_modes.py,
kernel 10) against the JAX package's benchmarks/gather_modes.py.  The
Pallas gather does not run in TPU interpret mode (the interpreter's DMA
emulation of its pltpu.ANY operand fails), so its CPU oracle is the
reference's own portable fallback: jnp.take on the [N // tr, tr, D] view.
The CUDA kernel against the plain version is in test_torch_cuda.py."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agp_tpu_torch.benchmarks import gather_modes as gm


def reference_module():
    """The reference's benchmarks/gather_modes.py, loaded from its path."""
    path = Path(__file__).resolve().parent.parent / "benchmarks" / "gather_modes.py"
    spec = importlib.util.spec_from_file_location("reference_gather_modes", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


REF = reference_module()


def data(n, d, n_idx, tr, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    return X, rng.integers(0, n // tr, size=n_idx)


@pytest.mark.parametrize("tile_rows", [None, 5])
@pytest.mark.parametrize("d", [8, 20, 33])
def test_plain_gather_equals_take_on_the_tile_view(d, tile_rows):
    """gather_row_tiles_reference bit-equal to jnp.take on the reference's
    [N // tr, tr, D] view (N not a multiple of tr: the view drops the
    tail), with the default tile height and an explicit one."""
    tr = REF.gather_tile_rows(d) if tile_rows is None else tile_rows
    n = 7 * tr + 3
    X, tidx = data(n, d, 11, tr)
    view = jnp.asarray(X)[: n // tr * tr].reshape(n // tr, tr, d)
    ref = np.asarray(jnp.take(view, jnp.asarray(tidx), axis=0)).reshape(-1, d)
    out = gm.gather_row_tiles_reference(torch.as_tensor(X), torch.as_tensor(tidx), tile_rows=tile_rows)
    assert out.shape == (11 * tr, d)
    assert np.array_equal(out.numpy(), ref)


def test_tile_rows_formula_matches_the_reference():
    for d in range(1, 257):
        assert gm.gather_tile_rows(d) == REF.gather_tile_rows(d), d
    assert gm.gather_tile_rows(20) == 32 and gm.gather_tile_rows(8) == 16


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cpu_wrapper_runs_the_plain_version(dtype):
    """On CPU tensors the wrapper is the plain version (either index
    width), launches nothing, and ignores tiles_per_step."""
    X, tidx = data(640, 20, 9, 32, seed=1)
    X, tidx = torch.as_tensor(X), torch.as_tensor(tidx, dtype=dtype)
    before = gm.gather_row_tiles.launches
    out = gm.gather_row_tiles(X, tidx, tiles_per_step=3)
    assert gm.gather_row_tiles.launches == before
    assert torch.equal(out, gm.gather_row_tiles_reference(X, tidx))
    assert torch.equal(out[32:64], X[int(tidx[1]) * 32:(int(tidx[1]) + 1) * 32])


def test_tile_rows_must_be_positive():
    with pytest.raises(ValueError, match="tile_rows"):
        gm.gather_row_tiles(torch.zeros((8, 4)), torch.zeros(2, dtype=torch.int64), tile_rows=0)
