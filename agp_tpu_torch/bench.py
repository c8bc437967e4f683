"""Benchmark of the PyTorch port on one NVIDIA GPU: the counterpart of the
JAX package's ``bench.py`` and of its two kernel sweeps
(``benchmarks/fused_variants.py``, ``benchmarks/gather_modes.py``).

    python3 -m agp_tpu_torch.bench [--iters N] [--chunk N]
    python3 -m agp_tpu_torch.bench extra
    python3 -m agp_tpu_torch.bench variants
    python3 -m agp_tpu_torch.bench gather

* default: natural-gradient CAVI iterations/s of the flagship (SVGP + RBF
  + logistic, N=200,000, D=20, M=64, B=4096, "block" sampling, fixed
  hyperparameters, float32), timed as ``bench.py::bench_jax`` times it: two
  warm-up chunks of ``--chunk`` steps, then ``--iters`` steps in chunks,
  each chunk's minibatches drawn in one call, ending in
  ``torch.cuda.synchronize()`` and a finite check on mu.  Prints the card's
  name and power limit, then one JSON line {"metric", "value", "unit",
  "vs_baseline"}; ``vs_baseline`` is the rate over the same iteration in
  numpy (``bench_numpy_baseline``, a copy of the reference's, on the host).
* ``extra``: the rows of ``bench.py::bench_extra`` that the port runs, each
  in a child process of its own (the host's cost per launch grows over a
  process's life); one JSON line, also written to
  ``_chip/bench_torch_extra.json``.
* ``variants``: kernel 1, kernel 8 ("nt", "packed") and kernel 9 beside the
  sweep's bar (``xla_stats_reference``), CUDA events, at the flagship's
  statistics shape and at the sweep's four rows; each one's s1/S2 error
  against the float64 plain version.  Kernel 1 takes M <= 128: at the
  sweep's M=256 and M=512 rows its column says out of range.
* ``gather``: the raw "block" draw at the flagship shape, ``index_select``
  on the tile view against kernel 10, for tiles of 32 and 64 rows, in us a
  draw.

Every mode needs a CUDA card and raises without one: its rates are the
card's.  Data are made with numpy from fixed seeds.  The functions take
their sizes as arguments, so that a test can drive them small on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import AnalyticSVI, HeteroscedasticLikelihood, LogisticLikelihood, LogisticSoftMaxLikelihood, SVGP
from . import SqExponentialKernel, init_state
from .benchmarks.fused_variants import direct_stats, direct_stats_reference, two_factor_nt, xla_stats_reference
from .benchmarks.gather_modes import gather_row_tiles, gather_tile_rows
from .ops import cuda_kernels as ck
from .training.train import vi_steps

METRIC = "torch_cavi_iters_per_sec_svgp_m64_logistic_b4096"
# the flagship of bench.py:21-53
N, D, M, B = 200_000, 20, 64, 4096
ITERS, CHUNK = 8000, 2000
# where the extra rows go: gitignored, beside the package
_OUT = Path(__file__).resolve().parent.parent / "_chip"
# the sweep's shapes (B, D, M): the flagship's statistics, then the sweep's
# four rows (benchmarks/fused_variants.py:286)
VARIANT_SHAPES = ((B, D, M), (8192, 8, 512), (65_536, 8, 256), (65_536, 8, 512), (262_144, 8, 128))
# the sweep's hyperparameters (fused_variants.py:286-289)
SWEEP_LS, SWEEP_VAR, SWEEP_RHO, SWEEP_JITT = 1.3, 1.1, 4.0, 1e-4
# the gather's tile heights: gather_tile_rows(20) and the "block" default
GATHER_TILES = (gather_tile_rows(D), 64)


def require_card() -> torch.device:
    """The first CUDA device, TF32 off; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("agp_tpu_torch.bench measures the CUDA card, and torch.cuda.is_available() is false")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True)
    return proc.stdout.strip() or torch.cuda.get_device_name(0)


# ------------------------------------------------------------- workloads
def _workload(kernel, lik, X, y, m, b, sampling):
    """(model, state, X, treated y) of an SVGP with fixed hyperparameters
    on X's device and dtype."""
    model = SVGP.create(kernel, lik, AnalyticSVI(b, minibatch_sampling=sampling), X[:m], optimiser=None)
    y2, treated = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=treated)
    y2 = y2.to(device=X.device, dtype=X.dtype)
    return model, init_state(model, X, y2), X, y2


def flagship_workload(device, sampling="block", n=N, d=D, m=M, b=B, seed=0):
    """bench.py's flagship: X standard normal, y the sign of X w, RBF with
    lengthscale 2 and variance 1, the logistic likelihood."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(X @ rng.normal(size=d).astype(np.float32) > 0, 1.0, -1.0).astype(np.float32)
    X, y = torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)
    return _workload(SqExponentialKernel(lengthscale=2.0, variance=1.0), LogisticLikelihood.create(), X, y, m, b,
                     sampling)


def multiclass_workload(device, n=50_000, d=10, m=64, b=2048, k=10, seed=1):
    """bench_extra's multiclass_k10_m64_b2048: labels the argmax of X W, the
    logistic-softmax likelihood, slice sampling."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(d, k)).astype(np.float32), axis=1)
    X = torch.as_tensor(X, device=device)
    return _workload(SqExponentialKernel(lengthscale=2.0), LogisticSoftMaxLikelihood.create(k), X,
                     torch.as_tensor(y, device=device), m, b, "slice")


def het_workload(device, n=50_000, d=10, m=64, b=2048, seed=2):
    """bench_extra's heteroscedastic_m64_b2048: y = sin(x_0) + 0.1 eps,
    slice sampling."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.normal(size=n)).astype(np.float32)
    X = torch.as_tensor(X, device=device)
    return _workload(SqExponentialKernel(lengthscale=2.0), HeteroscedasticLikelihood.create(), X,
                     torch.as_tensor(y, device=device), m, b, "slice")


def big_logistic_workload(device, n=500_000, d=20, m=512, b=65_536, seed=4):
    """bench_extra's logistic_m512_b65536: the flagship's data rule at
    M=512, B=65,536, slice sampling."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    y = np.where(X @ rng.normal(size=d).astype(np.float32) > 0, 1.0, -1.0).astype(np.float32)
    X = torch.as_tensor(X, device=device)
    return _workload(SqExponentialKernel(lengthscale=2.0), LogisticLikelihood.create(), X,
                     torch.as_tensor(y, device=device), m, b, "slice")


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed_rate(model, state, X, y, iters, chunk, seed=0):
    """CAVI iterations/s, as bench.py times them: two warm-up chunks of
    ``chunk`` steps, then max(iters // chunk, 1) chunks, each drawing its
    minibatches in one call; the clock stops after a synchronize.  Raises if
    mu is not finite.  Returns (it/s, model, state)."""
    gen = torch.Generator(device=X.device).manual_seed(seed)
    for _ in range(2):
        model, state = vi_steps(model, state, X, y, chunk, generator=gen)
    _sync(X.device)
    n = max(iters // chunk, 1)
    t0 = time.perf_counter()
    for _ in range(n):
        model, state = vi_steps(model, state, X, y, chunk, generator=gen)
    _sync(X.device)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(state.mu).all()):
        raise RuntimeError("non-finite posterior")
    return n * chunk / dt, model, state


def bench_numpy_baseline(iters=20):
    """Same CAVI iteration in single-thread-ish numpy/BLAS: the stand-in for
    the reference's per-iteration cost model (kernel matrices recomputed per
    minibatch, closed-form logistic E-step, natural-gradient update).  A copy
    of ``bench.py::bench_numpy_baseline``: the port imports nothing of the
    JAX package's files."""
    rng = np.random.RandomState(0)
    N, D, M, B = 200_000, 20, 64, 4096
    X = rng.randn(N, D)
    w = rng.randn(D)
    y = np.where(X @ w > 0, 1.0, -1.0)
    Z = X[:M]
    ls, var = 2.0, 1.0

    def gram(A, C):
        d2 = (
            (A * A).sum(1)[:, None] + (C * C).sum(1)[None, :] - 2.0 * A @ C.T
        ) / ls**2
        return var * np.exp(-0.5 * np.maximum(d2, 0))

    Kmm = gram(Z, Z) + 1e-4 * np.eye(M)
    Kinv = np.linalg.inv(Kmm)
    eta1 = np.zeros(M)
    eta2 = -0.5 * np.eye(M)
    mu = np.zeros(M)
    Sig = np.eye(M)
    rho = N / B
    lr = 0.05
    t0 = time.perf_counter()
    for it in range(iters):
        idx = rng.randint(0, N, B)
        xb, yb = X[idx], y[idx]
        Knm = gram(xb, Z)
        kap = Knm @ Kinv
        Ktl = var + 1e-4 - np.einsum("bm,bm->b", kap, Knm)
        mf = kap @ mu
        vf = Ktl + np.einsum("bm,mn,bn->b", kap, Sig, kap)
        c = np.sqrt(mf**2 + vf)
        th = np.tanh(c / 2) / (2 * c)
        g1 = kap.T @ (rho * yb / 2) + 0 - eta1
        g2 = -((rho * 0.5 * th)[:, None] * kap).T @ kap - 0.5 * Kinv - eta2
        eta1 = eta1 + lr * g1
        eta2 = eta2 + lr * g2
        Sig = np.linalg.inv(-2 * eta2)
        mu = Sig @ eta1
    return iters / (time.perf_counter() - t0)


def primary(iters=ITERS, chunk=CHUNK):
    """The primary line: the flagship's rate on the card over the numpy
    baseline's."""
    device = require_card()
    value = timed_rate(*flagship_workload(device), iters, chunk)[0]
    base = bench_numpy_baseline()
    return {"metric": METRIC, "value": value, "unit": "iters/s/gpu", "vs_baseline": value / base}


# ----------------------------------------------------------------- extra
# bench_extra's rows that the port runs: (workload, iters, chunk); the
# Gibbs and online rows wait for the slices that port those models
EXTRA_ROWS = {
    "flagship_slice_iters_per_s": (lambda dev: flagship_workload(dev, sampling="slice"), 8000, 2000),
    "multiclass_k10_m64_b2048": (multiclass_workload, 4000, 2000),
    "heteroscedastic_m64_b2048": (het_workload, 4000, 2000),
    "logistic_m512_b65536": (big_logistic_workload, 300, 50),
}


def extra_row(name):
    """One row of ``EXTRA_ROWS`` on the card, in this process: it/s."""
    build, iters, chunk = EXTRA_ROWS[name]
    return timed_rate(*build(require_card()), iters, chunk)[0]


def extra():
    """Each row of ``EXTRA_ROWS`` in a child process of its own
    (``python3 -m agp_tpu_torch.bench row NAME``), and logistic_m512's
    points/s; written to ``_chip/bench_torch_extra.json``."""
    require_card()
    rows = {}
    for name in EXTRA_ROWS:
        proc = subprocess.run([sys.executable, "-m", "agp_tpu_torch.bench", "row", name], capture_output=True,
                              text=True, timeout=900, cwd=Path(__file__).resolve().parent.parent)
        if proc.returncode != 0:
            raise RuntimeError(f"extra row {name} exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
        rows[name] = json.loads(proc.stdout.splitlines()[-1])["value"]
    rows["logistic_m512_b65536_pts_per_s"] = rows["logistic_m512_b65536"] * 65_536
    rows["device"] = torch.cuda.get_device_name(0)
    _OUT.mkdir(exist_ok=True)
    (_OUT / "bench_torch_extra.json").write_text(json.dumps(rows, indent=1))
    return rows


# -------------------------------------------------------------- variants
def sweep_inputs(b, d, m, device, seed=0):
    """The sweep's inputs (fused_variants.py:282-301) made with numpy: X, Z
    standard normal, y the sign of a normal, Kzz = RBF(Z) + 1e-3 I with the
    sweep's hyperparameters, its L^-T and K^-1 (float64 on the host), mu
    standard normal, Sigma = I; float32 on ``device``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b, d))
    y = np.where(rng.normal(size=b) > 0, 1.0, -1.0)
    Z = rng.normal(size=(m, d))
    zs = Z / SWEEP_LS
    r2 = np.maximum((zs * zs).sum(1)[:, None] + (zs * zs).sum(1)[None, :] - 2.0 * zs @ zs.T, 0.0)
    Kzz = SWEEP_VAR * np.exp(-0.5 * r2) + 1e-3 * np.eye(m)
    Linv = np.linalg.inv(np.linalg.cholesky(Kzz))
    arrays = dict(X=X, y=y, Z=Z, L_invT=Linv.T, Kinv=Linv.T @ Linv, mu=rng.normal(size=m), Sigma=np.eye(m))
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device).contiguous() for k, v in arrays.items()}


def sweep_args(t):
    return (t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], SWEEP_LS, SWEEP_VAR, SWEEP_JITT, SWEEP_RHO)


def variant_calls(t):
    """The sweep's candidates on inputs ``t``: kernel 1 (where it takes
    the shape: ``fused_fits(1, D, M)``), kernel 8 ("nt", "packed"), kernel 9
    and the bar, each a function of no argument returning (s1, S2, ...)."""
    a = sweep_args(t)
    calls = {}
    if ck.fused_fits(1, t["X"].shape[1], t["Z"].shape[0]):
        calls["fused_cavi_stats"] = lambda: ck.fused_cavi_stats(*a, kind="rbf", lik="logistic")
    return {
        **calls,
        "direct_stats_nt": lambda: direct_stats(*a, variant="nt"),
        "direct_stats_packed": lambda: direct_stats(*a, variant="packed"),
        "two_factor_nt": lambda: two_factor_nt(*a),
        "xla_stats_reference": lambda: xla_stats_reference(t["X"], t["y"], t["Z"], t["Kinv"], t["mu"], t["Sigma"],
                                                           SWEEP_LS, SWEEP_VAR, SWEEP_RHO),
    }


def event_ms(fn, reps):
    """Milliseconds a call on the card by CUDA events: one warm-up call,
    then ``reps`` calls between two events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def variant_reps(b, reps):
    """Timed calls of a candidate at batch b: a tenth of ``reps`` at the
    sweep's B=262,144."""
    return reps if b <= 65_536 else max(1, reps // 10)


def variants(reps=100):
    """Each candidate of ``variant_calls`` at each shape of
    ``VARIANT_SHAPES``: one call for the error of s1 and S2 against the
    float64 plain version (max |d| over the largest entry, as the sweep
    reports it), then ``event_ms`` over ``variant_reps`` calls; kernel 1's
    column says why it is out of range where it is.  Returns the rows."""
    device = require_card()
    rows = []
    for b, d, m in VARIANT_SHAPES:
        t = sweep_inputs(b, d, m, device)
        ref = direct_stats_reference(*sweep_args({k: v.double() for k, v in t.items()}))[:2]
        row = {"B": b, "D": d, "M": m}
        calls = variant_calls(t)
        if "fused_cavi_stats" not in calls:
            row["fused_cavi_stats_out_of_range"] = (
                f"M={m} > {ck.MAX_M}: kernel 1 holds K^-1 and Sigma ({8 * m * m} bytes) in a block's shared memory "
                f"({ck.SMEM_OPTIN} bytes)")
        for name, fn in calls.items():
            out = fn()[:2]
            row[name + "_err"] = max(float((o.double() - r).abs().max() / r.abs().max()) for o, r in zip(out, ref))
            row[name + "_ms"] = event_ms(fn, variant_reps(b, reps))
        rows.append(row)
        del t, ref
    return rows


# ---------------------------------------------------------------- gather
def gather(draws=2000, n=N, d=D, b=B, tiles=GATHER_TILES, seed=0):
    """The raw "block" draw of b rows from [n, d] float32 data, us a draw,
    for each tile height: ``index_select`` on the [n // tr, tr, d] view (the
    training driver's draw) against kernel 10, over ``draws`` precomputed
    int64 draws, by CUDA events in the order index_select, kernel, kernel,
    index_select; the two outputs equal on the first draw."""
    device = require_card()
    rng = np.random.default_rng(seed)
    X = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32), device=device)
    rows = {}
    for tr in tiles:
        view = X[: n // tr * tr].reshape(n // tr, tr, d)
        tidx = torch.randint(0, n // tr, (draws, b // tr), device=device,
                             generator=torch.Generator(device=device).manual_seed(seed))
        if not torch.equal(gather_row_tiles(X, tidx[0], tile_rows=tr), view.index_select(0, tidx[0]).reshape(-1, d)):
            raise RuntimeError(f"kernel 10 differs from index_select at tiles of {tr}")

        def take():
            for i in range(draws):
                view.index_select(0, tidx[i])

        def kernel():
            for i in range(draws):
                gather_row_tiles(X, tidx[i], tile_rows=tr)

        times = {"index_select": [event_ms(take, 1)], "kernel": []}
        times["kernel"] += [event_ms(kernel, 1), event_ms(kernel, 1)]
        times["index_select"].append(event_ms(take, 1))
        rows[f"tile{tr}"] = {f"{k}_us_per_draw": sum(v) / len(v) / draws * 1e3 for k, v in times.items()}
    return rows


# ------------------------------------------------------------------ main
def main(argv=None):
    parser = argparse.ArgumentParser(prog="python3 -m agp_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    parser.add_argument("mode", nargs="?", default="primary", choices=("primary", "extra", "variants", "gather", "row"))
    parser.add_argument("name", nargs="?", help="the extra row of mode 'row' (a child of 'extra')")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed CAVI steps of the primary line")
    parser.add_argument("--chunk", type=int, default=CHUNK, help="steps per chunk of the primary line")
    args = parser.parse_args(argv)
    if args.mode == "row":
        print(json.dumps({"row": args.name, "value": extra_row(args.name)}))
        return
    require_card()
    print(card_line(), flush=True)
    if args.mode == "primary":
        print(json.dumps(primary(args.iters, args.chunk)))
    elif args.mode == "extra":
        print(json.dumps(extra()))
    elif args.mode == "variants":
        for row in variants():
            print(json.dumps(row))
    else:
        print(json.dumps(gather()))


if __name__ == "__main__":
    main()
