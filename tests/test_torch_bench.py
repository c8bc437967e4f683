"""The port's bench entry point (agp_tpu_torch/bench.py) on the CPU, at cut
sizes: its workload builders make bench.py's configurations, its timed
loop runs and counts, its sweep candidates agree with each other, and it
refuses to measure without a card.  In a fresh process, importing the port
and its bench leaves JAX and the JAX package unloaded."""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from agp_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("build,kw,n_latent,sampling", [
    (bench.flagship_workload, dict(n=2048, m=16, b=256), 1, "block"),
    (bench.flagship_workload, dict(sampling="slice", n=2048, m=16, b=256), 1, "slice"),
    (bench.multiclass_workload, dict(n=1024, d=4, m=8, b=128, k=3), 3, "slice"),
    (bench.het_workload, dict(n=1024, d=4, m=8, b=128), 2, "slice"),
    (bench.big_logistic_workload, dict(n=2048, d=4, m=130, b=256), 1, "slice"),
])
def test_workload_builders_and_timed_loop(build, kw, n_latent, sampling):
    """Each builder at a cut size on the CPU: bench.py's model (fixed
    hyperparameters, lengthscale 2, its sampling), a state at step 0, then
    timed_rate's two warm-up chunks and two timed ones (M=130 takes the
    single-latent split pair)."""
    model, state, X, y = build("cpu", **kw)
    assert model.optimiser is None and model.n_latent == n_latent
    assert model.inference.minibatch_sampling == sampling and model.inference.batchsize == kw["b"]
    assert float(model.kernel.lengthscale.reshape(-1)[0]) == 2.0
    assert X.dtype == torch.float32 and X.shape[0] == kw["n"] and int(state.step) == 0
    rate, model, state = bench.timed_rate(model, state, X, y, iters=4, chunk=2)
    assert rate > 0 and np.isfinite(rate)
    assert int(state.step) == 8 and torch.isfinite(state.mu).all()


def test_flagship_data_follow_bench_py():
    """X standard normal, labels the sign of X w: half of each sign, a
    linear rule 64 inducing points fit only in part."""
    _, _, X, y = bench.flagship_workload("cpu", n=4096, m=16, b=256)
    assert set(torch.unique(y).tolist()) == {-1.0, 1.0}
    assert abs(float(y.mean())) < 0.1 and abs(float(X.std()) - 1.0) < 0.02


def test_sweep_candidates_agree_on_the_cpu():
    """The variants mode's candidates on the sweep's inputs at a cut size
    (plain versions on the CPU, float32): s1 and S2 of kernel 1, kernel 8
    (nt, packed), kernel 9 and the bar within 1e-4 of the float64 plain
    version's largest entry (float32 sums; Kmm has the sweep's 1e-3 jitter
    at lengthscale 1.3 in 8-D)."""
    t = bench.sweep_inputs(512, 8, 32, "cpu")
    ref = bench.direct_stats_reference(*bench.sweep_args({k: v.double() for k, v in t.items()}))[:2]
    for name, fn in bench.variant_calls(t).items():
        for o, r in zip(fn()[:2], ref):
            assert float((o.double() - r).abs().max() / r.abs().max()) < 1e-4, name


def test_variant_shapes_hold_the_reference_sweep():
    """The variants mode runs the flagship's statistics shape and the
    reference sweep's four (B, M) rows at D=8 (benchmarks/fused_variants.py:
    286), none of them out of range for kernels 8-9."""
    assert bench.VARIANT_SHAPES[0] == (bench.B, bench.D, bench.M)
    rows = [(8192, 512), (65536, 256), (65536, 512), (262144, 128)]
    assert [(b, m) for b, _, m in bench.VARIANT_SHAPES[1:]] == rows
    assert all(d == 8 for _, d, _ in bench.VARIANT_SHAPES[1:])
    assert not hasattr(bench, "OUT_OF_RANGE_SHAPES")


def test_kernel_1_leaves_the_candidates_past_m128():
    """At M=130 the candidates are kernels 8 and 9 and the bar (kernel 1
    holds K^-1 and Sigma in shared memory, M <= 128), and they agree with
    the float64 plain version on the CPU as at M=32."""
    t = bench.sweep_inputs(256, 8, 130, "cpu")
    calls = bench.variant_calls(t)
    assert set(calls) == {"direct_stats_nt", "direct_stats_packed", "two_factor_nt", "xla_stats_reference"}
    ref = bench.direct_stats_reference(*bench.sweep_args({k: v.double() for k, v in t.items()}))[:2]
    for name, fn in calls.items():
        for o, r in zip(fn()[:2], ref):
            assert float((o.double() - r).abs().max() / r.abs().max()) < 1e-4, name


def test_numpy_baseline_runs():
    assert bench.bench_numpy_baseline(iters=2) > 0


@pytest.mark.parametrize("call", [
    lambda: bench.primary(iters=2, chunk=1),
    lambda: bench.extra_row("multiclass_k10_m64_b2048"),
    lambda: bench.variants(reps=1),
    lambda: bench.gather(draws=1),
    lambda: bench.main([]),
])
def test_every_mode_needs_a_card(monkeypatch, call):
    """No mode falls back to the CPU: each raises without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        call()


def test_the_port_imports_no_jax():
    """The port, its bench and its benchmark kernels import neither JAX nor
    the JAX package (a fresh process: this one has both loaded)."""
    code = ("import sys, agp_tpu_torch, agp_tpu_torch.bench, agp_tpu_torch.benchmarks.fused_variants, "
            "agp_tpu_torch.benchmarks.gather_modes; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'agp_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
