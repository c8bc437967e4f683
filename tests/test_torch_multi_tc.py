"""Kernels 2-3 (``fused_cavi_stats_multiclass``, ``fused_cavi_stats_het``)
on the tensor cores, checked on the CPU: their products as the kernels
split them (``torch_helpers.multi_tf32``: each latent's kappa = Knm K^-1
and kappa Sigma by ``moments_tf32``, S2 by ``stats_tf32``, each in three
TF32 passes, with the plain versions' E-steps) against the float64 plain
version at the reference's multi-latent oracles cut to M=128
(``chip_smoke.multi_oracle_inputs``), and a multiclass SVGP at a shape
that the fused pass newly takes (D=64, M=128) stepped against the JAX
package.

The emulation checks the split only: each pass is a float32 matmul, which
rounds to nearest; the tensor cores' truncating alignment, and the kernels
themselves, are checked on a card, against float64 with no floor below
float32's own error (tests/test_torch_cuda.py::
test_cuda_multi_tc_oracle_precision, chip_smoke.py phase 3)."""
import functools

import numpy as np
import pytest
import torch

import agp_tpu as agp
import chip_smoke as smoke
from agp_tpu_torch.ops import cuda_kernels as ck
from torch_helpers import jax_svgp, multi_tf32, multiclass_data, replay_steps

@functools.lru_cache(maxsize=None)
def errors(name, kind, passes):
    """{output: (emulated, float32 plain)} error against the float64 plain
    version over max(|float64|, 1), the largest over the entries."""
    which, _, call_fn, names = smoke.MULTI_KERNELS[name]
    t = smoke.multi_oracle_inputs(which, "cpu", kind)
    plain = getattr(ck, name + "_reference")
    ref32, ref64 = call_fn(plain, t), call_fn(plain, smoke.to_float64(t))
    out = call_fn(multi_tf32(which, passes), t)
    e = {}
    for i, n in enumerate(names):
        scale = max(float(ref64[i].abs().max()), 1.0)
        e[n] = tuple(float((o[i].double() - ref64[i]).abs().max()) / scale for o in (out, ref32))
    return e


@pytest.mark.parametrize("kind", ck.KINDS)
@pytest.mark.parametrize("name", list(smoke.MULTI_KERNELS))
def test_multi_on_the_tensor_cores_is_as_close_as_float32(name, kind):
    """Kernels 2-3's split (kappa, kappa Sigma and S2 in three TF32 passes)
    keeps every output (multiclass: s1, S2, c, theta, gamma, alpha; het:
    s1, S2, c, phi, gamma, theta, sigg) of each gram kind within
    FLOAT32_FACTOR (2.0) times the float32 plain version's own error
    against float64 at the oracle shapes (multiclass K=3, B=8192, D=2;
    heteroscedastic B=16,384, D=1; M=128, lengthscale 1, Z on the batch's
    rows), with no floor: emulated at 0.68-1.52 times float32's."""
    e = errors(name, kind, 3)
    assert all(a <= smoke.FLOAT32_FACTOR * p for a, p in e.values()), e


@pytest.mark.parametrize("name", list(smoke.MULTI_KERNELS))
def test_one_tf32_pass_is_not(name):
    """One TF32 pass for every product puts every output 100 times or more
    beyond float32's error at the oracle shape (emulated: 459-19,290
    times over the kinds)."""
    e = errors(name, "rbf", 1)
    assert all(a > 100.0 * p for a, p in e.values()), e


# ------------------------------ a multiclass SVGP at D=64, M=128 (fused)
N, D, K, M, B, STEPS = 1024, 64, 3, 128, 256, 3


@pytest.fixture(scope="module")
def wide_runs():
    """STEPS slice-sampled CAVI steps of a multiclass SVGP (K=3, D=64,
    M=128, lengthscale 8) in both packages from one state, on the JAX
    package's draws, counting the port's calls of the fused pass."""
    X, y = multiclass_data(N, D, K)
    calls = []
    wrapped = ck.fused_cavi_stats_multiclass

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return wrapped(*args, **kw)

    ck.fused_cavi_stats_multiclass = spy
    try:
        runs = replay_steps(*jax_svgp(X, y, M, B, sampling="slice", lengthscale=8.0,
                                      likelihood=agp.LogisticSoftMaxLikelihood.create(K)), STEPS)
    finally:
        ck.fused_cavi_stats_multiclass = wrapped
    return runs, calls


def test_wide_multiclass_takes_the_fused_pass(wide_runs):
    """At D=64, M=128 several latents now take the fused pass (before:
    D <= 45 at M=128): one call a step."""
    assert ck.fused_fits(K, D, M)
    assert wide_runs[1] == [torch.Size([B, D])] * STEPS


@pytest.mark.parametrize("step", range(STEPS))
def test_wide_multiclass_step_matches_reference(wide_runs, step):
    """eta, mu, Sigma and the local variables after each step, rtol 1e-8
    (atol 1e-12): float64 on both sides, the port through the plain fused
    pass, the reference through its XLA path."""
    _, sj, _, st = wide_runs[0]["per_step"][step]
    for name in ("eta1", "eta2", "mu", "Sigma"):
        np.testing.assert_allclose(getattr(st, name).numpy(), np.asarray(getattr(sj, name)), rtol=1e-8, atol=1e-12,
                                   err_msg=name)
    for name in sj.local_vars:
        np.testing.assert_allclose(st.local_vars[name].numpy(), np.asarray(sj.local_vars[name]), rtol=1e-8,
                                   atol=1e-12, err_msg=name)
    assert int(st.step) == int(sj.step) == step + 1
