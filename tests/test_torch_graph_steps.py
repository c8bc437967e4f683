"""The captured chunk of CAVI steps (``agp_tpu_torch/training/graphs.py``,
the counterpart of the JAX package's ``_vi_steps``) on the CPU, in
float64, where its k-step body runs eagerly through the same static carry:

(a) one call of ``vi_steps`` over n steps against one call of the JAX
    package's ``_vi_steps`` on its own minibatch indices, at rtol 1e-8, for
    a case of each route the chunk is captured on: kernel 1 (the flagship;
    Poisson with a Matern kernel and slice sampling), kernels 2-3 (the
    heteroscedastic pass), the split pair (a learnt Gaussian noise),
    numerical VI (Monte Carlo with SoftMax, fed the reference's normals),
    with k cut to 2 so that a chunk of 6 runs the eager warm-up step, two
    replays of k and one of a single step;
(b) no host read while the chunk of every captured route runs: a
    ``TorchDispatchMode`` raises on ``aten._local_scalar_dense``, the ops
    whose output shape depends on the data, and copies to the host;
(c) the bookkeeping at the real k: n = 1 + q k + r steps, each counted
    once, the kernel launch counters credited by replays (a stub graph
    that counts a capture as a real one does), the result bit-equal to the
    eager loop's, a capture reused by the next call;
(d) the routing: the eager-loop kinds never reach a capture, and a
    captured kind whose capture fails raises.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu.training.train import _precomputed_draws, _vi_steps
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training import graphs
from agp_tpu_torch.training import train as ttrain
from agp_tpu_torch.training.train import vi_steps
from agp_tpu_torch.utils import batch_sums
from test_torch_numerical import build as numerical_case
from test_torch_numerical import states_close
from torch_helpers import (
    close, het_data, jax_rm_scales, jax_single_latent, jax_svgp, lik_params_close, locals_close, logistic_data,
    port_from_jax, replay_rule, single_latent_data,
)

N, D, M, B = 512, 3, 16, 64
# steps of the parity chunk, with k cut to 2: the warm-up step, two replays
# of 2 and one of 1
STEPS, CUT_K = 6, 2


@pytest.fixture(autouse=True)
def fresh_captures():
    graphs.clear()
    yield
    graphs.clear()


# ---------------------------------------------- (a) parity with _vi_steps
def analytic_case(route):
    if route == "flagship":
        X, y = logistic_data(N, D)
        return jax_svgp(X, y, M, B)
    if route == "poisson_matern32_slice":
        X, _, y = single_latent_data("poisson", N, D)
        return jax_svgp(X, y, M, B, sampling="slice", likelihood=jax_single_latent("poisson"),
                        kernel=agp.Matern32Kernel)
    if route == "heteroscedastic":
        X, y = het_data(N, D)
        return jax_svgp(X, y, M, B, sampling="slice", likelihood=agp.HeteroscedasticLikelihood.create(1.7))
    X, y = het_data(N, D)  # "learnt_noise"
    return jax_svgp(X, y, M, B, sampling="slice", lengthscale=1.0,
                    likelihood=agp.GaussianLikelihood.create(0.1, opt_noise=True))


def reference_normals(mj, sj, Xj, n):
    """The normals [n, n_mc, L, B] of n Monte Carlo steps, as the
    reference's step draws them: key, sub = split(key), then normal(sub)."""
    key, out = sj.key, []
    shape = (mj.inference.n_mc, mj.n_latent, mj.inference.batchsize)
    for _ in range(n):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, shape, dtype=jnp.float64)))
    return torch.as_tensor(np.stack(out))


@pytest.mark.parametrize("route", ["flagship", "poisson_matern32_slice", "heteroscedastic", "learnt_noise",
                                   "monte_carlo"])
def test_chunk_matches_reference_vi_steps(route, monkeypatch):
    """``vi_steps`` over STEPS steps in one call against the reference's
    ``_vi_steps`` over the same steps in one call, on its indices (and,
    for Monte Carlo, its normals): eta, mu, Sigma, the local variables,
    the likelihood's parameters and the optimiser's state at rtol 1e-8
    (the analytic routes with the reference's float32 Robbins-Monro scales
    replayed: XLA's and PyTorch's pow differ by an ulp)."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    if route == "monte_carlo":
        (mj, sj, Xj, yj), (mt, st, Xt, yt) = numerical_case("softmax", "mc", True)
        eps = reference_normals(mj, sj, Xj, STEPS)
    else:
        mj, sj, Xj, yj = analytic_case(route)
        mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(STEPS)))
        eps = None
    draws = torch.as_tensor(np.array(_precomputed_draws(mj, sj, Xj, STEPS)[1]), dtype=torch.int64)
    mj, sj = _vi_steps(mj, sj, Xj, yj, STEPS)
    mt, st = vi_steps(mt, st, Xt, yt, STEPS, draws=draws, mc_draws=eps)
    latest = graphs.latest()
    assert latest is not None and sorted(latest.graphs) == [1, CUT_K]
    if route == "monte_carlo":
        states_close(st, sj, STEPS - 1)
        return
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name)
    locals_close(st.local_vars, sj.local_vars, rtol=1e-8)
    lik_params_close(mt.likelihood, mj.likelihood, rtol=1e-8)
    assert int(st.opt_state) == int(sj.opt_state) == STEPS
    assert int(st.step) == int(sj.step) == STEPS


# --------------------------------------------------- (b) no host read
aten = torch.ops.aten
# ops that read the device on the host, or whose output's shape does
HOST_READS = {aten._local_scalar_dense, aten.is_nonzero, aten.equal, aten.nonzero, aten.masked_select,
              aten._unique2, aten.unique_consecutive, aten.unique_dim}


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads a tensor on the host, or copies one
    there from a device (on the card: a sync, which no capture takes)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket in HOST_READS:
            raise AssertionError(f"host read in a captured chunk: {func}")
        if func.overloadpacket is aten._to_copy and args[0].device.type != "cpu" and \
                torch.device(kwargs.get("device") or args[0].device).type == "cpu":
            raise AssertionError(f"copy to the host in a captured chunk: {func}")
        if func.overloadpacket is aten.copy_ and args[0].device.type == "cpu" and args[1].device.type != "cpu":
            raise AssertionError(f"copy to the host in a captured chunk: {func}")
        return func(*args, **kwargs)


def tiny_case(route):
    """(model, X, y) of a captured route at a tiny size, float64 on the
    CPU; y as ``train`` takes it."""
    rng = np.random.default_rng(0)
    n, d = 300, 2
    X = torch.as_tensor(rng.normal(size=(n, d)))
    f = torch.sin(X[:, 0]) + 0.5 * X[:, 1]
    binary = torch.where(f > 0, 1.0, -1.0).to(X.dtype)
    counts = torch.as_tensor(rng.poisson(np.exp(0.5 * f.numpy())), dtype=torch.float64)
    classes = torch.as_tensor(np.argmax(rng.normal(size=(n, 3)) + f.numpy()[:, None] * [1, 0, -1], axis=1))
    real = f + 0.1 * torch.as_tensor(rng.normal(size=n))
    rbf = agt.SqExponentialKernel(lengthscale=1.0)
    m, b = (130, 32) if route.endswith("m130") else (8, 32)
    svi = agt.AnalyticSVI(b, minibatch_sampling="slice")
    table = {
        "flagship": (rbf, agt.LogisticLikelihood.create(), agt.AnalyticSVI(b, minibatch_sampling="block"), binary),
        "poisson_matern32": (agt.Matern32Kernel(), agt.PoissonLikelihood.create(), svi, counts),
        "studentt_matern12_gather": (agt.Matern12Kernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticSVI(b),
                                     real),
        "full_batch": (rbf, agt.LogisticLikelihood.create(), agt.AnalyticVI(), binary),
        "multiclass": (rbf, agt.LogisticSoftMaxLikelihood.create(3), svi, classes),
        "heteroscedastic": (rbf, agt.HeteroscedasticLikelihood.create(1.7), svi, real),
        "single_pair_m130": (rbf, agt.LogisticLikelihood.create(), svi, binary),
        "batched_pair_m130": (rbf, agt.LogisticSoftMaxLikelihood.create(3), svi, classes),
        "learnt_noise": (rbf, agt.GaussianLikelihood.create(0.1, opt_noise=True), svi, real),
        "plain_kappa_sum": (rbf + agt.LinearKernel(variance=0.1), agt.LogisticLikelihood.create(), svi, binary),
        "alrsvi": (rbf, agt.LogisticLikelihood.create(), agt.AnalyticSVI(b, optimiser=agt.alrsvi()), binary),
        "quadrature": (rbf, agt.LogisticLikelihood.create(),
                       agt.QuadratureSVI(b, n_points=10, optimiser=agt.sgd(1e-3, 0.9)), binary),
        "monte_carlo": (rbf, agt.SoftMaxLikelihood.create(3),
                        agt.MCIntegrationSVI(b, n_mc=8, optimiser=agt.sgd(1e-3, 0.9)), classes),
    }
    kernel, lik, inference, y = table[route]
    return agt.SVGP.create(kernel, lik, inference, X[:m], optimiser=None), X, y


CAPTURED_ROUTES = ["flagship", "poisson_matern32", "studentt_matern12_gather", "full_batch", "multiclass",
                   "heteroscedastic", "single_pair_m130", "batched_pair_m130", "learnt_noise", "plain_kappa_sum",
                   "alrsvi", "quadrature", "monte_carlo"]


@pytest.mark.parametrize("route", CAPTURED_ROUTES)
def test_captured_chunk_reads_no_host(route, monkeypatch):
    """``train``'s fast path on every captured route runs its chunk (the
    warm-up step, replays of k and of one step) under ``NoHostRead``; the
    posterior it leaves is finite."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    run = graphs.run
    calls = []

    def guarded(*args, **kw):
        calls.append(1)
        with NoHostRead():
            return run(*args, **kw)

    monkeypatch.setattr(graphs, "run", guarded)
    model, X, y = tiny_case(route)
    model, state = agt.train(model, X, y, iterations=STEPS, generator=torch.Generator().manual_seed(0))
    assert calls and int(state.step) == STEPS
    assert bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())


# ------------------------------------------------------ (c) bookkeeping
class StubGraph:
    """A graph for the CPU that counts as a CUDA graph does: its capture
    runs the body once (each wrapper counts its launch) and puts the carry
    and the generator back (a capture runs nothing); a replay runs the
    body with the counters held (a replay calls no Python), so that only
    ``CapturedLaunches``' credits count it."""

    captures = []
    replays = [0]

    def __init__(self, device, generator=None, stream=None):
        self.fn, self.generator = None, generator

    def capture(self, fn, carried):
        saved = [t.clone() for t in carried]
        rng = None if self.generator is None else self.generator.get_state()
        fn()
        for t, s in zip(carried, saved):
            t.copy_(s)
        if rng is not None:
            self.generator.set_state(rng)
        self.fn = fn
        StubGraph.captures.append(fn.args[0])

    def replay(self):
        with ck.CapturedLaunches():
            self.fn()
        StubGraph.replays[0] += 1


@pytest.fixture
def stub(monkeypatch):
    """The stub graph in the CUDA graph's place, and kernel 1's wrapper
    counting each call on the CPU as it counts a launch on the card."""
    StubGraph.captures, StubGraph.replays = [], [0]
    monkeypatch.setattr(graphs, "_graph_class", lambda device: StubGraph)

    def counting(*args, **kw):
        counting.launches += 1
        return ck.fused_cavi_stats_reference(*args, **kw)

    counting.launches = 0
    monkeypatch.setattr(ck, "fused_cavi_stats", counting)
    return counting


def flagship_chunk(n, seed=0):
    model, X, y = tiny_case("flagship")
    state = agt.init_state(model, X, y)
    gen = torch.Generator().manual_seed(seed)
    return model, state, X, y, ttrain._chunk_draws(model, X, n, None, gen)[1]


@pytest.mark.parametrize("n", [1, 2, graphs.STEPS_PER_GRAPH, graphs.STEPS_PER_GRAPH + 1,
                               2 * graphs.STEPS_PER_GRAPH + 3])
def test_chunk_takes_exactly_n_steps(n, stub, monkeypatch):
    """n = 1 + q k + r steps at the real k: the warm-up step, q replays of
    the k-step graph and r of the one-step graph; ``step`` advances by n,
    kernel 1's counter by n (the captures' counts taken back, each replay
    credited its k or 1), and the state is bit-equal to the eager loop's on
    the same indices."""
    k = graphs.STEPS_PER_GRAPH
    model, state, X, y, draws = flagship_chunk(n)
    _, out = vi_steps(model, state, X, y, n, draws=draws)
    q, r = divmod(n - 1, k)
    assert int(out.step) == n and stub.launches == n
    assert StubGraph.replays[0] == q + r
    assert sorted(StubGraph.captures) == sorted(([k] if q else []) + ([1] if r else []))
    latest = graphs.latest()
    assert {s: g.per_replay for s, g in latest.launches.items()} == {
        s: {("fused_cavi_stats", "launches"): s} for s in StubGraph.captures}
    monkeypatch.setattr(graphs, "takes", lambda model: False)
    _, eager = vi_steps(model, state, X, y, n, draws=draws)
    for name in ("eta1", "eta2", "mu", "Sigma", "step", "opt_state"):
        assert torch.equal(getattr(out, name), getattr(eager, name)), name
    for name in eager.local_vars:
        assert torch.equal(out.local_vars[name], eager.local_vars[name]), name


def test_capture_is_reused_across_calls(stub, monkeypatch):
    """A second call of the same structure takes the first call's capture:
    no new capture of k and no eager first step; so does a call from a
    fresh state on the same data, bit-equal to the eager loop.  A capture
    reads X and y in place (no copy); new data of the same shapes takes a
    capture of its own, which steps on that data."""
    k = graphs.STEPS_PER_GRAPH
    model, state0, X, y, draws = flagship_chunk(k + 1)
    model, state = vi_steps(model, state0, X, y, k + 1, draws=draws)
    first = graphs.latest()
    assert first.X is X and first.y is y
    model, state = vi_steps(model, state, X, y, k, draws=draws[:k])
    assert graphs.latest() is first and StubGraph.captures == [k] and StubGraph.replays[0] == 2
    assert int(state.step) == 2 * k + 1 and stub.launches == 2 * k + 1
    _, fresh = vi_steps(model, state0, X, y, k + 1, draws=draws)
    assert graphs.latest() is first and StubGraph.captures.count(k) == 1
    X2, y2 = X.flip(0).contiguous(), y.flip(0).contiguous()
    _, s3 = vi_steps(model, state, X2, y2, k + 1, draws=draws)
    assert graphs.latest() is not first and graphs.latest().X is X2 and StubGraph.captures.count(k) == 2
    monkeypatch.setattr(graphs, "takes", lambda model: False)
    _, eager = vi_steps(model, state0, X, y, k + 1, draws=draws)
    _, eager3 = vi_steps(model, state, X2, y2, k + 1, draws=draws)
    for name in ("eta1", "eta2", "mu", "Sigma", "step"):
        assert torch.equal(getattr(fresh, name), getattr(eager, name)), name
        assert torch.equal(getattr(s3, name), getattr(eager3, name)), name


def test_launch_credits_multiply_by_replays():
    """``CapturedLaunches`` takes back what a capture counted and adds it
    once per replay; a plain version in a kernel's place (no counter)
    counts nothing."""
    ck.cavi_stats.launches, ck.fused_kappa.launches_f64 = 5, 2
    with ck.CapturedLaunches() as launches:
        ck.cavi_stats.launches += 3
        ck.fused_kappa.launches_f64 += 1
    assert (ck.cavi_stats.launches, ck.fused_kappa.launches_f64) == (5, 2)
    assert launches.per_replay == {("cavi_stats", "launches"): 3, ("fused_kappa", "launches_f64"): 1}
    launches.replayed(4)
    assert (ck.cavi_stats.launches, ck.fused_kappa.launches_f64) == (17, 6)
    plain = ck.CapturedLaunches([(ck, "cavi_stats_reference", "launches")])
    with plain:
        pass
    plain.replayed(3)
    assert plain.per_replay == {} and not hasattr(ck.cavi_stats_reference, "launches")
    ck.cavi_stats.launches = ck.fused_kappa.launches_f64 = 0


# --------------------------------------------------------- (d) routing
def test_eager_loop_kinds_never_reach_a_capture(monkeypatch):
    """The dense VGP, the online and multi-output models (the flags
    ``takes`` reads) and any model inside a sharded step stay on the eager
    loop (``graphs.takes``); ``vi_steps`` on a VGP and
    ``train`` with a callback, ``verbose=2`` or hyperparameter steps never
    call ``graphs.run``; ``train``'s fast path on an SVGP does."""
    model, X, y = tiny_case("flagship")
    vgp = agt.VGP.create(X[:40], y[:40], agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.AnalyticVI(), optimiser=None)
    online = SimpleNamespace(is_sparse=True, is_online=True, is_multioutput=False)
    multioutput = SimpleNamespace(is_sparse=True, is_online=False, is_multioutput=True)
    assert graphs.takes(model) and not any(map(graphs.takes, (vgp, online, multioutput)))
    with batch_sums.sharded(object()):
        assert not graphs.takes(model)
    calls = []
    run = graphs.run
    monkeypatch.setattr(graphs, "run", lambda *a, **kw: calls.append(1) or run(*a, **kw))
    vi_steps(vgp, agt.init_state(vgp), vgp.train_x, vgp.train_y, 3)
    gen = torch.Generator().manual_seed(0)
    agt.train(model, X, y, iterations=4, generator=gen, callback=lambda m, s, i: None)
    agt.train(model, X, y, iterations=4, generator=gen, verbose=2)
    agt.train(model.replace(optimiser=agt.adam(0.01)), X, y, iterations=4, generator=gen)
    assert calls == []
    agt.train(model, X, y, iterations=4, generator=gen)
    assert calls == [1]


class FailingGraph(StubGraph):
    def capture(self, fn, carried):
        raise RuntimeError("operation not permitted when stream is capturing (simulated)")


def test_failed_capture_raises(monkeypatch):
    """A captured kind whose capture fails raises from ``vi_steps`` and
    ``train``; neither re-runs the chunk on the eager loop."""
    monkeypatch.setattr(graphs, "_graph_class", lambda device: FailingGraph)
    eager = []
    monkeypatch.setattr(ttrain, "_minibatches", lambda *a, **kw: eager.append(1) or iter(()))
    model, state, X, y, draws = flagship_chunk(5)
    with pytest.raises(RuntimeError, match="capturing 1 CAVI step"):
        vi_steps(model, state, X, y, 5, draws=draws)
    graphs.clear()
    with pytest.raises(RuntimeError, match="does not run on the eager loop"):
        agt.train(model, X, y, iterations=5, generator=torch.Generator().manual_seed(0))
    assert eager == []
