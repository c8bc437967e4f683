"""``train``'s hyperparameter branch as captured iterations
(``agp_tpu_torch/training/graphs.py::run_hyper``, the counterpart of the
JAX package's ``_vi_step`` and ``_hyper_step`` programs) on the CPU, in
float64, where each graph's body runs eagerly through the same static
carry:

(a) ``agt.train`` with an optimiser against ``agp.train`` with the same
    optax optimiser on the reference's own draws, with k cut to 2, over
    ITERATIONS iterations (the warm-up step, the unmarked one-iteration
    graph, the eager hyperparameter warm-up, replays of the large pattern,
    the marked one-iteration graph and the unmarked last): the flagship
    with a ZeroMean, a ConstantMean with a Zoptimiser, the
    heteroscedastic model and quadrature VI, at ``atfrequency`` 1 and 2;
(b) no host read across the captured iterations of every route;
(c) the schedule at the real k: the iterations and Adam's counts exact,
    the patterns captured and replayed, the launch counters credited by
    replays, the result bit-equal to the eager loop's; Adam's count of a
    group with no leaf on the model's device;
(d) the routing: a callback and ``verbose=2`` never reach a capture, an
    optimiser takes ``run_hyper``, a failed capture raises.
"""
import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import agp_tpu as agp
import agp_tpu.training.train as jtrain
import agp_tpu_torch as agt
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training import graphs
from agp_tpu_torch.training import train as ttrain
from agp_tpu_torch.utils.opt import adam, init_on
from test_torch_graph_steps import FailingGraph, NoHostRead, StubGraph, tiny_case
from test_torch_numerical import build as numerical_case
from torch_helpers import close, het_data, jax_rm_scales, jax_svgp, logistic_data, port_from_jax, replay_rule

N, D, M, B = 512, 3, 16, 64
# iterations of the parity runs, with k cut to 2: at atfrequency 1 the
# warm-up step, iteration 2 on the unmarked graph, iteration 3's eager
# hyperparameter warm-up, 4-7 as two replays of (marked, marked), 8 on the
# marked graph and the unmarked last; at 2 the same with (unmarked, marked)
ITERATIONS, CUT_K = 9, 2


@pytest.fixture(autouse=True)
def fresh_captures():
    graphs.clear()
    yield
    graphs.clear()


# -------------------------------------------- (a) parity with agp.train
@functools.lru_cache(maxsize=None)
def parity_case(route):
    """(JAX model, state, X, y) with optax.adam(0.01), the port's copy, its
    Adam states carried over and the reference's Robbins-Monro scales
    replayed (quadrature: the same sgd on both sides), and the reference's
    minibatch indices of ITERATIONS steps (None for a full batch); made
    once for both ``atfrequency`` values."""
    if route == "quadrature":
        (mj, sj, Xj, yj), (mt, st, Xt, yt) = numerical_case("logistic", "quad", True, optimiser=0.01)
    else:
        kw, zopt = {}, None
        if route == "flagship":
            X, y = logistic_data(N, D)
            case = dict(sampling="block")
        elif route == "mean_and_z":
            X, y = logistic_data(N, D)
            kw, zopt = {"mean": agp.ConstantMean(c=jnp.asarray(0.2)), "Zoptimiser": optax.adam(0.05)}, adam(0.05)
            case = dict(sampling="slice")
        else:  # "heteroscedastic"
            X, y = het_data(N, D)
            case = dict(sampling="slice", likelihood=agp.HeteroscedasticLikelihood.create(1.7))
        mj, sj, Xj, yj = jax_svgp(X, y, M, B, optimiser=optax.adam(0.01), **case, **kw)
        mt, st, Xt, yt = port_from_jax(mj, sj, Xj, yj, optimiser=replay_rule(jax_rm_scales(ITERATIONS)))
        mt = mt.replace(optimiser=agt.adam(0.01), Zoptimiser=zopt)
    idx = jtrain._precomputed_draws(mj, sj, Xj, ITERATIONS)[1]
    draws = None if idx is None else torch.as_tensor(np.array(idx), dtype=torch.int64)
    return (mj, sj, Xj, yj), (mt, st, Xt, yt), draws


@pytest.mark.parametrize("atfrequency", [1, 2])
@pytest.mark.parametrize("route", ["flagship", "mean_and_z", "heteroscedastic", "quadrature"])
def test_captured_hyper_matches_reference_train(route, atfrequency, monkeypatch):
    """ITERATIONS iterations of ``agt.train`` (through ``run_hyper``, every
    pattern run) against ``agp.train`` from the same state on its draws:
    the kernel, the mean, Z, eta, mu, Sigma and the likelihood's state at
    rtol 1e-7 (atol 1e-10), every Adam count equal to optax's."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    (mj, sj, Xj, yj), (mt, st, Xt, yt), draws = parity_case(route)
    mj, mt = mj.replace(atfrequency=atfrequency), mt.replace(atfrequency=atfrequency)
    calls = []
    run_hyper = graphs.run_hyper
    monkeypatch.setattr(graphs, "run_hyper", lambda *a, **kw: calls.append(1) or run_hyper(*a, **kw))
    mj, sj = agp.train(mj, Xj, yj, iterations=ITERATIONS, state=sj)
    mt, st = agt.train(mt, Xt, yt, iterations=ITERATIONS, state=st, draws=draws)
    assert calls == [1] and {1, graphs.large_pattern(atfrequency)} <= set(graphs.latest().graphs)
    kw = dict(rtol=1e-7, atol=1e-10)
    close(mt.kernel.lengthscale, mj.kernel.lengthscale, msg="lengthscale", **kw)
    close(mt.kernel.variance, mj.kernel.variance, msg="variance", **kw)
    if hasattr(mj.mean, "c"):
        close(mt.mean.c, mj.mean.c, msg="mean", **kw)
    close(mt.Z, mj.Z, msg="Z", **kw)
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name, **kw)
    if route == "heteroscedastic":
        close(mt.likelihood.lam, mj.likelihood.lam, msg="lambda", **kw)
    hyper_steps = len(range(3 + (-3) % atfrequency, ITERATIONS, atfrequency))
    assert set(st.hyper_state) == set(sj.hyper_state)
    for group in sj.hyper_state:
        assert int(st.hyper_state[group]["count"]) == int(sj.hyper_state[group][0].count) == hyper_steps
    assert int(st.step) == ITERATIONS
    assert float(jnp.max(jnp.abs(mj.kernel.variance - 1.0))) > 1e-3  # the hyperparameters moved


# --------------------------------------------------- (b) no host read
HYPER_ROUTES = ["flagship", "full_batch", "multiclass", "heteroscedastic", "single_pair_m130", "learnt_noise",
                "plain_kappa_sum", "quadrature", "monte_carlo", "mean_and_z"]


def hyper_case(route, atfrequency=1):
    """(model, X, y) of ``tiny_case``'s route with Adam(0.01) every
    ``atfrequency`` iterations ("mean_and_z": the flagship with a
    ConstantMean and a Zoptimiser)."""
    model, X, y = tiny_case("flagship" if route == "mean_and_z" else route)
    if route == "mean_and_z":
        model = agt.SVGP.create(model.kernel, model.likelihood, model.inference, X[:8], mean=agt.ConstantMean(0.1),
                                optimiser=None, Zoptimiser=agt.adam(0.01))
    return model.replace(optimiser=agt.adam(0.01), atfrequency=atfrequency), X, y


@pytest.mark.parametrize("route", HYPER_ROUTES)
def test_captured_hyper_reads_no_host(route, monkeypatch):
    """``train`` with Adam on every captured route runs its iterations (the
    warm-ups, replays of the large pattern and of one iteration with and
    without a hyperparameter step) under ``NoHostRead``; the posterior
    and the kernel it leaves are finite."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    run_hyper = graphs.run_hyper
    calls = []

    def guarded(*args, **kw):
        calls.append(1)
        with NoHostRead():
            return run_hyper(*args, **kw)

    monkeypatch.setattr(graphs, "run_hyper", guarded)
    model, X, y = hyper_case(route)
    model, state = agt.train(model, X, y, iterations=ITERATIONS, generator=torch.Generator().manual_seed(0))
    assert calls and int(state.step) == ITERATIONS and set(graphs.latest().graphs) == {1, (True,), (True, True)}
    assert int(state.hyper_state["kernel"]["count"]) == ITERATIONS - 3
    assert bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())
    assert all(bool(torch.isfinite(t).all()) for t in model.kernel.leaves().values() if t.is_floating_point())


# ------------------------------------------------------ (c) bookkeeping
def counting(reference):
    """``reference`` counting each call in ``launches``, as a kernel's
    wrapper counts its launch on the card."""
    def wrapper(*args, **kw):
        wrapper.launches += 1
        return reference(*args, **kw)

    wrapper.launches = 0
    return wrapper


@pytest.fixture
def stub(monkeypatch):
    """The stub graph in the CUDA graph's place, and kernels 1 and 6
    counting each call on the CPU as they count a launch on the card."""
    StubGraph.captures, StubGraph.replays = [], [0]
    monkeypatch.setattr(graphs, "_graph_class", lambda device: StubGraph)
    for name in ("fused_cavi_stats", "fused_kappa"):
        monkeypatch.setattr(ck, name, counting(getattr(ck, name + "_reference")))


@pytest.mark.parametrize("atfrequency,n", [(1, 2 * graphs.STEPS_PER_GRAPH + 5), (1, 4), (3, 30), (12, 30)])
def test_schedule_and_launches_at_real_k(atfrequency, n, stub, monkeypatch):
    """n iterations at the real k: the marked ones are the reference's
    (a multiple of ``atfrequency``, from 3, never the last); every
    iteration runs once (kernel 1 n times, kernel 6's forward once a
    hyperparameter step), the replays and captures are the greedy
    schedule's, the Adam counts are the hyperparameter steps, and the
    result is bit-equal to the eager loop's on the same draws."""
    k = graphs.STEPS_PER_GRAPH
    model, X, y = hyper_case("flagship", atfrequency)
    gen = torch.Generator().manual_seed(0)
    draws = ttrain._chunk_draws(model, X, n, None, gen)[1]
    flags = [i % atfrequency == 0 and i >= 3 and i != n for i in range(1, n + 1)]
    m, s = agt.train(model, X, y, iterations=n, draws=draws)
    large = graphs.large_pattern(atfrequency)
    want, at, warm, eager = [], 1, flags[0], 1
    while at < n:
        window = graphs.marks(large)
        if tuple(flags[at:at + len(window)]) == window and (warm or not any(window)):
            want.append(large)
            at += len(window)
        elif flags[at] and not warm:
            warm, eager, at = True, eager + 1, at + 1
        else:
            want.append(graphs.pattern_of(flags[at:at + 1]))
            at += 1
    hyper_steps = sum(flags)
    chunks = graphs.latest()
    assert int(s.step) == n and int(s.hyper_state["kernel"]["count"]) == hyper_steps
    assert int(s.hyper_state["mean"]["count"]) == hyper_steps
    assert StubGraph.replays[0] == len(want) and sorted(map(str, StubGraph.captures)) == sorted(map(str, set(want)))
    assert ck.fused_cavi_stats.launches == n and ck.fused_kappa.launches == hyper_steps
    for pattern in set(want):
        per = {"fused_cavi_stats": len(graphs.marks(pattern)), "fused_kappa": sum(graphs.marks(pattern))}
        assert chunks.launches[pattern].per_replay == {(name, "launches"): v for name, v in per.items() if v}
    if atfrequency == 1 and n > k + 4:  # 2-3 unmarked, 4-23 two replays of k marked, 24 marked, 25 the last
        assert large == (True,) * k and want == [1, large, large, (True,), 1] and eager == 2
    monkeypatch.setattr(graphs, "takes", lambda model: False)
    me, se = agt.train(model, X, y, iterations=n, draws=draws)
    for name in ("eta1", "eta2", "mu", "Sigma", "step", "opt_state"):
        assert torch.equal(getattr(s, name), getattr(se, name)), name
    for name in ("lengthscale", "variance"):
        assert torch.equal(getattr(m.kernel, name), getattr(me.kernel, name)), name
    for group in ("kernel", "mean"):
        assert torch.equal(s.hyper_state[group]["count"], se.hyper_state[group]["count"])


def test_leafless_adam_count_on_the_models_device():
    """A group with no leaf (a ZeroMean) takes its Adam count to the
    device it is given; the default model's state keeps every Adam count
    on Z's device."""
    state = init_on(adam(0.01), {}, torch.device("meta"))
    assert state["count"].device.type == "meta" and state["count"].dtype == torch.int32
    model, X, y = hyper_case("flagship")
    hyper = agt.init_state(model, X, y).hyper_state
    assert all(hyper[g]["count"].device == model.Z.device for g in hyper)


# --------------------------------------------------------- (d) routing
def test_callback_and_verbose_never_reach_a_capture(monkeypatch, capsys):
    """With an optimiser, ``train`` with a callback or ``verbose=2`` runs
    the eager loop (no capture of either kind); without them it takes
    ``run_hyper`` and never ``run``."""
    calls = []
    for name in ("run", "run_hyper", "_run"):
        fn = getattr(graphs, name)
        monkeypatch.setattr(graphs, name, lambda *a, _fn=fn, _name=name, **kw: calls.append(_name) or _fn(*a, **kw))
    model, X, y = hyper_case("flagship")
    gen = torch.Generator().manual_seed(0)
    seen = []
    agt.train(model, X, y, iterations=5, generator=gen, callback=lambda m, s, i: seen.append(i))
    agt.train(model, X, y, iterations=5, generator=gen, verbose=2)
    assert calls == [] and seen == [1, 2, 3, 4, 5] and "iter 5" in capsys.readouterr().out
    agt.train(model, X, y, iterations=5, generator=gen)
    assert calls == ["run_hyper", "_run"]


def test_failed_hyper_capture_raises(monkeypatch):
    """A capture of iterations with hyperparameter steps that fails raises
    from ``train``; nothing re-runs on the eager loop."""
    monkeypatch.setattr(graphs, "_graph_class", lambda device: FailingGraph)
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    eager = []
    monkeypatch.setattr(ttrain, "_minibatches", lambda *a, **kw: eager.append(1) or iter(()))
    model, X, y = hyper_case("flagship")
    with pytest.raises(RuntimeError, match="capturing 1 CAVI step.*does not run on the eager loop"):
        agt.train(model, X, y, iterations=ITERATIONS, generator=torch.Generator().manual_seed(0))
    graphs.clear()

    class MarkedFails(StubGraph):
        def capture(self, fn, carried):
            if isinstance(fn.args[0], tuple):
                raise RuntimeError("operation not permitted when stream is capturing (simulated)")
            super().capture(fn, carried)

    monkeypatch.setattr(graphs, "_graph_class", lambda device: MarkedFails)
    with pytest.raises(RuntimeError, match=r"capturing 2 iteration\(s\) with 2 hyperparameter step\(s\)"):
        agt.train(model, X, y, iterations=ITERATIONS, generator=torch.Generator().manual_seed(0))
    assert eager == []
