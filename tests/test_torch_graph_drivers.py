"""The multi-output and streaming drivers' iterations as captured graphs
(``agp_tpu_torch/training/graphs.py``: ``run`` and ``run_hyper`` under
``mo_train``, ``run_batch`` under ``online_train`` and
``online_train_stream``) on the CPU, in float64, where each graph's body
runs eagerly through the same static carry:

(a) ``agt.mo_train`` with k cut to 2 against ``agp.mo_train``: its fast
    path (``_mo_steps``) on the reference's own indices (fold_in(state.key,
    step)) at rtol 1e-8 for Q=2 Gaussian + logistic stochastic with Adam on
    A, Q=1 full batch and a MOVGP (within 1e-8 of its largest entry, as
    ``torch_helpers.mo_close`` says why); with Adam(0.01) on the kernel at
    ``atfrequency`` 1 and 3 against its hyperparameter loop (``_mo_step``,
    ``_mo_hyper_step``) at rtol 1e-7 (atol 1e-10);
(b) ``agt.online_train`` and ``agt.online_train_stream`` with k cut to 2
    against the JAX package's (3 batches x 6 iterations) with OIPS and
    UniGridOnline at rtol 1e-8 (atol 1e-12), and with the default Adam
    against its per-batch driver at rtol 1e-7 (atol 1e-10);
(c) the mechanism at the real k: bit-equal to the drivers' eager loops
    (``graphs.drives`` false), the eager iterations, replays, graphs and
    static carries counted by ``graphs.tally`` (one carry for a whole
    stream, ceil(n / k) replays a later batch), kernels 4 + 5 credited by
    replays, A and a learnt task noise carried (held, either differs from
    the eager loop), a tuple y in the key, a failed capture raising, and no
    host read inside the drivers' captured iterations.
"""
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu_torch.models import multioutput as tmo
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training import graphs
from test_torch_graph_hyper import counting
from test_torch_graph_steps import FailingGraph, NoHostRead, StubGraph
from test_torch_multioutput import N, as_torch, case_models, gl_liks, start
from test_torch_online import batch, check_states, models
from torch_helpers import (
    adam_state_arrays, close, jax_mo, jax_mo_draws, mo_close, one_torch_thread, port_mo, reg_data, toy,
)

# iterations of the parity runs with k cut to 2: the warm-up step, two
# replays of 2 and one of 1 (CAVI steps alone); at atfrequency 1 the
# warm-up step, iteration 2 on the unmarked graph, 3's eager
# hyperparameter warm-up, 4-7 two replays of (marked, marked), 8 on the
# marked graph and the unmarked last
STEPS, ITERATIONS, CUT_K = 6, 9, 2
# the streaming parity runs: batches of ON_B rows, ON_ITERS iterations each,
# with each inducing algorithm of test_torch_online's ALGS
ON_B, ON_BATCHES, ON_ITERS = 10, 3, 6
ONLINE_ALGS = ("oips", "unigrid", "webscale", "streamkmeans")
F64 = dict(dtype=torch.float64, device="cpu")
# tiny tensors: one intra-op thread runs them as fast, and keeps the suite's
# parallel workers from oversubscribing the CPU
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def fresh_captures():
    graphs.clear()
    yield
    graphs.clear()


def mo_data():
    """test_torch_multioutput's data: X uniform on [-2, 2]^2, a Gaussian
    task on f + 0.1 eps and a logistic one on sign(f - 0.2)."""
    X, f = toy(N)
    return X, f, (f + 0.1 * np.random.default_rng(1).normal(size=N), np.sign(f - 0.2))


# ------------------------------------------- (a) parity with agp.mo_train
@pytest.mark.parametrize("name", ["q2_stochastic_adamA", "q1", "movgp"])
def test_captured_mo_train_matches_reference(name, monkeypatch):
    """STEPS iterations of ``agt.mo_train`` (through ``graphs.run``: the
    warm-up step, replays of k and of one step) against the reference's
    fast path over the same steps on its indices: eta, mu, Sigma, A, each
    task's local variables and parameters and A's Adam state at rtol 1e-8
    (the stochastic case with the reference's Robbins-Monro scales
    replayed)."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    mj, sj, Xj, ysj, mt, st = case_models(name, mo_data())
    draws = None
    if mj.inference.stochastic:
        draws = torch.as_tensor(jax_mo_draws(mj, sj, N, STEPS), dtype=torch.int64)
    mj, sj = agp.mo_train(mj, Xj, ysj, iterations=STEPS, state=sj)
    mt, st = agt.mo_train(mt, *as_torch(Xj, ysj), iterations=STEPS, state=st, draws=draws)
    assert sorted(graphs.latest().graphs) == [1, CUT_K]
    mo_close(mt, st, mj, sj, 1e-8, msg=f"{name}: ", normwise=name == "movgp")
    assert int(st.step) == int(sj.step) == STEPS


@pytest.fixture(scope="module")
def mo_hyper_case():
    """A Q=2 full-batch model with optax's Adam(0.01) on the kernel and on
    A in the JAX package, its port with the port's Adam(0.01) on both, the
    Adam states carried over."""
    X, _, ys = mo_data()
    mj = jax_mo(X, gl_liks(), 12, 2, optimiser=optax.adam(0.01), Aoptimiser=optax.adam(0.01))
    mj, sj, Xj, ysj = start(mj, X, ys)
    mt, st = port_mo(mj, sj, optimiser=agt.adam(0.01), Aoptimiser=agt.adam(0.01))
    return mj, sj, Xj, ysj, mt, st


@pytest.mark.parametrize("atfrequency", [1, 3])
def test_captured_mo_hyper_matches_reference(atfrequency, mo_hyper_case, monkeypatch):
    """ITERATIONS iterations of ``agt.mo_train`` with hyperparameter steps
    (through ``graphs.run_hyper``) against the reference's loop of
    ``_mo_step`` and ``_mo_hyper_step`` from the same state: the kernel,
    eta, mu, Sigma and A at rtol 1e-7 (atol 1e-10), the kernel's Adam
    count equal to optax's; the hyperparameters moved."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    mj, sj, Xj, ysj, mt, st = mo_hyper_case
    mj, mt = mj.replace(atfrequency=atfrequency), mt.replace(atfrequency=atfrequency)
    calls = []
    run_hyper = graphs.run_hyper
    monkeypatch.setattr(graphs, "run_hyper", lambda *a, **kw: calls.append(1) or run_hyper(*a, **kw))
    mj, sj = agp.mo_train(mj, Xj, ysj, iterations=ITERATIONS, state=sj)
    mt, st = agt.mo_train(mt, *as_torch(Xj, ysj), iterations=ITERATIONS, state=st)
    assert calls == [1] and {1, graphs.large_pattern(atfrequency)} <= set(graphs.latest().graphs)
    kw = dict(rtol=1e-7, atol=1e-10)
    close(mt.kernel.lengthscale, mj.kernel.lengthscale, msg="lengthscale", **kw)
    close(mt.kernel.variance, mj.kernel.variance, msg="variance", **kw)
    close(mt.A, mj.A, msg="A", **kw)
    for name in ("eta1", "eta2", "mu", "Sigma"):
        close(getattr(st, name), getattr(sj, name), msg=name, **kw)
    hyper_steps = len(range(3 + (-3) % atfrequency, ITERATIONS, atfrequency))
    ref = adam_state_arrays(sj.hyper_state)["kernel"]
    assert int(st.hyper_state["kernel"]["count"]) == int(ref["count"]) == hyper_steps
    assert int(st.step) == ITERATIONS
    assert float(jnp.max(jnp.abs(mj.kernel.lengthscale - 1.0))) > 1e-3


# --------------------------------------- (b) parity with agp.online_train
@pytest.fixture(scope="module")
def online_reference():
    """The JAX package's streams, by algorithm: the (model, state) after
    each batch of ``online_train`` and after ``online_train_stream`` over
    the same batches; and the default Adam's per-batch run."""
    X, _, y = reg_data()
    out = {}
    for alg in ONLINE_ALGS:
        mj, _ = models(alg)
        sj, per_batch = None, []
        for i in range(ON_BATCHES):
            mj, sj = agp.online_train(mj, *map(jnp.asarray, batch(X, y, i)), state=sj, iterations=ON_ITERS)
            per_batch.append((mj, sj))
        n = ON_BATCHES * ON_B
        stream = agp.online_train_stream(models(alg)[0], jnp.asarray(X[:n].reshape(ON_BATCHES, ON_B, 2)),
                                         jnp.asarray(y[:n].reshape(ON_BATCHES, ON_B)), iterations=ON_ITERS)
        out[alg] = per_batch, stream
    mj, _ = models(default_adam=True)
    sj, per_batch = None, []
    for i in range(ON_BATCHES):
        mj, sj = agp.online_train(mj, *map(jnp.asarray, batch(X, y, i)), state=sj, iterations=ON_ITERS)
        per_batch.append((mj, sj))
    out["adam"] = per_batch
    return X, y, out


@pytest.mark.parametrize("alg", ONLINE_ALGS)
def test_captured_online_matches_reference(alg, online_reference, monkeypatch):
    """``online_train`` batch by batch and ``online_train_stream`` over the
    same 3 batches (the first batch's iterations through
    ``graphs.run_batch``: the warm-up step and replays of k; each later
    batch's prologue, with its inducing update by each algorithm, and its
    iterations replays of the capture's graphs, through ``run_batch`` or
    ``run_stream``) against the JAX package's drivers: eta1, eta2, mu and
    Sigma at rtol 1e-8 (atol 1e-12) after every batch and after the
    stream, the active slots identical (their points too, or within rtol
    1e-12 for the k-means families' moved centres), one static carry."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    X, y, ref = online_reference
    per_batch, (mjs, sjs) = ref[alg]
    exact = alg in ("oips", "unigrid")  # a k-means family's moved centres: rtol 1e-12 (check_states)
    mt, st = models(alg)[1], None
    for i, (mj, sj) in enumerate(per_batch):
        before = dict(graphs.tally)
        mt, st = agt.online_train(mt, *map(torch.as_tensor, batch(X, y, i)), state=st, iterations=ON_ITERS)
        check_states(mt, st, mj, sj, rtol=1e-8, exact_Z=exact, msg=f"{alg} batch {i}")
        if i:
            assert graphs.tally["eager"] == before["eager"] and graphs.tally["carries"] == before["carries"]
    n = ON_BATCHES * ON_B
    before = dict(graphs.tally)
    ms, ss = agt.online_train_stream(models(alg)[1], X[:n].reshape(ON_BATCHES, ON_B, 2),
                                     y[:n].reshape(ON_BATCHES, ON_B), iterations=ON_ITERS)
    check_states(ms, ss, mjs, sjs, rtol=1e-8, exact_Z=exact, msg=f"{alg} stream")
    assert graphs.tally["carries"] == before["carries"] and graphs.tally["eager"] - before["eager"] <= 1


def test_captured_online_adam_matches_reference(online_reference, monkeypatch):
    """The default Adam(0.01) (hyperparameter steps after iterations 3-5 of
    each batch, through ``run_batch``'s marked graphs) against the JAX
    package's per-batch driver: the kernel, the posterior, the masked kmat
    and Adam's count after every batch at rtol 1e-7 (atol 1e-10)."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    X, y, ref = online_reference
    mt, st = models(default_adam=True)[1], None
    kw = dict(rtol=1e-7, atol=1e-10)
    for i, (mj, sj) in enumerate(ref["adam"]):
        mt, st = agt.online_train(mt, *map(torch.as_tensor, batch(X, y, i)), state=st, iterations=ON_ITERS)
        for name in ("eta1", "eta2", "mu", "Sigma"):
            close(getattr(st, name), getattr(sj, name), msg=f"batch {i} {name}", **kw)
        close(mt.kernel.lengthscale, mj.kernel.lengthscale, msg=f"batch {i} lengthscale", **kw)
        close(mt.kernel.variance, mj.kernel.variance, msg=f"batch {i} variance", **kw)
        for k in ("L_K", "K_inv"):
            close(st.kmat[k], sj.kmat[k], msg=f"batch {i} {k}", **kw)
        assert int(st.hyper_state["kernel"]["count"]) == int(adam_state_arrays(sj.hyper_state)["kernel"]["count"])
    assert any(isinstance(p, tuple) and any(p) for p in graphs.latest().graphs)


# ------------------------------------------------------ (c) the mechanism
def mo_port_case(route, b=20):
    """(model, X, ys) of a multi-output route at a tiny size, float64 on
    the CPU: Q=2 Gaussian + logistic stochastic with Adam on A ("q2"),
    Q=1 full batch ("q1"), a MOVGP, the Q=2 model with Adam(0.01) on the
    kernel ("hyper"), and a learnt Gaussian noise in the first task
    ("learnt_noise")."""
    X, f, ys = mo_data()
    X, ys = torch.as_tensor(X), tuple(torch.as_tensor(y) for y in ys)
    noise = agt.GaussianLikelihood.create(0.1, opt_noise=route == "learnt_noise")
    liks = [noise, agt.LogisticLikelihood.create()]
    svi = agt.AnalyticSVI(b)
    kw = dict(optimiser=None)
    if route == "q1":
        return agt.MOSVGP.create(agt.SqExponentialKernel(), liks, agt.AnalyticVI(), X[:12], n_latent=1, **kw), X, ys
    if route == "movgp":
        return agt.MOVGP.create(X[:30], liks, agt.SqExponentialKernel(), agt.AnalyticVI(), n_latent=2, **kw), \
            X[:30], tuple(y[:30] for y in ys)
    if route == "hyper":
        kw = dict(optimiser=agt.adam(0.01))
    return agt.MOSVGP.create(agt.SqExponentialKernel(), liks, svi, X[:12], n_latent=2, **kw), X, ys


def all_equal(a, b, what):
    """Every leaf of two (model, state) pairs bit-equal."""
    la, lb = graphs._leaves(*a), graphs._leaves(*b)
    assert [p for p, _ in la] == [p for p, _ in lb], what
    differ = [p for (p, x), (_, y) in zip(la, lb) if not torch.equal(x, y)]
    assert not differ, f"{what}: {differ}"


def eager(monkeypatch, fn):
    """``fn()`` with the drivers on their eager loops."""
    with monkeypatch.context() as m:
        m.setattr(graphs, "drives", lambda model: False)
        return fn()


@pytest.mark.parametrize("route", ["q2", "q1", "movgp", "hyper", "learnt_noise"])
def test_mo_train_bit_equal_to_eager_at_real_k(route, monkeypatch):
    """2 k + 5 iterations of ``mo_train`` (the warm-up step, replays of the
    large pattern, of one iteration and, with Adam on the kernel, the eager
    hyperparameter warm-up and the marked graphs) bit-equal in every leaf
    to the eager loop on the same generator's draws, with the eager
    iterations the schedule says (the first; with Adam on the kernel,
    also the hyperparameter warm-up) and one static carry; A (Adam on A)
    moved."""
    n = 2 * graphs.STEPS_PER_GRAPH + 5
    model, X, ys = mo_port_case(route)
    before = dict(graphs.tally)
    got = agt.mo_train(model, X, ys, iterations=n, generator=torch.Generator().manual_seed(0))
    want = eager(monkeypatch, lambda: agt.mo_train(model, X, ys, iterations=n,
                                                   generator=torch.Generator().manual_seed(0)))
    all_equal(got, want, route)
    assert graphs.tally["eager"] - before["eager"] == (2 if route == "hyper" else 1)
    assert graphs.tally["carries"] - before["carries"] == 1
    if route == "learnt_noise":
        assert not torch.equal(got[0].likelihoods[0].sigma2, model.likelihoods[0].sigma2)
    if route != "q1":  # one latent: A's rows are +-1 and stay so
        assert not torch.equal(got[0].A, model.A)


@pytest.fixture
def stub(monkeypatch):
    """The stub graph in the CUDA graph's place, and kernels 4 and 5
    counting each call on the CPU as they count a launch on the card."""
    StubGraph.captures, StubGraph.replays = [], [0]
    monkeypatch.setattr(graphs, "_graph_class", lambda device: StubGraph)
    for name in ("fused_kappa_moments_batched", "cavi_stats_batched"):
        monkeypatch.setattr(ck, name, counting(getattr(ck, name + "_reference")))


@pytest.mark.parametrize("hyper", [False, True])
def test_mo_launch_credits_at_real_k(hyper, stub):
    """2 k + 5 iterations of the Q=2 model: kernel 5 launched once a step
    and kernel 4 once more a hyperparameter step, the captures' counts
    taken back and each replay credited its pattern's; the replays those
    of the greedy schedule."""
    k, n = graphs.STEPS_PER_GRAPH, 2 * graphs.STEPS_PER_GRAPH + 5
    model, X, ys = mo_port_case("hyper" if hyper else "q2")
    marks = [i >= 3 and i != n for i in range(1, n + 1)] if hyper else [False] * n
    agt.mo_train(model, X, ys, iterations=n, generator=torch.Generator().manual_seed(0))
    h = sum(marks)
    assert ck.cavi_stats_batched.launches == n and ck.fused_kappa_moments_batched.launches == n + h
    chunks = graphs.latest()
    for pattern, launches in chunks.launches.items():
        m = graphs.marks(pattern)
        assert launches.per_replay == {("fused_kappa_moments_batched", "launches"): len(m) + sum(m),
                                       ("cavi_stats_batched", "launches"): len(m)}
    if hyper:  # 1 eager, 2 unmarked, 3 eager, 4-23 two replays of k marked, 24 marked, 25 unmarked
        assert StubGraph.replays[0] == 5 and set(chunks.graphs) == {1, (True,), (True,) * k}
    else:  # 1 eager, 2-21 two replays of k, 22-25 four of one
        assert StubGraph.replays[0] == 6 and set(chunks.graphs) == {1, k}


ONLINE_ZALGS = {"oips": None, "streamkmeans": lambda: agt.inducing.StreamKmeans(16, 0.25),
                "webscale": lambda: agt.inducing.Webscale(8), "unigrid": lambda: agt.inducing.UniGridOnline(3)}


def online_port(opt=None, lik="gaussian", alg=None):
    likelihood = agt.GaussianLikelihood.create(0.05) if lik == "gaussian" else agt.LogisticLikelihood.create()
    return agt.OnlineSVGP.create(agt.SqExponentialKernel(), likelihood, agt.AnalyticVI(), Zalg=alg, n_dim=2,
                                 capacity=16, optimiser=opt, **F64)


def stream_data(b=24, batches=4, lik="gaussian"):
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.uniform(-2, 2, size=(batches * b, 2)))
    y = torch.sin(2 * X[:, 0]) + 0.5 * X[:, 1] + 0.05 * torch.as_tensor(rng.normal(size=batches * b))
    return X.reshape(batches, b, 2), (y if lik == "gaussian" else torch.sign(y)).reshape(batches, b)


@pytest.mark.parametrize("opt,lik,zalg", [(None, "gaussian", "oips"), (None, "logistic", "oips"),
                                          ("default", "gaussian", "oips"), (None, "gaussian", "streamkmeans"),
                                          (None, "gaussian", "webscale"), (None, "gaussian", "unigrid")])
def test_online_bit_equal_and_one_capture_at_real_k(opt, lik, zalg, monkeypatch):
    """4 batches of 20 iterations at the real k, batch by batch and (no
    optimiser) as a stream: bit-equal in every leaf to the eager loop;
    one static carry for the whole run; after the first batch, no eager
    iteration and ceil(20 / k) + 1 replays a batch (the prologue's graph,
    then the windows; with Adam the batch's end inside the last window),
    no new graph after the second, the prologue warmed once on copies of
    the carry before its capture (in the second batch); the stream
    replays the per-batch calls' capture."""
    k, iters = graphs.STEPS_PER_GRAPH, 20
    Xs, ys = stream_data(lik=lik)

    make = ONLINE_ZALGS[zalg]

    def port():
        return online_port(opt, lik, None if make is None else make())

    def per_batch(record=None):
        m, s = port(), None
        for i in range(Xs.shape[0]):
            before = dict(graphs.tally)
            m, s = agt.online_train(m, Xs[i], ys[i], state=s, iterations=iters)
            if record is not None:
                record.append({key: graphs.tally[key] - before[key] for key in before})
        return m, s

    counts = []
    got = per_batch(counts)
    want = eager(monkeypatch, per_batch)
    all_equal(got, want, f"{opt} {lik} per batch")
    assert counts[0]["carries"] == 1 and sum(c["carries"] for c in counts) == 1
    for c in counts[1:]:
        assert c["eager"] == 0 and c["replays"] == -(-iters // k) + 1, counts
    assert all(c["graphs"] == 0 for c in counts[2:]), counts
    assert [c["warm"] for c in counts] == [0, 1] + [0] * (len(counts) - 2), counts
    if opt is None:
        before = dict(graphs.tally)
        stream = agt.online_train_stream(port(), Xs, ys, iterations=iters)
        all_equal(stream, want, f"{lik} stream")
        assert graphs.tally["carries"] == before["carries"] and graphs.tally["graphs"] == before["graphs"]
        assert graphs.tally["eager"] - before["eager"] == 1  # the first batch's first iteration
        assert graphs.tally["warm"] == before["warm"]


@pytest.mark.parametrize("held", [(), ("A",), ("likelihoods",)])
def test_mo_carry_holds_A_and_task_noise(held, monkeypatch):
    """A (Adam on A) and a task's learnt Gaussian noise are carried: with
    both in the carry the captured run is bit-equal to the eager loop;
    with either held, as the carry's rule held them before, the replays
    read it stale and the run differs from the eager loop in it (and, as
    both feed every step, in the other)."""
    n = graphs.STEPS_PER_GRAPH + 3
    model, X, ys = mo_port_case("learnt_noise")
    step_fields = graphs._step_fields
    monkeypatch.setattr(graphs, "_step_fields",
                        lambda m: tuple(f for f in step_fields(m) if f not in held))
    got = agt.mo_train(model, X, ys, iterations=n, generator=torch.Generator().manual_seed(0))
    want = eager(monkeypatch, lambda: agt.mo_train(model, X, ys, iterations=n,
                                                   generator=torch.Generator().manual_seed(0)))
    same_A = torch.equal(got[0].A, want[0].A)
    same_noise = torch.equal(got[0].likelihoods[0].sigma2, want[0].likelihoods[0].sigma2)
    if not held:
        all_equal(got, want, "both carried")
    else:
        assert not same_A and not same_noise


def test_tuple_labels_in_the_key(monkeypatch):
    """A multi-output model's labels are keyed tensor by tensor: the same
    tuple replays its capture, a tuple with one task's labels at another
    address takes a capture of its own, which steps on those labels
    (bit-equal to the eager loop on them)."""
    model, X, ys = mo_port_case("q2")
    state = tmo.mo_init_state(model, X, ys)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    n = graphs.STEPS_PER_GRAPH + 1
    m1, s1 = tmo.mo_steps(model, state, X, ys, n, generator=gen())
    first = graphs.latest()
    before = dict(graphs.tally)
    tmo.mo_steps(m1, s1, X, ys, n, generator=gen())
    assert graphs.latest() is first and graphs.tally["eager"] == before["eager"]
    assert graphs.tally["carries"] == before["carries"]
    ys2 = (ys[0].flip(0).contiguous(), ys[1])
    key = lambda y: graphs._key(model, state, X, y, "gather", torch.zeros((1, 20), dtype=torch.int64), None,  # noqa
                                None, tmo._mo_batch, tmo._mo_update, None, graphs.large_pattern(None), False)
    assert key(ys) != key(ys2) and key(ys) == key(tuple(ys))
    got = tmo.mo_steps(model, state, X, ys2, n, generator=gen())
    assert graphs.latest() is not first and graphs.latest().y[0] is ys2[0]
    want = eager(monkeypatch, lambda: tmo.mo_steps(model, state, X, ys2, n, generator=gen()))
    all_equal(got, want, "new labels")


def test_failed_driver_capture_raises(monkeypatch):
    """A capture that fails raises from ``mo_train`` and ``online_train``:
    after the first iteration, which runs eagerly before any capture,
    nothing runs on the eager loop."""
    monkeypatch.setattr(graphs, "_graph_class", lambda device: FailingGraph)
    model, X, ys = mo_port_case("q2")
    before = graphs.tally["eager"]
    with pytest.raises(RuntimeError, match="capturing .* of a MOSVGP failed.*does not run on the eager loop"):
        agt.mo_train(model, X, ys, iterations=5, generator=torch.Generator().manual_seed(0))
    assert graphs.tally["eager"] == before + 1
    Xs, ys = stream_data()
    with pytest.raises(RuntimeError, match="capturing .* of a OnlineSVGP failed"):
        agt.online_train(online_port(), Xs[0], ys[0], iterations=5)
    assert graphs.tally["eager"] == before + 2


DRIVER_ROUTES = ["mo q2", "mo q1", "mo movgp", "mo hyper", "mo learnt_noise", "online gaussian", "online logistic",
                 "online adam", "online unigrid", "online webscale", "online streamkmeans", "online stream"]


def kernel_stand_in(fn):
    """A walk's wrapper run outside the dispatch mode: on the CPU it is
    its plain version, a Python loop over the points; on the card one
    kernel launch, which reads nothing back."""
    def call(*args, **kw):
        with _disable_current_modes():
            return fn(*args, **kw)
    return call


@pytest.mark.parametrize("route", DRIVER_ROUTES)
def test_driver_iterations_read_no_host(route, monkeypatch):
    """Every captured route of the drivers runs its iterations (the
    warm-ups, replays of every pattern) and, from the second streaming
    batch on, the batch's prologue (save-old, the inducing update of each
    algorithm, the masked kmat, fresh local variables) and, with Adam, its
    end under ``NoHostRead``, the accept walks standing in for their
    kernels; what it leaves is finite."""
    monkeypatch.setattr(graphs, "STEPS_PER_GRAPH", CUT_K)
    for name in ("oips_accept", "streamkmeans_pass"):
        monkeypatch.setattr(ck, name, kernel_stand_in(getattr(ck, name)))
    calls = []
    for name in ("run", "run_hyper", "run_batch", "run_stream"):
        fn = getattr(graphs, name)

        def guarded(*args, _fn=fn, **kw):
            calls.append(1)
            with NoHostRead():
                return _fn(*args, **kw)

        monkeypatch.setattr(graphs, name, guarded)
    kind, which = route.split()
    if kind == "mo":
        model, X, ys = mo_port_case(which)
        if which == "hyper":
            model = model.replace(atfrequency=1)
        m, s = agt.mo_train(model, X, ys, iterations=ITERATIONS, generator=torch.Generator().manual_seed(0))
    else:
        opt = "default" if which == "adam" else None
        lik = "logistic" if which == "logistic" else "gaussian"
        alg = {"unigrid": agt.inducing.UniGridOnline(3), "webscale": agt.inducing.Webscale(8),
               "streamkmeans": agt.inducing.StreamKmeans(12, 0.25)}.get(which)
        Xs, ys = stream_data(lik=lik, batches=3)
        m, s = online_port(opt, lik, alg), None
        if which == "stream":
            m, s = agt.online_train_stream(m, Xs, ys, iterations=ITERATIONS)
        else:
            for i in range(3):
                m, s = agt.online_train(m, Xs[i], ys[i], state=s, iterations=ITERATIONS)
    assert calls and int(s.step) >= ITERATIONS
    assert all(bool(torch.isfinite(t).all()) for _, t in graphs._leaves(m, s) if t.is_floating_point())
