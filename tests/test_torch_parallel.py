"""Slice K: data-parallel CAVI over torch.distributed, against the JAX
package's mesh (float64, CPU).

Two process groups are spawned over gloo, of 2 and of 4 processes, each
running every case below (``python tests/test_torch_parallel.py worker
...``: the children import agp_tpu_torch only); the parent computes the
reference's results with JAX on ``make_mesh(2)`` / ``make_mesh(4)``
meanwhile:
- ``sharded_train`` for logistic, Gaussian with noise learning and Poisson
  at N=61 (the tail padded, the row mask threaded through): mu, Sigma,
  sigma2, lambda at rtol 1e-8;
- ``mo_sharded_train`` with A's Adam steps at N=61: mu, Sigma, A;
- 10 fused SVI steps (kernel 1's plain version on each process's shard)
  fed the reference's ``gen_idx`` rows, against its ``sharded_svi_step``;
- Poisson's fused SVI steps against the reference's single-device
  ``variational_update`` on the concatenated batch (the port updates
  lambda, as one device does).
The rest needs no group: the draws never reach pad rows, a dense model and
``fused=True`` without kernel 1 are refused, a world of one process is
``train``.
"""
import json
import os
import subprocess
import sys
from functools import lru_cache, partial

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, NM, NS, D, M, BPD, SVI_STEPS, SVI_POISSON_STEPS, ITERS, MO_ITERS = 61, 61, 125, 3, 8, 16, 10, 5, 10, 8
LIKS = ("logistic", "gaussian_noise", "poisson", "het")
# the minibatched cases: kernel 1 (fused=True), kernels 3 and 2 (fused=None)
SVI_LIKS = {"logistic": (SVI_STEPS, True), "poisson": (SVI_POISSON_STEPS, True), "het": (SVI_STEPS, None),
            "multiclass": (SVI_STEPS, None)}
WORLDS = (2, 4)


# ------------------------------------------------------- data, with numpy
def full_data(lik):
    """N=61 points in 2-D, f = sin(2 x_0) + 0.5 x_1 and the labels."""
    rng = np.random.default_rng(5)
    X = rng.uniform(-2, 2, size=(N, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    if lik == "logistic":
        return X, np.sign(f)
    if lik == "gaussian_noise":
        return X, f + 0.1 * rng.normal(size=N)
    if lik == "het":
        return X, f + (0.05 + 0.3 * np.abs(X[:, 0])) * rng.normal(size=N)
    return X, rng.poisson(2.0 / (1.0 + np.exp(-f))).astype(float)


def mo_data():
    rng = np.random.default_rng(6)
    X = rng.uniform(-2, 2, size=(NM, 2))
    A = rng.normal(size=(2, 2))
    return X, [np.sin(2 * X[:, 0]), 0.5 * X[:, 1] + 0.1 * rng.normal(size=NM)], A / np.linalg.norm(A, axis=1,
                                                                                                     keepdims=True)


def svi_data(lik):
    rng = np.random.default_rng(7)
    X = rng.normal(size=(NS, D))
    f = X @ np.ones(D)
    if lik == "logistic":
        return X, np.sign(f)
    if lik == "het":
        return X, np.sin(f) + (0.05 + 0.2 * np.abs(X[:, 0])) * rng.normal(size=NS)
    if lik == "multiclass":
        return X, np.argmax(X @ rng.normal(size=(D, 3)), axis=1)
    return X, rng.poisson(2.0 / (1.0 + np.exp(-f))).astype(float)


def likelihood(pkg, lik):
    """The case's likelihood in ``pkg`` (the port or the JAX package)."""
    if lik == "gaussian_noise":
        return pkg.GaussianLikelihood.create(0.5, opt_noise=True)
    return {"logistic": lambda: pkg.LogisticLikelihood.create(), "poisson": lambda: pkg.PoissonLikelihood.create(),
            "het": lambda: pkg.HeteroscedasticLikelihood.create(1.0),
            "multiclass": lambda: pkg.LogisticSoftMaxLikelihood.create(3)}[lik]()


# each likelihood's batch-summed parameter
LIK_PARAM = {"gaussian_noise": "sigma2", "poisson": "lam", "het": "lam"}


# --------------------------------------------------- the worker (no JAX)
def _replay_init(params):
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def _replay_update(table, updates, state):
    scale = table.to(updates[0].device)[state.long()]
    return tuple(-u * scale for u in updates), state + 1


def worker(rank, world, init, inp, out):
    """One process of a group: every case, rank 0 writing the results."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.utils.opt import GradientTransformation

    agt.config.set_default_device("cpu")
    torch.set_default_dtype(torch.float64)
    mesh = pm.initialize_distributed(init, world, rank, device="cpu")
    assert (mesh.rank, mesh.size, mesh.backend) == (rank, world, "gloo")
    fed = dict(np.load(inp))
    res = {}
    t = partial(torch.as_tensor, dtype=torch.float64)
    for lik in LIKS:
        X, y = full_data(lik)
        model = agt.SVGP.create(agt.SqExponentialKernel(), likelihood(agt, lik), agt.AnalyticVI(), t(X[:M]),
                                optimiser=None)
        model, state = pm.sharded_train(model, X, y, ITERS, mesh=mesh)
        local = pm.gather_local_vars(mesh, state.local_vars)
        res.update({f"{lik}/mu": state.mu, f"{lik}/Sigma": state.Sigma, f"{lik}/theta": local["theta"][..., :N]})
        if lik in LIK_PARAM:
            res[f"{lik}/param"] = getattr(model.likelihood, LIK_PARAM[lik])
    X, ys, A = mo_data()
    mo = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1)] * 2, agt.AnalyticVI(),
                           t(X[:M]), n_latent=2, optimiser=None).replace(A=t(A))
    mo, state = pm.mo_sharded_train(mo, X, ys, MO_ITERS, mesh=mesh)
    res.update({"mo/mu": state.mu, "mo/Sigma": state.Sigma, "mo/A": mo.A})
    rule = GradientTransformation(_replay_init, partial(_replay_update, t(fed["scales"])))
    for lik, (steps, fused) in SVI_LIKS.items():
        X, y = svi_data(lik)
        model = agt.SVGP.create(agt.SqExponentialKernel(), likelihood(agt, lik),
                                agt.AnalyticSVI(BPD * world, optimiser=rule), t(X[:M]), optimiser=None)
        draws = torch.as_tensor(fed[f"svi_{lik}_idx"][:, rank * BPD:(rank + 1) * BPD])
        model, state = pm.sharded_svi_train(model, X, y, steps, mesh=mesh, batch_per_device=BPD, fused=fused,
                                            draws=draws)
        local = pm.gather_local_vars(mesh, state.local_vars)
        res.update({f"svi_{lik}/mu": state.mu, f"svi_{lik}/Sigma": state.Sigma, f"svi_{lik}/theta": local["theta"]})
        if lik in LIK_PARAM:
            res[f"svi_{lik}/param"] = getattr(model.likelihood, LIK_PARAM[lik])
    if rank == 0:
        np.savez(out, **{k: v.detach().numpy() for k, v in res.items()})
    torch.distributed.barrier()  # no rank tears down while another is still in a collective
    torch.distributed.destroy_process_group()


# ---------------------------------------------------- the reference (JAX)
@lru_cache(maxsize=None)
def jax_svi_setup(lik, world):
    """The reference's stochastic step on ``make_mesh(world)``: (mesh,
    model, state, Xs, ys, step) at rho = N / (BPD x world)."""
    import dataclasses

    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.parallel.mesh import make_mesh, shard_batch, sharded_svi_step
    from agp_tpu.training.train import init_state

    X, y = svi_data(lik)
    m = agp.SVGP.create(agp.SqExponentialKernel(), likelihood(agp, lik), agp.AnalyticSVI(BPD * world),
                        jnp.asarray(X[:M]), optimiser=None)
    y2, lik_t = m.likelihood.treat_labels(y)
    m = m.replace(likelihood=lik_t, inference=dataclasses.replace(m.inference, batchsize=BPD * world))
    mesh = make_mesh(world)
    Xj = jnp.asarray(X)
    Xs, ys = shard_batch(mesh, Xj, jnp.asarray(y2, Xj.dtype))
    state = init_state(m, Xs, ys).replace(rho=jnp.asarray(NS / (BPD * world), Xj.dtype))
    n_pad = (-NS) % world
    return mesh, m, state, Xs, ys, sharded_svi_step(mesh, BPD, n_pad)


def reference_results(world, fed):
    """The reference's results of every case at ``world`` devices."""
    import jax
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.inference.analytic_vi import variational_update
    from agp_tpu.parallel.mesh import make_mesh, mo_sharded_train, sharded_train

    out = {}
    for lik in LIKS:
        X, y = full_data(lik)
        model = agp.SVGP.create(agp.SqExponentialKernel(), likelihood(agp, lik), agp.AnalyticVI(),
                                jnp.asarray(X[:M]), optimiser=None)
        mj, sj = sharded_train(model, X, y, iterations=ITERS, mesh=make_mesh(world))
        out.update({f"{lik}/mu": sj.mu, f"{lik}/Sigma": sj.Sigma, f"{lik}/theta": sj.local_vars["theta"][..., :N]})
        if lik in LIK_PARAM:
            out[f"{lik}/param"] = getattr(mj.likelihood, LIK_PARAM[lik])
    X, ys, A = mo_data()
    mo = agp.MOSVGP.create(agp.SqExponentialKernel(), [agp.GaussianLikelihood.create(0.1, opt_noise=False)] * 2,
                           agp.AnalyticVI(), jnp.asarray(X[:M]), n_latent=2, optimiser=None).replace(A=jnp.asarray(A))
    mo, sj = mo_sharded_train(mo, X, ys, iterations=MO_ITERS, mesh=make_mesh(world))
    out.update({"mo/mu": sj.mu, "mo/Sigma": sj.Sigma, "mo/A": mo.A})
    for lik in ("logistic", "het", "multiclass"):
        _, m, state, Xs, ys_s, step = jax_svi_setup(lik, world)
        for _ in range(SVI_STEPS):
            m, state = step(m, state, Xs, ys_s)
        out.update({f"svi_{lik}/mu": state.mu, f"svi_{lik}/Sigma": state.Sigma,
                    f"svi_{lik}/theta": state.local_vars["theta"]})
        if lik in LIK_PARAM:
            out[f"svi_{lik}/param"] = getattr(m.likelihood, LIK_PARAM[lik])
    # Poisson on one device: the concatenated batch of the processes' rows
    _, m, state, Xs, ys_s, _ = jax_svi_setup("poisson", world)
    rows = Xs.shape[0] // world
    idx = fed["svi_poisson_idx"]
    glob = idx + np.repeat(np.arange(world) * rows, BPD)[None]
    update = jax.jit(variational_update)
    for i in range(SVI_POISSON_STEPS):
        m, state = update(m, state, Xs[glob[i]], ys_s[glob[i]])
        state = state.replace(step=state.step + 1)
    out.update({"svi_poisson/mu": state.mu, "svi_poisson/Sigma": state.Sigma,
                "svi_poisson/theta": state.local_vars["theta"], "svi_poisson/param": m.likelihood.lam})
    return {k: np.asarray(v) for k, v in out.items()}


def fed_inputs(world):
    """The reference's draw rows (its ``gen_idx``, [steps, world x BPD]) and
    its Robbins-Monro scales, which the children replay."""
    from torch_helpers import jax_rm_scales

    fed = {"scales": jax_rm_scales(SVI_STEPS)}
    for lik, (steps, _) in SVI_LIKS.items():
        _, _, state, Xs, _, step = jax_svi_setup(lik, world)
        fed[f"svi_{lik}_idx"] = np.asarray(step.gen_idx(Xs, state.key, state.step, steps))
    return fed


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups spawned at once; {world: (port's results, reference's)}."""
    base = tmp_path_factory.mktemp("groups")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    fed, procs = {}, {}
    for world in WORLDS:
        fed[world] = fed_inputs(world)
        inp = str(base / f"fed{world}.npz")
        np.savez(inp, **fed[world])
        init = f"file://{base}/rendezvous{world}"
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), init, inp,
             str(base / f"out{world}.npz")], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for r in range(world)]
    refs = {world: reference_results(world, fed[world]) for world in WORLDS}
    out = {}
    for world in WORLDS:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs[world]]
        for p, log in zip(procs[world], logs):
            assert p.returncode == 0, f"world {world} worker failed:\n{log[-4000:]}"
        out[world] = (dict(np.load(base / f"out{world}.npz")), refs[world])
    return out


def check(groups, world, keys, rtol=1e-8):
    port, ref = groups[world]
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=1e-10, err_msg=f"world {world}: {k}")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("lik", LIKS)
def test_sharded_train_matches_reference(groups, world, lik):
    """N=61 pads the tail; mu, Sigma, the local variables and the
    likelihood's batch-summed parameter (sigma2 by its noise rule, the
    Poisson rate, the heteroscedastic lambda from its row count) at rtol
    1e-8."""
    check(groups, world, [f"{lik}/{k}" for k in ["mu", "Sigma", "theta"] + (["param"] if lik in LIK_PARAM else [])])


@pytest.mark.parametrize("world", WORLDS)
def test_mo_sharded_train_matches_reference(groups, world):
    """The multi-output step's statistics and A's gradient contractions
    summed over the processes (test_parallel.py:306, N=61 padded)."""
    check(groups, world, ["mo/mu", "mo/Sigma", "mo/A"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("lik", ["logistic", "het", "multiclass"])
def test_fused_svi_steps_match_reference(groups, world, lik):
    """10 steps of the fused pass (kernel 1 by fused=True; kernels 3 and 2
    by the dispatch, fused=None; their plain versions) on every process's
    shard, fed the reference's gen_idx rows, against its sharded_svi_step:
    mu, Sigma, the gathered local variables and the heteroscedastic
    lambda (its batch sums and row count summed over the processes)."""
    check(groups, world, [f"svi_{lik}/{k}" for k in ["mu", "Sigma", "theta"] + (["param"] if lik in LIK_PARAM else [])])


def test_poisson_fused_svi_follows_single_device(groups):
    """The fused sharded Poisson step updates lambda from the summed batch,
    as the reference's single-device step on the concatenated batch does
    (its own fused sharded step leaves lambda unchanged)."""
    for world in WORLDS:
        check(groups, world, ["svi_poisson/mu", "svi_poisson/Sigma", "svi_poisson/theta", "svi_poisson/param"])
        assert abs(float(groups[world][0]["svi_poisson/param"]) - 1.0) > 1e-3


# ----------------------------------------------------------- no group needed
@pytest.mark.parametrize("sampling", ["gather", "slice", "block:4"])
def test_draws_never_reach_pad_rows(sampling):
    """The last process's draws stay below its valid rows (test_parallel.py:
    332): its shard's pad rows poisoned with NaN are never drawn."""
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.training import train

    rows, n_pad, world = 16, 3, 4
    mesh = pm.Mesh(None, world - 1, world, torch.device("cpu"))
    Xs = torch.ones((rows, 2), dtype=torch.float64)
    Xs[rows - n_pad:] = float("nan")
    ys = Xs[:, 0].clone()
    plan = pm.draw_plan(mesh, sampling, 8, rows, n_pad)
    tiled = train._tile_views(Xs, ys, plan.tile) if plan.mode == "block" else None
    idx = torch.randint(0, plan.high, (200,) + plan.shape, generator=pm.rank_generator(mesh))
    assert plan.mode == sampling.split(":")[0]
    for i in range(200):
        xb, yb = train._draw_from_idx(None, Xs, ys, tiled, plan.mode, idx[i], b=8)
        assert xb.shape == (8, 2) and bool(torch.isfinite(xb).all()) and bool(torch.isfinite(yb).all())


def test_refusals():
    """A dense model is refused with TypeError; fused=True where kernel 1
    cannot take the model (here M=130) with ValueError."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.parallel import mesh as pm

    X = torch.as_tensor(np.random.default_rng(0).normal(size=(200, 2)))
    y = torch.sign(X[:, 0])
    vgp = agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticVI())
    with pytest.raises(TypeError, match="sparse"):
        pm.sharded_train(vgp, X, y, 1)
    with pytest.raises(TypeError, match="sparse"):
        pm.sharded_svi_train(vgp, X, y, 1)
    big = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(32), X[:130],
                          optimiser=None)
    with pytest.raises(ValueError, match="kernel 1"):
        pm.sharded_svi_train(big, X, y, 1, fused=True)
    with pytest.raises(ValueError, match="kernel 1"):
        pm.sharded_fused_svi_step(pm.make_mesh("cpu"), big, 32)


@pytest.mark.parametrize("sampling", ["gather", "block"])
def test_world_of_one_is_train(sampling):
    """Without a process group the mesh is one process: sharded_svi_train
    on the same draws is vi_steps bit for bit (kernel 1's plain version),
    fused=False (the split pair) within rounding of it, and sharded_train
    is train."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.training.train import vi_steps

    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(300, 3)))
    y = torch.sign(X @ torch.ones(3, dtype=X.dtype))
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                            agt.AnalyticSVI(64, minibatch_sampling=sampling), X[:M], optimiser=None)
    mesh = pm.make_mesh("cpu")
    plan = pm.draw_plan(mesh, sampling, 64, 300, 0)
    draws = torch.randint(0, plan.high, (5,) + plan.shape, generator=torch.Generator().manual_seed(3))
    _, st = vi_steps(model, agt.init_state(model, X, y), X, y, 5, draws=draws)
    _, s1 = pm.sharded_svi_train(model, X, y, 5, mesh=mesh, draws=draws)
    assert torch.equal(s1.mu, st.mu) and torch.equal(s1.Sigma, st.Sigma)
    assert torch.equal(s1.local_vars["theta"], st.local_vars["theta"])
    _, s2 = pm.sharded_svi_train(model, X, y, 5, mesh=mesh, draws=draws, fused=False)
    torch.testing.assert_close(s2.mu, st.mu, rtol=1e-10, atol=1e-12)
    full = model.replace(inference=agt.AnalyticVI())
    _, s3 = pm.sharded_train(full, X, y, 3, mesh=mesh)
    _, s4 = agt.train(full, X, y, iterations=3)
    assert torch.equal(s3.mu, s4.mu) and torch.equal(s3.Sigma, s4.Sigma)


def test_shard_batch_and_gather():
    """shard_batch's rows, pad and mask at each rank of 4 over N=61, and
    gather_local_vars of one process (its own rows back)."""
    from agp_tpu_torch.parallel import mesh as pm

    X = torch.arange(61.0, dtype=torch.float64)[:, None]
    got = []
    for rank in range(4):
        mesh = pm.Mesh(None, rank, 4, torch.device("cpu"))
        xs, mask = pm.shard_batch(mesh, X, with_mask=True)
        assert xs.shape == (16, 1) and mask.dtype == torch.float64
        got.append(torch.where(mask > 0, xs[:, 0], torch.full_like(mask, -1.0)))
    allrows = torch.cat(got)
    assert torch.equal(allrows[:61], X[:, 0]) and bool((allrows[61:] == -1).all())
    one = pm.make_mesh("cpu")
    local = {"theta": torch.arange(5.0), "state": {"count": torch.tensor(3)}}
    back = pm.gather_local_vars(one, local)
    assert torch.equal(back["theta"], local["theta"]) and int(back["state"]["count"]) == 3


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5], sys.argv[6])
    print(json.dumps({"rank": int(sys.argv[2]), "ok": True}), flush=True)
    # its results are written: exit at once, as an orderly interpreter
    # shutdown can abort in gloo's threads' teardown
    os._exit(0)
