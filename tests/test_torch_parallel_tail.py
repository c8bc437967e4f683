"""The rest of the reference's multi-device paths (``__graft_entry__.py::
dryrun_multichip``) in the port, over torch.distributed (float64, CPU).

Two process groups are spawned over gloo, of 2 and of 4 processes, each
running every case below (``python tests/test_torch_parallel_tail.py
worker ...``: the children import agp_tpu_torch only); the parent computes
the references meanwhile:
- the (data, latent) mesh: the dryrun's model (K=4, N=64, D=3, M=8,
  AnalyticVI) on a 1 x 2 and a 2 x 2 mesh, 10 steps through
  ``sharded_train``; the gathered mu, Sigma, eta1, eta2, alpha, gamma and
  the ELBO against the reference's GSPMD step on a JAX mesh of virtual CPU
  devices with the dryrun's shardings, at rtol 1e-8; K=3 (latents 2 + 1)
  against the reference on one device (JAX cannot lay 3 over 2 devices);
- the (data, latent) SVI trainer against the port's world-1 ``vi_steps`` on
  the same global draws, at 1e-10;
- particle-parallel SMC: worlds 2 and 4 reproduce world 1's particles and
  log Z at 1e-12 (the reference's sharded call equals its unsharded one:
  the semantics matched is "sharding changes nothing");
- chain-parallel Gibbs: each process's chains bit-equal to its one-process
  twin (checked in the process);
- a sharded online stream: 3 batches against the reference's
  ``_online_batch`` with the batch's rows over ``make_mesh(n)``'s "data"
  at rtol 1e-8, and a batch that does not divide against the port's world 1;
- a gathered state resumed: 5 + 5 full-batch and SVI steps across a save
  and a load, world 2 -> 2 and 2 -> 4, against 10 uninterrupted steps at
  1e-12;
- a latent axis of one process is the one-axis mesh, bit for bit.
The rest needs no group: the refusals on a latent axis, the blocks, a
world of one.
"""
import json
import os
import subprocess
import sys
from functools import partial

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
# the dryrun's multiclass model, __graft_entry__.py:96-108
N, D, M, STEPS = 64, 3, 8, 10
# the SVI case: rows a data index of a step
BPD = 8
# SMC on an MCGP: points, particles a process, temperatures, MALA steps
SN, SP, ST, SMALA = 24, 4, 3, 2
# Gibbs: samples, burn-in, chains a process
GS, GB, GC = 6, 3, 2
# the online stream: 3 batches of 8 rows a process (the dryrun's Bo), a
# capacity of 16, 3 iterations; the ragged batch's rows
OB, OCAP, OITERS, ORAGGED = 8, 16, 3, 13
# the resume: full-batch rows (padded at worlds 2 and 4), SVI rows, steps
RN, RSN, RHALF = 61, 64, 5


def dryrun_data(K, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(N, D)), rng.integers(0, K, N)


def mcgp_data():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(SN, 2))
    return X, np.sign(X[:, 0] + 0.1)


def online_data(n):
    rng = np.random.default_rng(4)
    X = rng.uniform(-2, 2, size=(n, 2))
    return X, np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]


def resume_data(n, seed=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 2))
    return X, np.argmax(X @ rng.normal(size=(2, 3)), axis=1)


def quarter_draws(steps, world):
    """[steps, 4 x BPD] row indices of the resume's SVI draws: BPD rows in
    each quarter of RSN rows (world 4's shards), concatenated in order,
    which are also world 2's shards' draws (the halves' quarters)."""
    rng = np.random.default_rng(8)
    q = RSN // 4
    return rng.integers(0, q, size=(steps, 4, BPD)) + (np.arange(4) * q)[None, :, None]


def rank_draws(draws, world, rank):
    """This rank's index rows within its shard of RSN / world rows."""
    per = 4 // world
    rows = RSN // world
    return draws[:, rank * per:(rank + 1) * per].reshape(draws.shape[0], -1) - rank * rows


# --------------------------------------------------- the worker (no JAX)
def _cpu_model(agt, K, X, stochastic=False):
    t = torch.as_tensor(X[:M], dtype=torch.float64)
    inf = agt.AnalyticSVI(BPD) if stochastic else agt.AnalyticVI()
    return agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticSoftMaxLikelihood.create(K), inf, t,
                           optimiser=None)


def worker(rank, world, init, base):
    """One process of a group: every case, rank 0 writing the results."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.inference.analytic_vi import elbo
    from agp_tpu_torch.inference.smc import gather_particles
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.utils import batch_sums

    agt.config.set_default_device("cpu")
    torch.set_default_dtype(torch.float64)
    flat = pm.initialize_distributed(init, world, rank, device="cpu")
    grid = pm.make_mesh("cpu", latent=2)
    n_data = world // 2
    assert (grid.rank, grid.size, grid.data.size, grid.latent.size) == (rank, world, n_data, 2)
    assert (grid.data.rank, grid.latent.rank) == divmod(rank, 2)
    res, flags = {}, {}

    # the (data, latent) mesh, full batch, on the dryrun's model
    for K in (4, 3):
        X, y = dryrun_data(K)
        calls = batch_sums.latent_sum.calls
        m, s = pm.sharded_train(_cpu_model(agt, K, X), X, y, STEPS, mesh=grid)
        flags[f"grid{K}_latents"] = (m.n_latent, s.mu.shape[0]) == ((2, 2) if K == 4 else ((2, 2), (1, 1))[rank % 2])
        flags[f"grid{K}_latent_sums"] = batch_sums.latent_sum.calls - calls == 2 * STEPS
        Xs, ys = pm.shard_batch(grid, torch.as_tensor(X), m.likelihood.treat_labels(y)[0])
        with batch_sums.sharded(grid):
            e = elbo(m, s, Xs, ys)
        mg, sg = pm.gather_latents(grid, m, s)
        local = pm.gather_local_vars(grid, sg.local_vars)
        res.update({f"grid{K}/{k}": getattr(sg, k) for k in ("mu", "Sigma", "eta1", "eta2")})
        res.update({f"grid{K}/alpha": local["alpha"], f"grid{K}/gamma": local["gamma"], f"grid{K}/elbo": e,
                    f"grid{K}/Z": mg.Z})
        # a sharded result trained on: 4 + 6 steps are the 10 steps, bit for bit
        m4, s4 = pm.sharded_train(_cpu_model(agt, K, X), X, y, 4, mesh=grid)
        _, s4 = pm.sharded_train(m4, X, y, STEPS - 4, mesh=grid, state=s4)
        flags[f"grid{K}_continued"] = bool(torch.equal(s4.mu, s.mu) and torch.equal(s4.Sigma, s.Sigma))

    # the (data, latent) mesh, minibatched, fed each data index's rows
    X, y = dryrun_data(4, seed=1)
    draws = np.load(os.path.join(base, f"svi_draws{world}.npy"))
    rows = N // n_data
    mine = torch.as_tensor(draws[:, grid.data.rank * BPD:(grid.data.rank + 1) * BPD] - grid.data.rank * rows)
    m, s = pm.sharded_svi_train(_cpu_model(agt, 4, X, stochastic=True), X, y, STEPS, mesh=grid,
                                batch_per_device=BPD, draws=mine)
    _, sg = pm.gather_latents(grid, m, s)
    res.update({"svi_grid/mu": sg.mu, "svi_grid/Sigma": sg.Sigma,
                "svi_grid/alpha": pm.gather_local_vars(grid, sg.local_vars)["alpha"]})

    # particle-parallel SMC and chain-parallel Gibbs on the one-axis mesh
    Xg, yg = mcgp_data()
    mg = agt.MCGP.create(torch.as_tensor(Xg), yg, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=GB))
    fs, log_z = agt.smc_sample(mg, n_particles=SP * world, n_temps=ST, n_mala=SMALA,
                               generator=torch.Generator().manual_seed(7), mesh=flat)
    flags["smc_block"] = tuple(fs.shape) == (SP, 1, SN)
    res.update({"smc/f": gather_particles(flat, fs), "smc/log_z": log_z})
    kept = agt.sample(mg, GS, generator=torch.Generator().manual_seed(100 + rank), n_chains=GC * world, mesh=flat)
    twin = agt.sample(mg, GS, generator=torch.Generator().manual_seed(100 + rank), n_chains=GC)
    flags["gibbs_twin"] = bool(torch.equal(kept[rank * GC:(rank + 1) * GC], twin))
    res["gibbs/kept"] = kept

    # the online stream: batches of OB rows a process, and a ragged one
    Xo, yo = online_data(3 * OB * world)
    mo = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                               n_dim=2, capacity=OCAP, optimiser=None, dtype=torch.float64, device="cpu")
    stream = torch.as_tensor(Xo).reshape(3, OB * world, 2), torch.as_tensor(yo).reshape(3, OB * world)
    mo1, so1 = agt.online_train_stream(mo, *stream, iterations=OITERS, mesh=flat)
    res.update({"online/mu": so1.mu, "online/Sigma": so1.Sigma, "online/Z": mo1.Z, "online/mask": mo1.z_mask})
    Xr, yr = online_data(ORAGGED)
    mr, sr = agt.online_train(mo1, Xr, yr, state=so1, iterations=OITERS, mesh=flat)
    res.update({"ragged/mu": sr.mu, "ragged/Sigma": sr.Sigma})

    # a gathered state resumed: 2 -> 2 on the world-2 group, 2 -> 4 on the
    # world-4 group (its first two processes as a world of 2)
    pair_group = torch.distributed.new_group([0, 1]) if world == 4 else flat.group
    pair = pm.Mesh(pair_group, rank, 2, flat.device, "gloo") if rank < 2 else None
    Xf, yf = resume_data(RN)
    Xv, yv = resume_data(RSN, seed=9)
    qd = quarter_draws(2 * RHALF, 4)
    if pair is not None:
        full = _cpu_model(agt, 3, Xf)
        _, s10 = pm.sharded_train(full, Xf, yf, 2 * RHALF, mesh=pair)
        m5, s5 = pm.sharded_train(full, Xf, yf, RHALF, mesh=pair)
        svi = _cpu_model(agt, 3, Xv, stochastic=True)
        d2 = torch.as_tensor(rank_draws(qd, 2, rank))
        _, v10 = pm.sharded_svi_train(svi, Xv, yv, 2 * RHALF, mesh=pair, batch_per_device=2 * BPD, draws=d2)
        mv5, v5 = pm.sharded_svi_train(svi, Xv, yv, RHALF, mesh=pair, batch_per_device=2 * BPD, draws=d2[:RHALF])
        res.update({"resume/full10": s10.mu, "resume/full10_alpha": pm.gather_local_vars(pair, s10.local_vars)["alpha"],
                    "resume/svi10": v10.mu, "resume/svi10_alpha": pm.gather_local_vars(pair, v10.local_vars)["alpha"]})
        # the true rows alone: a template's init_state holds RN
        full_local = {k: v[..., :RN] for k, v in pm.gather_local_vars(pair, s5.local_vars).items()}
        svi_local = pm.gather_local_vars(pair, v5.local_vars)
        if rank == 0:
            agt.checkpoint.save(os.path.join(base, f"full{world}"), m5, s5.replace(local_vars=full_local))
            agt.checkpoint.save(os.path.join(base, f"svi{world}"), mv5, v5.replace(local_vars=svi_local))
    torch.distributed.barrier()
    Xt, Xvt = torch.as_tensor(Xf), torch.as_tensor(Xv)
    tf = _cpu_model(agt, 3, Xf)
    mf, sf = agt.checkpoint.load(os.path.join(base, f"full{world}"), tf, agt.init_state(tf, Xt, yf))
    _, sf = pm.sharded_train(mf, Xf, yf, RHALF, mesh=flat, state=sf)
    tv = _cpu_model(agt, 3, Xv, stochastic=True).replace(
        inference=agt.AnalyticSVI(4 * BPD))
    mv, sv = agt.checkpoint.load(os.path.join(base, f"svi{world}"), tv, agt.init_state(tv, Xvt, yv))
    dw = torch.as_tensor(rank_draws(qd, world, rank))[RHALF:]
    _, sv = pm.sharded_svi_train(mv, Xv, yv, RHALF, mesh=flat, batch_per_device=4 * BPD // world, state=sv, draws=dw)
    res.update({"resume/full": sf.mu, "resume/full_alpha": pm.gather_local_vars(flat, sf.local_vars)["alpha"],
                "resume/svi": sv.mu, "resume/svi_alpha": pm.gather_local_vars(flat, sv.local_vars)["alpha"]})

    # a latent axis of one process: the one-axis mesh, built as make_mesh() always built it
    X, y = dryrun_data(4, seed=2)
    one = pm.make_mesh("cpu", latent=1)
    legacy = pm.Mesh(torch.distributed.group.WORLD, rank, world, torch.device("cpu"), "gloo")
    calls = batch_sums.latent_sum.calls
    _, s_one = pm.sharded_train(_cpu_model(agt, 4, X), X, y, 3, mesh=one)
    _, s_old = pm.sharded_train(_cpu_model(agt, 4, X), X, y, 3, mesh=legacy)
    flags["latent1_bits"] = bool(torch.equal(s_one.mu, s_old.mu) and torch.equal(s_one.Sigma, s_old.Sigma))
    flags["latent1_no_latent_sum"] = batch_sums.latent_sum.calls == calls and one.data is one

    every = [None] * world
    torch.distributed.all_gather_object(every, flags)
    if rank == 0:
        np.savez(os.path.join(base, f"out{world}.npz"), **{k: v.detach().numpy() for k, v in res.items()})
        with open(os.path.join(base, f"flags{world}.json"), "w") as f:
            json.dump(every, f)
    torch.distributed.barrier()  # no rank tears down while another is still in a collective
    torch.distributed.destroy_process_group()


# ---------------------------------------------------- the references (JAX)
def jax_grid(K, shape):
    """The dryrun's step on a JAX mesh of ``shape`` ("data", "latent")
    virtual CPU devices with its shardings (None: one device), STEPS
    steps; the posterior, the local variables and the ELBO."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import agp_tpu as agp
    from agp_tpu.inference.analytic_vi import elbo, variational_update
    from agp_tpu.training.train import init_state

    X, y = dryrun_data(K)
    X = jnp.asarray(X)
    model = agp.SVGP.create(agp.SqExponentialKernel(lengthscale=jnp.ones(())), agp.LogisticSoftMaxLikelihood.create(K),
                            agp.AnalyticVI(), X[:M], optimiser=None)
    yh, tl = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=tl)
    state = init_state(model, X, yh)
    yh = jnp.asarray(yh, X.dtype)
    if shape is not None:
        mesh = Mesh(np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "latent"))
        data, lat = NamedSharding(mesh, P("data")), NamedSharding(mesh, P("latent"))
        X, yh = jax.device_put(X, data), jax.device_put(yh, data)
        put = partial(jax.device_put, device=lat)
        state = state.replace(eta1=put(state.eta1), eta2=put(state.eta2), mu=put(state.mu), Sigma=put(state.Sigma),
                              kmat={k: put(v) for k, v in state.kmat.items()})
        model = model.replace(Z=put(model.Z))
    step = jax.jit(variational_update)
    for _ in range(STEPS):
        model, state = step(model, state, X, yh)
    out = {k: getattr(state, k) for k in ("mu", "Sigma", "eta1", "eta2")}
    out.update(alpha=state.local_vars["alpha"], gamma=state.local_vars["gamma"],
               elbo=jax.jit(elbo)(model, state, X, yh), Z=model.Z)
    return {k: np.asarray(v) for k, v in out.items()}


def jax_smc_sharding_changes_nothing(world):
    """The reference's particle-parallel SMC equals its unsharded call."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import agp_tpu as agp
    from agp_tpu.inference.smc import smc_sample
    from agp_tpu.parallel.mesh import make_mesh

    X, y = mcgp_data()
    mg = agp.MCGP.create(jnp.asarray(X), y, agp.SqExponentialKernel(), agp.LogisticLikelihood.create(),
                         agp.GibbsSampling(n_burnin=GB))
    kw = dict(n_particles=SP * world, n_temps=ST, n_mala=SMALA, key=jax.random.PRNGKey(7))
    f0, z0 = smc_sample(mg, **kw)
    f1, z1 = smc_sample(mg, **kw, particle_sharding=NamedSharding(make_mesh(world), P("data")))
    return np.asarray(f0), float(z0), np.asarray(f1), float(z1)


def jax_online(world):
    """The reference's stream: the first batch by ``online_train``, the
    next two by ``_online_batch`` with the rows over make_mesh(world)'s
    "data"."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import agp_tpu as agp
    from agp_tpu.models.online_svgp import _online_batch
    from agp_tpu.parallel.mesh import make_mesh

    Xo, yo = online_data(3 * OB * world)
    b = OB * world
    mon = agp.OnlineSVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
                                agp.AnalyticVI(), n_dim=2, capacity=OCAP, optimiser=None)
    mon, son = agp.online_train(mon, jnp.asarray(Xo[:b]), jnp.asarray(yo[:b]), iterations=OITERS)
    dsh = NamedSharding(make_mesh(world), P("data"))
    for i in (1, 2):
        xb = jax.device_put(jnp.asarray(Xo[i * b:(i + 1) * b]), dsh)
        yb = jax.device_put(jnp.asarray(yo[i * b:(i + 1) * b]), dsh)
        mon, son = _online_batch(mon, son, xb, yb, OITERS)
    return {"mu": np.asarray(son.mu), "Sigma": np.asarray(son.Sigma), "Z": np.asarray(mon.Z),
            "mask": np.asarray(mon.z_mask)}


def port_world1(world, base):
    """The port's own world-1 runs the groups are held to."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.training.train import vi_steps

    t = partial(torch.as_tensor, dtype=torch.float64)
    out = {}
    X, y = dryrun_data(4, seed=1)
    n_data = world // 2
    model = _cpu_model(agt, 4, X, stochastic=True).replace(inference=agt.AnalyticSVI(BPD * n_data))
    yt, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    draws = torch.as_tensor(np.load(os.path.join(base, f"svi_draws{world}.npy")))
    _, st = vi_steps(model, agt.init_state(model, t(X), yt), t(X), yt, STEPS, draws=draws)
    out.update({"svi_grid/mu": st.mu, "svi_grid/Sigma": st.Sigma, "svi_grid/alpha": st.local_vars["alpha"]})
    Xg, yg = mcgp_data()
    mg = agt.MCGP.create(t(Xg), yg, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=GB))
    fs, log_z = agt.smc_sample(mg, n_particles=SP * world, n_temps=ST, n_mala=SMALA,
                               generator=torch.Generator().manual_seed(7))
    out.update({"smc/f": fs, "smc/log_z": log_z})
    mo = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                               n_dim=2, capacity=OCAP, optimiser=None, dtype=torch.float64, device="cpu")
    Xo, yo = online_data(3 * OB * world)
    mo, so = agt.online_train_stream(mo, t(Xo).reshape(3, OB * world, 2), t(yo).reshape(3, OB * world),
                                     iterations=OITERS)
    Xr, yr = online_data(ORAGGED)
    _, sr = agt.online_train(mo, Xr, yr, state=so, iterations=OITERS)
    out.update({"ragged/mu": sr.mu, "ragged/Sigma": sr.Sigma})
    return {k: v.numpy() for k, v in out.items()}


def svi_draws(world):
    """[STEPS, BPD x n_data] global row indices: each data index's BPD rows
    from its own shard of N / n_data rows."""
    n_data = world // 2
    rows = N // n_data
    rng = np.random.default_rng(world)
    return np.concatenate([rng.integers(0, rows, size=(STEPS, BPD)) + d * rows for d in range(n_data)], axis=1)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Both groups spawned at once; {world: (port's results, its flags,
    the references)}."""
    base = tmp_path_factory.mktemp("tail")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for world in WORLDS:
        np.save(base / f"svi_draws{world}.npy", svi_draws(world))
        init = f"file://{base}/rendezvous{world}"
        procs[world] = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", str(r), str(world), init, str(base)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    refs, shapes = {}, {2: (1, 2), 4: (2, 2)}
    for world in WORLDS:
        refs[world] = {f"grid4/{k}": v for k, v in jax_grid(4, shapes[world]).items()}
        refs[world].update({f"online/{k}": v for k, v in jax_online(world).items()})
        refs[world]["smc_ref"] = jax_smc_sharding_changes_nothing(world)
        refs[world].update(port_world1(world, base))
    grid3 = {f"grid3/{k}": v for k, v in jax_grid(3, None).items()}
    out = {}
    for world in WORLDS:
        logs = [p.communicate(timeout=600)[0].decode() for p in procs[world]]
        for p, log in zip(procs[world], logs):
            assert p.returncode == 0, f"world {world} worker failed:\n{log[-4000:]}"
        with open(base / f"flags{world}.json") as f:
            flags = json.load(f)
        out[world] = (dict(np.load(base / f"out{world}.npz")), flags, {**refs[world], **grid3})
    return out


def close(port, ref, keys, world, rtol, atol=1e-12):
    for k in keys:
        np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=atol, err_msg=f"world {world}: {k}")


GRID_KEYS = ("mu", "Sigma", "eta1", "eta2", "alpha", "gamma", "elbo", "Z")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("K", [4, 3])
def test_data_latent_mesh_matches_reference(groups, world, K):
    """The dryrun's model, 10 steps on a 1 x 2 (world 2) and a 2 x 2 (world
    4) mesh: each latent rank steps its block (kernel 4, the coupled
    E-step over latent_sum, kernel 5; their plain versions here), the
    gathered posterior, local variables and whole-batch ELBO against the
    reference's GSPMD step with the dryrun's shardings (K=4) or on one
    device (K=3, latents 2 + 1), at rtol 1e-8; a sharded result trained
    on (4 + 6 steps) is the 10 steps bit for bit."""
    port, flags, ref = groups[world]
    close(port, ref, [f"grid{K}/{k}" for k in GRID_KEYS], world, rtol=1e-8, atol=1e-10)
    for f in flags:
        assert f[f"grid{K}_latents"] and f[f"grid{K}_latent_sums"] and f[f"grid{K}_continued"], f


@pytest.mark.parametrize("world", WORLDS)
def test_data_latent_svi_matches_world1(groups, world):
    """10 minibatched steps on the (data, latent) mesh, each data index fed
    its rows (both latent ranks of it draw the same), against the port's
    world-1 vi_steps on the same global batches, at 1e-10."""
    port, _, ref = groups[world]
    close(port, ref, ["svi_grid/mu", "svi_grid/Sigma", "svi_grid/alpha"], world, rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_particle_parallel_smc(groups, world):
    """Worlds 2 and 4 reproduce world 1's particles and log Z at 1e-12,
    each process holding its block of them; the reference's sharded call
    equals its unsharded one."""
    port, flags, ref = groups[world]
    close(port, ref, ["smc/f", "smc/log_z"], world, rtol=1e-12)
    assert all(f["smc_block"] for f in flags)
    f0, z0, f1, z1 = ref["smc_ref"]
    np.testing.assert_allclose(f1, f0, rtol=1e-12, atol=1e-12)
    assert abs(z1 - z0) <= 1e-12 * abs(z0)


@pytest.mark.parametrize("world", WORLDS)
def test_chain_parallel_gibbs(groups, world):
    """Each process's chains, gathered in rank order, bit-equal to the
    one-process sample with its generator and its chains."""
    port, flags, _ = groups[world]
    assert port["gibbs/kept"].shape == (GC * world, GS, 1, SN) and np.isfinite(port["gibbs/kept"]).all()
    assert all(f["gibbs_twin"] for f in flags)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_online_stream(groups, world):
    """3 batches with their rows split over the processes (Z selected on
    process 0 and broadcast) against the reference's _online_batch with the
    rows over "data", at rtol 1e-8; then a batch of 13 rows (a pad row's
    mask) against the port's world 1."""
    port, _, ref = groups[world]
    close(port, ref, ["online/mu", "online/Sigma"], world, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(port["online/mask"], ref["online/mask"])
    np.testing.assert_array_equal(port["online/Z"], ref["online/Z"])
    close(port, ref, ["ragged/mu", "ragged/Sigma"], world, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_gathered_state_resumes(groups, world):
    """A world-2 checkpoint after 5 of 10 full-batch (N=61, padded) and SVI
    steps (multiclass: the E-step reads the saved alpha), resumed at world
    ``world``: mu and the gathered alpha equal the uninterrupted run's at
    1e-12."""
    port, _, _ = groups[world]
    for which in ("full", "svi"):
        np.testing.assert_allclose(port[f"resume/{which}"], port[f"resume/{which}10"], rtol=1e-12, atol=1e-14)
        n = RN if which == "full" else 4 * BPD
        np.testing.assert_allclose(port[f"resume/{which}_alpha"][..., :n], port[f"resume/{which}10_alpha"][..., :n],
                                   rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("world", WORLDS)
def test_latent_axis_of_one_is_the_data_mesh(groups, world):
    """make_mesh(latent=1) is the one-axis mesh: the same steps bit for bit
    as a mesh built the way the data-parallel port built it, and no latent
    collective."""
    _, flags, _ = groups[world]
    assert all(f["latent1_bits"] and f["latent1_no_latent_sum"] for f in flags)


# ----------------------------------------------------------- no group needed
def _fake_grid(latent=2):
    """A (data, latent) mesh of this one process's view, no group: enough
    for the refusals, which come before any collective."""
    from agp_tpu_torch.parallel import mesh as pm

    cpu = torch.device("cpu")
    return pm.Mesh(None, 0, latent, cpu, data_axis=pm.Mesh(None, 0, 1, cpu),
                   latent_axis=pm.Mesh(None, 0, latent, cpu))


def _refused_models():
    import agp_tpu_torch as agt

    rng = np.random.default_rng(0)
    X = torch.as_tensor(rng.normal(size=(40, 2)))
    Z = X[:M]
    svgp = partial(agt.SVGP.create, optimiser=None)
    return X, {
        "het": (svgp(agt.SqExponentialKernel(), agt.HeteroscedasticLikelihood.create(1.0), agt.AnalyticVI(), Z),
                torch.sin(X[:, 0]), "lambda"),
        "softmax": (svgp(agt.SqExponentialKernel(), agt.SoftMaxLikelihood.create(3), agt.MCIntegrationVI(), Z),
                    torch.arange(40) % 3, "normaliser"),
        "numerical": (svgp(agt.SqExponentialKernel(), agt.LogisticSoftMaxLikelihood.create(3), agt.MCIntegrationVI(),
                           Z), torch.arange(40) % 3, "link"),
        "logistic": (svgp(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticVI(), Z),
                     torch.sign(X[:, 0]), "coupled E-step"),
        "alrsvi": (svgp(agt.SqExponentialKernel(), agt.LogisticSoftMaxLikelihood.create(3),
                        agt.AnalyticSVI(16, optimiser=agt.alrsvi()), Z), torch.arange(40) % 3, "alrsvi"),
    }


@pytest.mark.parametrize("case", ["het", "softmax", "numerical", "logistic", "alrsvi"])
def test_latent_axis_refusals(case):
    """A latent axis wider than one refuses, with TypeError naming the
    coupling it lacks, every model but the logistic-softmax one under
    closed-form CAVI: in each trainer and inside a sharded step."""
    from agp_tpu_torch.inference.analytic_vi import variational_update
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.training.train import init_state
    from agp_tpu_torch.utils import batch_sums

    X, cases = _refused_models()
    model, y, words = cases[case]
    grid = _fake_grid()
    train = pm.sharded_svi_train if model.inference.stochastic else pm.sharded_train
    with pytest.raises(TypeError, match=words):
        train(model, X, y, 1, mesh=grid)
    with pytest.raises(TypeError, match=words):
        pm.shard_latents(grid, model, None)
    if case == "het":
        yt, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        state = init_state(model, X, yt.to(X.dtype))
        with batch_sums.sharded(grid), pytest.raises(TypeError, match=words):
            variational_update(model, state, X, yt.to(X.dtype))


def test_latent_axis_refuses_other_models():
    """The multi-output and the online models on a latent axis: TypeError
    (the mixing matrix couples every latent; the online selection is made
    for all at once); fewer latents than processes: ValueError."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.parallel import mesh as pm

    X, _ = _refused_models()
    grid = _fake_grid()
    mo = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1)] * 2, agt.AnalyticVI(),
                           X[:M], n_latent=2, optimiser=None)
    with pytest.raises(TypeError, match="mixing matrix"):
        pm.mo_sharded_train(mo, X, [X[:, 0], X[:, 1]], 1, mesh=grid)
    on = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                               n_dim=2, capacity=8, optimiser=None, dtype=torch.float64, device="cpu")
    with pytest.raises(TypeError, match="online"):
        agt.online_train(on, X, X[:, 0], mesh=grid)
    two = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticSoftMaxLikelihood.create(2), agt.AnalyticVI(),
                          X[:M], optimiser=None)
    with pytest.raises(ValueError, match="2 latents"):
        pm.sharded_train(two, X, torch.arange(40) % 2, 1, mesh=_fake_grid(3))


@pytest.mark.parametrize("n,parts", [(3, 2), (4, 2), (10, 4), (10, 3), (5, 5), (7, 1)])
def test_blocks_split_as_tensor_split(n, parts):
    """Mesh.block gives torch.tensor_split's blocks (K=3 over 2: 2 + 1)."""
    from agp_tpu_torch.parallel import mesh as pm

    got = [pm.Mesh(None, i, parts, torch.device("cpu")).block(n) for i in range(parts)]
    sizes = [len(w) for w in torch.tensor_split(torch.arange(n), parts)]
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    assert got == [(lo, lo + size) for lo, size in zip(starts, sizes)]


def test_shard_local_vars_inverts_gather():
    """shard_local_vars cuts a gathered (padded) state back to each rank's
    rows in shard_batch's layout, pad rows row 0's, for a world other than
    the one it was gathered on; on a (data, latent) mesh also each rank's
    latents (K=3 over 2: 2 + 1)."""
    from agp_tpu_torch.parallel import mesh as pm

    n = 61
    local = {"alpha": torch.arange(62.0), "gamma": torch.arange(3 * 62.0).reshape(3, 62), "count": torch.tensor(4)}
    for world in (2, 4):
        for rank in range(world):
            mesh = pm.Mesh(None, rank, world, torch.device("cpu"))
            rows = pm.shard_batch(mesh, torch.arange(61.0))
            got = pm.shard_local_vars(mesh, local, n)
            assert torch.equal(got["alpha"], rows) and torch.equal(got["gamma"], local["gamma"][:, rows.long()])
            assert int(got["count"]) == 4
    cpu = torch.device("cpu")
    for lat in range(2):
        grid = pm.Mesh(None, 2 + lat, 4, cpu, data_axis=pm.Mesh(None, 1, 2, cpu), latent_axis=pm.Mesh(None, lat, 2, cpu))
        got = pm.shard_local_vars(grid, local, n)
        rows = pm.shard_batch(grid, torch.arange(61.0)).long()
        assert torch.equal(got["gamma"], local["gamma"][[0, 1] if lat == 0 else [2]][:, rows])


def test_world_of_one_samplers():
    """On a mesh of one process, sample and smc_sample are their calls
    without a mesh, bit for bit."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.parallel import mesh as pm

    Xg, yg = mcgp_data()
    mg = agt.MCGP.create(torch.as_tensor(Xg), yg, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),
                         agt.GibbsSampling(n_burnin=GB))
    one = pm.make_mesh("cpu")
    gen = lambda: torch.Generator().manual_seed(3)
    assert torch.equal(agt.sample(mg, GS, gen(), n_chains=4, mesh=one), agt.sample(mg, GS, gen(), n_chains=4))
    a = agt.smc_sample(mg, n_particles=8, n_temps=2, n_mala=1, generator=gen(), mesh=one)
    b = agt.smc_sample(mg, n_particles=8, n_temps=2, n_mala=1, generator=gen())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    print(json.dumps({"rank": int(sys.argv[2]), "ok": True}), flush=True)
    # its results are written: exit at once, as an orderly interpreter
    # shutdown can abort in gloo's threads' teardown
    os._exit(0)
