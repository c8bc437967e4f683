"""Slice J: checkpoints.  The JAX package's checkpoints (written by
``agp_tpu.checkpoint.save``) load into the port onto templates, every leaf
bit-equal, and resume as the reference resumes (float64, CPU, rtol 1e-8);
the port's own checkpoints round-trip with templates and with
``allow_pickle``; ``interop.reference_leaf_table`` is the reference's
flatten order for each family it loads."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import agp_tpu as agp
import agp_tpu_torch as agt
from agp_tpu_torch.interop import reference_leaf_table
from agp_tpu_torch.training.checkpoint import named_leaves
from torch_helpers import close, reg_data

F64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def data():
    X, f, y = reg_data()
    return X, f, y


def t(a):
    return torch.as_tensor(np.array(a), dtype=torch.float64)


# each family: (the JAX model and state after a few iterations, the port's
# template of the same structure); the JAX package's defaults on both
# sides (Adam on the kernel where the reference's create builds it)
def svgp_stochastic(X, f, y):
    mj = agp.SVGP.create(agp.SqExponentialKernel(), agp.LogisticLikelihood.create(), agp.AnalyticSVI(10),
                         jnp.asarray(X[:8]))
    mj, sj = agp.train(mj, X, np.sign(f), iterations=4)
    mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(10), t(X[:8]))
    return (mj, sj), (mt, agt.init_state(mt, t(X), t(np.sign(f))))


def svgp_noise(X, f, y):
    lik = agp.GaussianLikelihood.create(0.05, opt_noise=True)
    mj = agp.SVGP.create(agp.SqExponentialKernel(), lik, agp.AnalyticVI(), jnp.asarray(X[:8]), optimiser=None)
    mj, sj = agp.train(mj, X, y, iterations=2)
    mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05, opt_noise=True),
                         agt.AnalyticVI(), t(X[:8]), optimiser=None)
    return (mj, sj), (mt, agt.init_state(mt, t(X), t(y)))


def vgp(X, f, y):
    mj = agp.VGP.create(jnp.asarray(X), y, agp.SqExponentialKernel(), agp.StudentTLikelihood.create(4.0),
                        agp.AnalyticVI())
    mj, sj = agp.train(mj, iterations=2)
    mt = agt.VGP.create(t(X), t(y), agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI())
    return (mj, sj), (mt, agt.init_state(mt))


def online_pair():
    return (agp.OnlineSVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
                                  agp.AnalyticVI(), n_dim=2, capacity=16),
            agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                                  n_dim=2, capacity=16, **F64))


def stream(train, m, X, y, upto, start=0):
    s = None
    for i in range(start, upto):
        m, s = train(m, X[i * 10:(i + 1) * 10], y[i * 10:(i + 1) * 10], s)
    return m, s


def jax_online_train(m, xb, yb, s):
    return agp.online_train(m, jnp.asarray(xb), jnp.asarray(yb), state=s, iterations=5)


def port_online_train(m, xb, yb, s):
    return agt.online_train(m, t(xb), t(yb), state=s, iterations=5)


def online(X, f, y):
    mj, mt = online_pair()
    return stream(jax_online_train, mj, X, y, 2), stream(port_online_train, mt, X, y, 2)


def mo_pair(X):
    A = np.random.default_rng(9).normal(size=(2, 2))
    A = A / np.linalg.norm(A, axis=1, keepdims=True)
    mj = agp.MOSVGP.create(agp.SqExponentialKernel(), [agp.GaussianLikelihood.create(0.1, opt_noise=False)] * 2,
                           agp.AnalyticVI(), jnp.asarray(X[:8]), n_latent=2, optimiser=None)
    mt = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1)] * 2, agt.AnalyticVI(),
                           t(X[:8]), n_latent=2, optimiser=None)
    return mj.replace(A=jnp.asarray(A)), mt.replace(A=t(A))


def mosvgp(X, f, y):
    mj, mt = mo_pair(X)
    ys = [f, y]
    mj, sj = agp.mo_train(mj, X, ys, iterations=2)
    return (mj, sj), (mt, agt.mo_init_state(mt, t(X), tuple(t(a) for a in ys)))


def vstp(X, f, y):
    mj = agp.VStP.create(jnp.asarray(X), y, agp.SqExponentialKernel(), agp.StudentTLikelihood.create(4.0),
                         agp.AnalyticVI(), nu=5.0)
    mj, sj = agp.train(mj, iterations=2)
    mt = agt.VStP.create(t(X), t(y), agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                         nu=5.0)
    return (mj, sj), (mt, agt.init_state(mt))


def gp(X, f, y):
    mj = agp.GP.create(jnp.asarray(X), y, agp.SqExponentialKernel())
    mj, sj = agp.train(mj, iterations=3)
    mt = agt.GP.create(t(X), t(y), agt.SqExponentialKernel())
    return (mj, sj), (mt, mt.init_state())


def movgp(X, f, y):
    mj = agp.MOVGP.create(jnp.asarray(X), [agp.GaussianLikelihood.create(0.1, opt_noise=False)] * 2,
                          agp.SqExponentialKernel(), agp.AnalyticVI(), n_latent=2, optimiser=None)
    mj, sj = agp.mo_train(mj, X, [f, y], iterations=2)
    mt = agt.MOVGP.create(t(X), [agt.GaussianLikelihood.create(0.1)] * 2, agt.SqExponentialKernel(), agt.AnalyticVI(),
                          2, optimiser=None)
    return (mj, sj), (mt, agt.mo_init_state(mt, t(X), (t(f), t(y))))


FAMILIES = {"svgp_stochastic": svgp_stochastic, "svgp_noise": svgp_noise, "vgp": vgp, "online": online,
            "mosvgp": mosvgp, "vstp": vstp, "gp": gp, "movgp": movgp}


@pytest.fixture(scope="module")
def runs(data):
    """Each family's (reference, template) pair, built once for the module."""
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = FAMILIES[family](*data)
        return cache[family]

    return get


@pytest.mark.parametrize("family", FAMILIES)
def test_leaf_order_table_is_the_reference_flatten_order(family, runs):
    """reference_leaf_table's paths, in order, are jax.tree_util's
    tree_flatten_with_path of the reference's (model, state), every shape
    the port template's."""
    (mj, sj), (mt, st) = runs(family)
    table = reference_leaf_table(mt, st)
    for which, tree in (("model", mj), ("state", sj)):
        ref = jax.tree_util.tree_flatten_with_path(tree)[0]
        rows = [r for r in table if r[0] == which]
        assert [jax.tree_util.keystr(p) for p, _ in ref] == [r[1] for r in rows]
        for (p, leaf), (_, _, keys, tt) in zip(ref, rows):
            if keys is not None:
                assert tuple(tt.shape) == np.shape(leaf), jax.tree_util.keystr(p)


def reference_leaves(mj, sj):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(mj)], [np.asarray(x) for x in jax.tree_util.tree_leaves(sj)]


def assert_bit_equal_to_reference(mt, st, mj, sj):
    """Every leaf of the loaded (model, state), found by the table, equals
    the reference's bit for bit (the PRNG key has no place in the port)."""
    lm, ls = reference_leaves(mj, sj)
    leaves = {"model": iter(lm), "state": iter(ls)}
    n = 0
    for which, path, keys, tt in reference_leaf_table(mt, st):
        ref = next(leaves[which])
        if keys is None:
            continue
        np.testing.assert_array_equal(tt.numpy(), ref, err_msg=path)
        assert tt.dtype == torch.as_tensor(np.array(ref)).dtype, path
        n += 1
    assert next(leaves["model"], None) is None and next(leaves["state"], None) is None
    assert n > 0


def assert_same_leaves(a, b):
    """Two port (model, state) pairs leaf for leaf, bit-equal, same paths."""
    for tree_a, tree_b, name in ((a[0], b[0], "model"), (a[1], b[1], "state")):
        la, lb = named_leaves(tree_a, name), named_leaves(tree_b, name)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (p, x), (_, y) in zip(la, lb):
            assert x.dtype == y.dtype and x.device == y.device, p
            assert torch.equal(x, y), p


def test_reference_svgp_checkpoint_loads_and_resumes(data, tmp_path):
    """test_engines.py:329's model: the JAX checkpoint onto port templates,
    bit-equal; 3 resumed iterations at rtol 1e-8; templates required;
    allow_pickle refused on it; the port's own round trip, by templates and
    by allow_pickle, bit-equal."""
    X, f, y = data
    mj = agp.SVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
                         agp.AnalyticVI(), jnp.asarray(X[:8]), optimiser=None)
    mj, sj = agp.train(mj, X, y, iterations=5)
    agp.checkpoint.save(str(tmp_path / "ref"), mj, sj)
    mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(), t(X[:8]),
                         optimiser=None)
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ref"), mt, agt.init_state(mt, t(X), t(y)))
    assert_bit_equal_to_reference(m2, s2, mj, sj)
    with pytest.raises(ValueError, match="weights-only"):
        agt.checkpoint.load(str(tmp_path / "ref"))
    with pytest.raises(ValueError, match="JAX"):
        agt.checkpoint.load(str(tmp_path / "ref"), allow_pickle=True)
    mj3, sj3 = agp.train(mj, X, y, iterations=3, state=sj)
    m3, s3 = agt.train(m2, t(X), t(y), iterations=3, state=s2)
    for name in ("mu", "Sigma", "eta1", "eta2"):
        close(getattr(s3, name), getattr(sj3, name), rtol=1e-8, msg=name)
    close(agt.predict_f(m3, s3, t(X)), agp.predict_f(mj3, sj3, jnp.asarray(X)), rtol=1e-8)

    agt.checkpoint.save(str(tmp_path / "port"), m2, s2)
    assert_same_leaves(agt.checkpoint.load(str(tmp_path / "port"), mt, agt.init_state(mt, t(X), t(y))), (m2, s2))
    m4, s4 = agt.checkpoint.load(str(tmp_path / "port"), allow_pickle=True)
    assert_same_leaves((m4, s4), (m2, s2))
    assert type(m4) is type(m2) and m4.inference == m2.inference
    m5, s5 = agt.train(m4, t(X), t(y), iterations=3, state=s4)
    assert torch.equal(s5.mu, s3.mu) and torch.equal(s5.Sigma, s3.Sigma)


def test_reference_online_checkpoint_loads_and_resumes(data, runs, tmp_path):
    """test_engines.py:812's model: the masked slot buffers and the
    streaming ``previous`` block carried bit-equal; the next batch resumed
    in both at rtol 1e-8; the port's own round trip by allow_pickle."""
    X, f, y = data
    (mj, sj), template = runs("online")
    assert sj.previous is not None
    agp.checkpoint.save(str(tmp_path / "ref"), mj, sj)
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ref"), *template)
    assert_bit_equal_to_reference(m2, s2, mj, sj)
    assert m2.z_mask.dtype == torch.bool
    mj3, sj3 = jax_online_train(mj, X[20:30], y[20:30], sj)
    m3, s3 = port_online_train(m2, X[20:30], y[20:30], s2)
    for name in ("mu", "Sigma"):
        close(getattr(s3, name), getattr(sj3, name), rtol=1e-8, msg=name)
    np.testing.assert_array_equal(m3.z_mask.numpy(), np.asarray(mj3.z_mask))
    agt.checkpoint.save(str(tmp_path / "port"), m3, s3)
    assert_same_leaves(agt.checkpoint.load(str(tmp_path / "port"), allow_pickle=True), (m3, s3))


def test_reference_mosvgp_checkpoint_loads_and_resumes(data, tmp_path):
    """test_engines.py:853's model: A, its Adam state and the per-task local
    variables carried bit-equal; 3 resumed iterations at rtol 1e-8."""
    X, f, y = data
    ys = [f, y]
    mj, mt = mo_pair(X)
    mj, sj = agp.mo_train(mj, X, ys, iterations=6)
    agp.checkpoint.save(str(tmp_path / "ref"), mj, sj)
    yt = tuple(t(a) for a in ys)
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ref"), mt, agt.mo_init_state(mt, t(X), yt))
    assert_bit_equal_to_reference(m2, s2, mj, sj)
    mj3, sj3 = agp.mo_train(mj, X, ys, iterations=3, state=sj)
    m3, s3 = agt.mo_train(m2, t(X), yt, iterations=3, state=s2)
    for name in ("mu", "Sigma"):
        close(getattr(s3, name), getattr(sj3, name), rtol=1e-8, msg=name)
    close(m3.A, mj3.A, rtol=1e-8)
    close(s3.A_state["mu"], sj3.A_state[0].mu, rtol=1e-8)


def test_checkpoint_shape_mismatch_rejected(data, tmp_path):
    """test_engines.py:879: a template of another M is refused with
    ValueError, for the reference's checkpoint and for the port's."""
    X, f, y = data

    def port(m):
        mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                             t(X[:m]), optimiser=None)
        return mt, agt.init_state(mt, t(X), t(y))

    mj = agp.SVGP.create(agp.SqExponentialKernel(), agp.GaussianLikelihood.create(0.05, opt_noise=False),
                         agp.AnalyticVI(), jnp.asarray(X[:8]), optimiser=None)
    mj, sj = agp.train(mj, X, y, iterations=2)
    agp.checkpoint.save(str(tmp_path / "ref"), mj, sj)
    with pytest.raises(ValueError, match="shape"):
        agt.checkpoint.load(str(tmp_path / "ref"), *port(10))
    agt.checkpoint.save(str(tmp_path / "port"), *port(8))
    with pytest.raises(ValueError, match="shape"):
        agt.checkpoint.load(str(tmp_path / "port"), *port(10))
    # another structure: a learnt noise adds the rule's state
    mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05, opt_noise=True),
                         agt.AnalyticVI(), t(X[:8]), optimiser=None)
    with pytest.raises(ValueError, match="leaves"):
        agt.checkpoint.load(str(tmp_path / "port"), mt, agt.init_state(mt, t(X), t(y)))
    with pytest.raises(ValueError, match="leaves"):
        agt.checkpoint.load(str(tmp_path / "ref"), mt, agt.init_state(mt, t(X), t(y)))


@pytest.mark.parametrize("family", ["svgp_stochastic", "vgp", "vstp", "gp", "movgp"])
def test_reference_checkpoint_loads_bit_equal(family, runs, tmp_path):
    """The stochastic SVGP with Adam on the kernel (the Robbins-Monro count,
    optax's Adam states, the PRNG key dropped), the dense VGP, the VStP
    (its prior's nu beside the likelihood's, its prior state), the exact GP
    (alpha and its Cholesky factor, no eta) and a MOVGP: every leaf
    bit-equal; a float32 template takes the same values in float32."""
    (mj, sj), (mt, st) = runs(family)
    agp.checkpoint.save(str(tmp_path / "ref"), mj, sj)
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ref"), mt, st)
    assert_bit_equal_to_reference(m2, s2, mj, sj)
    m32, s32 = agt.checkpoint.load(str(tmp_path / "ref"), mt.to(dtype=torch.float32), st.to(dtype=torch.float32))
    for (p, a), (_, b) in zip(named_leaves(s32, "state") + named_leaves(m32, "model"),
                              named_leaves(s2, "state") + named_leaves(m2, "model")):
        want = b.float() if b.is_floating_point() else b
        assert a.dtype == want.dtype and torch.equal(a, want), p


def test_float64_checkpoint_onto_float32_template(data, tmp_path):
    """The port's own float64 checkpoint loads onto a float32 template: each
    tensor in the template's dtype, equal to the float64 one rounded."""
    X, f, y = data
    mt = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(10), t(X[:8]))
    m1, s1 = agt.train(mt, t(X), t(np.sign(f)), iterations=4)
    agt.checkpoint.save(str(tmp_path / "ck"), m1, s1)
    X32 = t(X).float()
    m32 = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(10), X32[:8])
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ck"), m32, agt.init_state(m32, X32, torch.sign(X32[:, 0])))
    for (p, a), (_, b) in zip(named_leaves(s2, "state"), named_leaves(s1, "state")):
        want = b.float() if b.is_floating_point() else b
        assert a.dtype == want.dtype and torch.equal(a, want), p
    assert m2.Z.dtype == torch.float32 and torch.equal(m2.kernel.lengthscale, m1.kernel.lengthscale.float())
