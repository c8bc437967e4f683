"""The port's CUDA kernels against their plain versions on the card, the
wrappers' refusals, and the main paths' launch counts.  These tests need an NVIDIA GPU and skip
elsewhere; the file imports no JAX so that it runs on a machine with a card
(``python -m pytest tests/test_torch_cuda.py -m cuda``)."""
import numpy as np
import pytest
import torch

import agp_tpu_torch as agt
import chip_smoke as smoke
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.ops import linalg

LS, VAR, RHO, JITT = 2.0, 1.0, 40.0, 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


KERNEL_OF = {kind: cls for cls, kind in agt.kernels.FUSED_KINDS.items()}
def kernel_inputs(b, m, d, device, seed=0, kind="rbf", lik="logistic"):
    """Float32 inputs on ``device``: Z from the data as the main path takes
    it, K^-1 from the gram of ``kind``, a random SPD Sigma, labels and
    (p0, p1) of likelihood ``lik``."""
    from agp_tpu_torch.inference.analytic_vi import _fused_lik_spec

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(m, m))
    arrays = dict(
        X=X[m:], Z=X[:m], y=smoke.single_latent_labels(lik, np.sin(X[m:, 0]), rng),
        mu=rng.normal(size=m), Sigma=A @ A.T / m + np.eye(m),
    )
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
    kern = KERNEL_OF[kind](lengthscale=LS, variance=VAR)
    L = linalg.safe_cholesky(kern.gram(t["Z"].double()), JITT)
    eye = torch.eye(m, dtype=torch.float64, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.float()
    _, t["p0"], t["p1"], _ = _fused_lik_spec(smoke.single_latent_lik(agt, lik).to(device=device, dtype=torch.float32))
    t["kind"], t["lik"] = kind, lik
    return t


def call(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], LS, VAR, JITT, RHO,
              lik_p0=t["p0"], lik_p1=t["p1"], kind=t["kind"], lik=t["lik"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(4096, 64), (300, 64), (4096, 128)])
def test_cuda_kernel_matches_plain(cuda_device, b, m):
    """CUDA kernel against the plain version on the same card tensors, both
    float32.  The sums run in another order; the tolerance is 1e-4 of each
    output's largest entry (float32 against float64 the plain version is off
    by ~1e-6 here, where Kmm has cond ~5)."""
    t = kernel_inputs(b, m, 20, cuda_device)
    before = ck.fused_cavi_stats.launches
    out = call(ck.fused_cavi_stats, t)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 1
    ref = call(ck.fused_cavi_stats_reference, t)
    for name, o, r in zip(("s1", "S2", "c", "theta", "mf", "vf"), out, ref):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [4096, 300])
@pytest.mark.parametrize("lik", list(ck.LIKS))
def test_cuda_kernel_branch_matches_plain(cuda_device, lik, b):
    """Each likelihood branch (rbf, M=64, D=20) against the plain version
    on the same card tensors, both float32: 1e-4 of each output's largest
    entry, as above."""
    assert_kernel_matches_plain(ck.fused_cavi_stats, ck.fused_cavi_stats_reference, call,
                                kernel_inputs(b, 64, 20, cuda_device, lik=lik), ("s1", "S2", "c", "theta", "mf", "vf"))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 128])
@pytest.mark.parametrize("kind", list(KERNEL_OF))
def test_cuda_kernel_kind_matches_plain(cuda_device, kind, m):
    """Each gram kind (Student-t, B=4096, D=20) against the plain version,
    as above."""
    assert_kernel_matches_plain(ck.fused_cavi_stats, ck.fused_cavi_stats_reference, call,
                                kernel_inputs(4096, m, 20, cuda_device, kind=kind, lik="studentt"),
                                ("s1", "S2", "c", "theta", "mf", "vf"))


@pytest.mark.cuda
@pytest.mark.parametrize("lik,kind", [(lik, "rbf") for lik in ck.LIKS] + [("studentt", k) for k in ck.KINDS[1:]])
def test_cuda_kernel_oracle_shape_matches_plain(cuda_device, lik, kind):
    """Each likelihood branch (rbf) and Matern kind (Student-t) at the
    oracle paths' shape (B=8192, D=2, M=128, Z on the batch's rows,
    lengthscale 1), where float32 fixes the outputs only to ~5e-3: each
    output against the plain version in float64 on the same inputs, within
    max(1e-4, FLOAT32_FACTOR times the float32 plain version's own error)."""
    t = smoke.branch_inputs(agt, smoke.OB, smoke.OM, cuda_device, lik, kind, at="oracle")
    before = ck.fused_cavi_stats.launches
    out = smoke.call_branch(ck.fused_cavi_stats, t)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 1
    ref = smoke.call_branch(ck.fused_cavi_stats_reference, t)
    ref64 = smoke.call_branch(ck.fused_cavi_stats_reference, smoke.to_float64(t))
    smoke.check_outputs(f"{lik}/{kind}", ("s1", "S2", "c", "theta", "mf", "vf"), out, ref, ref64)


@pytest.mark.cuda
def test_cuda_wrapper_raises(cuda_device):
    """On a CUDA tensor the wrapper launches or raises: no fallback for a
    likelihood, kind, dtype or shape the kernel does not take."""
    t = kernel_inputs(64, 16, 4, cuda_device)
    before = ck.fused_cavi_stats.launches
    with pytest.raises(ValueError, match="likelihoods"):
        call(ck.fused_cavi_stats, {**t, "lik": "softmax"})
    with pytest.raises(ValueError, match="kinds"):
        call(ck.fused_cavi_stats, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        call(ck.fused_cavi_stats, {**t, "X": t["X"].double()})
    big = kernel_inputs(64, ck.MAX_M + 1, 4, cuda_device)
    with pytest.raises(ValueError, match="M <="):
        call(ck.fused_cavi_stats, big)
    assert ck.fused_cavi_stats.launches == before


@pytest.mark.cuda
def test_train_launches_once_per_step(cuda_device):
    rng = np.random.default_rng(1)
    X = torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32, device=cuda_device)
    y = torch.where(X[:, 0] > 0, 1.0, -1.0)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
        agt.AnalyticSVI(512, minibatch_sampling="block"), X[:32], optimiser=None,
    )
    before = ck.fused_cavi_stats.launches
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 20
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


def multi_inputs(b, m, n_latent, d, device, seed=0, kind="rbf"):
    """Float32 card tensors for the multi-latent kernels: per-latent ARD
    lengthscales, Z from the data, K^-1 from the gram of ``kind``, random
    SPD Sigma, one-hot labels (multiclass) and real targets
    (heteroscedastic)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(n_latent, m, m))
    ls = rng.uniform(1.5, 2.5, size=(n_latent, d))
    arrays = dict(
        X=X[m:], Z=np.stack([X[:m]] * n_latent), ls=ls, var=rng.uniform(0.8, 1.2, size=n_latent),
        mu=rng.normal(size=(n_latent, m)), Sigma=A @ A.transpose(0, 2, 1) / m + np.eye(m),
        onehot=np.eye(n_latent)[rng.integers(0, n_latent, size=b)], yr=np.sin(X[m:, 0]),
        alpha=rng.uniform(1.0, 2.0 * n_latent, size=b), beta=np.full(b, float(n_latent)),
    )
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in arrays.items()}
    kern = KERNEL_OF[kind]()
    L = torch.stack([linalg.safe_cholesky(kern.gram(t["Z"][l].double() / t["ls"][l].double()) * float(arrays["var"][l]), JITT)
                     for l in range(n_latent)])
    eye = torch.eye(m, dtype=torch.float64, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).mT.float().contiguous()
    t["kind"] = kind
    return t


def call_mc(fn, t):
    return fn(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], JITT, RHO,
              t["alpha"], t["beta"], kind=t["kind"])


def call_het(fn, t, lam=3.0):
    return fn(t["X"], t["yr"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], JITT, RHO, lam,
              kind=t["kind"])


def assert_kernel_matches_plain(wrapper, plain, call, t, names):
    before = wrapper.launches
    out = call(wrapper, t)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = call(plain, t)
    for name, o, r in zip(names, out, ref):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(2048, 64), (300, 64), (2048, 128)])
def test_cuda_multiclass_kernel_matches_plain(cuda_device, b, m):
    """fused_cavi_stats_multiclass at K=10, D=10 against its plain version on
    the same card tensors, both float32: 1e-4 of each output's largest
    entry (sums in another order, the series digamma against
    torch.special.digamma)."""
    t = multi_inputs(b, m, 10, 10, cuda_device)
    assert_kernel_matches_plain(ck.fused_cavi_stats_multiclass, ck.fused_cavi_stats_multiclass_reference, call_mc, t,
                                ("s1", "S2", "c", "theta", "gamma", "alpha"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m", [(2048, 64), (300, 64), (2048, 128)])
def test_cuda_het_kernel_matches_plain(cuda_device, b, m):
    """fused_cavi_stats_het at D=10 against its plain version, as above."""
    t = multi_inputs(b, m, 2, 10, cuda_device)
    assert_kernel_matches_plain(ck.fused_cavi_stats_het, ck.fused_cavi_stats_het_reference, call_het, t,
                                ("s1", "S2", "c", "phi", "gamma", "theta", "sigg"))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["matern12", "matern32", "matern52"])
@pytest.mark.parametrize("which", ["multiclass", "het"])
def test_cuda_multi_kernels_matern_match_plain(cuda_device, which, kind):
    """Kernels 2 (K=10) and 3 with each Matern kind at B=2048, M=64, D=10,
    as above."""
    n_latent = 10 if which == "multiclass" else 2
    t = multi_inputs(2048, 64, n_latent, 10, cuda_device, kind=kind)
    if which == "multiclass":
        assert_kernel_matches_plain(ck.fused_cavi_stats_multiclass, ck.fused_cavi_stats_multiclass_reference, call_mc,
                                    t, ("s1", "S2", "c", "theta", "gamma", "alpha"))
    else:
        assert_kernel_matches_plain(ck.fused_cavi_stats_het, ck.fused_cavi_stats_het_reference, call_het, t,
                                    ("s1", "S2", "c", "phi", "gamma", "theta", "sigg"))


@pytest.mark.cuda
def test_cuda_multi_wrappers_raise(cuda_device):
    """On a CUDA tensor the wrappers launch or raise: no fallback for a
    kind, dtype or shape their kernels do not take."""
    t = multi_inputs(64, 16, 3, 4, cuda_device)
    with pytest.raises(ValueError, match="kinds"):
        call_mc(ck.fused_cavi_stats_multiclass, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        call_mc(ck.fused_cavi_stats_multiclass, {**t, "X": t["X"].double()})
    big = multi_inputs(64, ck.MAX_M + 1, 2, 4, cuda_device)
    with pytest.raises(ValueError, match="M <="):
        call_het(ck.fused_cavi_stats_het, big)
    with pytest.raises(ValueError, match="2 latents"):
        call_het(ck.fused_cavi_stats_het, t)
    th = multi_inputs(64, 16, 2, 4, cuda_device)
    with pytest.raises(ValueError, match="kinds"):
        call_het(ck.fused_cavi_stats_het, {**th, "kind": "periodic"})


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["multiclass", "het"])
def test_train_multi_latent_launches_once_per_step(cuda_device, which):
    rng = np.random.default_rng(2)
    X = torch.as_tensor(rng.normal(size=(4096, 6)), dtype=torch.float32, device=cuda_device)
    if which == "multiclass":
        lik, y, wrapper = agt.LogisticSoftMaxLikelihood.create(4), torch.argmax(X[:, :4], dim=1), ck.fused_cavi_stats_multiclass
    else:
        lik, y, wrapper = agt.HeteroscedasticLikelihood.create(), torch.sin(X[:, 0]), ck.fused_cavi_stats_het
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik,
                            agt.AnalyticSVI(512, minibatch_sampling="slice"), X[:32], optimiser=None)
    before = wrapper.launches
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 20
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["SqExponentialKernel", "Matern12Kernel"])
def test_train_poisson_launches_once_per_step(cuda_device, kernel):
    """The Poisson path: one launch per step, lambda rewritten on the device
    every step (finite, moved from its start)."""
    rng = np.random.default_rng(3)
    X = torch.as_tensor(rng.uniform(-2, 2, size=(4096, 2)), dtype=torch.float32, device=cuda_device)
    rate = 20.0 * torch.sigmoid(torch.sin(2 * X[:, 0]) + 0.5 * X[:, 1])
    y = torch.poisson(rate, generator=torch.Generator(device=cuda_device).manual_seed(0))
    model = agt.SVGP.create(getattr(agt, kernel)(), agt.PoissonLikelihood.create(10.0),
                            agt.AnalyticSVI(1024, minibatch_sampling="slice"), X[:64], optimiser=None)
    before = ck.fused_cavi_stats.launches
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 20
    lam = model.likelihood.lam
    assert lam.device.type == "cuda" and bool(torch.isfinite(lam)) and abs(float(lam) - 10.0) > 1e-3
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


# ------------------------------------------------------- the batched pair
def pair_case(b, m, n_latent, d, device, kind="rbf"):
    """Card tensors of kernels 4 and 5, made as chip_smoke.pair_inputs makes
    them from standard normal data (lengthscale 2: well conditioned)."""
    X = torch.as_tensor(np.random.default_rng(4).normal(size=(max(b, m), d)), dtype=torch.float32)
    return smoke.pair_inputs(X, b, m, n_latent, device, kind=kind)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n_latent,d,kind", [
    (300, 129, 1, 20, "rbf"), (300, 129, 2, 20, "matern12"), (300, 129, 3, 5, "matern32"), (333, 64, 3, 37, "matern52"),
    (4096, 512, 1, 20, "rbf"), (1000, 1024, 2, 20, "rbf"), (700, 1680, 1, 20, "rbf"),
])
def test_cuda_pair_matches_plain(cuda_device, b, m, n_latent, d, kind):
    """Kernels 4 and 5 against their plain versions on the same card
    tensors, both float32: 1e-4 of each output's largest entry (at most
    M=1,680, where kernel 4 takes 16-row tiles); S2 exactly symmetric."""
    t = pair_case(b, m, n_latent, d, cuda_device, kind)
    before = (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches)
    got = smoke.call_k4(ck.fused_kappa_moments_batched, t)
    s_got = ck.cavi_stats_batched(got[0], t["g"], t["theta"])
    torch.cuda.synchronize()
    assert (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches) == (before[0] + 1, before[1] + 1)
    ref = smoke.call_k4(ck.fused_kappa_moments_batched_reference, t)
    s_ref = ck.cavi_stats_batched_reference(got[0], t["g"], t["theta"])
    for name, o, r in zip(("kappa", "mf", "vf", "s1", "S2"), (*got, *s_got), (*ref, *s_ref)):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)
    assert torch.equal(s_got[1], s_got[1].mT)


@pytest.mark.cuda
def test_cuda_pair_autograd_matches_plain(cuda_device):
    smoke.phase_pair_autograd(ck, cuda_device)


@pytest.mark.cuda
def test_cuda_pair_wrappers_raise(cuda_device):
    """On a CUDA tensor the pair launches or raises: an unknown kind,
    float64, a wrong shape, or M beyond kernel 4's shared memory (past
    kappa_max_m("moments"), 2,392 on an H100)."""
    t = pair_case(64, 16, 2, 4, cuda_device)
    before = (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches)
    with pytest.raises(ValueError, match="kinds"):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "X": t["X"].double()})
    with pytest.raises(ValueError):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "mu": t["mu"][:1]})
    big = pair_case(8, ck.kappa_max_m("moments") + 1, 1, 2, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
        smoke.call_k4(ck.fused_kappa_moments_batched, big)
    kappa = torch.zeros((2, 64, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ck.cavi_stats_batched(kappa, t["g"].double(), t["theta"])
    with pytest.raises(ValueError):
        ck.cavi_stats_batched(kappa, t["g"][:, :10], t["theta"])
    assert (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["logistic", "poisson", "multiclass", "het"])
def test_train_beyond_the_fused_range_launches_the_pair(cuda_device, which):
    """M=130 (and M=128 at D=46 for one latent), beyond the fused kernels'
    shared memory: each step launches one kernel of the single-latent
    split pair (6-7, one latent) or of the batched pair (4-5, several)
    each, no fused kernel, and the posterior stays finite."""
    rng = np.random.default_rng(5)
    d = 46 if which == "logistic" else 3
    m = 128 if which == "logistic" else 130
    X = torch.as_tensor(rng.normal(size=(2048, d)), dtype=torch.float32, device=cuda_device)
    lik, y = {
        "logistic": (agt.LogisticLikelihood.create(), torch.sign(X[:, 0])),
        "poisson": (agt.PoissonLikelihood.create(5.0), torch.poisson(5.0 * torch.sigmoid(X[:, 0]))),
        "multiclass": (agt.LogisticSoftMaxLikelihood.create(3), torch.argmax(X, dim=1)),
        "het": (agt.HeteroscedasticLikelihood.create(), torch.sin(X[:, 0])),
    }[which]
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), lik,
                            agt.AnalyticSVI(512, minibatch_sampling="slice"), X[:m], optimiser=None)
    smoke.reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, which, smoke.route_launches(20, "single" if which in ("logistic", "poisson") else "batched"))
    assert torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


@pytest.mark.cuda
def test_numpy_inputs_land_on_the_card(cuda_device):
    """Arrays without a device go to the card by default, floating ones in
    torch's default float32, and train there through the kernels."""
    rng = np.random.default_rng(6)
    X = rng.normal(size=(1024, 4))
    y = np.where(X[:, 0] > 0, 1.0, -1.0)
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                            agt.AnalyticSVI(256), X[:32], optimiser=None)
    assert model.Z.device.type == "cuda" and model.Z.dtype == torch.float32
    before = ck.fused_cavi_stats.launches
    model, state = agt.train(model, X, y, iterations=10)
    assert ck.fused_cavi_stats.launches == before + 10
    assert agt.predict_y(model, state, X).device.type == "cuda"


# ------------------------------------------ the single-latent split pair
@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d,kind,f64", [
    (300, 129, 20, "rbf", False), (300, 129, 5, "matern12", False), (333, 64, 37, "matern32", False),
    (300, 130, 8, "matern52", False), (4096, 512, 20, "rbf", False), (1000, 1024, 20, "rbf", False),
    (700, 1680, 20, "rbf", False), (64, 1681, 20, "rbf", False),
    (300, 130, 3, "matern52", True), (64, 1681, 2, "rbf", True),
])
def test_cuda_single_pair_matches_plain(cuda_device, b, m, d, kind, f64):
    """Kernels 6 and 7 against their plain versions on the same card
    tensors, both float32: 1e-4 of each output's largest entry (up to
    M=1,681, kernel 6's 16-row tiles); one launch each; S2 exactly
    symmetric.  Where M inducing
    points crowd a low-D space (f64), float32 fixes kappa and Ktilde only
    coarsely (on an H100 kernel and plain version differ there by 2.2e-3
    in kappa at M=1,681, D=2, and 2.3e-4 in Ktilde at M=130, D=3), so
    each output is held against the plain version in float64 on the same
    inputs, within FLOAT32_FACTOR times the float32 plain version's own
    error, as chip_smoke.py holds the ill-conditioned oracle shape."""
    t = smoke.single_args(pair_case(b, m, 1, d, cuda_device, kind))
    before = (ck.fused_kappa.launches, ck.cavi_stats.launches)
    got = smoke.call_k6(ck.fused_kappa, t)
    s_got = ck.cavi_stats(got[0], t["g"], t["theta"])
    torch.cuda.synchronize()
    assert (ck.fused_kappa.launches, ck.cavi_stats.launches) == (before[0] + 1, before[1] + 1)
    label = f"{b}-{m}-{d}-{kind}"
    ref = smoke.call_k6(ck.fused_kappa_reference, t)
    ref64 = smoke.call_k6(ck.fused_kappa_reference, smoke.to_float64(t)) if f64 else None
    smoke.check_outputs(f"fused_kappa {label}", ("kappa", "Ktilde"), got, ref, ref64)
    s_ref = ck.cavi_stats_reference(got[0], t["g"], t["theta"])
    s64 = ck.cavi_stats_reference(got[0].double(), t["g"].double(), t["theta"].double()) if f64 else None
    smoke.check_outputs(f"cavi_stats {label}", ("s1", "S2"), s_got, s_ref, s64)
    assert torch.equal(s_got[1], s_got[1].T)


# ------------------------------------- kernels 5 and 7 on the tensor cores
def stats_case(b, m, n_latent, device, seed):
    """kappa [L, B, M] standard normal, g normal and theta uniform on
    [0, 0.5] with about a quarter of it zero, float32 on the card."""
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0.0, 0.5, size=(n_latent, b))
    theta[rng.uniform(size=(n_latent, b)) < 0.25] = 0.0
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.as_tensor(rng.normal(size=(n_latent, b, m)), **f32),
            torch.as_tensor(rng.normal(size=(n_latent, b)), **f32), torch.as_tensor(theta, **f32))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 64, 129, 512, 1681])
@pytest.mark.parametrize("b", [1, 7, 300, 8192])
def test_cuda_stats_tc_match_plain(cuda_device, b, m):
    """Kernel 5 with L = 1, 2, 3 latents and kernel 7 (L = 1) against their
    plain versions on the same card tensors (stats_case): within 1e-4 of
    each output's largest entry, one launch a call, S2 exactly symmetric
    and a second call bit-equal to the first."""
    for n_latent in (1, 2, 3):
        kappa, g, theta = stats_case(b, m, n_latent, cuda_device, seed=m * 7919 + b + n_latent)
        calls = [(ck.cavi_stats_batched, ck.cavi_stats_batched_reference, (kappa, g, theta))]
        if n_latent == 1:
            calls.append((ck.cavi_stats, ck.cavi_stats_reference, (kappa[0], g[0], theta[0])))
        for fn, plain, args in calls:
            label = f"{fn.__name__} B={b} M={m} L={n_latent}"
            before = fn.launches
            got = fn(*args)
            torch.cuda.synchronize()
            assert fn.launches == before + 1, label
            smoke.check_outputs(label, ("s1", "S2"), got, plain(*args))
            smoke.check_stats_repeat(label, fn, args, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 512])
def test_cuda_stats_tc_unaligned_kappa(cuda_device, m):
    """kappa at an address that is not 16-byte aligned (a view one float
    into its storage) takes the 4-byte copies, as M % 4 != 0 does, and
    agrees with the plain version as above."""
    kappa, g, theta = stats_case(300, m, 1, cuda_device, seed=m)
    shifted = torch.empty(300 * m + 1, device=cuda_device)[1:].view(300, m)
    shifted.copy_(kappa[0])
    assert shifted.data_ptr() % 16 != 0
    got = ck.cavi_stats(shifted, g[0], theta[0])
    torch.cuda.synchronize()
    smoke.check_outputs(f"cavi_stats unaligned M={m}", ("s1", "S2"), got, ck.cavi_stats_reference(kappa[0], g[0], theta[0]))
    smoke.check_stats_repeat(f"cavi_stats unaligned M={m}", ck.cavi_stats, (shifted, g[0], theta[0]), got)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", *smoke.MATERN_KINDS])
def test_cuda_stats_tc_oracle_precision(cuda_device, kind):
    """At the M=512 oracle shape (B=8192, D=2, lengthscale 1, Z on the
    batch's rows; kappa from kernel 4's plain version, as phase 12 makes
    it) kernels 5 and 7 against the plain version in float64, within
    FLOAT32_FACTOR times the float32 plain version's own error with no
    KERNEL_TOL floor: one TF32 pass, or the tensor cores' truncating sum
    carried over a whole chunk, falls outside it."""
    X = smoke.oracle_data("studentt", "cpu")[0]
    t = smoke.pair_inputs(X, smoke.OB, smoke.PM, 1, cuda_device, kind=kind, ls=1.0)
    kappa = smoke.call_k4(ck.fused_kappa_moments_batched_reference, t)[0].contiguous()
    g, theta = t["g"], t["theta"]
    for fn, plain, args in ((ck.cavi_stats_batched, ck.cavi_stats_batched_reference, (kappa, g, theta)),
                            (ck.cavi_stats, ck.cavi_stats_reference, (kappa[0], g[0], theta[0]))):
        got = fn(*args)
        torch.cuda.synchronize()
        s64 = plain(*(a.double() for a in args))
        smoke.check_outputs(f"{fn.__name__} {kind} oracle M={smoke.PM}", ("s1", "S2"), got, plain(*args), s64,
                            floor=0.0)


# ------------------------------------- kernels 4 and 6 on the tensor cores
def kappa_calls(t):
    """(label, wrapper, plain version, call, output names) of kernels 4 and
    6 on pair_inputs' tensors (kernel 6 on the first latent)."""
    return (("fused_kappa_moments_batched", ck.fused_kappa_moments_batched, ck.fused_kappa_moments_batched_reference,
             smoke.call_k4, t, ("kappa", "mf", "vf")),
            ("fused_kappa", ck.fused_kappa, ck.fused_kappa_reference, smoke.call_k6, smoke.single_args(t),
             ("kappa", "Ktilde")))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rbf", *smoke.MATERN_KINDS])
def test_cuda_kappa_tc_oracle_precision(cuda_device, kind):
    """At the M=512 oracle shape (B=8192, D=2, lengthscale 1, Z on the
    batch's rows, cond(Kmm) ~1e5, as phase 12 makes it) kernels 4 and 6
    against their plain versions in float64, within FLOAT32_FACTOR times
    the float32 plain version's own error with no KERNEL_TOL floor: one
    TF32 pass, or the tensor cores' truncating sum carried over a long
    accumulation, falls outside it; a second call bit-equal."""
    X = smoke.oracle_data("studentt", "cpu")[0]
    t = smoke.pair_inputs(X, smoke.OB, smoke.PM, 1, cuda_device, kind=kind, ls=1.0)
    for name, fn, plain, call, args, names in kappa_calls(t):
        got = call(fn, args)
        torch.cuda.synchronize()
        label = f"{name} {kind} oracle M={smoke.PM}"
        smoke.check_outputs(label, names, got, call(plain, args), call(plain, smoke.to_float64(args)), floor=0.0)
        smoke.check_repeat(label, lambda: call(fn, args), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d,n_latent,kernels", [
    (300, 129, 20, 1, "both"), (300, 129, 20, 3, "moments"), (700, 1680, 20, 1, "both"), (64, 2392, 2, 2, "moments"),
    (300, 2158, 20, 1, "both"), (65, 2406, 3, 1, "single"), (333, 697, 5, 1, "both"), (7, 681, 37, 2, "moments"),
])
def test_cuda_kappa_tc_keep_the_range(cuda_device, b, m, d, n_latent, kernels):
    """Every shape the FP32 kernels took, and the tile edges (64-row tiles
    to M=680 for kernel 4 and M=696 for kernel 6, 32 to 1,392 and 1,408,
    16 to 2,392 and 2,406): ragged B and M, 1-3 latents; against the plain
    version in float64, within FLOAT32_FACTOR times the float32 plain
    version's own error or 1e-4 of each output's largest entry, whichever
    is larger (M points crowd a low-D space: float32 fixes kappa there
    only coarsely); one launch a call, and a second call bit-equal."""
    t = pair_case(b, m, n_latent, d, cuda_device)
    for name, fn, plain, call, args, names in kappa_calls(t):
        if kernels != "both" and (name == "fused_kappa") != (kernels == "single"):
            continue
        before = fn.launches
        got = call(fn, args)
        torch.cuda.synchronize()
        assert fn.launches == before + 1, name
        label = f"{name} B={b} M={m} D={d} L={n_latent}"
        smoke.check_outputs(label, names, got, call(plain, args), call(plain, smoke.to_float64(args)))
        smoke.check_repeat(label, lambda: call(fn, args), got)


@pytest.mark.cuda
def test_cuda_kappa_autograd_matches_plain(cuda_device):
    smoke.phase_kappa_autograd(ck, cuda_device)


@pytest.mark.cuda
def test_cuda_single_pair_wrappers_raise(cuda_device):
    """On a CUDA tensor the single-latent pair launches or raises: an
    unknown kind, float64, a wrong shape, or M beyond kernel 6's shared
    memory (past kappa_max_m("single"), 2,406 on an H100)."""
    t = smoke.single_args(pair_case(64, 16, 1, 4, cuda_device))
    before = (ck.fused_kappa.launches, ck.cavi_stats.launches)
    with pytest.raises(ValueError, match="kinds"):
        smoke.call_k6(ck.fused_kappa, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        smoke.call_k6(ck.fused_kappa, {**t, "X": t["X"].double()})
    with pytest.raises(ValueError):
        smoke.call_k6(ck.fused_kappa, {**t, "Z": t["Z"][:, :2].contiguous()})
    big = smoke.single_args(pair_case(8, ck.kappa_max_m("single") + 1, 1, 2, cuda_device))
    with pytest.raises(ValueError, match="shared memory"):
        smoke.call_k6(ck.fused_kappa, big)
    kappa = torch.zeros((64, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ck.cavi_stats(kappa, t["g"].double(), t["theta"])
    with pytest.raises(ValueError):
        ck.cavi_stats(kappa, t["g"][:10], t["theta"])
    assert (ck.fused_kappa.launches, ck.cavi_stats.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 130])
def test_train_with_the_default_adam_launches_kernel_6(cuda_device, m):
    """The reference's default optimiser on the card: 10 iterations with a
    hyperparameter step after iterations 3..9 launch kernel 6 once a
    hyperparameter step (its backward runs the plain version), beside the
    CAVI step's kernel 1 (M=64) or kernels 6-7 (M=130); the
    log-hyperparameters move and stay finite."""
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32, device=cuda_device)
    y = torch.sign(X[:, 0] + 0.5 * X[:, 1])
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                            agt.AnalyticSVI(1024, minibatch_sampling="slice"), X[:m])
    smoke.reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=10)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, f"M={m}", smoke.route_launches(10, "fused" if m == 64 else "single", hyper_steps=7))
    logs = smoke.log_hypers(model)
    assert torch.isfinite(logs).all() and float((logs - torch.tensor([np.log(2.0), 0.0])).abs().max()) > 1e-2
    assert torch.isfinite(state.mu).all()


# ---------------------------------------------- the bench's kernels (8-10)
# the edges of kernels 8-9's row tiles beside phase 16's cases: one row and
# one inducing point, M=127 and 128 (the narrow tile's last; packed leaves
# it at 128), M=128 at D=44 and D=45 (past the fused kernels' range: any D
# since the tensor-core design), the largest M of 64-row (680) and 32-row
# (1,392) tiles and of the kernels (2,392, 16-row tiles) and one past each
VARIANT_EDGES = [(1, 3, 1), (65, 8, 127), (65, 44, 128), (65, 45, 128), (70, 8, 680), (70, 8, 681), (40, 8, 1392),
                 (40, 8, 1393), (20, 8, 2392)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,d,m", list(smoke.VARIANT_CASES) + VARIANT_EDGES)
def test_cuda_fused_variants_match_plain(cuda_device, b, d, m):
    """Kernels 8 (every variant) and 9 against their plain versions on the
    same card tensors (the sweep's inputs), against the plain version in
    float64 within FLOAT32_FACTOR times the float32 plain version's own
    error or 1e-4 of each output's largest entry, whichever is larger (at
    these 8-D shapes the float32 plain version is within ~1e-6); one
    launch each; a second call bit-equal.  B=300, 65, 70 and others leave
    a ragged last tile, whose rows the plain versions do not have."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    t = bench.sweep_inputs(b, d, m, cuda_device)
    t64 = smoke.to_float64(t)
    for label, (kern, plain, kw) in smoke.variant_kernels(fv).items():
        before = kern.launches
        got = smoke.sweep_call(kern, t, **kw)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        smoke.check_outputs(f"{label} B={b} D={d} M={m}", smoke.STATS_NAMES, got, smoke.sweep_call(plain, t, **kw),
                            smoke.sweep_call(plain, t64, **kw))
        smoke.check_repeat(label, lambda: smoke.sweep_call(kern, t, **kw), got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [smoke.OM, smoke.PM])
def test_cuda_fused_variants_ill_conditioned(cuda_device, m):
    """Kernels 8 (every variant) and 9 (and kernel 1 at M=128) at the
    oracle shapes (B=8192, D=2, M=128 or 512, lengthscale 1), Sigma = 0:
    each output against its plain version in float64 within FLOAT32_FACTOR
    times the float32 plain version's own error, with no floor for kernels
    8-9 (chip_smoke.check_outputs)."""
    from agp_tpu_torch.benchmarks import fused_variants as fv

    t = smoke.ill_conditioned_inputs(agt, cuda_device, m)
    cases = [(fn, plain, kw, 0.0) for fn, plain, kw in smoke.variant_kernels(fv).values()]
    if m == smoke.OM:
        cases.append((ck.fused_cavi_stats, ck.fused_cavi_stats_reference, {"kind": "rbf", "lik": "logistic"},
                      smoke.KERNEL_TOL))
    for fn, plain, kw, floor in cases:
        got = smoke.ill_call(fn, t, **kw)
        torch.cuda.synchronize()
        smoke.check_outputs(f"{fn.__name__} {kw} M={m}", smoke.STATS_NAMES, got, smoke.ill_call(plain, t, **kw),
                            smoke.ill_call(plain, smoke.to_float64(t), **kw), floor=floor)


@pytest.mark.cuda
def test_cuda_fused_variants_raise(cuda_device):
    """On a CUDA tensor kernels 8-9 launch or raise: float64, M one past
    the largest their row tiles take (variant_max_m, 2,392 on an H100), a
    wrong shape, an unknown variant."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    t = bench.sweep_inputs(64, 4, 16, cuda_device)
    before = (fv.direct_stats.launches, fv.two_factor_nt.launches)
    with pytest.raises(TypeError):
        smoke.sweep_call(fv.direct_stats, {**t, "X": t["X"].double()})
    edge = fv.variant_max_m(fv._smem_limit(cuda_device.index or 0))
    assert edge == 2392
    big = bench.sweep_inputs(8, 2, edge + 1, cuda_device)
    for kern, kw in ((fv.two_factor_nt, {}), (fv.direct_stats, {"variant": "packed"})):
        with pytest.raises(ValueError, match=f"M <= {edge}"):
            smoke.sweep_call(kern, big, **kw)
    with pytest.raises(ValueError):
        smoke.sweep_call(fv.two_factor_nt, {**t, "y": t["y"][:10]})
    with pytest.raises(ValueError, match="variants"):
        smoke.sweep_call(fv.direct_stats, t, variant="tn")
    assert (fv.direct_stats.launches, fv.two_factor_nt.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,tr,T,dtype,offset", [
    (200_000, 20, 32, 128, torch.int64, 0), (200_000, 20, 64, 64, torch.int64, 0), (200_000, 20, 32, 77, torch.int32, 0),
    (1000, 33, None, 9, torch.int64, 0), (1000, 33, 3, 50, torch.int64, 0), (1001, 6, 2, 40, torch.int32, 1),
])
def test_cuda_gather_equals_plain(cuda_device, n, d, tr, T, dtype, offset):
    """Kernel 10 bit-equal to index_select on the tile view (it is a copy),
    on 16-byte vectors and on the scalar paths (99-float tiles; a view that
    starts 24 bytes into its storage); one launch."""
    from agp_tpu_torch.benchmarks import gather_modes as gm

    X = torch.as_tensor(np.random.default_rng(8).normal(size=(n + offset, d)).astype(np.float32), device=cuda_device)
    X = X[offset:]
    rows = gm.gather_tile_rows(d) if tr is None else tr
    tidx = torch.randint(0, n // rows, (T,), device=cuda_device, generator=torch.Generator(device=cuda_device).manual_seed(0))
    tidx = tidx.to(dtype)
    before = gm.gather_row_tiles.launches
    got = gm.gather_row_tiles(X, tidx, tile_rows=tr)
    torch.cuda.synchronize()
    assert gm.gather_row_tiles.launches == before + 1
    assert torch.equal(got, gm.gather_row_tiles_reference(X, tidx, tile_rows=tr))


@pytest.mark.cuda
def test_cuda_gather_raises(cuda_device):
    """On a CUDA tensor kernel 10 launches or raises: float64 X, float
    indices, indices on the CPU, an empty draw."""
    from agp_tpu_torch.benchmarks import gather_modes as gm

    X = torch.zeros((640, 20), device=cuda_device)
    tidx = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    before = gm.gather_row_tiles.launches
    with pytest.raises(TypeError):
        gm.gather_row_tiles(X.double(), tidx)
    with pytest.raises(TypeError):
        gm.gather_row_tiles(X, tidx.float())
    with pytest.raises(ValueError):
        gm.gather_row_tiles(X, tidx.cpu())
    with pytest.raises(ValueError):
        gm.gather_row_tiles(X, tidx[:0])
    assert gm.gather_row_tiles.launches == before


@pytest.mark.cuda
def test_cuda_refuses_a_float64_model(cuda_device):
    """A float64 model on the card is refused when it is built, and one
    moved there later when its state is made: TypeError naming float32 and
    set_default_device("cpu"), before any kernel runs."""
    X = torch.as_tensor(np.random.default_rng(9).normal(size=(512, 3)), device=cuda_device)
    y = torch.sign(X[:, 0])
    make = lambda Z: agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),  # noqa: E731
                                     agt.AnalyticSVI(128), Z, optimiser=None)
    with pytest.raises(TypeError, match=r'float32.*set_default_device\("cpu"\)'):
        make(X[:16])
    moved = make(X[:16].float()).to(dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        agt.init_state(moved, X, y)
    with pytest.raises(TypeError, match="float32"):
        agt.train(moved, X, y, iterations=2)
    model, state = agt.train(make(X[:16].float()), X.float(), y.float(), iterations=2)
    assert torch.isfinite(state.mu).all()
