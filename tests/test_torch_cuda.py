"""The port's CUDA kernels against their plain versions on the card, the
wrappers' refusals, and the main paths' launch counts.  These tests need an NVIDIA GPU and skip
elsewhere; the file imports no JAX so that it runs on a machine with a card
(``python -m pytest tests/test_torch_cuda.py -m cuda``)."""
import sys

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
@pytest.mark.parametrize("lik,kind", [(lik, kind) for lik in ck.LIKS for kind in ck.KINDS])
def test_cuda_kernel_tile_edges_match_plain(cuda_device, lik, kind):
    """Every likelihood branch with every gram kind at a ragged B=300 and
    D=45 (fused since the tensor-core design: the gram is staged in chunks
    of features), at M = 1, 63, 64, 127 and 128 (odd M take the ring's
    4-byte copies; M=128 fills the row tile's one output tile): against
    the plain version on the same card tensors within 1e-4 of each
    output's largest entry, one launch a call, S2 exactly symmetric and a
    second call bit-equal."""
    for m in (1, 63, 64, 127, 128):
        t = kernel_inputs(300, m, 45, cuda_device, kind=kind, lik=lik)
        label = f"{lik}/{kind} B=300 D=45 M={m}"
        before = ck.fused_cavi_stats.launches
        got = call(ck.fused_cavi_stats, t)
        torch.cuda.synchronize()
        assert ck.fused_cavi_stats.launches == before + 1
        smoke.check_outputs(label, smoke.STATS_NAMES, got, call(ck.fused_cavi_stats_reference, t))
        smoke.check_stats_repeat(label, lambda: call(ck.fused_cavi_stats, t), (), got)


@pytest.mark.cuda
@pytest.mark.parametrize("lik,kind", [(lik, "rbf") for lik in ck.LIKS] + [("studentt", k) for k in ck.KINDS[1:]])
def test_cuda_kernel_oracle_shape_matches_plain(cuda_device, lik, kind):
    """Each likelihood branch (rbf) and Matern kind (Student-t) at the
    oracle paths' shape (B=8192, D=2, M=128, Z on the batch's rows,
    lengthscale 1), where float32 fixes the outputs only to ~5e-3: each
    output against the plain version in float64 on the same inputs, within
    FLOAT32_FACTOR times the float32 plain version's own error with no
    floor (the tensor-core design's 3xTF32 products); a second call
    bit-equal."""
    t = smoke.branch_inputs(agt, smoke.OB, smoke.OM, cuda_device, lik, kind, at="oracle")
    before = ck.fused_cavi_stats.launches
    out = smoke.call_branch(ck.fused_cavi_stats, t)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == before + 1
    ref = smoke.call_branch(ck.fused_cavi_stats_reference, t)
    ref64 = smoke.call_branch(ck.fused_cavi_stats_reference, smoke.to_float64(t))
    smoke.check_outputs(f"{lik}/{kind}", smoke.STATS_NAMES, out, ref, ref64, floor=0.0)
    smoke.check_repeat(f"{lik}/{kind}", lambda: smoke.call_branch(ck.fused_cavi_stats, t), out)


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
    lengthscales (1.5-2.5 at d=10, scaled by sqrt(d / 10)), Z from the
    data, K^-1 from the gram of ``kind``, random SPD Sigma, one-hot labels
    (multiclass) and real targets (heteroscedastic)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, d))
    A = rng.normal(size=(n_latent, m, m))
    ls = rng.uniform(1.5, 2.5, size=(n_latent, d)) * (d / 10) ** 0.5
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
    """One launch, every output finite and within 1e-4 of the plain
    version's largest entry; S2 exactly symmetric and a second call
    bit-equal."""
    before = wrapper.launches
    out = call(wrapper, t)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = call(plain, t)
    for name, o, r in zip(names, out, ref):
        assert torch.isfinite(o).all(), name
        err = float((o - r).abs().max()) / max(float(r.abs().max()), 1.0)
        assert err <= 1e-4, (name, err)
    smoke.check_stats_repeat(wrapper.__name__, lambda: call(wrapper, t), (), out)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(2048, 64, 10), (300, 64, 10), (2048, 128, 10), (2048, 128, 64), (300, 128, 64)])
def test_cuda_multiclass_kernel_matches_plain(cuda_device, b, m, d):
    """fused_cavi_stats_multiclass at K=10 against its plain version on the
    same card tensors, both float32: 1e-4 of each output's largest entry
    (sums in another order, the series digamma against
    torch.special.digamma); D=64 at M=128 is fused since kernels 2-3 stage
    the gram in chunks of features."""
    t = multi_inputs(b, m, 10, d, cuda_device)
    assert_kernel_matches_plain(ck.fused_cavi_stats_multiclass, ck.fused_cavi_stats_multiclass_reference, call_mc, t,
                                ("s1", "S2", "c", "theta", "gamma", "alpha"))


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,d", [(2048, 64, 10), (300, 64, 10), (2048, 128, 10), (2048, 128, 64), (300, 128, 64)])
def test_cuda_het_kernel_matches_plain(cuda_device, b, m, d):
    """fused_cavi_stats_het against its plain version, as above."""
    t = multi_inputs(b, m, 2, d, cuda_device)
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
@pytest.mark.parametrize("kind", list(ck.KINDS))
@pytest.mark.parametrize("name", list(smoke.MULTI_KERNELS))
def test_cuda_multi_tc_oracle_precision(cuda_device, name, kind):
    """Kernels 2 (K=3, B=8192, D=2) and 3 (B=16,384, D=1) at the
    reference's multi-latent oracles cut to M=128 (lengthscale 1, Z on the
    batch's rows; chip_smoke.multi_oracle_inputs) against the plain version
    in float64: every output within FLOAT32_FACTOR times the float32 plain
    version's own error with no KERNEL_TOL floor; S2 exactly symmetric and a
    second call bit-equal (chip_smoke.multi_oracle_check)."""
    smoke.multi_oracle_check(ck, name, kind, cuda_device)


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
    """On a CUDA tensor the pair launches or raises: an unknown kind, mixed
    dtypes or a wrong shape raise; float64 launches the float64 form,
    which matches the float64 plain version (chip_smoke's check_f64) and
    counts in launches_f64 alone; past the row slab's old ceiling
    (kappa_max_m("moments") + 1, 2,393 on an H100) kernel 4 launches its
    column-blocked form in float32 and in float64 and matches (cols_match)."""
    t = pair_case(64, 16, 2, 4, cuda_device)
    t64 = smoke.to_float64(t)
    before = (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches)
    before64 = (ck.fused_kappa_moments_batched.launches_f64, ck.cavi_stats_batched.launches_f64)
    with pytest.raises(ValueError, match="kinds"):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "X": t["X"].double()})
    got = smoke.call_k4(ck.fused_kappa_moments_batched, t64)
    cpu64 = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in t64.items()}
    smoke.check_f64("kernel 4 float64", ("kappa", "mf", "vf"), got,
                    smoke.call_k4(ck.fused_kappa_moments_batched_reference, t64),
                    smoke.call_k4(ck.fused_kappa_moments_batched_reference, cpu64))
    s_args = (got[0].contiguous(), t64["g"], t64["theta"])
    smoke.check_f64("kernel 5 float64", ("s1", "S2"), ck.cavi_stats_batched(*s_args),
                    ck.cavi_stats_batched_reference(*s_args), ck.cavi_stats_batched_reference(*(a.cpu() for a in s_args)))
    assert (ck.fused_kappa_moments_batched.launches_f64, ck.cavi_stats_batched.launches_f64) == tuple(
        n + 1 for n in before64)
    with pytest.raises(ValueError):
        smoke.call_k4(ck.fused_kappa_moments_batched, {**t, "mu": t["mu"][:1]})
    big = pair_case(8, ck.kappa_max_m("moments") + 1, 1, 2, cuda_device)
    cols_match(big, "moments")
    cols_match(smoke.to_float64(big), "moments")
    before = (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches)
    kappa = torch.zeros((2, 64, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ck.cavi_stats_batched(kappa, t["g"].double(), t["theta"])
    with pytest.raises(ValueError):
        ck.cavi_stats_batched(kappa, t["g"][:, :10], t["theta"])
    assert (ck.fused_kappa_moments_batched.launches, ck.cavi_stats_batched.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["logistic", "poisson", "multiclass", "het"])
def test_train_beyond_the_fused_range_launches_the_pair(cuda_device, which):
    """M=130 (at D=46 for the logistic model), beyond the fused kernels'
    range (kernel 1's one 128-column output tile, kernels 2-3's shared
    memory): each step launches one kernel of the single-latent split pair
    (6-7, one latent) or of the batched pair (4-5, several) each, no fused
    kernel, and the posterior stays finite."""
    rng = np.random.default_rng(5)
    d = 46 if which == "logistic" else 3
    m = 130
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n_latent,unaligned", [
    (300, 1, 1, False), (300, 8, 1, False), (300, 8, 1, True), (300, 129, 1, False), (300, 129, 3, False),
    (700, 1000, 1, False), (700, 1000, 3, False),
])
def test_cuda_stats_f64_match_plain(cuda_device, b, m, n_latent, unaligned):
    """Kernels 5 and 7 in float64 (both geometries: the m16n8k8 one the
    wrappers take, and the m8n8k4 one under chip_smoke.k4_stats) at ragged
    B with M = 1, 8 and 129 (odd M, or kappa one double off a 16-byte
    boundary, takes the one-element copies), L = 1 and 3, and M = 1,000,
    against their float64 plain versions by chip_smoke.check_f64's rule:
    one launch a call in launches_f64 alone, S2 exactly symmetric and a
    second call bit-equal to the first."""
    kappa, g, theta = (a.double() for a in stats_case(b, m, n_latent, cuda_device, seed=m * 31 + n_latent))
    if unaligned:
        shifted = torch.empty(kappa.numel() + 1, dtype=torch.float64, device=cuda_device)[1:].view(kappa.shape)
        shifted.copy_(kappa)
        kappa = shifted
        assert kappa.data_ptr() % 16 != 0
    calls = [(ck.cavi_stats_batched, ck.cavi_stats_batched_reference, (kappa, g, theta))]
    if n_latent == 1:
        calls.append((ck.cavi_stats, ck.cavi_stats_reference, (kappa[0], g[0], theta[0])))
    for fn, plain, args in calls:
        ref, ref_cpu = plain(*args), plain(*(a.cpu() for a in args))
        for form in ("m16n8k8", "m8n8k4"):
            label = f"{fn.__name__} float64 {form} B={b} M={m} L={n_latent}"
            before = (fn.launches, fn.launches_f64)
            with smoke.k4_stats(ck) if form == "m8n8k4" else smoke.contextlib.nullcontext():
                got = fn(*args)
                torch.cuda.synchronize()
                assert (fn.launches, fn.launches_f64) == (before[0], before[1] + 1), label
                smoke.check_f64(label, ("s1", "S2"), got, ref, ref_cpu)
                smoke.check_stats_repeat(label, fn, args, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", smoke.BIG_MS)
def test_cuda_kappa_cols_past_the_old_grid(cuda_device, m):
    """Float64 kernels 6 + 7 and 4 + 5 at B = 8,388,481, one row past the
    column-blocked form's old grid (65,535 row tiles of 128), at M = 129
    and at M = 260, where B M passes 2^31 (chip_smoke.large_b_check: rows
    at the start, around the 2^31 index and at the end against the plain
    version on those rows alone; the statistics finite, S2 exactly
    symmetric and within 1e-9 of the plain sums over chunks)."""
    smoke.large_b_check(ck, cuda_device, m)


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


def cols_match(t, kernels):
    """Kernel 4 and/or 6 (``kernels``: "moments", "single" or "both") on
    pair_inputs' tensors t on the column-blocked route, one launch a call
    in the dtype's counter: float64 within chip_smoke.check_f64's bound (10
    x the float64 plain version's own card-vs-CPU difference), float32
    against the float64 plain version within FLOAT32_FACTOR times the
    float32 plain version's own error with no floor; a second call
    bit-equal."""
    f64 = t["X"].dtype == torch.float64
    for name, caller, a, names in smoke.cols_calls(t, kernels):
        fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
        assert ck.kappa_route("single" if name == "fused_kappa" else "moments", a["Z"].shape[-2],
                              a["X"].dtype)[0] == "cols"
        counter = "launches_f64" if f64 else "launches"
        before = getattr(fn, counter)
        got = caller(fn, a)
        torch.cuda.synchronize()
        assert getattr(fn, counter) == before + 1, name
        label = f"{name} B={a['X'].shape[0]} M={a['Z'].shape[-2]} {a['X'].dtype}"
        if f64:
            a_cpu = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in a.items()}
            smoke.check_f64(label, names, got, caller(plain, a), caller(plain, a_cpu))
        else:
            smoke.check_outputs(label, names, got, caller(plain, a), caller(plain, smoke.to_float64(a)), floor=0.0)
        smoke.check_repeat(label, lambda: caller(fn, a), got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,m,n_latent,d,kernels,dtype", [
    (300, 129, 1, 20, "both", torch.float64), (300, 129, 3, 20, "moments", torch.float64),
    (300, 1185, 2, 20, "moments", torch.float64), (300, 1193, 1, 20, "both", torch.float64),
    (700, 2048, 1, 20, "both", torch.float64), (300, 2393, 2, 20, "moments", torch.float32),
    (300, 2407, 1, 20, "both", torch.float32), (1000, 4096, 1, 20, "both", torch.float32),
])
def test_cuda_kappa_cols_match_plain(cuda_device, b, m, n_latent, d, kernels, dtype):
    """Kernels 4 and 6 on the column-blocked route (every float64 call;
    float32 past the row slab's range) at ragged B=300 with an odd M=129,
    at M=1,185-2,048 in float64 and M=2,393-4,096 in float32, against
    their plain versions (cols_match)."""
    t = pair_case(b, m, n_latent, d, cuda_device)
    cols_match(smoke.to_float64(t) if dtype == torch.float64 else t, kernels)


@pytest.mark.cuda
def test_cuda_kappa_autograd_matches_plain(cuda_device):
    smoke.phase_kappa_autograd(ck, cuda_device)


@pytest.mark.cuda
def test_cuda_single_pair_wrappers_raise(cuda_device):
    """On a CUDA tensor the single-latent pair launches or raises: an
    unknown kind, mixed dtypes or a wrong shape raise; float64 launches the
    float64 form, which matches the float64 plain version (chip_smoke's
    check_f64) and counts in launches_f64 alone; past the row slab's old
    ceiling (kappa_max_m("single") + 1, 2,407 on an H100) kernel 6
    launches its column-blocked form in float32 and in float64 and matches
    (cols_match)."""
    t = smoke.single_args(pair_case(64, 16, 1, 4, cuda_device))
    t64 = smoke.to_float64(t)
    before = (ck.fused_kappa.launches, ck.cavi_stats.launches)
    before64 = (ck.fused_kappa.launches_f64, ck.cavi_stats.launches_f64)
    with pytest.raises(ValueError, match="kinds"):
        smoke.call_k6(ck.fused_kappa, {**t, "kind": "periodic"})
    with pytest.raises(TypeError):
        smoke.call_k6(ck.fused_kappa, {**t, "X": t["X"].double()})
    got = smoke.call_k6(ck.fused_kappa, t64)
    cpu64 = {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in t64.items()}
    smoke.check_f64("kernel 6 float64", ("kappa", "Ktilde"), got, smoke.call_k6(ck.fused_kappa_reference, t64),
                    smoke.call_k6(ck.fused_kappa_reference, cpu64))
    s_args = (got[0].contiguous(), t64["g"], t64["theta"])
    smoke.check_f64("kernel 7 float64", ("s1", "S2"), ck.cavi_stats(*s_args), ck.cavi_stats_reference(*s_args),
                    ck.cavi_stats_reference(*(a.cpu() for a in s_args)))
    assert (ck.fused_kappa.launches_f64, ck.cavi_stats.launches_f64) == tuple(n + 1 for n in before64)
    with pytest.raises(ValueError):
        smoke.call_k6(ck.fused_kappa, {**t, "Z": t["Z"][:, :2].contiguous()})
    big = pair_case(8, ck.kappa_max_m("single") + 1, 1, 2, cuda_device)
    cols_match(big, "single")
    cols_match(smoke.to_float64(big), "single")
    before = (ck.fused_kappa.launches, ck.cavi_stats.launches)
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
# it at 128), M=128 at D=44 and D=45 (past the FP32 kernel 1's range: any D
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
    times the float32 plain version's own error, with no floor
    (chip_smoke.check_outputs)."""
    from agp_tpu_torch.benchmarks import fused_variants as fv

    t = smoke.ill_conditioned_inputs(agt, cuda_device, m)
    cases = list(smoke.variant_kernels(fv).values())
    if m == smoke.OM:
        cases.append((ck.fused_cavi_stats, ck.fused_cavi_stats_reference, {"kind": "rbf", "lik": "logistic"}))
    for fn, plain, kw in cases:
        got = smoke.ill_call(fn, t, **kw)
        torch.cuda.synchronize()
        smoke.check_outputs(f"{fn.__name__} {kw} M={m}", smoke.STATS_NAMES, got, smoke.ill_call(plain, t, **kw),
                            smoke.ill_call(plain, smoke.to_float64(t), **kw), floor=0.0)


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
    edge = fv.variant_max_m(ck._smem_limit(cuda_device.index or 0))
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
    """A float64 model on the card is built and trains on kernels 6 + 7's
    float64 form (one launch of each a step, no fused kernel though M=16
    is within kernel 1's range); a float16 model is refused when it is
    built, and one moved there later when its state is made: TypeError
    naming float32, float64 and set_default_device("cpu"), before any
    kernel runs."""
    X = torch.as_tensor(np.random.default_rng(9).normal(size=(512, 3)), device=cuda_device)
    y = torch.sign(X[:, 0])
    make = lambda Z: agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(),  # noqa: E731
                                     agt.AnalyticSVI(128), Z, optimiser=None)
    smoke.reset_launches(ck)
    model, state = agt.train(make(X[:16]), X, y, iterations=2)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "float64 SVGP", smoke.route_launches(2, "single", f64=True))
    assert state.mu.dtype == torch.float64 and torch.isfinite(state.mu).all()
    with pytest.raises(TypeError, match=r'float32 or float64.*set_default_device\("cpu"\)'):
        make(X[:16].half())
    moved = make(X[:16].float()).to(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.init_state(moved, X.half(), y.half())
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.train(moved, X.half(), y.half(), iterations=2)
    model, state = agt.train(make(X[:16].float()), X.float(), y.float(), iterations=2)
    assert torch.isfinite(state.mu).all()


# ------------------------------------------------ Slice E: the dense models
def toy_on(device, n, d=2, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(n, d))
    y = np.sin(2 * X[:, 0]) + 0.1 * rng.normal(size=n)
    return torch.as_tensor(X, dtype=dtype, device=device), torch.as_tensor(y, dtype=dtype, device=device)


@pytest.mark.cuda
def test_cuda_dense_models_refuse_float64(cuda_device):
    """A GP or a VGP built from float64 data on the card trains there in
    float64 with no launch of a kernel of the port; one built from float16
    data is refused at create, and one moved there later at init_state:
    TypeError naming float32 and float64."""
    X, y = toy_on(cuda_device, 64, dtype=torch.float64)
    smoke.reset_launches(ck)
    _, s_gp = agt.train(agt.GP.create(X, y, agt.SqExponentialKernel()), iterations=2)
    _, s_vgp = agt.train(agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                                        agt.AnalyticVI()), iterations=2)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "float64 dense models", {})
    for t in (s_gp.alpha, s_vgp.mu):
        assert t.dtype == torch.float64 and torch.isfinite(t).all()
    with pytest.raises(TypeError, match=r'float32 or float64.*set_default_device\("cpu"\)'):
        agt.GP.create(X.half(), y.half(), agt.SqExponentialKernel())
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.VGP.create(X.half(), y.half(), agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                       agt.AnalyticVI())
    gp = agt.GP.create(X.float(), y.float(), agt.SqExponentialKernel()).to(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.init_state(gp)
    vgp = agt.VGP.create(X.float(), y.float(), agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                         agt.AnalyticVI()).to(dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.init_state(vgp)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gp", "vgp", "vgp_het"])
def test_cuda_dense_step_launches_no_kernel(cuda_device, which):
    """The exact GP and the dense VGP (with hyperparameter steps, or two
    latents) train on the card with no launch of any kernel of the port,
    as the reference's dense models reach no Pallas kernel; the posterior
    stays on the card and finite."""
    X, y = toy_on(cuda_device, 256, d=1 if which == "vgp_het" else 2)
    if which == "gp":
        model = agt.GP.create(X, y, agt.SqExponentialKernel())
    elif which == "vgp":
        model = agt.VGP.create(X, y, agt.Matern52Kernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI())
    else:
        model = agt.VGP.create(X, y, agt.SqExponentialKernel(), agt.HeteroscedasticLikelihood.create(8.0),
                               agt.AnalyticVI(), optimiser=None)
    smoke.reset_launches(ck)
    model, state = agt.train(model, iterations=6)
    torch.cuda.synchronize()
    assert smoke.expect_launches(ck, which, {}) == 0
    post = state.alpha if which == "gp" else state.mu
    assert post.is_cuda and torch.isfinite(post).all()
    assert agt.predict_f(model, state, X[:16], cov=True, diag=False)[1].is_cuda


@pytest.mark.cuda
def test_cuda_noise_learning_takes_the_split_pair(cuda_device):
    """An SVGP whose Gaussian likelihood learns its noise launches kernel 6
    and kernel 7 once a step and never kernel 1, as phase 21 of the smoke
    run at its shape; sigma^2 stays a finite 0-d tensor on the card."""
    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32, device=cuda_device)
    y = X @ torch.as_tensor(rng.normal(size=8), dtype=torch.float32, device=cuda_device)
    model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.GaussianLikelihood.create(0.1, opt_noise=True),
                            agt.AnalyticSVI(512, minibatch_sampling="block"), X[:32], optimiser=None)
    smoke.reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=20)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "noise learning", smoke.route_launches(20, "single"))
    s2 = model.likelihood.sigma2
    assert s2.is_cuda and s2.ndim == 0 and torch.isfinite(s2) and float(s2) != 0.1


# ------------------------------------------------- Slice G: the samplers
@pytest.mark.cuda
def test_cuda_samplers_hold_their_moments(cuda_device):
    """PG(1, 1), PG(3.5, 0.5) and GIG(3, 0.5, 3/2) at 2^18 lanes on the card
    (float32): finite, positive, mean within 6 standard errors."""
    n = 2**18
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for name, (draw, mean, var) in smoke.sampler_cases().items():
        if name not in ("PG(1, 1.0)", "PG(3.5, 0.5)", "GIG(3.0, 0.5, 1.5)"):
            continue
        s = draw(g, n, cuda_device)
        assert s.is_cuda and s.dtype == torch.float32 and bool(torch.isfinite(s).all() and (s > 0).all()), name
        assert abs(float(s.double().mean()) - mean) < 6 * np.sqrt(var / n), name


@pytest.mark.cuda
def test_cuda_sampler_parity(cuda_device):
    """The smoke run's phase 26: the fed-noise global resample (both
    solvers), leapfrog and SVGD on the card against the CPU (float32),
    each within 10x the CPU float32's own error against float64."""
    smoke.phase_sampler_parity(agt, cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("inference", ["chol", "cg", "nuts", "hmc"])
def test_cuda_mcgp_from_numpy_samples_on_the_card(cuda_device, inference):
    """A numpy input to MCGP.create lands on the card; sample runs there
    with no launch of a kernel of the port, its samples on the card and
    finite; predict_f_samples stays there too."""
    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(64, 2)).astype(np.float32)
    y = np.sign(np.sin(2 * X[:, 0]) + 0.5 * X[:, 1])
    engine = (agt.GibbsSampling(n_burnin=5, solver=inference) if inference in ("chol", "cg")
              else agt.HMCSampling(n_burnin=5, algorithm=inference))
    model = agt.MCGP.create(X, y, agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), engine)
    assert model.train_x.is_cuda and model.train_y.is_cuda
    smoke.reset_launches(ck)
    s = agt.sample(model, 10, generator=torch.Generator(device=cuda_device).manual_seed(0), n_chains=2)
    torch.cuda.synchronize()
    assert smoke.expect_launches(ck, inference, {}) == 0
    assert s.shape == (2, 10, 1, 64) and s.is_cuda and torch.isfinite(s).all()
    from agp_tpu_torch.models.mcgp import predict_f_samples

    assert predict_f_samples(model, s[0], X[:8]).is_cuda


@pytest.mark.cuda
def test_cuda_mcgp_refuses_float64(cuda_device):
    """A float64 MCGP on the card samples there in float64 (no kernel of the
    port); a float16 one is refused at create."""
    X, y = toy_on(cuda_device, 32, dtype=torch.float64)
    mc = agt.MCGP.create(X, y, agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.1),
                         agt.GibbsSampling(n_burnin=5))
    s = agt.sample(mc, 10, generator=torch.Generator(device=cuda_device).manual_seed(0))
    assert s.dtype == torch.float64 and torch.isfinite(s).all()
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.MCGP.create(X.half(), y.half(), agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.1))


# ---------------------------------------------- Slice I: the online model
@pytest.mark.cuda
@pytest.mark.parametrize("zalg", ["oips", "streamkmeans", "webscale", "unigrid"])
def test_cuda_online_stream_on_the_card(cuda_device, zalg):
    """Numpy batches stream into an OnlineSVGP made on the card (its
    default device): every buffer stays there, the accept walk launched
    once a later batch for OIPS (oips_accept) and StreamKmeans
    (streamkmeans_pass), and once more for each prologue warmed before its
    capture, and no kernel for the others, no host read, and the
    posterior equals the same stream's on the CPU (float32) within 1e-3 of
    its largest entry."""
    from agp_tpu_torch.utils.tensors import host_read

    rng = np.random.default_rng(0)
    X = rng.uniform(-2, 2, size=(192, 2)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    alg = {"oips": None, "streamkmeans": agt.inducing.StreamKmeans(32, 0.25), "webscale": agt.inducing.Webscale(16),
           "unigrid": agt.inducing.UniGridOnline(4)}[zalg]

    def stream(device):
        m = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                                  Zalg=alg, n_dim=2, capacity=32, optimiser=None, device=device)
        s = None
        for i in range(3):
            m, s = agt.online_train(m, X[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64], state=s, iterations=5)
        return m, s

    from agp_tpu_torch.training import graphs

    smoke.reset_launches(ck)
    reads, warm = host_read.reads, graphs.tally["warm"]
    m, s = stream(cuda_device)
    torch.cuda.synchronize()
    walks = 2 + graphs.tally["warm"] - warm
    walk = {"oips": "oips_accept", "streamkmeans": "streamkmeans_pass"}.get(zalg)
    assert smoke.expect_launches(ck, zalg, {walk: walks} if walk else {}) == (walks if walk else 0)
    assert host_read.reads == reads
    assert m.Z.is_cuda and m.z_mask.is_cuda and s.mu.is_cuda and s.kmat["K_inv"].is_cuda
    mc, sc = stream("cpu")
    assert torch.equal(m.z_mask.cpu(), mc.z_mask)
    for k in ("mu", "Sigma"):
        a, b = getattr(s, k).cpu(), getattr(sc, k)
        assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max()), k
    assert agt.predict_f(m, s, X[:16]).is_cuda


@pytest.mark.cuda
def test_cuda_online_default_adam(cuda_device):
    """The default Adam(0.01) on the card: the kernel's log parameters move,
    the posterior and online_elbo stay finite, the OIPS walk launched once
    for the later batch (and once for each prologue warmed before its
    capture) and no other kernel."""
    from agp_tpu_torch.training import graphs

    rng = np.random.default_rng(1)
    X = rng.uniform(-2, 2, size=(128, 2)).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]).astype(np.float32)
    m = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                              n_dim=2, capacity=32)
    smoke.reset_launches(ck)
    s, warm = None, graphs.tally["warm"]
    for i in range(2):
        m, s = agt.online_train(m, X[i * 64:(i + 1) * 64], y[i * 64:(i + 1) * 64], state=s, iterations=8)
    walks = 1 + graphs.tally["warm"] - warm
    assert smoke.expect_launches(ck, "online adam", {"oips_accept": walks}) == walks
    assert abs(float(torch.log(m.kernel.lengthscale[0]))) > 1e-3
    assert torch.isfinite(s.mu).all() and torch.isfinite(s.Sigma).all()
    assert np.isfinite(float(agt.online_elbo(m, s, X[64:], y[64:])))


# ------------------------------------------------- Slice F: numerical VI
@pytest.mark.cuda
@pytest.mark.parametrize("which", ["quad", "mc", "septuple"])
def test_cuda_numerical_step_launches(cuda_device, which):
    """One step of each of the smoke run's paths 30 (QuadratureSVI: kernels
    6 and 7), 31 (SoftMax by MCIntegrationSVI: kernels 4 and 5) and 32a
    (the logistic septuple by AnalyticSVI: kernels 6 and 7) at a cut shape
    launches exactly its pair once and nothing else; the posterior stays
    on the card and finite."""
    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.normal(size=(4096, 8)), dtype=torch.float32, device=cuda_device)
    if which == "mc":
        y = torch.argmax(X[:, :3] @ torch.eye(3, device=cuda_device), dim=1)
        model = agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.SoftMaxLikelihood.create(3),
                                agt.MCIntegrationSVI(512, n_mc=32, optimiser=agt.sgd(1e-3, 0.9)), X[:32],
                                optimiser=None)
    else:
        y = torch.sign(X[:, 0] + 0.5 * X[:, 1])
        model = (smoke.quad_model if which == "quad" else smoke.septuple_model)(agt, X[:, :8], b=512)
    smoke.reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=1)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, which, smoke.route_launches(1, "batched" if which == "mc" else "single"))
    assert state.mu.is_cuda and torch.isfinite(state.mu).all() and torch.isfinite(state.Sigma).all()


@pytest.mark.cuda
def test_cuda_laplace_transform_grid_matches_cpu(cuda_device):
    """The Laplace-transform sampler's float64 grid and inverted density on
    the card against the CPU's (rtol 1e-12 on the grid, the cell masses
    within 1e-9 of their sum), and the card's draws fed the CPU's uniforms
    fall in the same cells."""
    from agp_tpu_torch.distributions.lap_transf import LaplaceTransformDistribution, invert_laplace

    phi = lambda r: 1.0 / torch.cosh(torch.sqrt(r) / 2.0)  # noqa: E731
    dist = LaplaceTransformDistribution(phi)
    t_cpu, t_card = dist.grid(), dist.grid(device=cuda_device)
    assert t_card.dtype == torch.float64
    assert float(((t_card.cpu() - t_cpu).abs() / t_cpu).max()) <= 1e-12
    m_cpu = invert_laplace(phi, t_cpu) * torch.gradient(t_cpu)[0]
    m_card = (invert_laplace(phi, t_card) * torch.gradient(t_card)[0]).cpu()
    assert float((m_card - m_cpu).abs().max()) <= 1e-9 * float(m_cpu.sum())
    s0 = torch.linspace(0.0, 9.0, 1000, dtype=torch.float32)
    u = torch.rand(1000, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
    d_cpu, d_card = dist.sample(None, s0, u=u), dist.sample(None, s0.to(cuda_device), u=u.to(cuda_device))
    assert d_card.dtype == torch.float32 and d_card.is_cuda
    assert float(((d_card.cpu() - d_cpu).abs() / d_cpu).max()) <= 1e-6


@pytest.mark.cuda
def test_cuda_numerical_refuses_float64(cuda_device):
    """A float64 SVGP with a numerical engine trains on the card on kernels
    4-7's float64 form (quadrature, one latent: kernels 6 + 7 a step; the
    SoftMax by Monte Carlo, two latents: 4 + 5), a float64 VGP with a
    septuple likelihood with no kernel launch; their float16 models are
    refused at create: TypeError naming float32 and float64; the float32
    one trains."""
    X = torch.as_tensor(np.random.default_rng(2).normal(size=(256, 2)), device=cuda_device)
    y = torch.sign(X[:, 0])
    for lik, engine, route, yy in ((agt.LogisticLikelihood.create(), agt.QuadratureSVI(64), "single", y),
                                   (agt.SoftMaxLikelihood.create(2), agt.MCIntegrationSVI(64), "batched",
                                    (y > 0).long())):
        smoke.reset_launches(ck)
        _, state = agt.train(agt.SVGP.create(agt.SqExponentialKernel(), lik, engine, X[:8], optimiser=None), X, yy,
                             iterations=2)
        torch.cuda.synchronize()
        smoke.expect_launches(ck, f"float64 {engine.name}", smoke.route_launches(2, route, f64=True))
        assert state.mu.dtype == torch.float64 and torch.isfinite(state.mu).all()
    smoke.reset_launches(ck)
    _, state = agt.train(agt.VGP.create(X, y, agt.SqExponentialKernel(), smoke.logistic_septuple(agt),
                                        agt.QuadratureVI()), iterations=2)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "float64 septuple VGP", {})
    assert torch.isfinite(state.mu).all()
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.QuadratureSVI(64),
                        X[:8].half())
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.VGP.create(X.half(), y.half(), agt.SqExponentialKernel(), smoke.logistic_septuple(agt), agt.QuadratureVI())
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.SVGP.create(agt.SqExponentialKernel(), agt.SoftMaxLikelihood.create(2), agt.MCIntegrationSVI(64),
                        X[:8].half())
    model = agt.SVGP.create(agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.QuadratureSVI(64),
                            X[:8].float(), optimiser=None)
    _, state = agt.train(model, X.float(), y.float(), iterations=2)
    assert torch.isfinite(state.mu).all()


# ---------------------------------- Slice H: VStP, multi-output models, AR
def mo_after(model, X, ys, draws, perm=None):
    """mu (in Z's own order) and A after len(draws) multi-output steps of
    ``model`` on (X, ys) from the fed minibatch indices, as float64 on the
    CPU."""
    if perm is not None:
        model = model.replace(Z=model.Z[:, perm].contiguous())
    model, ys = smoke.mo_treated(model, ys)
    state = agt.mo_init_state(model, X, ys)
    model, state = smoke.mo_steps(model, state, X, ys, draws.shape[0], draws=draws.to(X.device))
    mu = state.mu.double().cpu()
    return (mu if perm is None else mu[:, torch.argsort(perm)]), model.A.double().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("q", [2, 1])
def test_cuda_mo_step_launches_and_matches_cpu(cuda_device, q):
    """5 multi-output steps (Gaussian + logistic tasks, M=128, B=512) from
    fed indices launch kernels 4 + 5 (Q=2) or 6 + 7 (Q=1) once a step and
    nothing else; mu and A within 10 times the CPU's own float32 noise of
    the CPU's (the CPU run again with Z reordered)."""
    X, _, ys = smoke.mo_data(2048, "cpu", seed=4)
    draws = torch.randint(0, 2048, (5, 512), generator=torch.Generator().manual_seed(0))
    build = lambda X: smoke.mo_model(agt, X, m=128, b=512, q=q)  # noqa: E731
    smoke.reset_launches(ck)
    card = mo_after(build(X.to(cuda_device)), X.to(cuda_device), tuple(y.to(cuda_device) for y in ys), draws)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, f"mo q={q}", smoke.route_launches(5, "batched" if q > 1 else "single"))
    cpu = mo_after(build(X), X, ys, draws)
    noise = smoke.mo_err(mo_after(build(X), X, ys, draws, torch.randperm(128, generator=torch.Generator().manual_seed(1))),
                         cpu)
    assert torch.isfinite(card[0]).all()
    assert smoke.mo_err(card, cpu) <= 10 * noise, (smoke.mo_err(card, cpu), noise)


@pytest.mark.cuda
def test_cuda_slice_h_models_refuse_float64(cuda_device):
    """A float64 VStP trains on the card with no kernel launch, a float64
    MOSVGP (Q=2) on kernels 4 + 5's float64 form, once each a step; their
    float16 models are refused at create: TypeError naming float32 and
    float64."""
    X, y = toy_on(cuda_device, 64, dtype=torch.float64)
    smoke.reset_launches(ck)
    _, state = agt.train(agt.VStP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                                         agt.AnalyticVI(), nu=5.0), iterations=2)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "float64 VStP", {})
    assert state.mu.dtype == torch.float64 and torch.isfinite(state.mu).all()
    mo = agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1)], agt.AnalyticVI(), X[:8], 2,
                           optimiser=None)
    _, state = agt.mo_train(mo, X, [y], iterations=2)
    torch.cuda.synchronize()
    smoke.expect_launches(ck, "float64 MOSVGP", smoke.route_launches(2, "batched", f64=True))
    assert state.mu.dtype == torch.float64 and torch.isfinite(state.mu).all()
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.VStP.create(X.half(), y.half(), agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0),
                        agt.AnalyticVI(), nu=5.0)
    with pytest.raises(TypeError, match="float32 or float64"):
        agt.MOSVGP.create(agt.SqExponentialKernel(), [agt.GaussianLikelihood.create(0.1)], agt.AnalyticVI(),
                          X[:8].half(), 2)


@pytest.mark.cuda
def test_cuda_movgp_over_the_kernel_range_refused(cuda_device):
    """A MOVGP whose N (its M) passes the row slab's old ceiling of kernel
    4 (Q=2) or 6 (Q=1), in float32 and in float64, is no longer refused: it
    is built and takes CAVI steps with its exact launches, its kernel on the
    column-blocked route, mu finite."""
    for q, which, route in ((2, "moments", "batched"), (1, "single", "single")):
        for dtype in (torch.float32, torch.float64):
            n = ck.kappa_max_m(which, dtype=dtype) + 1
            X, y = toy_on(cuda_device, n, dtype=dtype)
            model = agt.MOVGP.create(X, [agt.GaussianLikelihood.create(0.1)], agt.SqExponentialKernel(),
                                     agt.AnalyticVI(), q, optimiser=None)
            assert ck.kappa_route(which, n, dtype)[0] == "cols"
            smoke.reset_launches(ck)
            model, state = agt.mo_train(model, X, [y], iterations=2)
            torch.cuda.synchronize()
            want = smoke.route_launches(2, route, f64=dtype == torch.float64)
            assert {k: smoke.launches_of(ck, k) for k in want} == want, (q, dtype)
            assert bool(torch.isfinite(state.mu).all())


@pytest.mark.cuda
def test_cuda_vstp_and_rollouts_launch_no_kernel(cuda_device):
    """A VStP trains on the card with no launch of any kernel of the port,
    chi finite and positive; predict_ar and sample_ar launch none either
    and read nothing back to the host."""
    from agp_tpu_torch.utils.tensors import host_read

    X, y = toy_on(cuda_device, 256)
    model = agt.VStP.create(X, y, agt.SqExponentialKernel(), agt.StudentTLikelihood.create(4.0), agt.AnalyticVI(),
                            nu=5.0)
    smoke.reset_launches(ck)
    model, state = agt.train(model, iterations=6)
    torch.cuda.synchronize()
    assert smoke.expect_launches(ck, "vstp", {}) == 0
    chi = state.prior_state["chi"]
    assert chi.is_cuda and torch.isfinite(chi).all() and (chi > 0).all()
    series, Xl, yl, ar = smoke.ar_model(agt, cuda_device)
    ar, ars = agt.train(ar, Xl, yl, iterations=3)
    smoke.reset_launches(ck)
    reads = host_read.reads
    preds = agt.predict_ar(ar, ars, series[-smoke.AR_LAG:], 5)
    traj = agt.sample_ar(ar, ars, series[-smoke.AR_LAG:], 5, n_samples=8)
    torch.cuda.synchronize()
    assert smoke.expect_launches(ck, "rollouts", {}) == 0 and host_read.reads == reads
    assert preds.is_cuda and traj.shape == (8, 5) and torch.isfinite(traj).all()


# ------------------------------------------- Slices J and K on the card
@pytest.mark.cuda
def test_cuda_checkpoint_onto_cuda_template(cuda_device, tmp_path):
    """A float64 CPU checkpoint loads onto a float32 CUDA template: every
    tensor on the card in float32, equal to the CPU's rounded, and the
    model trains on from it with kernel 1."""
    from agp_tpu_torch.training.checkpoint import named_leaves

    Xc, yc = (t.double() for t in smoke.flagship_data("cpu", n=8192))
    m, s = agt.train(smoke.flagship_model(agt, Xc, b=512), Xc, yc, iterations=5)
    agt.checkpoint.save(str(tmp_path / "ck"), m, s)
    X, y = Xc.float().to(cuda_device), yc.float().to(cuda_device)
    template = smoke.flagship_model(agt, X, b=512)
    m2, s2 = agt.checkpoint.load(str(tmp_path / "ck"), template, agt.init_state(template, X, y))
    for (p, a), (_, b) in zip(named_leaves(s2, "state") + named_leaves(m2, "model"),
                              named_leaves(s, "state") + named_leaves(m, "model")):
        want = b.float() if b.is_floating_point() else b
        assert a.is_cuda and a.dtype == want.dtype and torch.equal(a.cpu(), want), p
    smoke.reset_launches(ck)
    m2, s2 = agt.train(m2, X, y, iterations=3, state=s2)
    torch.cuda.synchronize()
    assert smoke.expect_launches(ck, "checkpoint resume", {"fused_cavi_stats": 3}) == 3
    assert torch.isfinite(s2.mu).all()


@pytest.mark.cuda
def test_cuda_world1_nccl_step_is_vi_steps(cuda_device):
    """sharded_svi_train over NCCL at world 1 on fed block draws is vi_steps
    bit for bit (kernel 1 once a step; a group of one runs no all-reduce,
    its broadcasts the only collectives)."""
    from agp_tpu_torch.parallel import mesh as pm
    from agp_tpu_torch.training.train import vi_steps
    from agp_tpu_torch.utils.batch_sums import batch_sum

    X, y = smoke.flagship_data(cuda_device, n=20_000)
    draws = torch.randint(0, 20_000 // 64, (6, smoke.B // 64), generator=torch.Generator().manual_seed(0))
    draws = draws.to(cuda_device)
    model = smoke.flagship_model(agt, X)
    _, ref = vi_steps(model, agt.init_state(model, X, y), X, y, 6, draws=draws)
    mesh = pm.initialize_distributed(f"localhost:{smoke.free_port()}", 1, 0, device=cuda_device)
    try:
        assert mesh.backend == "nccl"
        smoke.reset_launches(ck)
        calls = batch_sum.calls
        _, st = pm.sharded_svi_train(smoke.flagship_model(agt, X), X, y, 6, mesh=mesh, draws=draws)
        torch.cuda.synchronize()
        assert smoke.expect_launches(ck, "world 1", {"fused_cavi_stats": 6}) == 6 and batch_sum.calls == calls
    finally:
        torch.distributed.destroy_process_group()
    assert torch.equal(st.mu, ref.mu) and torch.equal(st.Sigma, ref.Sigma)
    assert torch.equal(st.local_vars["theta"], ref.local_vars["theta"])


def _gloo_child(rank, init, draws_path, out):
    """One of two processes on cuda:0 over gloo: 20 sharded SVI steps of the
    flagship at B/2 a rank on fed tile draws; rank 0 saves mu."""
    from agp_tpu_torch.parallel import mesh as pm

    device = torch.device("cuda:0")
    mesh = pm.initialize_distributed(init, 2, rank, backend="gloo", device=device)
    X, y = smoke.flagship_data(device)
    draws = torch.load(draws_path)[:, rank].to(device)
    smoke.reset_launches(ck)
    _, st = pm.sharded_svi_train(smoke.flagship_model(agt, X), X, y, 20, mesh=mesh, batch_per_device=smoke.B // 2,
                                 draws=draws)
    torch.cuda.synchronize()
    assert ck.fused_cavi_stats.launches == 20
    if rank == 0:
        torch.save(st.mu.cpu(), out)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_cuda_gloo_world2_within_noise_of_world1(cuda_device, tmp_path):
    """Two processes on the one card over gloo (CUDA tensors), kernel 1 on
    each rank's half of the batch: rank 0's mu within 10 times the path's
    own float32 noise of world 1 on the same global rows (the noise: the
    world-1 run with Z reordered, or with the batch's rows reversed)."""
    import os
    import subprocess

    draws = torch.randint(0, (smoke.N // 2) // 64, (20, 2, smoke.B // 2 // 64), generator=torch.Generator().manual_seed(1))
    torch.save(draws, tmp_path / "draws.pt")
    init = f"file://{tmp_path}/rendezvous"
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, "gloo-child", str(r), init, str(tmp_path / "draws.pt"),
                               str(tmp_path / "mu.pt")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env) for r in range(2)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    mu2 = torch.load(tmp_path / "mu.pt")
    X, y = smoke.flagship_data(cuda_device)
    d = draws.to(cuda_device)
    perm = torch.randperm(smoke.M, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    _, w1 = smoke.global_svi(agt, X, y, d, 2)
    _, wp = smoke.global_svi(agt, X, y, d, 2, perm=perm)
    _, wf = smoke.global_svi(agt, X, y, d, 2, flip=True)
    noise = max(smoke.mu_err(wp.mu, w1.mu, perm.cpu()), smoke.mu_err(wf.mu, w1.mu))
    assert smoke.mu_err(mu2, w1.mu) <= smoke.ORACLE_DEVICE_FACTOR * noise



@pytest.mark.cuda
def test_cuda_path42_step_matches_cpu(cuda_device):
    """Path 42's model (a projection under a squared exponential plus a
    linear kernel, Adam every iteration) for 20 iterations on PN rows: one
    launch of kernel 7 a CAVI step and nothing else, and the card within
    ORACLE_DEVICE_FACTOR times the path's own float32 noise of the CPU."""
    Xc, yc = smoke.flagship_data("cpu", n=smoke.PN, seed=1)
    draws = torch.randint(0, smoke.PN // 64, (20, smoke.B // 64), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(smoke.M, generator=torch.Generator().manual_seed(2))
    smoke.reset_launches(ck)
    card = smoke.path42_after(agt, Xc.to(cuda_device), yc.to(cuda_device), draws)
    counts = {name: smoke.launches_of(ck, name) for name in smoke.LAUNCH_COUNTERS}
    assert counts == {name: 20 if name == "cavi_stats" else 0 for name in smoke.LAUNCH_COUNTERS}
    cpu = smoke.path42_after(agt, Xc, yc, draws)
    noise = smoke.hyper_err(smoke.path42_after(agt, Xc, yc, draws, perm), cpu)
    assert smoke.hyper_err(card, cpu) <= smoke.ORACLE_DEVICE_FACTOR * noise


@pytest.mark.cuda
def test_cuda_path43_launches_kernel5_once_a_step(cuda_device):
    """A multiclass model with the rational-quadratic kernel takes the plain
    kappa and kernel 5: one launch a step, none of kernels 2 and 4."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = smoke.mc_data(cuda_device)
    model = smoke.multi_model(agt, X[:4096], "multiclass", "RationalQuadraticKernel")
    y_t, lik = model.likelihood.treat_labels(y[:4096])
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X[:4096], y_t)
    smoke.reset_launches(ck)
    _, state = vi_steps(model, state, X[:4096], y_t, 5, generator=torch.Generator(device=cuda_device).manual_seed(0))
    torch.cuda.synchronize()
    counts = {name: smoke.launches_of(ck, name) for name in smoke.LAUNCH_COUNTERS}
    assert counts == {name: 5 if name == "cavi_stats_batched" else 0 for name in smoke.LAUNCH_COUNTERS}
    assert torch.isfinite(state.mu).all()


@pytest.mark.cuda
def test_cuda_white_kernel_in_kmm(cuda_device):
    """WhiteKernel adds its variance to Kmm on the card as on the CPU: the
    gram of the inducing points with themselves is one tensor with itself."""
    from agp_tpu_torch.config import jitter
    from agp_tpu_torch.inference.analytic_vi import compute_kmat

    Z = torch.randn(32, 3, generator=torch.Generator().manual_seed(0))
    kern = agt.SqExponentialKernel() + agt.WhiteKernel(variance=0.5)
    kmats = []
    for dev in ("cpu", cuda_device):
        m = agt.SVGP.create(kern, agt.LogisticLikelihood.create(), agt.AnalyticVI(), Z.to(dev), optimiser=None)
        L_K = compute_kmat(m)["L_K"][0]
        kmats.append((L_K @ L_K.T).cpu())
    plain = agt.SqExponentialKernel().gram(Z, Z)
    for K in kmats:
        assert torch.allclose(torch.diagonal(K - plain), torch.full((32,), 0.5 + jitter(torch.float32)), atol=1e-5)
    assert torch.allclose(kmats[1], kmats[0], atol=1e-5)

# ------------------------------------------- captured chunks of steps
@pytest.mark.cuda
@pytest.mark.parametrize("label", list(smoke.graph_routes(agt, torch.device("cpu"))))
def test_cuda_captured_chunk_matches_eager(cuda_device, label):
    """Phase 56's check of one route (``chip_smoke.graph_route_check``):
    k + 2 steps as a captured chunk (the warm-up step, a replay of k, one
    of a single step) bit-equal to the eager loop from generators of one
    seed, and again from a second fresh state on the cached capture, each
    run's launches exact, a replay of k credited k steps' launches and a
    profiled replay's kernels on the device as many, the capture and the
    replays under sync debug "error"."""
    smoke.graph_route_check(agt, ck, cuda_device, label)


@pytest.mark.cuda
@pytest.mark.parametrize("label", list(smoke.hyper_graph_routes(agt, torch.device("cpu"))))
def test_cuda_captured_hyper_matches_eager(cuda_device, label):
    """Phase 57's check of one route (``chip_smoke.hyper_route_check``):
    k + 4 iterations of ``train`` with hyperparameter steps on captured
    graphs bit-equal to the eager loop from generators of one seed, each
    run's launches exact, a replay of the large pattern credited its
    launches and a profiled replay's kernels on the device as many,
    ``graphs.run_hyper`` under sync debug "error"."""
    smoke.hyper_route_check(agt, ck, cuda_device, label)


@pytest.mark.cuda
def test_cuda_captured_mo_matches_eager(cuda_device):
    """Phase 58's check of one route (``chip_smoke.mo_route_check``): k + 4
    iterations of phase 36's Q=1 multi-output model through ``mo_train``
    on captured graphs (kernels 6 + 7 inside) bit-equal to its eager loop,
    each run's launches exact, a replay credited its launches and a
    profiled replay's kernels on the device as many, ``graphs.run`` under
    sync debug "error"."""
    smoke.mo_route_check(agt, ck, cuda_device, "36 q1")


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["27", "27 stream", "28 streamkmeans"])
def test_cuda_captured_online_matches_eager(cuda_device, label):
    """Phase 59's check of a route (``chip_smoke.online_route_check``):
    phase 27's stream batch by batch through ``online_train`` and as one
    ``online_train_stream``, and phase 28's StreamKmeans stream, on
    captured graphs (each later batch's prologue one of them) bit-equal to
    the eager loop, the accept walk once a later batch on each loop, one
    static carry for the stream, no eager iteration and at most
    ceil(iterations / k) + 1 graph launches a later batch, each later batch
    whole under sync debug "error"."""
    smoke.online_route_check(agt, ck, cuda_device, label)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_captured_online_walks_match_plain(cuda_device, dtype):
    """``oips_accept`` and ``streamkmeans_pass`` (csrc/online_select.cu)
    against their plain versions on the same card tensors at the streaming
    row's and the wide stream's shapes (``chip_smoke.walk_main_cases``) and
    at the edge cases (a full buffer, no active slot, a point at exactly
    rho or r^2, a point an earlier one of its batch stops:
    ``chip_smoke.walk_edge_cases``): the same row_of_slot, or Z, mask and
    counts, bit for bit, a second call too, each edge case's outcome, one
    launch counted a call."""
    cases = {**smoke.walk_main_cases(agt, cuda_device, dtype), **smoke.walk_edge_cases(cuda_device, dtype)}
    for label, (kind, args) in cases.items():
        name = "oips_accept" if kind == "oips" else "streamkmeans_pass"
        before = getattr(ck, name).launches
        got, again = smoke.walk_call(ck, kind, args), smoke.walk_call(ck, kind, args)
        torch.cuda.synchronize()
        assert getattr(ck, name).launches == before + 2, label
        want = smoke.walk_call(ck, kind, args, plain=True)
        for a, b, c in zip(got, want, again):
            assert a.is_cuda and smoke.bit_equal(a, b) and smoke.bit_equal(a, c), label
        smoke.check_walk_edge(label, kind, args, got)


@pytest.mark.cuda
def test_cuda_walk_wrappers_refuse(cuda_device):
    """The walks' wrappers raise on what their kernels do not take: a
    float16 gram, a mask of another dtype or shape, a non-contiguous
    buffer."""
    g = torch.rand(1, 4, 3, device=cuda_device)
    gx, kx, kd = torch.rand(1, 4, 4, device=cuda_device), torch.ones(1, 4, device=cuda_device), torch.ones(1, 3,
                                                                                                          device=cuda_device)
    mask = torch.zeros(1, 3, dtype=torch.bool, device=cuda_device)
    with pytest.raises(TypeError):
        ck.oips_accept(g.half(), gx.half(), kx.half(), kd.half(), mask, 0.8)
    with pytest.raises(ValueError, match="mask"):
        ck.oips_accept(g, gx, kx, kd, mask.float(), 0.8)
    Z, X = torch.rand(1, 3, 2, device=cuda_device), torch.rand(4, 2, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ck.streamkmeans_pass(Z.transpose(1, 2).contiguous().transpose(1, 2), mask, torch.ones(1, 3, device=cuda_device),
                             X, 1.0, 3)


FRESH_PROLOGUE = """
import sys, torch
import agp_tpu_torch as agt
from agp_tpu_torch.ops import cuda_kernels as ck
from agp_tpu_torch.training import graphs
from agp_tpu_torch import bench
X, _, y = bench.online_data("cuda", n=4 * 256)
zalg = None if sys.argv[1] == "oips" else agt.inducing.StreamKmeans(128, 0.25)
m = agt.OnlineSVGP.create(agt.SqExponentialKernel(), agt.GaussianLikelihood.create(0.05), agt.AnalyticVI(),
                          Zalg=zalg, n_dim=2, capacity=128, optimiser=None)
s, counts = None, []
for i in range(3):
    before = dict(graphs.tally)
    m, s = agt.online_train(m, X[i * 256:(i + 1) * 256], y[i * 256:(i + 1) * 256], state=s, iterations=20)
    counts.append({k: graphs.tally[k] - before[k] for k in before})
torch.cuda.synchronize()
walk = ck.oips_accept if sys.argv[1] == "oips" else ck.streamkmeans_pass
assert [c["warm"] for c in counts] == [0, 1, 0], counts
assert walk.launches == 3, walk.launches  # batches 2 and 3, and the prologue's warm-up
assert all(c["eager"] == 0 and c["replays"] == 3 for c in counts[1:]), counts
assert bool(torch.isfinite(s.mu).all())
print("FRESH_OK", counts)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("alg", ["oips", "streamkmeans"])
def test_cuda_captured_online_prologue_in_a_fresh_process(cuda_device, alg, tmp_path):
    """In a fresh process, whose first accept walk is in the second
    batch's prologue (warmed on copies of the carry before its capture,
    ``graphs``' prologue warm-up): three batches of the streaming row, each
    later one its prologue's graph and two windows, no eager iteration,
    the walk launched once a later batch and once in the warm-up."""
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", FRESH_PROLOGUE, alg], cwd=root, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0 and "FRESH_OK" in proc.stdout, proc.stdout[-2000:] + proc.stderr[-4000:]


@pytest.mark.cuda
def test_cuda_captured_chunks_reused_with_remainders(cuda_device):
    """Two calls of 2 k + 3 steps at a small flagship shape: the second
    takes the first's capture (no warm-up step, no new capture), the
    states bit-equal to the eager loop's two calls, kernel 1's launches
    exactly 2 (2 k + 3)."""
    from agp_tpu_torch.training import graphs
    from agp_tpu_torch.training.train import vi_steps

    k = graphs.STEPS_PER_GRAPH
    X, y = smoke.flagship_data(cuda_device, n=20_000)
    model = smoke.flagship_model(agt, X, b=1024)
    state = agt.init_state(model, X, y)
    runs = {}
    for name in ("eager", "captured"):
        graphs.clear()
        smoke.reset_launches(ck)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        m, s = model, state
        with smoke.eager_loop() if name == "eager" else smoke.sync_errors():
            for call in range(2):
                m, s = vi_steps(m, s, X, y, 2 * k + 3, generator=gen)
                if name == "captured" and call == 0:
                    first = graphs.latest()
        torch.cuda.synchronize()
        assert ck.fused_cavi_stats.launches == 2 * (2 * k + 3)
        runs[name] = s
    assert graphs.latest() is first and sorted(first.graphs) == [1, k]
    for f in ("eta1", "eta2", "mu", "Sigma", "step", "opt_state"):
        assert torch.equal(getattr(runs["captured"], f), getattr(runs["eager"], f)), f
    graphs.clear()


if __name__ == "__main__" and sys.argv[1:2] == ["gloo-child"]:
    import os

    _gloo_child(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    sys.stdout.flush()
    os._exit(0)  # an orderly interpreter shutdown can abort in gloo's threads' teardown
