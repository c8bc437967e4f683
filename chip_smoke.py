"""Smoke run of the PyTorch port (agp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, turn TF32 off, print the card's name and power
   limit (nvidia-smi);
2. build: compile the CUDA kernels from the repo's sources with nvcc for
   sm_90a, one nvcc per source, all at once;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the same card tensors, at its main path's shape, a ragged B=300 and
   M=128, then both timed at the main path's shape (CUDA events, in the
   order plain, kernel, kernel, plain):
   - fused_cavi_stats at B=4096, M=64, D=20 (the flagship);
   - fused_cavi_stats_multiclass at B=2048, M=64, D=10, K=10;
   - fused_cavi_stats_het at B=2048, M=64, D=10;
4. flagship path: SVGP + RBF + logistic, N=200,000, D=20, M=64, B=4096,
   block sampling, float32, trained through agp_tpu_torch.train with one
   kernel launch per step; training accuracy and steady-state CAVI
   iterations/s;
5. oracle and cross-device parity: the N=300 2-D oracle on the card
   (accuracy > 0.9), and 20 flagship steps on the card (float32) against
   the same 20 steps on the CPU (float32 and float64) from the same draws;
6. multiclass path: the bench.py configuration (logistic-softmax, K=10,
   N=50,000, D=10, M=64, B=2048, slice sampling, float32), trained the same
   way; training accuracy and iterations/s;
7. heteroscedastic path: the bench.py configuration (N=50,000, D=10, M=64,
   B=2048, slice sampling, float32); RMSE of predict_y against the
   noiseless sin(x_0), and iterations/s;
8. multi-latent parity: 20 steps of each of paths 6 and 7 on the card
   (float32) against the same 20 steps on the CPU (float32), same draws.

Each path's launch counts are set to 0 just before it and read just after.
Prints the kernels' JSON line, then the device JSON line last.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# flagship shape
N, D, M, B = 200_000, 20, 64, 4096
MAIN_STEPS = 300
TIMED_STEPS = 1000
# kernel vs plain: largest |kernel - plain| over the output's largest entry
# (float32 on both arms, sums in another order; float32 against float64 the
# plain version is off by ~1e-6 at these shapes, whose Kmm has cond ~5)
KERNEL_TOL = 1e-4
# cross-device parity of mu after 20 steps, as max |d mu| / max |mu|:
# - card float32 against CPU float32 (the plain version, same jitter):
#   float32 sums in another order, carried through 20 steps;
# - card float32 against CPU float64: the dtype-keyed jitter differs
#   (1e-3 against 1e-4), which moves mu by ~5e-4 on its own.
PARITY_TOL = {torch.float32: 1e-4, torch.float64: 2e-3}
# flagship training accuracy floor: the labels are a linear rule in 20-D,
# which 64 RBF inducing points fit only in part (0.8965 for the plain
# version on a CPU); chance is 0.5
MIN_FLAGSHIP_ACC = 0.8
# the multi-latent configurations of bench.py (multiclass_k10_m64_b2048,
# heteroscedastic_m64_b2048)
MN, MD, MK, MM, MB = 50_000, 10, 10, 64, 2048
MULTI_TIMED_STEPS = 500
# floors after MAIN_STEPS steps.  With the plain versions on a CPU (float32,
# the same data and draws as the card's run) the multiclass training
# accuracy is 0.8702 (chance 0.1) and the heteroscedastic RMSE of predict_y
# against sin(x_0) is 0.3810 (predicting 0 gives 0.6578)
MIN_MC_ACC, MAX_HET_RMSE = 0.8, 0.45
# card float32 against CPU float32 after 20 steps, as max |d mu| / max |mu|
# (and |d lam| / lam): float32 sums in another order and the kernel's
# series digamma against torch.special.digamma, carried through 20 steps
MULTI_PARITY_TOL = 1e-4


def log(msg):
    print(msg, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    return torch.device("cuda:0")


def phase_build(ck):
    info = ck.build()
    ck._library()
    log(f"build: {info['seconds']:.2f} s -> {os.path.relpath(info['path'])}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


def kernel_inputs(b, m, device, seed=0):
    """Float32 card tensors as the main path hands them to the kernel: Z is
    the first m rows of the data, K^-1 from the RBF gram, rho = N/B."""
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, D))
    A = rng.normal(size=(m, m))
    t = {
        "X": X[m:], "Z": X[:m], "y": np.where(rng.normal(size=b) > 0, 1.0, -1.0),
        "mu": rng.normal(size=m), "Sigma": A @ A.T / m + np.eye(m),
    }
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
    Z = t["Z"] / 2.0
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    L = linalg.safe_cholesky(torch.exp(-0.5 * r2), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    return t


def call(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], 2.0, 1.0, 1e-3, N / B)


def cuda_ms(fn, reps=200):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel_vs_plain(ck, device):
    names = ("s1", "S2", "c", "theta", "mf", "vf")
    errs = {}
    for b, m in ((B, M), (300, M), (B, 128)):
        t = kernel_inputs(b, m, device)
        out = call(ck.fused_cavi_stats, t)
        torch.cuda.synchronize()
        ref = call(ck.fused_cavi_stats_reference, t)
        torch.cuda.synchronize()
        row = {}
        for name, o, r in zip(names, out, ref):
            if not bool(torch.isfinite(o).all()):
                raise AssertionError(f"kernel output {name} not finite at B={b}, M={m}")
            abs_err = float((o - r).abs().max())
            rel = abs_err / max(float(r.abs().max()), 1.0)
            if rel > KERNEL_TOL:
                raise AssertionError(f"kernel vs plain at B={b}, M={m}: {name} error {rel:.3e} > {KERNEL_TOL}")
            row[name] = abs_err
        errs[f"B{b}_M{m}"] = row
        log(f"kernel vs plain B={b} M={m}: max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
    t = kernel_inputs(B, M, device)
    plain = [cuda_ms(lambda: call(ck.fused_cavi_stats_reference, t))]
    kern = [cuda_ms(lambda: call(ck.fused_cavi_stats, t)) for _ in range(2)]
    plain.append(cuda_ms(lambda: call(ck.fused_cavi_stats_reference, t)))
    log(f"flagship B={B} D={D} M={M}: kernel {kern[0]:.4f}/{kern[1]:.4f} ms, plain {plain[0]:.4f}/{plain[1]:.4f} ms per call")
    return errs, sum(kern) / 2, sum(plain) / 2


def multi_inputs(b, m, n_latent, device, seed=0):
    """Float32 card tensors as the multi-latent paths hand them to their
    kernels: Z from the data, per-latent lengthscale 2 and variance 1,
    K^-1 from the RBF gram, random SPD Sigma, one-hot labels (multiclass),
    y = sin(x_0) (heteroscedastic), alpha = beta = K as at the first step."""
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = rng.normal(size=(b + m, MD))
    A = rng.normal(size=(n_latent, m, m))
    t = {
        "X": X[m:], "Z": np.stack([X[:m]] * n_latent), "ls": np.full((n_latent, MD), 2.0),
        "var": np.ones(n_latent), "mu": rng.normal(size=(n_latent, m)),
        "Sigma": A @ A.transpose(0, 2, 1) / m + np.eye(m),
        "onehot": np.eye(n_latent)[rng.integers(0, n_latent, size=b)], "y": np.sin(X[m:, 0]),
        "alpha": np.full(b, float(n_latent)), "beta": np.full(b, float(n_latent)),
    }
    t = {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in t.items()}
    Z = t["Z"][0] / 2.0
    r2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    L = linalg.safe_cholesky(torch.exp(-0.5 * r2), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.expand(n_latent, m, m).contiguous()
    return t


def call_mc(fn, t):
    return fn(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, MN / MB,
              t["alpha"], t["beta"])


def call_het(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, MN / MB, 1.0)


def phase_multi_kernels_vs_plain(ck, device):
    """Both multi-latent kernels against their plain versions; returns
    {name: (largest abs error at the path's shape, kernel ms, plain ms)}."""
    cases = {
        "fused_cavi_stats_multiclass": (MK, call_mc, ("s1", "S2", "c", "theta", "gamma", "alpha")),
        "fused_cavi_stats_het": (2, call_het, ("s1", "S2", "c", "phi", "gamma", "theta", "sigg")),
    }
    out = {}
    for name, (n_latent, call_fn, names) in cases.items():
        kern, plain = getattr(ck, name), getattr(ck, name + "_reference")
        errs = {}
        for b, m in ((MB, MM), (300, MM), (MB, 128)):
            t = multi_inputs(b, m, n_latent, device)
            got = call_fn(kern, t)
            torch.cuda.synchronize()
            ref = call_fn(plain, t)
            torch.cuda.synchronize()
            row = {}
            for o_name, o, r in zip(names, got, ref):
                if not bool(torch.isfinite(o).all()):
                    raise AssertionError(f"{name} output {o_name} not finite at B={b}, M={m}")
                abs_err = float((o - r).abs().max())
                rel = abs_err / max(float(r.abs().max()), 1.0)
                if rel > KERNEL_TOL:
                    raise AssertionError(f"{name} vs plain at B={b}, M={m}: {o_name} error {rel:.3e} > {KERNEL_TOL}")
                row[o_name] = abs_err
            errs[(b, m)] = row
            log(f"{name} vs plain B={b} M={m}: max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
        t = multi_inputs(MB, MM, n_latent, device)
        plain_ms = [cuda_ms(lambda: call_fn(plain, t))]
        kern_ms = [cuda_ms(lambda: call_fn(kern, t)) for _ in range(2)]
        plain_ms.append(cuda_ms(lambda: call_fn(plain, t)))
        log(f"{name} B={MB} D={MD} M={MM} L={n_latent}: kernel {kern_ms[0]:.4f}/{kern_ms[1]:.4f} ms, "
            f"plain {plain_ms[0]:.4f}/{plain_ms[1]:.4f} ms per call")
        out[name] = (max(errs[(MB, MM)].values()), sum(kern_ms) / 2, sum(plain_ms) / 2)
    return out


def flagship_data(device, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def flagship_model(agt, X, b=B):
    return agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0),
        agt.LogisticLikelihood.create(),
        agt.AnalyticSVI(b, minibatch_sampling="block"),
        X[:M],
        optimiser=None,
    )


def phase_main_path(agt, ck, device):
    from agp_tpu_torch.training.train import vi_steps

    X, y = flagship_data(device)
    model = flagship_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    ck.fused_cavi_stats.launches = ck.fused_cavi_stats_multiclass.launches = ck.fused_cavi_stats_het.launches = 0
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = ck.fused_cavi_stats.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"{MAIN_STEPS} steps launched the kernel {launches} times")
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("non-finite posterior after the main path")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if acc < MIN_FLAGSHIP_ACC:
        raise AssertionError(f"flagship training accuracy {acc:.4f} < {MIN_FLAGSHIP_ACC}")
    log(f"main path: {MAIN_STEPS} steps through agp_tpu_torch.train in {train_s:.3f} s "
        f"(first call, kernel loaded), {launches} launches, training accuracy {acc:.4f}")

    model, state = vi_steps(model, state, X, y, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = TIMED_STEPS / (time.perf_counter() - t0)
    log(f"steady state: {ips:.1f} CAVI iterations/s over {TIMED_STEPS} steps")
    return launches


def phase_oracle_and_parity(agt, device):
    from agp_tpu_torch.training.train import vi_steps

    rng = np.random.default_rng(0)
    Xo = rng.uniform(-2, 2, size=(300, 2))
    yo = (np.sin(2 * Xo[:, 0]) + 0.5 * Xo[:, 1] > 0).astype(np.float32)
    Xo = torch.as_tensor(Xo, dtype=torch.float32, device=device)
    yo = torch.as_tensor(yo, device=device)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(), agt.LogisticLikelihood.create(), agt.AnalyticSVI(64),
        Z=Xo[:32], optimiser=None,
    )
    model, state = agt.train(model, Xo, yo, iterations=150,
                             generator=torch.Generator(device=device).manual_seed(0))
    acc = float(((agt.predict_y(model, state, Xo) > 0) == (yo > 0)).float().mean())
    if acc <= 0.9:
        raise AssertionError(f"oracle accuracy {acc:.4f} <= 0.9")
    log(f"oracle (N=300, M=32, B=64, 150 iterations): accuracy {acc:.4f}")

    n = 20_000
    Xc, yc = flagship_data("cpu", n=n, seed=1)
    draws = torch.randint(0, n // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))

    def mu_after_20(dev, dt):
        X, y = Xc.to(device=dev, dtype=dt), yc.to(device=dev, dtype=dt)
        model = flagship_model(agt, X)
        state = agt.init_state(model, X, y)
        _, state = vi_steps(model, state, X, y, 20, draws=draws.to(dev))
        return state.mu.double().cpu()

    mu_card = mu_after_20(device, torch.float32)
    for dt, tol in PARITY_TOL.items():
        mu_cpu = mu_after_20(torch.device("cpu"), dt)
        err = float((mu_card - mu_cpu).abs().max() / mu_cpu.abs().max())
        if not err <= tol:
            raise AssertionError(f"card float32 vs CPU {dt} mu after 20 steps: {err:.3e} > {tol}")
        log(f"parity: 20 steps card (float32) vs CPU ({dt}), max |d mu| / max |mu| = {err:.3e}")


def mc_data(device, seed=0):
    """bench.py's multiclass data: X standard normal, labels the argmax of
    X W with W [D, K] standard normal."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(MN, MD)).astype(np.float32)
    y = np.argmax(X @ rng.normal(size=(MD, MK)).astype(np.float32), axis=1)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def het_data(device, seed=0):
    """bench.py's heteroscedastic data: y = sin(x_0) + 0.1 eps."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(MN, MD)).astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.1 * rng.normal(size=MN)).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def multi_model(agt, X, which):
    lik = agt.LogisticSoftMaxLikelihood.create(MK) if which == "multiclass" else agt.HeteroscedasticLikelihood.create()
    return agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0), lik, agt.AnalyticSVI(MB, minibatch_sampling="slice"),
        X[:MM], optimiser=None,
    )


def multi_quality(agt, model, state, X, y, which):
    """Training accuracy (multiclass) or RMSE of predict_y against the
    noiseless sin(x_0) (heteroscedastic)."""
    pred = agt.predict_y(model, state, X)
    if which == "multiclass":
        return float((pred == y).float().mean())
    return float(torch.sqrt(torch.mean((pred - torch.sin(X[:, 0])) ** 2)))


def phase_multi_path(agt, ck, device, which):
    """One multi-latent bench configuration through agp_tpu_torch.train:
    MAIN_STEPS steps with one kernel launch each, its floor, then
    steady-state iterations/s.  Returns (launches, quality, it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    wrapper = ck.fused_cavi_stats_multiclass if which == "multiclass" else ck.fused_cavi_stats_het
    X, y = (mc_data if which == "multiclass" else het_data)(device)
    model = multi_model(agt, X, which)
    gen = torch.Generator(device=device).manual_seed(0)
    ck.fused_cavi_stats.launches = ck.fused_cavi_stats_multiclass.launches = ck.fused_cavi_stats_het.launches = 0
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = wrapper.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"{which}: {MAIN_STEPS} steps launched its kernel {launches} times")
    tensors = [state.mu, state.Sigma] + ([model.likelihood.lam] if which == "het" else [])
    if not all(bool(torch.isfinite(t).all()) for t in tensors):
        raise AssertionError(f"{which}: non-finite posterior or lambda after the main path")
    quality = multi_quality(agt, model, state, X, y, which)
    if which == "multiclass" and not quality >= MIN_MC_ACC:
        raise AssertionError(f"multiclass training accuracy {quality:.4f} < {MIN_MC_ACC}")
    if which == "het" and not quality <= MAX_HET_RMSE:
        raise AssertionError(f"heteroscedastic RMSE {quality:.4f} > {MAX_HET_RMSE}")
    extra = f", lambda {float(model.likelihood.lam):.4f}" if which == "het" else ""
    log(f"{which} path: {MAIN_STEPS} steps through agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, "
        f"{'training accuracy' if which == 'multiclass' else 'RMSE vs sin(x_0)'} {quality:.4f}{extra}")

    y_t = model.likelihood.treat_labels(y)[0].to(X.dtype)
    model, state = vi_steps(model, state, X, y_t, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y_t, MULTI_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = MULTI_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"{which} steady state: {ips:.1f} CAVI iterations/s over {MULTI_TIMED_STEPS} steps")
    return launches, quality, ips


def phase_multi_parity(agt, device):
    """20 steps of each multi-latent path on the card (float32) against the
    same steps on the CPU (float32, the plain versions), same draws."""
    from agp_tpu_torch.training.train import vi_steps

    draws = torch.randint(0, MN - MB + 1, (20,), generator=torch.Generator().manual_seed(1))
    for which, data in (("multiclass", mc_data), ("het", het_data)):
        Xc, yc = data("cpu", seed=1)

        def after_20(dev):
            X, y = Xc.to(dev), yc.to(dev)
            model = multi_model(agt, X, which)
            y_t, lik = model.likelihood.treat_labels(y)
            model = model.replace(likelihood=lik)
            y_t = y_t.to(X.dtype)
            state = agt.init_state(model, X, y_t)
            model, state = vi_steps(model, state, X, y_t, 20, draws=draws.to(dev))
            lam = model.likelihood.lam.double().cpu() if which == "het" else None
            return state.mu.double().cpu(), lam

        (mu_card, lam_card), (mu_cpu, lam_cpu) = after_20(device), after_20(torch.device("cpu"))
        err = float((mu_card - mu_cpu).abs().max() / mu_cpu.abs().max())
        if lam_cpu is not None:
            err = max(err, float((lam_card - lam_cpu).abs() / lam_cpu))
        if not err <= MULTI_PARITY_TOL:
            raise AssertionError(f"{which}: card float32 vs CPU float32 after 20 steps: {err:.3e} > {MULTI_PARITY_TOL}")
        log(f"{which} parity: 20 steps card (float32) vs CPU (float32), max |d mu| / max |mu| "
            f"(and |d lam| / lam) = {err:.3e}")


def main():
    device = phase_device()
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck

    phase_build(ck)
    errs, kern_ms, plain_ms = phase_kernel_vs_plain(ck, device)
    multi = phase_multi_kernels_vs_plain(ck, device)
    launches = phase_main_path(agt, ck, device)
    phase_oracle_and_parity(agt, device)
    multi_launches = {
        "fused_cavi_stats_multiclass": phase_multi_path(agt, ck, device, "multiclass")[0],
        "fused_cavi_stats_het": phase_multi_path(agt, ck, device, "het")[0],
    }
    phase_multi_parity(agt, device)

    kernels = {"kernels": [{
        "name": "fused_cavi_stats",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats.cu",
        "replaces": "agp_tpu/ops/pallas_kernels.py:750",
        "launches": launches,
        "max_abs_err": max(errs[f"B{B}_M{M}"].values()),
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats_multi.cu",
        "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
        "launches": multi_launches[name],
        "max_abs_err": multi[name][0],
        "ms": multi[name][1],
        "plain_ms": multi[name][2],
    } for name, line in (("fused_cavi_stats_multiclass", 953), ("fused_cavi_stats_het", 1133))]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
