"""Smoke run of the PyTorch port (agp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, turn TF32 off, print the card's name and power
   limit (nvidia-smi);
2. build: compile the CUDA kernel from the repo's sources with nvcc for
   sm_90a;
3. kernel vs plain: the CUDA fused_cavi_stats against its plain PyTorch
   version on the same card tensors at B=4096/M=64 (the flagship), a ragged
   B=300 and M=128, then both timed at the flagship shape;
4. main path: the flagship workload (SVGP + RBF + logistic, N=200,000, D=20,
   M=64, B=4096, block sampling, float32) trained through
   agp_tpu_torch.train, with one kernel launch per step; training accuracy
   and steady-state CAVI iterations/s;
5. oracle and cross-device parity: the N=300 2-D oracle on the card
   (accuracy > 0.9), and 20 steps on the card (float32) against the same
   20 steps on the CPU (float32 and float64) from the same draws.

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
    ck.fused_cavi_stats.launches = 0
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


def main():
    device = phase_device()
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck

    phase_build(ck)
    errs, kern_ms, plain_ms = phase_kernel_vs_plain(ck, device)
    launches = phase_main_path(agt, ck, device)
    phase_oracle_and_parity(agt, device)

    kernels = {"kernels": [{
        "name": "fused_cavi_stats",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats.cu",
        "replaces": "agp_tpu/ops/pallas_kernels.py:750",
        "launches": launches,
        "max_abs_err": max(errs[f"B{B}_M{M}"].values()),
        "ms": kern_ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
