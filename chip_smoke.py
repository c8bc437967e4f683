"""Smoke run of the PyTorch port (agp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, turn TF32 off, print the card's name and power
   limit (nvidia-smi);
2. build: compile the CUDA kernels from the repo's sources with nvcc for
   sm_90a, one nvcc per source, all at once; then the TF32 tensor-core
   instructions that ``cuobjdump -sass`` finds in each instance of kernels
   4-9 (kappa_moments_batched, kappa_single, stats_tc, variant_rows; none
   fails the run), and kernels 4, 6 and 8-9's shared memory against the
   wrappers' Python copies of it, which choose their row tiles;
3. kernels vs plain: each CUDA kernel against its plain PyTorch version on
   the same card tensors, at its main path's shape, a ragged B=300 and
   M=128, then both timed at the main path's shape (CUDA events, in the
   order plain, kernel, kernel, plain):
   - fused_cavi_stats at B=4096, M=64, D=20 (the flagship), then each of
     its 8 likelihood branches (rbf) at that shape and at B=300, and each
     of its 4 gram kinds (Student-t) at M=64 and M=128, each timed at the
     flagship shape; then at the oracle paths' shape (B=8192, D=2, M=128)
     each branch (rbf) and each Matern kind (Student-t), held against the
     plain version in float64 (see FLOAT32_FACTOR);
   - fused_cavi_stats_multiclass at B=2048, M=64, D=10, K=10, and
     fused_cavi_stats_het at B=2048, M=64, D=10, each with every kind;
4. flagship path: SVGP + RBF + logistic, N=200,000, D=20, M=64, B=4096,
   block sampling, float32, trained through agp_tpu_torch.train with one
   kernel launch per step; training accuracy and steady-state CAVI
   iterations/s;
5. Student-t rate: the same shape with y = the flagship's latent
   + 0.1 t_4 and the Student-t likelihood, its launches and steady-state
   iterations/s, the first path of a child process
   (``python3 chip_smoke.py studentt-rate``);
6. oracle and cross-device parity: the N=300 2-D oracle on the card
   (accuracy > 0.9), and 20 flagship steps on the card (float32) against
   the same 20 steps on the CPU (float32 and float64) from the same draws;
7. multiclass path: the bench.py configuration (logistic-softmax, K=10,
   N=50,000, D=10, M=64, B=2048, slice sampling, float32), trained the same
   way; training accuracy and iterations/s;
8. heteroscedastic path: the bench.py configuration (N=50,000, D=10, M=64,
   B=2048, slice sampling, float32); RMSE of predict_y against the
   noiseless sin(x_0), and iterations/s;
9. multi-latent parity: 20 steps of each of paths 7 and 8, and of path 7
   with the Matern-3/2 kernel, on the card (float32) against the same 20
   steps on the CPU (float32), same draws;
10. single-latent oracles: the fused-tier oracles of
   benchmarks/tpu_acceptance.py for the seven other likelihoods (N=30,000,
   D=2, M=128, B=8192, slice sampling, 150 steps) and the Student-t one
   with each Matern kernel, each through agp_tpu_torch.train with one
   launch per step and its floor;
11. single-latent parity: 20 steps of each path of phase 10 on the card
   (float32) against the same steps on the CPU (float32), at the
   flagship's conditioning (1e-4; see MATERN12_PARITY_TOL) and at the
   oracle configuration, there against each path's own float32 noise and
   against the card with the plain version in the kernel's place (see
   ORACLE_DEVICE_FACTOR);
12. the batched pair (kernels 4-5, several latents) and the single-latent
   split pair (kernels 6-7, one latent beyond the fused range) against
   their plain versions at the M=512 paths' shapes (at the ill-conditioned
   ones against float64, within FLOAT32_FACTOR times the float32 plain
   version's own error), the flagship's, ragged B=300, M=129 (kernels 4-5
   with 1-3 latents) and each Matern kind, a second call of each kernel
   bit-equal, timed beside the plain versions and torch.bmm / torch.matmul
   (for kernels 4 and 6 their tensor products alone); kernel 4's and
   kernel 6's autograd;
13. logistic_m512_b65536 (bench.py: N=500,000, D=20, M=512, B=65,536) and
   the reference's seven single-latent oracles at M=512, each with one
   launch of kernel 6 and of kernel 7 a step, and the reference's M=512
   multiclass (K=3) and heteroscedastic oracles, each with one launch of
   kernel 4 and of kernel 5 a step, each with its floor;
14. the pairs' parity: 20 steps of each path of phase 13, at B=2048, on
   the card against the CPU, each against its own float32 noise;
15. the hyperparameter step (the reference's default Adam(0.01) on the
   kernel, every iteration): path A, the flagship (one launch of kernel 1
   a step and of kernel 6 a hyperparameter step), and path B,
   logistic_m512_b65536 (kernel 6 twice and kernel 7 once an iteration),
   each with its floor, moved and finite log-hyperparameters and its
   steady rate; then 20 iterations of each on the card against the CPU,
   against each path's own float32 noise;
16. kernels 8-9 (the bench's fused variants): each variant against its
   plain version at the flagship's B=4096, D=20, M=64, a ragged B=300 with
   M=128, the sweep's four rows (B=262,144, M=128; B=8192, M=512;
   B=65,536, M=256 and 512; D=8) and a ragged B=300 at M=129 and M=520,
   a second call bit-equal; at the ill-conditioned oracle shapes (M=128,
   with kernel 1, and M=512) against the float64 plain version with no
   floor (Ktilde's, S2's and mf's errors logged); timed at the flagship
   shape and the sweep's rows beside kernel 1 (M <= 128), the sweep's bar
   and the plain versions, with device us at B=262,144, M=128; then the
   bench's variants mode, their main path, with its exact launches;
17. kernel 10 (the bench's tile gather) bit-equal to index_select on the
   tile view (tiles of 32 and 64 rows, a ragged T, the scalar paths),
   timed beside it; then the bench's gather mode with its exact launches;
18. the bench's entry point, ``python3 -m agp_tpu_torch.bench`` at a cut
   step count in a child process: its JSON line parses and its rate is
   finite and positive.

Each path's launch counts are set to 0 just before it and read just after.
Each phase's wall time is logged, then all of them and the total.  Prints
the kernels' JSON line, then the device JSON line last.

Other modes: ``studentt-rate`` (phase 5's child), ``profile logistic``,
``profile multiclass`` or ``profile hyper A|B`` (torch.profiler over 20
steps of an M=512 path, or 20 iterations of path A or B with a
hyperparameter step each), ``profile kernels`` (device time of the bench's
candidates at each of its shapes: kernels 1 (M <= 128), 8, 9, the sweep's
bar; kernel 10 and index_select),
``moved-paths`` (a row-weighted step and elbo at fused-range shapes),
``stats`` (kernels 5 and 7 at phase 12's timed shapes by CUDA events and
device us, logistic_m512_b65536's steady it/s and ``profile logistic``),
``kappa`` (kernels 6 and 4 at phase 12's timed shapes by CUDA events and
device us beside their tensor products alone, the steady it/s of
logistic_m512_b65536 and of path B, ``profile logistic`` and ``profile
multiclass``), ``probe`` (builds and runs
agp_tpu_torch/csrc/probes/kappa_tc.cu: kernel 6's parts, kernels 4 and 6
at other tile shapes, the mma.sync rate with and without 3xTF32's
splits), ``variants`` (kernels 8-9 at the flagship shape and the sweep's
rows by CUDA events and device us beside the bar, and each form with
each row tile at the sweep's M=128 and M=512 rows).  ``ab ROOT MODE...``
runs any mode with agp_tpu_torch imported from ROOT (an earlier commit
unpacked under _chip/), to compare two trees in one call: ``ab ROOT
kappa`` and ``kappa`` (or ``variants``) in the order parent, this, this,
parent.
"""
from __future__ import annotations

import contextlib
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
# kernel 1 at the oracle paths' shape (B=8192, D=2, M=128, lengthscale 1,
# Z on the batch's rows): K^-1's entries reach ~800, so float32 fixes the
# outputs only to ~5e-3 of their largest entry (the plain version against
# itself in float64 on the same inputs), and kernel and plain version in
# float32 differ by up to 2.5e-4 there.  Each output is held against the
# float64 plain version instead, within this many times the float32 plain
# version's own error (on an H100 the ratio reads 0.83-1.05).
FLOAT32_FACTOR = 2.0
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
# the single-latent oracles of benchmarks/tpu_acceptance.py:278-367, at
# M=128 (the reference's 512 is above the CUDA kernel's range)
ON, OM, OB, OSTEPS = 30_000, 128, 8192, 150
ORACLE_LIKS = ("gaussian", "studentt", "laplace", "matern32", "bayesiansvm", "poisson", "negbinomial")
# floors of the oracle paths, by "likelihood/kernel": (metric, floor) on
# X[:4096], as the reference measures them: "rmse" of predict_f against the
# noiseless f (below the floor), "acc" of predict_y (above), "corr" of
# predict_y with the true rate or mean (above).  Each allows about three
# times the plain version's error on a CPU (1 - accuracy for the SVM; the
# correlations are held at 0.99) (float32, the same data, CPU draws:
# RMSE 0.0037 Gaussian, 0.0095 Student-t, 0.0055 Laplace, 0.0052
# Matern-3/2 noise, 0.0582 / 0.0224 / 0.0141 Student-t with Matern
# 1/2, 3/2, 5/2; accuracy 0.9875; corr 0.9992 Poisson, 0.9995 negative
# binomial) and inside the reference's own floor (RMSE 0.25, 0.25, 0.3;
# accuracy 0.9; corr 0.8; none for the Gaussian).
ORACLE_FLOORS = {
    "gaussian/SqExponentialKernel": ("rmse", 0.012),
    "studentt/SqExponentialKernel": ("rmse", 0.03),
    "laplace/SqExponentialKernel": ("rmse", 0.017),
    "matern32/SqExponentialKernel": ("rmse", 0.016),
    "bayesiansvm/SqExponentialKernel": ("acc", 0.96),
    "poisson/SqExponentialKernel": ("corr", 0.99),
    "negbinomial/SqExponentialKernel": ("corr", 0.99),
    "studentt/Matern12Kernel": ("rmse", 0.18),
    "studentt/Matern32Kernel": ("rmse", 0.07),
    "studentt/Matern52Kernel": ("rmse", 0.045),
}
MATERN_KERNELS = ("Matern12Kernel", "Matern32Kernel", "Matern52Kernel")
# the batched pair's paths, M=512 (beyond the fused kernels' range):
# bench.py's logistic_m512_b65536 (N, D, B) and the reference's batched
# multiclass (K=3, B=8192, 200 steps) and heteroscedastic (B=16384, 100
# steps) oracles, tpu_acceptance.py:370-412
LN, LD, PM, LB = 500_000, 20, 512, 65_536
L_TRAIN_STEPS, L_TIMED_STEPS = 50, 300
PAIR_MC_B, PAIR_MC_STEPS, PAIR_HET_B, PAIR_HET_STEPS = 8192, 200, 16384, 100
# the Student-t steady state at the flagship shape
T_TIMED_STEPS = 1000
# iterations (each with a hyperparameter step) of the steady rates of the
# hyperparameter paths A (the flagship) and B (logistic_m512_b65536)
A_TIMED_STEPS, B_TIMED_STEPS = 300, 60
# the log-hyperparameters of paths A and B must move by more than this
# (Adam(0.01) moves each by up to 0.01 a step)
MIN_HYPER_MOVE = 1e-2
# single-latent parity at the flagship's conditioning (N rows)
PN = 20_000
# card vs CPU (float32) after 20 steps for Student-t with the Matern-1/2
# kernel at the flagship's conditioning, as max |d mu| / max |mu|: Kmm's
# diagonal comes through the expanded |z|^2 + |z|^2 - 2 z.z, whose rounding
# (~eps |z|^2) the Matern-1/2 gram carries as its square root (the diagonal
# reads 0.9986 where it is 1, at D=20), so float32 determines mu there only
# to ~6e-4: the plain version on a CPU, run again with X's features in
# another order, moves it by 6.1e-4 (1e-6 for the other kernels).  The
# bound is five times that; the other paths are held at MULTI_PARITY_TOL.
MATERN12_PARITY_TOL = 3e-3
# 20 steps at the oracle configuration (M=128 in 2-D at lengthscale 1),
# as max |d mu| / max |mu| (and |d lam| / lam), each path against its own
# float32 noise: the plain version on the CPU, run again with the inducing
# points in another order, moves mu by 5.4e-6 - 3.4e-3 there.
# - The kernel's part: the card with the kernel against the card with the
#   plain version in its place, within the noise (on an H100 it reads
#   0.008-0.13 times the noise).
# - Card against CPU (both float32) within ORACLE_DEVICE_FACTOR times the
#   noise: the card's own dense float32 algebra (Cholesky, solves, K^-1)
#   moves mu by up to 5.1 times the noise on these paths, with the plain
#   version in the kernel's place as much as with the kernel (within 2 %
#   on an H100), so that part of the gap is not the kernel's.
# Both bounds are at least MULTI_PARITY_TOL.
ORACLE_DEVICE_FACTOR = 10.0


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
    name = ""
    for line in info["log"].splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {name[:90]}: {line.split(':', 1)[-1].strip()}")
    return info["path"]


# the kernels that run on the tensor cores, by the name of their CUDA
# function: every instance must hold TF32 mma instructions
TC_KERNELS = {"kappa_moments_batched": "kernel 4", "stats_tc": "kernels 5 and 7", "kappa_single": "kernel 6",
              "variant_rows": "kernels 8-9"}


def check_tc_sass(lib_path):
    """Kernels 4-9 run on the tensor cores: every instance of
    kappa_moments_batched (kernel 4), kappa_single (6), stats_tc (5 and
    7, and the statistics of 8-9) and variant_rows (8-9, every form) in the
    built library holds TF32 HMMA (or HGMMA) instructions, as ``cuobjdump
    -sass`` shows them, and each of the four has one."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    # the function's own name in the mangled one (the anonymous namespace's
    # name holds the source file's, e.g. kappa_single_cu)
    own = re.compile(r"\d(" + "|".join(TC_KERNELS) + r")I")
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            if own.search(name):
                counts[name] = 0
        elif name in counts and ("HMMA" in line and "TF32" in line or "HGMMA" in line):
            counts[name] += 1
    missing = [k for k in TC_KERNELS if not any(own.search(n)[1] == k for n in counts)]
    if missing or not all(counts.values()):
        raise AssertionError(f"a tensor-core kernel holds no TF32 tensor-core instruction in its SASS: {counts}, "
                             f"no instance of {missing}")
    for fn, n in sorted(counts.items()):
        stats = re.search(r"stats_tcILb(\d)", fn)
        tile = re.search(r"(kappa_single|kappa_moments_batched|variant_rows)INS_9TileShapeILi(\d+)ELi(\d+)ELi(\d+)E",
                         fn)
        if stats:
            label = f"stats_tc<{'16-byte' if stats[1] == '1' else '4-byte'} copies>"
        elif tile:
            label = f"{tile[1]}<{tile[2]}-row tiles, {tile[3]} x {tile[4]} warps>"
        else:
            label = fn[:90]
        kernel = TC_KERNELS[own.search(fn)[1]]
        log(f"  SASS: {label} ({kernel}; {fn[:40]}...): {n} TF32 HMMA/HGMMA")


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
        row = check_outputs(f"kernel vs plain at B={b}, M={m}", names, out, ref)
        errs[f"B{b}_M{m}"] = row
        log(f"kernel vs plain B={b} M={m}: max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
    t = kernel_inputs(B, M, device)
    kern_ms, plain_ms = timed_pair(lambda: call(ck.fused_cavi_stats, t), lambda: call(ck.fused_cavi_stats_reference, t))
    log(f"flagship B={B} D={D} M={M}: kernel {kern_ms:.4f} ms, plain {plain_ms:.4f} ms per call")
    return errs, kern_ms, plain_ms


def multi_inputs(b, m, n_latent, device, seed=0, kind="rbf"):
    """Float32 card tensors as the multi-latent paths hand them to their
    kernels: Z from the data, per-latent lengthscale 2 and variance 1,
    K^-1 from the gram of ``kind``, random SPD Sigma, one-hot labels
    (multiclass), y = sin(x_0) (heteroscedastic), alpha = beta = K as at
    the first step."""
    import agp_tpu_torch as agt
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
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=2.0)
    L = linalg.safe_cholesky(kern.gram(t["Z"][0]), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.expand(n_latent, m, m).contiguous()
    t["kind"] = kind
    return t


def call_mc(fn, t):
    return fn(t["X"], t["onehot"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, MN / MB,
              t["alpha"], t["beta"], kind=t["kind"])


def call_het(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], t["var"], 1e-3, MN / MB, 1.0,
              kind=t["kind"])


def phase_multi_kernels_vs_plain(ck, device):
    """Both multi-latent kernels against their plain versions: rbf at the
    path's shape, B=300 and M=128, each Matern kind at the path's shape;
    each kind timed at the path's shape.  Returns {name: (largest abs error
    over every check, kernel ms, plain ms, {kind: (kernel ms, plain ms)})},
    the first two at rbf."""
    cases = {
        "fused_cavi_stats_multiclass": (MK, call_mc, ("s1", "S2", "c", "theta", "gamma", "alpha")),
        "fused_cavi_stats_het": (2, call_het, ("s1", "S2", "c", "phi", "gamma", "theta", "sigg")),
    }
    out = {}
    for name, (n_latent, call_fn, names) in cases.items():
        kern, plain = getattr(ck, name), getattr(ck, name + "_reference")
        worst, per_kind = 0.0, {}
        checks = [("rbf", MB, MM), ("rbf", 300, MM), ("rbf", MB, 128)] + [(k, MB, MM) for k in ck.KINDS[1:]]
        for kind, b, m in checks:
            t = multi_inputs(b, m, n_latent, device, kind=kind)
            got = call_fn(kern, t)
            torch.cuda.synchronize()
            ref = call_fn(plain, t)
            torch.cuda.synchronize()
            row = check_outputs(f"{name} {kind} B={b} M={m}", names, got, ref)
            worst = max(worst, *row.values())
            log(f"{name} vs plain {kind} B={b} M={m}: max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
        for kind in ck.KINDS:
            t = multi_inputs(MB, MM, n_latent, device, kind=kind)
            per_kind[kind] = timed_pair(lambda: call_fn(kern, t), lambda: call_fn(plain, t))
            log(f"{name} {kind} B={MB} D={MD} M={MM} L={n_latent}: kernel {per_kind[kind][0]:.4f} ms, "
                f"plain {per_kind[kind][1]:.4f} ms per call")
        out[name] = (worst, *per_kind["rbf"], per_kind)
    return out


def flagship_data(device, n=N, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = np.where(X @ w > 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def flagship_model(agt, X, b=B, optimiser=None):
    return agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0),
        agt.LogisticLikelihood.create(),
        agt.AnalyticSVI(b, minibatch_sampling="block"),
        X[:M],
        optimiser=optimiser,
    )


def phase_main_path(agt, ck, device):
    from agp_tpu_torch.training.train import vi_steps

    X, y = flagship_data(device)
    model = flagship_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, "flagship", route_launches(MAIN_STEPS, "fused"))
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


def multi_model(agt, X, which, kernel="SqExponentialKernel"):
    lik = agt.LogisticSoftMaxLikelihood.create(MK) if which == "multiclass" else agt.HeteroscedasticLikelihood.create()
    return agt.SVGP.create(
        getattr(agt, kernel)(lengthscale=2.0), lik, agt.AnalyticSVI(MB, minibatch_sampling="slice"),
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
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, which, route_launches(MAIN_STEPS, "fused", fused=wrapper.__name__))
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


def after_20(agt, model, X, y, draws):
    """mu (and lambda, where the likelihood has one) after 20 steps of
    ``model`` on (X, y) with the given draws, on X's device, as float64 on
    the CPU."""
    from agp_tpu_torch.training.train import vi_steps

    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(device=X.device, dtype=X.dtype)
    state = agt.init_state(model, X, y_t)
    model, state = vi_steps(model, state, X, y_t, 20, draws=draws.to(X.device))
    lam = getattr(model.likelihood, "lam", None)
    return state.mu.double().cpu(), None if lam is None else lam.double().cpu()


def rel_err(a, b):
    """max |d mu| / max |mu| (and |d lam| / lam) between two after_20
    results, b the CPU's."""
    err = float((a[0] - b[0]).abs().max() / b[0].abs().max())
    if b[1] is not None:
        err = max(err, float((a[1] - b[1]).abs() / b[1]))
    return err


def phase_multi_parity(agt, device):
    """20 steps of each multi-latent path, and of the multiclass one with
    the Matern-3/2 kernel, on the card (float32) against the same steps on
    the CPU (float32, the plain versions), same draws."""
    draws = torch.randint(0, MN - MB + 1, (20,), generator=torch.Generator().manual_seed(1))
    for which, data, kernel in (("multiclass", mc_data, "SqExponentialKernel"), ("het", het_data, "SqExponentialKernel"),
                                ("multiclass", mc_data, "Matern32Kernel")):
        Xc, yc = data("cpu", seed=1)
        card, cpu = (after_20(agt, multi_model(agt, X, which, kernel), X, y, draws)
                     for X, y in ((Xc.to(device), yc.to(device)), (Xc, yc)))
        err = rel_err(card, cpu)
        if not err <= MULTI_PARITY_TOL:
            raise AssertionError(f"{which} {kernel}: card float32 vs CPU float32 after 20 steps: {err:.3e} > {MULTI_PARITY_TOL}")
        log(f"{which} {kernel} parity: 20 steps card (float32) vs CPU (float32), "
            f"max |d mu| / max |mu| (and |d lam| / lam) = {err:.3e}")


# --------------------------------------------- the single-latent branches
def single_latent_lik(agt, name):
    """The port's likelihood of fused_cavi_stats's branch ``name`` as the
    kernel checks take it, here and in tests/test_torch_cuda.py, with
    parameters away from their defaults (Student-t's sigma != 1 tests its
    sigma^2 slot)."""
    return {
        "logistic": lambda: agt.LogisticLikelihood.create(),
        "gaussian": lambda: agt.GaussianLikelihood.create(0.05),
        "studentt": lambda: agt.StudentTLikelihood.create(4.0, 0.7),
        "laplace": lambda: agt.LaplaceLikelihood.create(0.3),
        "matern32": lambda: agt.Matern32Likelihood.create(0.7),
        "bayesiansvm": lambda: agt.BayesianSVM.create(),
        "negbinomial": lambda: agt.NegBinomialLikelihood.create(5.0),
        "poisson": lambda: agt.PoissonLikelihood.create(2.0),
    }[name]()


def single_latent_labels(name, f, rng):
    """Labels for likelihood ``name`` around the latent f: f plus noise of
    the likelihood's kind (regression), sign(f) (classification), counts
    of rate 5 sigma(f) (Poisson) or NB(5, sigma(f - 1)) drawn as
    Poisson(Gamma) (negative binomial)."""
    if name in ("logistic", "bayesiansvm"):
        return np.where(f > 0, 1.0, -1.0)
    if name == "poisson":
        return rng.poisson(5.0 / (1.0 + np.exp(-f))).astype(float)
    if name == "negbinomial":
        p = 1.0 / (1.0 + np.exp(-(f - 1.0)))
        return rng.poisson(rng.gamma(5.0, p / (1.0 - p))).astype(float)
    noise = {"studentt": lambda: rng.standard_t(4.0, size=f.shape), "laplace": lambda: rng.laplace(size=f.shape)}
    return f + 0.1 * noise.get(name, lambda: rng.normal(size=f.shape))()


def branch_inputs(agt, b, m, device, lik, kind, at="flagship", seed=0):
    """Float32 card tensors as a main path hands them to kernel 1 for
    likelihood ``lik`` and gram kind ``kind``: a random mu and SPD Sigma,
    K^-1 from that kind's gram, and the likelihood's (p0, p1) as the step
    takes them.
    - at="flagship": X standard normal in D dimensions, Z the m rows before
      the batch, lengthscale 2, rho = N/B, labels around sin(x_0) + 0.5 x_1;
    - at="oracle": an oracle path's first slice, the first b rows of its
      data (D=2, labels as the oracle draws them), Z = X[:m] on those rows,
      lengthscale 1 (the kernels' default), rho = ON/OB."""
    from agp_tpu_torch.inference.analytic_vi import _fused_lik_spec
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    if at == "flagship":
        X = rng.normal(size=(b + m, D))
        data = {"X": X[m:], "Z": X[:m], "y": single_latent_labels(lik, np.sin(X[m:, 0]) + 0.5 * X[m:, 1], rng)}
        ls, rho = 2.0, N / B
    else:
        X, y, _ = oracle_data(lik, "cpu")
        data = {"X": X[:b], "Z": X[:m], "y": y[:b]}
        ls, rho = 1.0, ON / OB
    A = rng.normal(size=(m, m))
    data.update(mu=rng.normal(size=m), Sigma=A @ A.T / m + np.eye(m))
    t = {k: torch.as_tensor(v, dtype=torch.float32).to(device) for k, v in data.items()}
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=ls)
    L = linalg.safe_cholesky(kern.gram(t["Z"]), 1e-3)
    eye = torch.eye(m, dtype=torch.float32, device=device)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    _, t["p0"], t["p1"], _ = _fused_lik_spec(single_latent_lik(agt, lik).to(device=device, dtype=torch.float32))
    t.update(kind=kind, lik=lik, ls=ls, rho=rho)
    return t


def call_branch(fn, t):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], t["ls"], 1.0, 1e-3, t["rho"],
              lik_p0=t["p0"], lik_p1=t["p1"], kind=t["kind"], lik=t["lik"])


def check_outputs(label, names, got, ref, ref64=None, floor=KERNEL_TOL):
    """Every output finite and within KERNEL_TOL of the plain version's, as
    |d| over the output's largest entry (at least 1).  With ``ref64``, the
    plain version in float64 on the same inputs, each output's error is
    taken against it instead, within max(floor, FLOAT32_FACTOR times the
    float32 plain version's own error against it); kernels 5 and 7 pass
    floor=0, so that their tensor-core arithmetic is held to float32's own
    error however small.  Returns the largest absolute error against the
    plain version of each output."""
    row, against64 = {}, []
    for i, (name, o, r) in enumerate(zip(names, got, ref)):
        if not bool(torch.isfinite(o).all()):
            raise AssertionError(f"{label}: output {name} not finite")
        abs_err = float((o - r).abs().max())
        rel, tol = abs_err / max(float(r.abs().max()), 1.0), KERNEL_TOL
        if ref64 is not None:
            scale = max(float(ref64[i].abs().max()), 1.0)
            rel = float((o.double() - ref64[i]).abs().max()) / scale
            plain = float((r.double() - ref64[i]).abs().max()) / scale
            tol = max(floor, FLOAT32_FACTOR * plain)
            against64.append(f"{name}={rel:.2e}/{plain:.2e}")
        if rel > tol:
            raise AssertionError(f"{label}: {name} error {rel:.3e} > {tol:.3e}")
        row[name] = abs_err
    if against64:
        log(f"  {label} against float64, kernel/plain: " + " ".join(against64))
    return row


def to_float64(t):
    return {k: v.double() if isinstance(v, torch.Tensor) else v for k, v in t.items()}


def timed_pair(kern_fn, plain_fn, reps=200):
    """(kernel ms, plain ms) per call, in the order plain, kernel, kernel,
    plain, each the mean of its two runs."""
    plain = [cuda_ms(plain_fn, reps)]
    kern = [cuda_ms(kern_fn, reps) for _ in range(2)]
    plain.append(cuda_ms(plain_fn, reps))
    return sum(kern) / 2, sum(plain) / 2


def phase_branches_vs_plain(agt, ck, device):
    """Kernel 1 against its plain version on each likelihood branch (rbf)
    at the flagship shape and B=300, on each gram kind (Student-t) at M=64
    and M=128, and at the oracle paths' shape (B=8192, D=2, M=128) on each
    likelihood branch (rbf) and each Matern kind (Student-t); each branch
    and kind timed at the flagship shape, Student-t at the oracle shape.
    Returns (largest abs error, {lik: (kernel ms, plain ms)}, {kind:
    (kernel ms, plain ms)}, (kernel ms, plain ms) at the oracle shape)."""
    names = ("s1", "S2", "c", "theta", "mf", "vf")
    worst, per_lik, per_kind = 0.0, {}, {}
    cases = [(lik, "rbf", b, M, "flagship") for lik in ck.LIKS for b in (B, 300)]
    cases += [("studentt", kind, B, m, "flagship") for kind in ck.KINDS for m in (M, 128)]
    cases += [(lik, "rbf", OB, OM, "oracle") for lik in ck.LIKS]
    cases += [("studentt", kind, OB, OM, "oracle") for kind in ck.KINDS[1:]]
    for lik, kind, b, m, at in cases:
        t = branch_inputs(agt, b, m, device, lik, kind, at=at)
        got = call_branch(ck.fused_cavi_stats, t)
        torch.cuda.synchronize()
        ref = call_branch(ck.fused_cavi_stats_reference, t)
        ref64 = call_branch(ck.fused_cavi_stats_reference, to_float64(t)) if at == "oracle" else None
        torch.cuda.synchronize()
        d = t["X"].shape[1]
        row = check_outputs(f"fused_cavi_stats {lik}/{kind} B={b} D={d} M={m}", names, got, ref, ref64)
        worst = max(worst, *row.values())
        log(f"kernel vs plain {lik}/{kind} B={b} D={d} M={m}: max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
    t = branch_inputs(agt, OB, OM, device, "studentt", "rbf", at="oracle")
    oracle_ms = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                           lambda: call_branch(ck.fused_cavi_stats_reference, t))
    log(f"fused_cavi_stats studentt/rbf B={OB} D=2 M={OM} (oracle shape): kernel {oracle_ms[0]:.4f} ms, "
        f"plain {oracle_ms[1]:.4f} ms")
    for lik in ck.LIKS:
        t = branch_inputs(agt, B, M, device, lik, "rbf")
        per_lik[lik] = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                                  lambda: call_branch(ck.fused_cavi_stats_reference, t))
        log(f"fused_cavi_stats {lik}/rbf B={B} D={D} M={M}: kernel {per_lik[lik][0]:.4f} ms, plain {per_lik[lik][1]:.4f} ms")
    for kind in ck.KINDS:
        t = branch_inputs(agt, B, M, device, "studentt", kind)
        per_kind[kind] = timed_pair(lambda: call_branch(ck.fused_cavi_stats, t),
                                    lambda: call_branch(ck.fused_cavi_stats_reference, t))
        log(f"fused_cavi_stats studentt/{kind} B={B} D={D} M={M}: kernel {per_kind[kind][0]:.4f} ms, "
            f"plain {per_kind[kind][1]:.4f} ms")
    return worst, per_lik, per_kind, oracle_ms


def studentt_flagship_data(device, seed=0):
    """The flagship's X and latent X w, with y = X w + 0.1 t_4."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, D)).astype(np.float32)
    w = rng.normal(size=D).astype(np.float32)
    y = (X @ w + 0.1 * rng.standard_t(4.0, size=N)).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def studentt_rate_first_in_process():
    """phase_studentt_rate as the first path of a process of its own
    (``python3 chip_smoke.py studentt-rate``), so that its rate compares
    with the flagship's, the first path of this one: the host's cost per
    launch grows over a process's life.  Relays that process's output and
    returns its launches."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "studentt-rate"],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"Student-t rate process exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    for line in lines[:-1]:
        log(f"  [studentt-rate] {line}")
    return json.loads(lines[-1])["launches"]


def phase_studentt_rate(agt, ck, device):
    """Student-t(4) at the flagship shape: MAIN_STEPS steps through
    agp_tpu_torch.train (one launch each), then steady-state iterations/s
    over T_TIMED_STEPS steps.  Returns (launches, it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = studentt_flagship_data(device)
    model = agt.SVGP.create(
        agt.SqExponentialKernel(lengthscale=2.0, variance=1.0), agt.StudentTLikelihood.create(4.0),
        agt.AnalyticSVI(B, minibatch_sampling="block"), X[:M], optimiser=None,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    model, state = agt.train(model, X, y, iterations=MAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    launches = ck.fused_cavi_stats.launches
    if launches != MAIN_STEPS:
        raise AssertionError(f"Student-t: {MAIN_STEPS} steps launched the kernel {launches} times")
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("Student-t: non-finite posterior")
    model, state = vi_steps(model, state, X, y, 50, generator=gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, T_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = T_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"Student-t steady state (N={N}, D={D}, M={M}, B={B}, block): {ips:.1f} CAVI iterations/s over "
        f"{T_TIMED_STEPS} steps; {launches} launches in {MAIN_STEPS} steps")
    return launches, ips


def oracle_data(lik, device, seed=0):
    """The reference's oracle data for likelihood ``lik``, made with numpy:
    X uniform on [-2, 2]^2, f = sin(2 x_0) + 0.5 x_1, y as
    benchmarks/tpu_acceptance.py draws it.  Returns (X, y, truth), truth
    the noiseless f (regression), the labels (SVM; logistic, which the
    kernel checks take at this shape), the rate (Poisson) or
    the mean (negative binomial)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(ON, 2))
    f = np.sin(2 * X[:, 0]) + 0.5 * X[:, 1]
    if lik in ("bayesiansvm", "logistic"):
        y = truth = np.sign(f)
    elif lik == "poisson":
        truth = 20.0 / (1.0 + np.exp(-f))
        y = rng.poisson(truth).astype(float)
    elif lik == "negbinomial":
        p = 1.0 / (1.0 + np.exp(-(f - 1.0)))
        truth = 5.0 * p / (1.0 - p)
        y = rng.poisson(rng.gamma(5.0, p / (1.0 - p))).astype(float)
    else:
        draw = {"studentt": lambda: rng.standard_t(4.0, size=ON), "laplace": lambda: rng.laplace(size=ON)}
        noise = draw.get(lik, lambda: rng.normal(size=ON))()
        y, truth = f + (0.05 if lik == "gaussian" else 0.1) * noise, f
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X, y, truth))


def oracle_model(agt, X, lik, kernel="SqExponentialKernel", m=OM, b=OB):
    """The reference's oracle model (tpu_acceptance.py _fused_svgp) with m
    inducing points (M=128 for the fused pass, the reference's 512 for the
    batched pair): default kernel hyperparameters, slice sampling, B=b
    (the reference's 8192 unless a parity check cuts it)."""
    liks = {
        "studentt": lambda: agt.StudentTLikelihood.create(4.0),
        "laplace": lambda: agt.LaplaceLikelihood.create(0.1),
        "matern32": lambda: agt.Matern32Likelihood.create(0.2),
        "gaussian": lambda: agt.GaussianLikelihood.create(0.05),
        "bayesiansvm": lambda: agt.BayesianSVM.create(),
        "poisson": lambda: agt.PoissonLikelihood.create(10.0),
        "negbinomial": lambda: agt.NegBinomialLikelihood.create(5.0),
    }
    return agt.SVGP.create(getattr(agt, kernel)(), liks[lik](), agt.AnalyticSVI(b, minibatch_sampling="slice"),
                           X[:m], optimiser=None)


def oracle_metric(agt, model, state, X, truth, metric):
    """The oracle's metric on X[:4096]: RMSE of predict_f against f,
    accuracy of predict_y, or corr(predict_y, truth)."""
    Xe, te = X[:4096], truth[:4096]
    if metric == "rmse":
        return float(torch.sqrt(torch.mean((agt.predict_f(model, state, Xe) - te) ** 2)))
    pred = agt.predict_y(model, state, Xe)
    if metric == "acc":
        return float(((pred > 0) == (te > 0)).float().mean())
    return float(torch.corrcoef(torch.stack([pred, te]))[0, 1])


def phase_oracles(agt, ck, device, m=OM, floors=None, paths=None):
    """Each oracle path through agp_tpu_torch.train with m inducing points:
    OSTEPS steps, finite posterior (and lambda), its floor.  At m <= 128
    each step launches kernel 1 once; beyond, kernels 6 and 7 once each and
    no fused kernel.  Returns (total launches of the path's kernels,
    {path: metric})."""
    floors = ORACLE_FLOORS if floors is None else floors
    results, total = {}, 0
    for lik, kernel in single_paths() if paths is None else paths:
        X, y, truth = oracle_data(lik, device)
        model = oracle_model(agt, X, lik, kernel, m=m)
        reset_launches(ck)
        t0 = time.perf_counter()
        model, state = agt.train(model, X, y, iterations=OSTEPS, generator=torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        name = f"{lik}/{kernel}"
        launches = expect_launches(ck, f"oracle {name} M={m}",
                                   route_launches(OSTEPS, "single" if m > ck.MAX_M else "fused"))
        total += launches
        tensors = [state.mu, state.Sigma] + ([model.likelihood.lam] if lik == "poisson" else [])
        if not all(bool(torch.isfinite(t).all()) for t in tensors):
            raise AssertionError(f"oracle {name}: non-finite posterior or lambda")
        metric, floor = floors[name]
        value = oracle_metric(agt, model, state, X, truth, metric)
        ok = value < floor if metric == "rmse" else value > floor
        if not ok:
            raise AssertionError(f"oracle {name} M={m}: {metric} {value:.4f} misses its floor {floor}")
        extra = f", lambda {float(model.likelihood.lam):.4f}" if lik == "poisson" else ""
        log(f"oracle {name} (N={ON}, D=2, M={m}, B={OB}, {OSTEPS} steps): {metric} {value:.4f} "
            f"(floor {floor}){extra}, {launches} launches, {train_s:.3f} s")
        results[name] = value
    return total, results


def route_launches(steps, route, fused="fused_cavi_stats", hyper_steps=0):
    """Each kernel's launches in ``steps`` CAVI steps on ``route`` ("fused":
    kernel ``fused`` once a step; "single": kernels 6 and 7; "batched":
    kernels 4 and 5) and ``hyper_steps`` hyperparameter steps of one latent
    (kernel 6's forward once each; the backward launches nothing)."""
    want = {"fused": {fused: steps}, "single": {"fused_kappa": steps, "cavi_stats": steps},
            "batched": {"fused_kappa_moments_batched": steps, "cavi_stats_batched": steps}}[route]
    if hyper_steps:
        want["fused_kappa"] = want.get("fused_kappa", 0) + hyper_steps
    return want


# each kernel's launches over every main-path run of this process (the
# kernels line's "launches")
LAUNCHES = dict()


def expect_launches(ck, label, want):
    """Fails unless the run just made launched each kernel as many times as
    ``want`` names (route_launches) and nothing else; adds them to
    LAUNCHES and returns their sum."""
    counts = {name: wrapper(ck, name).launches for name in LAUNCH_COUNTERS}
    expected = {name: want.get(name, 0) for name in LAUNCH_COUNTERS}
    if counts != expected:
        raise AssertionError(f"{label}: launched {counts}, expected {expected}")
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n
    return sum(counts.values())


def single_paths():
    return [(lik, "SqExponentialKernel") for lik in ORACLE_LIKS] + [("studentt", k) for k in MATERN_KERNELS]


def phase_single_parity(agt, ck, device):
    """Card (float32) against CPU (float32, the plain version) after 20
    steps from the same draws, for each single-latent path:
    - at the flagship's conditioning (N=20,000, D=20, M=64, lengthscale 2,
      B=4096, slice; labels around sin(x_0) + 0.5 x_1), within
      MULTI_PARITY_TOL (MATERN12_PARITY_TOL for the Matern-1/2 kernel),
      beside the CPU's own float32 noise there: the same CPU run with X's
      features in another order;
    - at the oracle configuration itself, against each path's own float32
      noise there (the same CPU run with the inducing points in another
      order): the card within ORACLE_DEVICE_FACTOR times it of the CPU,
      and within it of the card with the plain version in the kernel's
      place."""
    draws = torch.randint(0, PN - B + 1, (20,), generator=torch.Generator().manual_seed(1))
    fperm = torch.randperm(D, generator=torch.Generator().manual_seed(3))
    for lik, kernel in single_paths():
        rng = np.random.default_rng(1)
        Xn = rng.normal(size=(PN, D))
        y = single_latent_labels(lik, np.sin(Xn[:, 0]) + 0.5 * Xn[:, 1], rng)
        Xc, yc = (torch.as_tensor(a, dtype=torch.float32) for a in (Xn, y))

        def model(X):
            lik_t = oracle_model(agt, X, lik).likelihood
            return agt.SVGP.create(getattr(agt, kernel)(lengthscale=2.0), lik_t,
                                   agt.AnalyticSVI(B, minibatch_sampling="slice"), X[:M], optimiser=None)

        cpu = after_20(agt, model(Xc), Xc, yc, draws)
        err = rel_err(after_20(agt, model(Xc.to(device)), Xc.to(device), yc.to(device), draws), cpu)
        Xp = Xc[:, fperm].contiguous()
        noise = rel_err(after_20(agt, model(Xp), Xp, yc, draws), cpu)
        tol = MATERN12_PARITY_TOL if kernel == "Matern12Kernel" else MULTI_PARITY_TOL
        if not err <= tol:
            raise AssertionError(f"{lik}/{kernel}: card float32 vs CPU float32 after 20 steps: {err:.3e} > {tol}")
        log(f"{lik}/{kernel} parity (N={PN}, D={D}, M={M}, B={B}): 20 steps card (float32) vs CPU (float32), "
            f"max |d mu| / max |mu| (and |d lam| / lam) = {err:.3e} (bound {tol}); "
            f"CPU with features reordered vs CPU {noise:.3e}")
    draws = torch.randint(0, ON - OB + 1, (20,), generator=torch.Generator().manual_seed(1))
    perm = torch.randperm(OM, generator=torch.Generator().manual_seed(2))
    for lik, kernel in single_paths():
        Xc, yc, _ = oracle_data(lik, "cpu", seed=1)
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after_20(agt, oracle_model(agt, Xc, lik, kernel), Xc, yc, draws)
        card = after_20(agt, oracle_model(agt, Xd, lik, kernel), Xd, yd, draws)
        with plain_kernels(ck):
            card_plain = after_20(agt, oracle_model(agt, Xd, lik, kernel), Xd, yd, draws)
        m = oracle_model(agt, Xc, lik, kernel)
        mu_p, lam_p = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
        noise = rel_err((mu_p[:, torch.argsort(perm)], lam_p), cpu)
        err, err_kernel = rel_err(card, cpu), rel_err(card, card_plain)
        tol, tol_kernel = max(ORACLE_DEVICE_FACTOR * noise, MULTI_PARITY_TOL), max(noise, MULTI_PARITY_TOL)
        if not err <= tol:
            raise AssertionError(f"oracle {lik}/{kernel}: card vs CPU after 20 steps: {err:.3e} > {tol:.3e}")
        if not err_kernel <= tol_kernel:
            raise AssertionError(f"oracle {lik}/{kernel}: card vs card with the plain version after 20 steps: "
                                 f"{err_kernel:.3e} > {tol_kernel:.3e}")
        log(f"oracle {lik}/{kernel} parity: 20 steps card (float32) vs CPU (float32) {err:.3e} (bound {tol:.3e}), "
            f"vs the card with the plain version {err_kernel:.3e} (bound {tol_kernel:.3e}); "
            f"CPU with Z reordered vs CPU {noise:.3e}")


# ------------------------------------------- the batched pair (M > 128)
def big_logistic_data(device, n=LN, seed=0):
    """bench.py's logistic_m512_b65536 data: X standard normal in LD=20
    dimensions, labels the sign of X w."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, LD)).astype(np.float32)
    y = np.where(X @ rng.normal(size=LD).astype(np.float32) > 0, 1.0, -1.0).astype(np.float32)
    return torch.as_tensor(X, device=device), torch.as_tensor(y, device=device)


def big_logistic_model(agt, X, b=LB, optimiser=None):
    return agt.SVGP.create(agt.SqExponentialKernel(lengthscale=2.0), agt.LogisticLikelihood.create(),
                           agt.AnalyticSVI(b, minibatch_sampling="slice"), X[:PM], optimiser=optimiser)


def pair_mc_data(device, seed=0):
    """tpu_acceptance.py's batched multiclass oracle data: X standard
    normal in 2-D (N=30,000), the label of the nearest of three centres."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(ON, 2))
    centres = np.array([[1.5, 0.0], [-1.5, 1.0], [0.0, -1.5]])
    y = np.argmin(((X[:, None, :] - centres[None]) ** 2).sum(-1), axis=1)
    return torch.as_tensor(X, dtype=torch.float32, device=device), torch.as_tensor(y, device=device)


def pair_het_data(device, seed=0):
    """tpu_acceptance.py's batched heteroscedastic oracle data: x uniform
    on [-2, 2] (N=30,000), f = sin(2x), g = -1.5 + 1.2 tanh(x),
    y = f + eps / sqrt(8 sigma(g)).  Returns (X, y, f)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, size=(ON, 1))
    f = np.sin(2 * X[:, 0])
    g = -1.5 + 1.2 * np.tanh(X[:, 0])
    y = f + np.sqrt(1.0 / (8.0 / (1.0 + np.exp(-g)))) * rng.normal(size=ON)
    return tuple(torch.as_tensor(a, dtype=torch.float32, device=device) for a in (X, y, f))


def pair_multi_model(agt, X, which, b=None):
    """The reference's batched-tier oracle models at M=512: logistic-softmax
    K=3 with B=8192, or heteroscedastic (lambda 8) with B=16384 (or B=b);
    the default kernel, slice sampling."""
    if which == "multiclass":
        lik, b = agt.LogisticSoftMaxLikelihood.create(3), b or PAIR_MC_B
    else:
        lik, b = agt.HeteroscedasticLikelihood.create(lam=8.0), b or PAIR_HET_B
    return agt.SVGP.create(agt.SqExponentialKernel(), lik, agt.AnalyticSVI(b, minibatch_sampling="slice"),
                           X[:PM], optimiser=None)


@contextlib.contextmanager
def plain_kernels(ck, names=("fused_cavi_stats",)):
    """The step takes the plain versions in the named kernels' place."""
    wrappers = {name: getattr(ck, name) for name in names}
    for name in names:
        setattr(ck, name, getattr(ck, name + "_reference"))
    try:
        yield
    finally:
        for name, fn in wrappers.items():
            setattr(ck, name, fn)


# the kernels of the split pairs: batched (4-5) and single-latent (6-7)
SPLIT_PAIRS = ("fused_kappa_moments_batched", "cavi_stats_batched", "fused_kappa", "cavi_stats")
LAUNCH_COUNTERS = ("fused_cavi_stats", "fused_cavi_stats_multiclass", "fused_cavi_stats_het",
                   "fused_kappa_moments_batched", "cavi_stats_batched", "fused_kappa", "cavi_stats",
                   "direct_stats", "two_factor_nt", "gather_row_tiles")


def wrapper(ck, name):
    """The wrapper of kernel ``name``: one of ops/cuda_kernels.py, or one of
    the bench's kernels (agp_tpu_torch/benchmarks/)."""
    from agp_tpu_torch.benchmarks import fused_variants, gather_modes

    for module in (ck, fused_variants, gather_modes):
        if hasattr(module, name):
            return getattr(module, name)
    raise KeyError(name)


def reset_launches(ck):
    for name in LAUNCH_COUNTERS:
        wrapper(ck, name).launches = 0


# -------------------------------------------- the batched pair's phases
def check_fused_fits(ck):
    """fused_fits (Python, the same on the CPU) against the library's own
    shared-memory functions of kernels 1-3 on a grid of (latents, D, M)."""
    lib, n = ck._library(), 0
    for d in (1, 2, 10, 20, 44, 45, 46, 64):
        for m in (1, 16, 64, 127, 128, 129, 512):
            for n_latent in (1, 2, 10):
                smem = lib.agp_fused_cavi_smem_bytes(d, m) if n_latent == 1 else lib.agp_multi_smem_bytes(d, m)
                if ck.fused_fits(n_latent, d, m) != (m <= ck.MAX_M and smem <= ck.SMEM_OPTIN):
                    raise AssertionError(f"fused_fits({n_latent}, {d}, {m}) disagrees with {smem} bytes")
                n += 1
    log(f"fused_fits agrees with the library's shared-memory functions at {n} (latents, D, M)")


def check_kappa_tiles(ck):
    """kappa_smem_bytes (Python, the same on the CPU) against the library's
    own shared-memory functions of kernels 4 and 6 at every row tile, and
    so the wrapper's tile choice (kappa_tile_rows), on a grid of M."""
    lib, n = ck._library(), 0
    grid = (1, 8, 64, 128, 129, 512, 680, 681, 696, 697, 700, 1392, 1393, 1408, 1409, 1680, 2158, 2392, 2393, 2406, 2407)
    for which, fn in (("moments", lib.agp_kappa_moments_smem_bytes), ("single", lib.agp_fused_kappa_smem_bytes)):
        for m in grid:
            for tb in (64, 32, 16):
                if fn(m, tb) != ck.kappa_smem_bytes(which, m, tb):
                    raise AssertionError(f"kappa_smem_bytes({which!r}, {m}, {tb}) disagrees with {fn(m, tb)} bytes")
                n += 1
    tiles = {which: {m: ck.kappa_tile_rows(which, m) for m in (64, 512, 1680, 2158)} for which in ("moments", "single")}
    log(f"kappa_smem_bytes agrees with the library's shared-memory functions at {n} (kernel, M, tile); row tiles "
        f"(kernel 4, moments / kernel 6, single): {tiles}; largest M {ck.kappa_max_m('moments')} / "
        f"{ck.kappa_max_m('single')}")


def check_variant_tiles(ck):
    """variant_smem_bytes (Python, the same on the CPU) against the
    library's own shared-memory function of kernels 8-9 at every row tile
    on a grid of M, and so the wrappers' tile choice (variant_tile); an
    unknown tile gets SIZE_MAX."""
    import ctypes

    from agp_tpu_torch.benchmarks import fused_variants as fv

    lib, n = ck._library(), 0
    for m in (1, 8, 64, 127, 128, 129, 512, 520, 680, 681, 1392, 1393, 2392, 2393):
        for tile in fv._VARIANT_TILES:
            if lib.agp_fused_variant_smem_bytes(m, tile[0], tile[1]) != fv.variant_smem_bytes(m, tile):
                raise AssertionError(f"variant_smem_bytes({m}, {tile}) disagrees with the library's "
                                     f"{lib.agp_fused_variant_smem_bytes(m, tile[0], tile[1])} bytes")
            n += 1
    if lib.agp_fused_variant_smem_bytes(64, 64, 64) != ctypes.c_size_t(-1).value:
        raise AssertionError("agp_fused_variant_smem_bytes takes an unknown tile")
    tiles = {m: fv.variant_tile(m)[:2] for m in (64, 128, 129, 512, 681, 1393, 2392)}
    log(f"variant_smem_bytes agrees with the library at {n} (M, tile); row tiles (rows, columns) by M: {tiles}; "
        f"largest M {fv.variant_max_m()}")


def pair_inputs(X_all, b, m, n_latent, device, kind="rbf", ls=2.0, seed=0):
    """Float32 card tensors as a path hands them to kernel 4: the batch
    X_all[:b], Z = X_all[:m] (on the batch's rows, as a path's first slice)
    for each latent, lengthscale ls, variance 1, L^-T from the float32
    Cholesky of that kind's Kmm with jitter 1e-3, a random mu and SPD
    Sigma; and kernel 5's g (normal) and theta (uniform on [0, 0.5])."""
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import linalg

    rng = np.random.default_rng(seed)
    X = X_all[:b].to(device=device, dtype=torch.float32).contiguous()
    Z = X_all[:m].to(device=device, dtype=torch.float32)
    A = rng.normal(size=(n_latent, m, m))
    f32 = dict(dtype=torch.float32, device=device)
    t = {"X": X, "Z": Z.expand(n_latent, m, X.shape[1]).contiguous(),
         "ls": torch.full((n_latent, X.shape[1]), ls, **f32), "var": torch.ones(n_latent, **f32),
         "mu": torch.as_tensor(rng.normal(size=(n_latent, m)), **f32),
         "Sigma": torch.as_tensor(A @ A.transpose(0, 2, 1) / m + np.eye(m), **f32),
         "g": torch.as_tensor(rng.normal(size=(n_latent, b)), **f32),
         "theta": torch.as_tensor(rng.uniform(0, 0.5, size=(n_latent, b)), **f32), "kind": kind}
    kern = {v: k for k, v in agt.kernels.FUSED_KINDS.items()}[kind](lengthscale=ls)
    L = linalg.safe_cholesky(kern.gram(Z), 1e-3)
    t["L_invT"] = torch.linalg.solve_triangular(L, torch.eye(m, **f32), upper=False).T.expand(n_latent, m, m).contiguous()
    return t


def call_k4(fn, t):
    return fn(t["X"], t["Z"], t["L_invT"], t["ls"], t["var"], t["mu"], t["Sigma"], 1e-3, t["kind"])


def pair_cases(device):
    """(label, inputs, float64 check, timed) of each shape the pair is held
    at: the paths' own shapes and the flagship's (B=4096, D=20, M=64; all
    timed), ragged B=300, M=129 with 1-3 latents, and each Matern kind.
    The oracle, multiclass and heteroscedastic shapes (Z on the batch's
    rows, lengthscale 1, low dimension) are ill-conditioned (cond(Kmm) up
    to ~5e5), so there each output is held against the plain version in
    float64."""
    Xl, _ = big_logistic_data("cpu", n=LB)
    Xf, _ = flagship_data("cpu", n=B)
    Xo = oracle_data("studentt", "cpu")[0]
    cases = [("logistic_m512_b65536", pair_inputs(Xl, LB, PM, 1, device), False, True),
             ("flagship_m64_b4096", pair_inputs(Xf, B, M, 1, device), False, True),
             ("oracle_m512_b8192", pair_inputs(Xo, OB, PM, 1, device, ls=1.0), True, True),
             ("multiclass_m512_b8192", pair_inputs(pair_mc_data("cpu")[0], PAIR_MC_B, PM, 3, device, ls=1.0), True, True),
             ("het_m512_b16384", pair_inputs(pair_het_data("cpu")[0], PAIR_HET_B, PM, 2, device, ls=1.0), True, True)]
    cases += [(f"ragged_L{n}", pair_inputs(Xl, 300, 129, n, device, seed=n), False, False) for n in (1, 2, 3)]
    cases += [(f"{k}_ragged_L2", pair_inputs(Xl, 300, 129, 2, device, kind=k), False, False) for k in MATERN_KINDS]
    cases += [(f"{k}_oracle_m512", pair_inputs(Xo, OB, PM, 1, device, kind=k, ls=1.0), True, False)
              for k in MATERN_KINDS]
    return cases


MATERN_KINDS = ("matern12", "matern32", "matern52")
# the H100's published peaks (SXM, NVIDIA's data sheet, dense): FP32 outside
# the tensor cores, TF32 on them, and HBM3 bandwidth
PEAK_FP32_FLOPS, PEAK_TF32_FLOPS, PEAK_BYTES_S = 67e12, 495e12, 3.35e12


def bound(fmas, nbytes):
    """(ms, "operations" or "bytes"): the larger of 2 fmas over the FP32
    peak and nbytes over the memory rate."""
    ops_ms, bytes_ms = 2.0 * fmas / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


# FMAs a row needs for a symmetric product: the quadratic form kappa Sigma
# kappa^T (Sigma symmetric) or one row's share of S2 = kappa^T diag(theta)
# kappa (S2 symmetric), each counted on the upper triangle
def sym_fmas(m):
    return m * (m + 1) // 2


def fused_bound(b, d, m, n_latent, label_words):
    """Kernels 1-3: per row and latent kappa (M^2), vf's quadratic form and
    S2 (each ``sym_fmas``), the gram (M D) and ~5 M more FMAs; the inputs
    read and the outputs written once (label_words: the per-row inputs and
    outputs beyond x).  Returns three bounds, each (ms, by), as
    kappa_bounds: the function's (its products once at the TF32 peak,
    ``tc_bound``), a 3xTF32 design's (kappa and kappa Sigma in full and S2's
    upper triangle in three TF32 passes) and the FP32 one (``bound``), which
    kernels 1-3, FP32 designs, answer to."""
    tc = n_latent * b * (m * m + 2 * sym_fmas(m))
    design = 3 * n_latent * b * (2 * m * m + sym_fmas(m))
    simt = n_latent * b * (m * d + 5 * m)
    nbytes = 4 * (b * d + b * label_words + n_latent * (m * d + 2 * m * m + 2 * m + m * m))
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def tc_bound(tc_fmas, simt_fmas, nbytes):
    """(ms, "operations" or "bytes"): the larger of tc_fmas at the TF32
    tensor-core peak, simt_fmas at the FP32 one (another pipe, so the two
    overlap) and nbytes over the memory rate."""
    ops_ms = max(2.0 * tc_fmas / PEAK_TF32_FLOPS, 2.0 * simt_fmas / PEAK_FP32_FLOPS) * 1e3
    bytes_ms = nbytes / PEAK_BYTES_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def kappa_bounds(b, d, m, n_latent, moments):
    """Kernel 4 (moments: kappa, mf, vf; L latents) or 6 (kappa, Ktilde):
    per row and latent kappa's M^2 FMAs, for kernel 4 the quadratic form
    kappa Sigma kappa^T (``sym_fmas``; the design forms kappa Sigma in
    full, M^2), and on the FP32 pipes the gram's M D and the row sums' M
    (kernel 4: 3 M); reads X, Z, L^-T, ls, var (and mu, Sigma), writes
    kappa and Ktilde (mf, vf).  Returns three bounds, each (ms, by): the
    function's (its products once at the TF32 peak, ``tc_bound``), the
    design's (each full product in three TF32 passes) and the FP32 SIMT one
    (``bound``)."""
    tc = n_latent * b * (m * m + (sym_fmas(m) if moments else 0))
    design = 3 * n_latent * b * m * m * (2 if moments else 1)
    simt = n_latent * b * (m * d + (3 if moments else 1) * m)
    if moments:
        nbytes = 4 * (b * d + n_latent * (m * d + 2 * m * m + d + 1 + m + b * m + 2 * b))
    else:
        nbytes = 4 * (b * d + m * d + m * m + d + 1 + b * m + b)
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def pair_bounds(b, d, m, n_latent):
    """Kernels 4 and 5: ``kappa_bounds`` and ``stats_bounds``."""
    return kappa_bounds(b, d, m, n_latent, True), stats_bounds(b, m, n_latent)


def single_bounds(b, d, m):
    """Kernels 6 and 7: ``kappa_bounds`` and ``stats_bounds`` with one
    latent."""
    return kappa_bounds(b, d, m, 1, False), stats_bounds(b, m, 1)


def stats_bounds(b, m, n_latent):
    """Kernels 5 and 7 (L latents): S2 (``sym_fmas`` a row) and s1 (M);
    reads kappa, g, theta, writes s1, S2.  Returns three bounds, each (ms,
    by): the function's, S2's FMAs once on the tensor cores and s1's on the
    FP32 pipes (``tc_bound``); the design's, with S2's three TF32 passes
    (3xTF32); and the FP32 SIMT one (``bound``)."""
    s2_fmas, s1_fmas = n_latent * b * sym_fmas(m), n_latent * b * m
    nbytes = 4 * n_latent * (b * m + 2 * b + m + m * m)
    return (tc_bound(s2_fmas, s1_fmas, nbytes), tc_bound(3 * s2_fmas, s1_fmas, nbytes),
            bound(s2_fmas + s1_fmas, nbytes))


def kernel_name(key):
    """A profiler event's kernel name without its return type, anonymous
    namespace and arguments, at most 60 characters."""
    return key.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0].strip()[:60]


def device_us(fn, n=10):
    """(device us a call, {kernel: us a call}) of fn by torch.profiler over
    n calls after one, each kernel by ``kernel_name``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0:
            key = kernel_name(e.key)
            by[key] = by.get(key, 0.0) + e.self_device_time_total / n
    return sum(by.values()), by


def check_repeat(label, fn, got):
    """Kernels 4-7: a second call, fn(), bit-equal to the first's outputs
    ``got`` (no atomics; every sum in a fixed order)."""
    again = fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label}: a second call differs from the first")


def check_stats_repeat(label, fn, args, got):
    """Kernels 5 and 7: S2 exactly symmetric, and a second call bit-equal to
    the first."""
    if not torch.equal(got[1], got[1].mT):
        raise AssertionError(f"{label}: S2 is not exactly symmetric")
    check_repeat(label, lambda: fn(*args), got)


def kappa_products(ck, t, single):
    """One PyTorch call of kernel 6's product alone, torch.matmul(Knm,
    K^-1) ("kappa's product alone"), or of kernel 4's two, torch.bmm(Knm,
    K^-1) and torch.bmm(kappa, Sigma), on float32 operands the plain
    version forms from the case's inputs: a yardstick of the tensor
    products, not the whole function, which the port never calls."""
    kinv = ck._kinv(t["L_invT"])
    if single:
        ls = t["ls"]
        knm = ck._kappa_ktilde((t["X"] / ls)[None], (t["Z"] / ls)[None], kinv[None], t["var"].reshape(1), 1e-3,
                               t["kind"])[2][0]
        return lambda: torch.matmul(knm, kinv)
    ls = t["ls"][:, None, :]
    kappa, _, knm = ck._kappa_ktilde(t["X"][None] / ls, t["Z"] / ls, kinv, t["var"], 1e-3, t["kind"])
    return lambda: (torch.bmm(knm, kinv), torch.bmm(kappa, t["Sigma"]))


def kappa_timing(ck, name, t, reps):
    """Kernel ``name`` (fused_kappa_moments_batched or fused_kappa) at one
    shape: its ms by CUDA events beside its plain version (plain, kernel,
    kernel, plain) and its device us (profiler), and the same of its
    products alone (``kappa_products``)."""
    single = name == "fused_kappa"
    caller = call_k6 if single else call_k4
    fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
    ms, plain_ms = timed_pair(lambda: caller(fn, t), lambda: caller(plain, t), reps)
    dev, dev_by = device_us(lambda: caller(fn, t))
    products = kappa_products(ck, t, single)
    return {"ms": ms, "plain_ms": plain_ms, "device_us": dev, "device_us_by_kernel": dev_by,
            "products_ms": cuda_ms(products, reps), "products_device_us": device_us(products)[0]}


def kappa_line(label, name, r):
    what = "kappa's product alone, torch.matmul" if name == "kernel 6" else "the products alone, torch.bmm x2"
    return (f"  {label}: {name} {r['ms']:.4f} ms, device {r['device_us']:.1f} us ("
            + ", ".join(f"{k} {v:.1f}" for k, v in r["device_us_by_kernel"].items()) + f"); plain "
            f"{r['plain_ms']:.4f}; {what} {r['products_ms']:.4f} ms, device {r['products_device_us']:.1f} us")


def stats_timing(ck, name, kappa, g, th, reps, library_fn):
    """Kernel ``name`` (cavi_stats_batched or cavi_stats) at one shape: its
    ms by CUDA events beside its plain version (plain, kernel, kernel,
    plain) and ``library_fn`` (one PyTorch call of the same sums, which the
    port never calls), and the device us of the kernel and the library call
    (profiler)."""
    fn, plain = getattr(ck, name), getattr(ck, name + "_reference")
    ms, plain_ms = timed_pair(lambda: fn(kappa, g, th), lambda: plain(kappa, g, th), reps)
    lib_ms = cuda_ms(library_fn, reps)
    dev, dev_by = device_us(lambda: fn(kappa, g, th))
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "device_us": dev, "device_us_by_kernel": dev_by,
            "library_device_us": device_us(library_fn)[0]}


def stats_line(label, name, r):
    return (f"  {label}: {name} {r['ms']:.4f} ms, device {r['device_us']:.1f} us "
            + "(" + ", ".join(f"{k} {v:.1f}" for k, v in r["device_us_by_kernel"].items()) + f"); plain "
            f"{r['plain_ms']:.4f}; library {r['library_ms']:.4f} ms, device {r['library_device_us']:.1f} us")


def phase_pair_kernels_vs_plain(ck, device):
    """Kernels 4 and 5 against their plain versions at every case of
    pair_cases (at the float64 cases with no KERNEL_TOL floor: within
    FLOAT32_FACTOR times the float32 plain version's own error), then timed
    at the paths' shapes beside their plain versions (kernel 4 beside its
    products alone, kappa_timing; kernel 5 beside torch.bmm, stats_timing;
    neither of which the port calls), with their device us.  Kernel 5's S2
    exactly symmetric, and a second call of each bit-equal, at every case.
    Returns {kernel: (largest abs error, {shape: (ms, plain ms)}, {shape:
    library ms}, {shape: kappa_timing's or stats_timing's dict})}."""
    worst = {"fused_kappa_moments_batched": 0.0, "cavi_stats_batched": 0.0}
    extra = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    times = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    library = {"fused_kappa_moments_batched": {}, "cavi_stats_batched": {}}
    for label, t, f64, timed in pair_cases(device):
        got = call_k4(ck.fused_kappa_moments_batched, t)
        torch.cuda.synchronize()
        ref = call_k4(ck.fused_kappa_moments_batched_reference, t)
        ref64 = call_k4(ck.fused_kappa_moments_batched_reference, to_float64(t)) if f64 else None
        row = check_outputs(f"fused_kappa_moments_batched {label}", ("kappa", "mf", "vf"), got, ref, ref64, floor=0.0)
        check_repeat(f"fused_kappa_moments_batched {label}", lambda: call_k4(ck.fused_kappa_moments_batched, t), got)
        worst["fused_kappa_moments_batched"] = max(worst["fused_kappa_moments_batched"], *row.values())
        kappa = ref[0].contiguous()
        s_got = ck.cavi_stats_batched(kappa, t["g"], t["theta"])
        torch.cuda.synchronize()
        s_ref = ck.cavi_stats_batched_reference(kappa, t["g"], t["theta"])
        s64 = ck.cavi_stats_batched_reference(kappa.double(), t["g"].double(), t["theta"].double()) if f64 else None
        row5 = check_outputs(f"cavi_stats_batched {label}", ("s1", "S2"), s_got, s_ref, s64, floor=0.0)
        check_stats_repeat(f"cavi_stats_batched {label}", ck.cavi_stats_batched, (kappa, t["g"], t["theta"]), s_got)
        worst["cavi_stats_batched"] = max(worst["cavi_stats_batched"], *row5.values())
        L_, B_, M_ = kappa.shape
        log(f"pair vs plain {label} (B={B_}, D={t['X'].shape[1]}, M={M_}, L={L_}, {t['kind']}): max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in {**row, **row5}.items()))
        if timed:
            reps = 10 if B_ > 20000 else 30
            r4 = kappa_timing(ck, "fused_kappa_moments_batched", t, reps)
            extra["fused_kappa_moments_batched"][label] = r4
            times["fused_kappa_moments_batched"][label] = (r4["ms"], r4["plain_ms"])
            g, th = t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats_batched", kappa, g, th, reps, lambda: (
                torch.bmm((kappa * th[..., None]).mT, kappa), torch.bmm(kappa.mT, g[..., None])))
            extra["cavi_stats_batched"][label] = r
            times["cavi_stats_batched"][label] = (r["ms"], r["plain_ms"])
            library["cavi_stats_batched"][label] = r["library_ms"]
            log(kappa_line(label, "kernel 4", r4))
            log(stats_line(label, "kernel 5", r) + " (library: torch.bmm x2)")
        del got, ref, ref64, s_got, s_ref, s64
    return {name: (worst[name], times[name], library[name], extra[name]) for name in worst}


def phase_pair_autograd(ck, device):
    """Kernel 4's gradients (its backward is the plain version's vjp)
    against the plain version's, w.r.t. every tensor argument, at B=300,
    M=129, two latents."""
    Xl, _ = big_logistic_data("cpu", n=300)
    t = pair_inputs(Xl, 300, 129, 2, device)
    names = ("X", "Z", "L_invT", "ls", "var", "mu", "Sigma")
    gen = torch.Generator(device=device).manual_seed(0)
    w = [torch.randn(s, generator=gen, device=device) for s in ((2, 300, 129), (2, 300), (2, 300))]
    grads = []
    for fn in (ck.fused_kappa_moments_batched, ck.fused_kappa_moments_batched_reference):
        inputs = [t[k].clone().requires_grad_(True) for k in names]
        out = fn(*inputs, 1e-3, "rbf")
        grads.append(torch.autograd.grad(sum(torch.sum(o * wi) for o, wi in zip(out, w)), inputs))
    errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for n, a, b in zip(names, *grads)}
    if not all(e <= KERNEL_TOL for e in errs.values()):
        raise AssertionError(f"kernel 4's gradients differ from the plain version's: {errs}")
    log("kernel 4 autograd vs plain (B=300, M=129, L=2): " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


# floor of logistic_m512_b65536's training accuracy after L_TRAIN_STEPS
# steps: the labels are a linear rule in 20-D, which 512 RBF inducing
# points fit to 0.9769 on an H100 (float32), where the flagship's 64 reach
# 0.8965 (the plain version on a CPU); chance is 0.5
MIN_BIG_ACC = 0.9
# floors of the M=512 oracles, as ORACLE_FLOORS was worked out: about three
# times the plain version's error on a CPU (float32, the same data, CPU
# draws: RMSE 0.0050 Gaussian, 0.0083 Student-t, 0.0052 Laplace, 0.0056
# Matern-3/2 noise; accuracy 0.9868; corr 0.9993 Poisson, 0.9995 negative
# binomial, held at 0.99), inside the reference's own floors (RMSE 0.25,
# 0.25, 0.3; accuracy 0.9; corr 0.8; none for the Gaussian)
PAIR_ORACLE_FLOORS = {
    "gaussian/SqExponentialKernel": ("rmse", 0.015),
    "studentt/SqExponentialKernel": ("rmse", 0.025),
    "laplace/SqExponentialKernel": ("rmse", 0.016),
    "matern32/SqExponentialKernel": ("rmse", 0.017),
    "bayesiansvm/SqExponentialKernel": ("acc", 0.96),
    "poisson/SqExponentialKernel": ("corr", 0.99),
    "negbinomial/SqExponentialKernel": ("corr", 0.99),
}
# the reference's floors of the batched multiclass and heteroscedastic
# oracles (tpu_acceptance.py:387, :411); the plain version on a CPU
# reaches accuracy 0.9966 and RMSE 0.3290 there (float32, CPU draws)
MIN_PAIR_MC_ACC, MAX_PAIR_HET_RMSE = 0.85, 0.4


def phase_big_logistic(agt, ck, device):
    """bench.py's logistic_m512_b65536 through agp_tpu_torch.train:
    L_TRAIN_STEPS steps with one launch of each kernel of the single-latent
    split pair (kernels 6-7), the training accuracy, then steady-state
    iterations/s over L_TIMED_STEPS steps.  Returns (launches, accuracy,
    it/s)."""
    from agp_tpu_torch.training.train import vi_steps

    X, y = big_logistic_data(device)
    model = big_logistic_model(agt, X)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=L_TRAIN_STEPS, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, "logistic_m512_b65536", route_launches(L_TRAIN_STEPS, "single"))
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())):
        raise AssertionError("logistic_m512_b65536: non-finite posterior")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if not acc >= MIN_BIG_ACC:
        raise AssertionError(f"logistic_m512_b65536 training accuracy {acc:.4f} < {MIN_BIG_ACC}")
    t0 = time.perf_counter()
    model, state = vi_steps(model, state, X, y, L_TIMED_STEPS, generator=gen)
    torch.cuda.synchronize()
    ips = L_TIMED_STEPS / (time.perf_counter() - t0)
    log(f"logistic_m512_b65536 (N={LN}, D={LD}, M={PM}, B={LB}, slice): {L_TRAIN_STEPS} steps through "
        f"agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, training accuracy {acc:.4f}; "
        f"steady state {ips:.2f} CAVI iterations/s over {L_TIMED_STEPS} steps")
    return launches, acc, ips


def phase_pair_multi(agt, ck, device, which):
    """The reference's batched multiclass or heteroscedastic oracle at
    M=512 through agp_tpu_torch.train, with one launch of each kernel of
    the pair a step, and its floor.  Returns (launches, metric)."""
    if which == "multiclass":
        X, y = pair_mc_data(device)
        steps = PAIR_MC_STEPS
    else:
        X, y, f = pair_het_data(device)
        steps = PAIR_HET_STEPS
    model = pair_multi_model(agt, X, which)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=steps, generator=torch.Generator(device=device).manual_seed(0))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, f"{which} M={PM}", route_launches(steps, "batched"))
    if which == "multiclass":
        value = float((agt.predict_y(model, state, X[:4096]) == y[:4096]).float().mean())
        ok, what = value > MIN_PAIR_MC_ACC, f"accuracy {value:.4f} (floor {MIN_PAIR_MC_ACC})"
    else:
        value = float(torch.sqrt(torch.mean((agt.predict_f(model, state, X[:4096])[0] - f[:4096]) ** 2)))
        ok, what = value < MAX_PAIR_HET_RMSE, f"RMSE of f {value:.4f} (floor {MAX_PAIR_HET_RMSE})"
        what += f", lambda {float(model.likelihood.lam):.4f}"
    if not ok or not bool(torch.isfinite(state.mu).all()):
        raise AssertionError(f"{which} M={PM}: {what}")
    log(f"{which} M={PM} (N={ON}, B={model.inference.batchsize}, {steps} steps): {what}, {launches} launches, "
        f"{train_s:.3f} s")
    return launches, value


# batch of the pair's parity runs: each path's 20 steps run twice on the
# CPU, whose float32 [L, B, 512, 512] products took 54 s of a 120 s script
# at the paths' own B (8192-65,536) on an H100 host's 8 cores; at
# B=2048 the conditioning (Z, lengthscale, data) is the path's own and the
# kernels' own shapes are held in phase 12
PAIR_PARITY_B = 2048


def pair_parity_paths(agt, device):
    """(name, CPU data, model builder, slice batch) of each path of the
    pair, for card-vs-CPU parity, at B=PAIR_PARITY_B; logistic_m512_b65536
    on N=20,000 rows."""
    b = PAIR_PARITY_B
    Xl, yl = big_logistic_data("cpu", n=PN, seed=1)
    Xm, ym = pair_mc_data("cpu", seed=1)
    Xh, yh, _ = pair_het_data("cpu", seed=1)
    paths = [("logistic_m512", Xl, yl, lambda X: big_logistic_model(agt, X, b=b)),
             ("multiclass M=512", Xm, ym, lambda X: pair_multi_model(agt, X, "multiclass", b=b)),
             ("het M=512", Xh, yh, lambda X: pair_multi_model(agt, X, "het", b=b))]
    for lik in ORACLE_LIKS:
        Xo, yo, _ = oracle_data(lik, "cpu", seed=1)
        paths.append((f"oracle {lik} M=512", Xo, yo, lambda X, lik=lik: oracle_model(agt, X, lik, m=PM, b=b)))
    return [(name, X, y, build, b) for name, X, y, build in paths]


def phase_pair_parity(agt, ck, device):
    """20 steps of each path of the pair at B=PAIR_PARITY_B on the card
    (float32) against the same steps on the CPU (float32, the plain
    versions), same draws, each against its own float32 noise (the CPU run
    again with the inducing points in another order), as the oracle
    parity of kernel 1: the card
    within ORACLE_DEVICE_FACTOR times it of the CPU, and within it of the
    card with the plain versions in the kernels' place."""
    perm = torch.randperm(PM, generator=torch.Generator().manual_seed(2))
    for name, Xc, yc, build, b in pair_parity_paths(agt, device):
        t0 = time.perf_counter()
        draws = torch.randint(0, Xc.shape[0] - b + 1, (20,), generator=torch.Generator().manual_seed(1))
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after_20(agt, build(Xc), Xc, yc, draws)
        card = after_20(agt, build(Xd), Xd, yd, draws)
        with plain_kernels(ck, SPLIT_PAIRS):
            card_plain = after_20(agt, build(Xd), Xd, yd, draws)
        m = build(Xc)
        mu_p, lam_p = after_20(agt, m.replace(Z=m.Z[:, perm].contiguous()), Xc, yc, draws)
        noise = rel_err((mu_p[:, torch.argsort(perm)], lam_p), cpu)
        err, err_kernel = rel_err(card, cpu), rel_err(card, card_plain)
        tol, tol_kernel = max(ORACLE_DEVICE_FACTOR * noise, MULTI_PARITY_TOL), max(noise, MULTI_PARITY_TOL)
        if not (err <= tol and err_kernel <= tol_kernel):
            raise AssertionError(f"{name}: card vs CPU {err:.3e} (bound {tol:.3e}), card vs card with the plain "
                                 f"versions {err_kernel:.3e} (bound {tol_kernel:.3e})")
        log(f"{name} parity: 20 steps card (float32) vs CPU (float32) {err:.3e} (bound {tol:.3e}), vs the card "
            f"with the plain versions {err_kernel:.3e} (bound {tol_kernel:.3e}); CPU with Z reordered vs CPU {noise:.3e}; "
            f"{time.perf_counter() - t0:.2f} s")


# ------------------------------------- the single-latent split pair (6-7)
def single_args(t):
    """Kernel 6's and 7's arguments from pair_inputs' one-latent tensors: X,
    Z [M, D], L^-T [M, M], ls [D], var [], g and theta [B]."""
    return {"X": t["X"], "Z": t["Z"][0].contiguous(), "L_invT": t["L_invT"][0].contiguous(), "ls": t["ls"][0],
            "var": t["var"][0], "g": t["g"][0].contiguous(), "theta": t["theta"][0].contiguous(), "kind": t["kind"]}


def call_k6(fn, s):
    return fn(s["X"], s["Z"], s["L_invT"], s["ls"], s["var"], 1e-3, s["kind"])


def single_cases(device):
    """(label, kernel 6's and 7's inputs, float64 check, timed) of each shape
    the single-latent split pair is held at: logistic_m512_b65536 (timed),
    path A's hyperparameter step at the flagship shape (B=4096, D=20,
    M=64, timed), the ill-conditioned M=512 oracle shape (timed, against
    the float64 plain version), ragged B=300, M=129, and each Matern kind
    at the ragged and the oracle shapes."""
    Xl, _ = big_logistic_data("cpu", n=LB)
    Xf, _ = flagship_data("cpu", n=B)
    Xo = oracle_data("studentt", "cpu")[0]
    cases = [("logistic_m512_b65536", pair_inputs(Xl, LB, PM, 1, device), False, True),
             ("flagship_m64_b4096", pair_inputs(Xf, B, M, 1, device), False, True),
             ("oracle_m512_b8192", pair_inputs(Xo, OB, PM, 1, device, ls=1.0), True, True),
             ("ragged_m129", pair_inputs(Xl, 300, 129, 1, device, seed=1), False, False)]
    cases += [(f"{k}_ragged_m129", pair_inputs(Xl, 300, 129, 1, device, kind=k), False, False) for k in MATERN_KINDS]
    cases += [(f"{k}_oracle_m512", pair_inputs(Xo, OB, PM, 1, device, kind=k, ls=1.0), True, False)
              for k in MATERN_KINDS]
    return [(label, single_args(t), f64, timed) for label, t, f64, timed in cases]


def phase_single_kernels_vs_plain(ck, device):
    """Kernels 6 and 7 against their plain versions at every case of
    single_cases (at the float64 cases with no KERNEL_TOL floor; S2
    exactly symmetric), then timed at the timed shapes beside their plain
    versions, kernel 6 beside kappa's product alone (torch.matmul,
    kappa_timing) and kernel 7 beside torch.matmul for the same two sums
    (stats_timing), none of which the port calls, with their device us; a
    second call of each bit-equal at every case.  Returns {kernel:
    (largest abs error, {shape: (ms, plain ms)}, {shape: library ms},
    {shape: kappa_timing's or stats_timing's dict})}."""
    worst = {"fused_kappa": 0.0, "cavi_stats": 0.0}
    extra = {"fused_kappa": {}, "cavi_stats": {}}
    times = {"fused_kappa": {}, "cavi_stats": {}}
    library = {"fused_kappa": {}, "cavi_stats": {}}
    for label, t, f64, timed in single_cases(device):
        got = call_k6(ck.fused_kappa, t)
        torch.cuda.synchronize()
        ref = call_k6(ck.fused_kappa_reference, t)
        ref64 = call_k6(ck.fused_kappa_reference, to_float64(t)) if f64 else None
        row = check_outputs(f"fused_kappa {label}", ("kappa", "Ktilde"), got, ref, ref64, floor=0.0)
        check_repeat(f"fused_kappa {label}", lambda: call_k6(ck.fused_kappa, t), got)
        worst["fused_kappa"] = max(worst["fused_kappa"], *row.values())
        kappa, g, th = ref[0].contiguous(), t["g"], t["theta"]
        s_got = ck.cavi_stats(kappa, g, th)
        torch.cuda.synchronize()
        check_stats_repeat(f"cavi_stats {label}", ck.cavi_stats, (kappa, g, th), s_got)
        s_ref = ck.cavi_stats_reference(kappa, g, th)
        s64 = ck.cavi_stats_reference(kappa.double(), g.double(), th.double()) if f64 else None
        row7 = check_outputs(f"cavi_stats {label}", ("s1", "S2"), s_got, s_ref, s64, floor=0.0)
        worst["cavi_stats"] = max(worst["cavi_stats"], *row7.values())
        B_, M_ = kappa.shape
        log(f"single pair vs plain {label} (B={B_}, D={t['X'].shape[1]}, M={M_}, {t['kind']}): max abs err "
            + " ".join(f"{k}={v:.2e}" for k, v in {**row, **row7}.items()))
        if timed:
            reps = 10 if B_ > 20000 else 30
            r6 = kappa_timing(ck, "fused_kappa", t, reps)
            extra["fused_kappa"][label] = r6
            times["fused_kappa"][label] = (r6["ms"], r6["plain_ms"])
            r = stats_timing(ck, "cavi_stats", kappa, g, th, reps,
                             lambda: ((kappa * th[:, None]).T @ kappa, kappa.T @ g))
            extra["cavi_stats"][label] = r
            times["cavi_stats"][label] = (r["ms"], r["plain_ms"])
            library["cavi_stats"][label] = r["library_ms"]
            log(kappa_line(label, "kernel 6", r6))
            log(stats_line(label, "kernel 7", r) + " (library: torch.matmul x2)")
        del got, ref, ref64, s_got, s_ref, s64
    return {name: (worst[name], times[name], library[name], extra[name]) for name in worst}


def phase_kappa_autograd(ck, device):
    """Kernel 6's gradients (its backward is the plain version's vjp)
    against the plain version's, w.r.t. X, Z, L^-T, the [D] lengthscales
    and the variance, at B=300, M=129."""
    Xl, _ = big_logistic_data("cpu", n=300)
    t = single_args(pair_inputs(Xl, 300, 129, 1, device))
    names = ("X", "Z", "L_invT", "ls", "var")
    gen = torch.Generator(device=device).manual_seed(0)
    w = [torch.randn(s, generator=gen, device=device) for s in ((300, 129), (300,))]
    grads = []
    for fn in (ck.fused_kappa, ck.fused_kappa_reference):
        inputs = [t[k].clone().requires_grad_(True) for k in names]
        out = fn(*inputs, 1e-3, "rbf")
        grads.append(torch.autograd.grad(sum(torch.sum(o * wi) for o, wi in zip(out, w)), inputs))
    errs = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1.0) for n, a, b in zip(names, *grads)}
    if not all(e <= KERNEL_TOL for e in errs.values()):
        raise AssertionError(f"kernel 6's gradients differ from the plain version's: {errs}")
    log("kernel 6 autograd vs plain (B=300, M=129): " + " ".join(f"{k}={v:.1e}" for k, v in errs.items()))


# --------------------------------------------------- the hyperparameter step
def hyper_path(agt, X, which, b=None):
    """Path A (the flagship) or B (logistic_m512_b65536) with the
    reference's default optimiser, Adam(0.01) on the log kernel parameters
    every iteration (atfrequency 1); b cuts the batch (parity)."""
    if which == "A":
        return flagship_model(agt, X, b=b or B, optimiser="default")
    return big_logistic_model(agt, X, b=b or LB, optimiser="default")


def log_hypers(model):
    """The kernel's log lengthscale and log variance as float64 on the CPU."""
    k = model.kernel
    return torch.cat([torch.log(k.lengthscale).reshape(-1), torch.log(k.variance).reshape(-1)]).double().cpu()


def phase_hyper_path(agt, ck, device, which):
    """Path A or B through agp_tpu_torch.train: its first steps with the
    exact launches (path A: kernel 1 once a step and kernel 6 once a
    hyperparameter step; path B: kernels 6 and 7 once a step and kernel 6
    once more a hyperparameter step; no other kernel), the training
    accuracy floor, a finite posterior, log-hyperparameters finite and
    moved by more than MIN_HYPER_MOVE; then its steady rate, iterations
    (each with a hyperparameter step but the run's first three and its
    last) per second.  Returns (launches, accuracy, it/s)."""
    if which == "A":
        X, y = flagship_data(device)
        steps, timed, floor, route, name = MAIN_STEPS, A_TIMED_STEPS, MIN_FLAGSHIP_ACC, "fused", "path A (flagship)"
    else:
        X, y = big_logistic_data(device)
        steps, timed, floor, route, name = L_TRAIN_STEPS, B_TIMED_STEPS, MIN_BIG_ACC, "single", "path B (logistic_m512_b65536)"
    model = hyper_path(agt, X, which)
    log0 = log_hypers(model)
    gen = torch.Generator(device=device).manual_seed(0)
    reset_launches(ck)
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=steps, generator=gen)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = expect_launches(ck, name, route_launches(steps, route, hyper_steps=steps - 3))
    logs = log_hypers(model)
    if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(state.Sigma).all())
            and bool(torch.isfinite(logs).all())):
        raise AssertionError(f"{name}: non-finite posterior or hyperparameters")
    moved = float((logs - log0).abs().max())
    if not moved > MIN_HYPER_MOVE:
        raise AssertionError(f"{name}: the log-hyperparameters moved by {moved:.3e} <= {MIN_HYPER_MOVE}")
    acc = float((agt.predict_y(model, state, X) == y).float().mean())
    if not acc >= floor:
        raise AssertionError(f"{name}: training accuracy {acc:.4f} < {floor}")
    t0 = time.perf_counter()
    model, state = agt.train(model, X, y, iterations=timed, state=state, generator=gen)
    torch.cuda.synchronize()
    ips = timed / (time.perf_counter() - t0)
    k = model.kernel
    log(f"{name}: {steps} iterations through agp_tpu_torch.train in {train_s:.3f} s, {launches} launches, "
        f"training accuracy {acc:.4f}, log-hyperparameters moved by {moved:.4f} (lengthscale "
        f"{float(k.lengthscale.reshape(-1)[0]):.4f}, variance {float(k.variance.reshape(-1)[0]):.4f}); steady state "
        f"{ips:.2f} iterations/s over {timed} iterations ({timed - 3} hyperparameter steps)")
    return launches, acc, ips


def phase_hyper_parity(agt, ck, device):
    """20 iterations of paths A and B (B at B=PAIR_PARITY_B on N=20,000
    rows) on the card (float32) against the same iterations on the CPU
    (float32, the plain versions), same draws, as max |d mu| / max |mu|
    and max |d log-hyperparameter|, each against its own float32 noise
    (the CPU run again with the inducing points in another order): the
    card within ORACLE_DEVICE_FACTOR times it of the CPU, and within it of
    the card with the plain versions in the kernels' place."""
    def after(model, X, y, draws):
        model, state = agt.train(model, X, y, iterations=20, draws=draws.to(X.device))
        return state.mu.double().cpu(), log_hypers(model)

    def err(a, b, perm=None):
        mu = a[0] if perm is None else a[0][:, torch.argsort(perm)]
        return max(float((mu - b[0]).abs().max() / b[0].abs().max()), float((a[1] - b[1]).abs().max()))

    for which in ("A", "B"):
        t0 = time.perf_counter()
        if which == "A":
            Xc, yc = flagship_data("cpu", n=PN, seed=1)
            draws = torch.randint(0, PN // 64, (20, B // 64), generator=torch.Generator().manual_seed(1))
            b, m = B, M
        else:
            Xc, yc = big_logistic_data("cpu", n=PN, seed=1)
            b, m = PAIR_PARITY_B, PM
            draws = torch.randint(0, PN - b + 1, (20,), generator=torch.Generator().manual_seed(1))
        perm = torch.randperm(m, generator=torch.Generator().manual_seed(2))
        Xd, yd = Xc.to(device), yc.to(device)
        cpu = after(hyper_path(agt, Xc, which, b), Xc, yc, draws)
        card = after(hyper_path(agt, Xd, which, b), Xd, yd, draws)
        with plain_kernels(ck, ("fused_cavi_stats",) + SPLIT_PAIRS):
            card_plain = after(hyper_path(agt, Xd, which, b), Xd, yd, draws)
        mp = hyper_path(agt, Xc, which, b)
        noise = err(after(mp.replace(Z=mp.Z[:, perm].contiguous()), Xc, yc, draws), cpu, perm)
        e, e_kernel = err(card, cpu), err(card, card_plain)
        tol, tol_kernel = max(ORACLE_DEVICE_FACTOR * noise, MULTI_PARITY_TOL), max(noise, MULTI_PARITY_TOL)
        if not (e <= tol and e_kernel <= tol_kernel):
            raise AssertionError(f"path {which}: card vs CPU {e:.3e} (bound {tol:.3e}), card vs card with the plain "
                                 f"versions {e_kernel:.3e} (bound {tol_kernel:.3e})")
        log(f"path {which} parity (B={b}, M={m}, 20 iterations, 17 hyperparameter steps): card (float32) vs CPU "
            f"(float32) {e:.3e} (bound {tol:.3e}), vs the card with the plain versions {e_kernel:.3e} "
            f"(bound {tol_kernel:.3e}); CPU with Z reordered vs CPU {noise:.3e}; {time.perf_counter() - t0:.2f} s")


def profile_hyper_path(agt, device, which):
    """torch.profiler over 20 iterations of path A or B (after 30), each a
    CAVI step and a hyperparameter step on its minibatch
    (``python3 chip_smoke.py profile hyper A|B``): wall and device-busy
    time an iteration, the idle share, launches an iteration, the peak
    device memory, the largest kernels and the host operations that take
    the most CPU time."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch.inference import analytic_vi
    from agp_tpu_torch.training import autotuning
    from agp_tpu_torch.training.train import _minibatches

    X, y = flagship_data(device) if which == "A" else big_logistic_data(device)
    model = hyper_path(agt, X, which)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = agt.train(model, X, y, iterations=30, generator=gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n = 20

    def iterations(model, state):
        for x_b, y_b in _minibatches(model, X, y, n, generator=gen):
            model, state = analytic_vi.variational_update(model, state, x_b, y_b)
            model, state = autotuning.hyper_step(model, state, x_b, y_b)
        return model, state

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state = iterations(model, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / n * 1e6
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in events
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / n
    log(f"profile hyper (path {which}, CAVI + hyperparameter step): wall {wall_us:.1f} us/iteration, device busy "
        f"{busy:.1f} us/iteration, idle share {1 - busy / wall_us:.4f}, {launches:.1f} kernel launches/iteration, "
        f"{sum(r[1] for r in rows):.1f} device ops/iteration, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for us, count, key in rows[:10]:
        log(f"  device {us:10.1f} us/iteration  x{count:.1f}  {key[:90]}")
    host = sorted(((e.self_cpu_time_total / n, e.count / n, e.key) for e in events
                   if not str(e.device_type).endswith("CUDA")), reverse=True)
    for us, count, key in host[:12]:
        log(f"  host {us:10.1f} us/iteration  x{count:.1f}  {key[:90]}")


def profile_pair_path(agt, device, which):
    """torch.profiler over 20 steady-state steps (after 30) of
    logistic_m512_b65536 or the M=512 multiclass path
    (``python3 chip_smoke.py profile logistic|multiclass``): wall and
    device-busy time per step, the device's idle share, kernel launches
    per step and the device time of the largest kernels."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch.training.train import vi_steps

    if which == "logistic":
        X, y = big_logistic_data(device)
        model = big_logistic_model(agt, X)
    else:
        X, y = pair_mc_data(device)
        model = pair_multi_model(agt, X, "multiclass")
    y_t, lik = model.likelihood.treat_labels(y)
    model = model.replace(likelihood=lik)
    y_t = y_t.to(X.dtype)
    state = agt.init_state(model, X, y_t)
    gen = torch.Generator(device=device).manual_seed(0)
    model, state = vi_steps(model, state, X, y_t, 30, generator=gen)
    torch.cuda.synchronize()
    n = 20
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, state = vi_steps(model, state, X, y_t, n, generator=gen)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) / n * 1e6
    events = prof.key_averages()
    # device kernels only: the ATen ops that launch them carry the same time
    rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in events
                   if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")) / n
    log(f"profile {which}: wall {wall_us:.1f} us/step, device busy {busy:.1f} us/step, idle share "
        f"{1 - busy / wall_us:.4f}, {launches:.1f} kernel launches/step, {sum(r[1] for r in rows):.1f} device ops/step")
    for us, count, key in rows[:20]:
        log(f"  {us:10.1f} us/step  x{count:.1f}  {key[:100]}")
    return {"wall_us": wall_us, "busy_us": busy, "idle_share": 1 - busy / wall_us, "launches": launches}


def profile_bench_kernels(device, n=20):
    """torch.profiler over n calls of each candidate of the bench's variants
    mode at each of its shapes, and of kernel 10 and index_select at the
    flagship's draw (``python3 chip_smoke.py profile kernels``): device us
    a call, in all and by the kernels each call launches."""
    from torch.profiler import ProfilerActivity, profile

    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import gather_modes as gm

    cases = []
    for b, d, m in bench.VARIANT_SHAPES:
        calls = bench.variant_calls(bench.sweep_inputs(b, d, m, device))
        cases += [(f"{name} B={b} D={d} M={m}", fn) for name, fn in calls.items()]
    X, _ = flagship_data(device)
    for tr in (32, 64):
        tidx = torch.randint(0, N // tr, (B // tr,), device=device,
                             generator=torch.Generator(device=device).manual_seed(0))
        view = X[: N // tr * tr].reshape(N // tr, tr, D)
        cases.append((f"gather_row_tiles B={B} D={D} tr={tr}",
                       lambda tidx=tidx, tr=tr: gm.gather_row_tiles(X, tidx, tile_rows=tr)))
        cases.append((f"index_select B={B} D={D} tr={tr}", lambda view=view, tidx=tidx: view.index_select(0, tidx)))
    for label, fn in cases:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = sorted(((e.self_device_time_total / n, e.count / n, e.key) for e in prof.key_averages()
                       if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0), reverse=True)
        log(f"profile {label}: device {sum(r[0] for r in rows):.2f} us a call; "
            + "; ".join(f"{key[:70]} {us:.2f} us x{count:.0f}" for us, count, key in rows[:5]))


def stats_mode(agt, ck, device):
    """``python3 chip_smoke.py stats`` (``ab ROOT stats`` for an earlier
    tree): kernels 5 and 7 at phase 12's timed shapes by CUDA events and
    device us beside torch.bmm / torch.matmul (stats_timing),
    logistic_m512_b65536's steady it/s (phase 13's run) and ``profile
    logistic``; last a JSON line of them."""
    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"stats: agp_tpu_torch from {tree}")
    out = {"tree": tree, "cavi_stats_batched": {}, "cavi_stats": {}}
    for label, t, _, timed in pair_cases(device):
        if timed:
            kappa = call_k4(ck.fused_kappa_moments_batched_reference, t)[0].contiguous()
            g, th = t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats_batched", kappa, g, th, 10 if kappa.shape[1] > 20000 else 30, lambda: (
                torch.bmm((kappa * th[..., None]).mT, kappa), torch.bmm(kappa.mT, g[..., None])))
            out["cavi_stats_batched"][label] = r
            log(stats_line(label, "kernel 5", r))
    for label, t, _, timed in single_cases(device):
        if timed:
            kappa, g, th = call_k6(ck.fused_kappa_reference, t)[0].contiguous(), t["g"], t["theta"]
            r = stats_timing(ck, "cavi_stats", kappa, g, th, 10 if kappa.shape[0] > 20000 else 30,
                             lambda: ((kappa * th[:, None]).T @ kappa, kappa.T @ g))
            out["cavi_stats"][label] = r
            log(stats_line(label, "kernel 7", r))
    del kappa, g, th, t
    torch.cuda.empty_cache()
    out["logistic_m512_b65536_ips"] = phase_big_logistic(agt, ck, device)[2]
    out["profile_logistic"] = profile_pair_path(agt, device, "logistic")
    print(json.dumps(out))


def kappa_mode(agt, ck, device):
    """``python3 chip_smoke.py kappa`` (``ab ROOT kappa`` for an earlier
    tree): kernels 6 and 4 at phase 12's timed shapes by CUDA events and
    device us beside their products alone (kappa_timing), the steady it/s
    of logistic_m512_b65536 (phase 13's run) and of path B (phase 15's),
    ``profile logistic`` and ``profile multiclass``; last a JSON line of
    them."""
    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"kappa: agp_tpu_torch from {tree}")
    out = {"tree": tree, "fused_kappa": {}, "fused_kappa_moments_batched": {}}
    for name, label_of, cases in (("fused_kappa", "kernel 6", single_cases), ("fused_kappa_moments_batched",
                                                                             "kernel 4", pair_cases)):
        for label, t, _, timed in cases(device):
            if timed:
                reps = 10 if t["X"].shape[0] > 20000 else 30
                out[name][label] = kappa_timing(ck, name, t, reps)
                log(kappa_line(label, label_of, out[name][label]))
        del t
        torch.cuda.empty_cache()
    out["logistic_m512_b65536_ips"] = phase_big_logistic(agt, ck, device)[2]
    out["path_b_ips"] = phase_hyper_path(agt, ck, device, "B")[2]
    out["profile_logistic"] = profile_pair_path(agt, device, "logistic")
    out["profile_multiclass"] = profile_pair_path(agt, device, "multiclass")
    print(json.dumps(out))


def variants_mode(agt, device):
    """``python3 chip_smoke.py variants`` (``ab ROOT variants`` for an
    earlier tree): kernels 8 ("nt", "packed") and 9 at each shape of
    VARIANT_TIMED by CUDA events beside the sweep's bar (at the flagship's
    host-bound shape the median of three turns round the kernels, and the
    host us a call over 1000 calls), then (the profiler after every
    timing) their device us; a shape the tree's kernels refuse reads "out
    of range".  Where the tree has kernels 8-9's row tiles
    (fused_variants._VARIANT_TILES), each form at the sweep's M=128 and
    M=512 rows with every tile whose shared memory fits, through the
    wrapper's launch with that tile (no launch counted).  Last a JSON line
    of them."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    tree = os.path.relpath(os.path.dirname(agt.__file__))
    log(f"variants: agp_tpu_torch from {tree}")
    out = {"tree": tree, "ms": {}, "device_us": {}, "bar_ms": {}, "host_us": {}}
    kernels = timed_variant_kernels(fv)
    for profile in (False, True):
        for b, d, m in VARIANT_TIMED:
            key, reps = shape_key(b, d, m), 200 if b <= B else BIG_VARIANT_REPS
            t = bench.sweep_inputs(b, d, m, device)
            if not profile:
                out["bar_ms"][key] = cuda_ms(bench.variant_calls(t)["xla_stats_reference"], reps)
            fns = {f"{key} {label}": lambda kern=kern, kw=kw: sweep_call(kern, t, **kw)
                   for label, (kern, _, kw) in kernels.items()}
            for name, fn in fns.items():
                if profile and not isinstance(out["ms"][name], str):
                    out["device_us"][name] = device_us(fn)[0]
                elif not profile:
                    try:
                        fn()
                        out["ms"][name] = cuda_ms(fn, reps)
                    except ValueError as e:
                        out["ms"][name] = f"out of range: {e}"
            if not profile and b <= B:  # host-bound: two more turns round the kernels, the median
                ok = [n for n in fns if not isinstance(out["ms"][n], str)]
                turns = {n: [out["ms"][n]] for n in ok}
                for _ in range(2):
                    for n in ok:
                        turns[n].append(cuda_ms(fns[n], reps))
                for n in ok:
                    out["ms"][n] = sorted(turns[n])[1]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(1000):
                        fns[n]()
                    out["host_us"][n] = (time.perf_counter() - t0) * 1e3
                    torch.cuda.synchronize()
            if not profile:
                log(f"variants at {key}: bar {out['bar_ms'][key]:.4f} ms; " + "; ".join(
                    f"{k.split(' ')[1]} {v if isinstance(v, str) else f'{v:.4f} ms'}" for k, v in out["ms"].items()
                    if k.startswith(key + " ")))
            del t
    log("variants, device us: " + "; ".join(f"{k} {v:.1f}" for k, v in out["device_us"].items()))
    log("variants, host us a call: " + "; ".join(f"{k} {v:.1f}" for k, v in out["host_us"].items()))
    if hasattr(fv, "_VARIANT_TILES"):
        out["tiles"] = {}
        names = {"direct": "direct_stats", "packed": "direct_stats", "two_factor": "two_factor_nt"}
        for b, d, m in ((262_144, 8, 128), (65_536, 8, 512)):
            t = bench.sweep_inputs(b, d, m, device)
            for form in fv._FORMS:
                for tile in fv._VARIANT_TILES:
                    if fv.variant_smem_bytes(m, tile) > fv._smem_limit(0):
                        continue
                    key = f"{shape_key(b, d, m)} {form} {tile[0]}x{tile[1]}"
                    out["tiles"][key] = cuda_ms(lambda: fv._variant_launch(names[form], form, *bench.sweep_args(t),
                                                                           tile=tile), BIG_VARIANT_REPS)
                    log(f"  tile {key}: {out['tiles'][key]:.4f} ms"
                        + (" (variant_tile's choice)" if tile == fv.variant_tile(m) else ""))
            del t
    print(json.dumps(out))


def probe_mode(ck):
    """``python3 chip_smoke.py probe``: builds the measurement program
    agp_tpu_torch/csrc/probes/kappa_tc.cu with nvcc for sm_90a into the
    build directory and runs it on the card: kernel 6's gram and product
    apart at logistic_m512_b65536's shape, kernels 4 and 6 at other tile
    shapes, and the mma.sync rate with and without 3xTF32's splits."""
    src = ck._PKG / "csrc" / "probes" / "kappa_tc.cu"
    out_dir = ck._BUILD_ROOT / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "kappa_tc"
    subprocess.run([ck._nvcc(), *ck._ARCH, "-std=c++17", "-O3", "-o", str(exe), str(src)], check=True)
    log(subprocess.run([str(exe)], capture_output=True, text=True, check=True, timeout=600).stdout)


MOVED_CALLS = 200


def time_moved_paths(agt, device):
    """Wall time per call, on the host clock around MOVED_CALLS calls after
    20 and a torch.cuda.synchronize(), of the two calls that take the
    batched pair at shapes within fused_fits: a row-weighted CAVI step
    (``variational_update`` with w of ones, never fused) and ``elbo`` on
    its batch, at the flagship (L=1) and at the bench.py multiclass (L=10)
    and heteroscedastic (L=2) shapes (``python3 chip_smoke.py
    moved-paths``; ``ab ROOT moved-paths`` for an earlier tree)."""
    from agp_tpu_torch.inference import analytic_vi

    log(f"moved paths: agp_tpu_torch from {os.path.relpath(os.path.dirname(agt.__file__))}")
    X, y = flagship_data(device)
    cases = [("flagship", flagship_model(agt, X), X, y, B)]
    for which, data in (("multiclass", mc_data), ("het", het_data)):
        Xm, ym = data(device)
        cases.append((which, multi_model(agt, Xm, which), Xm, ym, MB))
    for name, model, X, y, b in cases:
        y_t, lik = model.likelihood.treat_labels(y)
        model = model.replace(likelihood=lik)
        y_t = y_t.to(X.dtype)
        state = agt.init_state(model, X, y_t)
        xb, yb = X[:b].contiguous(), y_t[:b].contiguous()
        w = torch.ones(b, dtype=X.dtype, device=device)
        step_us = elbo_us = 0.0
        for n in (20, MOVED_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                model, state = analytic_vi.variational_update(model, state, xb, yb, w=w)
            torch.cuda.synchronize()
            step_us = (time.perf_counter() - t0) / n * 1e6
            t0 = time.perf_counter()
            for _ in range(n):
                value = agt.elbo(model, state, xb, yb)
            torch.cuda.synchronize()
            elbo_us = (time.perf_counter() - t0) / n * 1e6
        if not (bool(torch.isfinite(state.mu).all()) and bool(torch.isfinite(value))):
            raise AssertionError(f"moved paths {name}: non-finite state or ELBO")
        log(f"moved paths {name} (B={b}, M={model.n_inducing}, L={model.n_latent}): row-weighted step "
            f"{step_us:.1f} us, elbo {elbo_us:.1f} us per call over {MOVED_CALLS} calls (ELBO {float(value):.6g})")


# ------------------------------------------ the bench's kernels (8-10)
# shapes (B, D, M) at which kernels 8-9 are held against their plain
# versions: the flagship's statistics, a ragged B with M=128, the sweep's
# four rows (benchmarks/fused_variants.py:286: the 64-row tile, two output
# tiles at M=512), and a ragged B at M=129 (past the narrow tile, M % 4 = 1:
# 4-byte copies) and M=520 (two output tiles, the last ragged)
VARIANT_CASES = ((B, D, M), (300, D, 128), (262_144, 8, 128), (8192, 8, 512), (65_536, 8, 256), (65_536, 8, 512),
                 (300, 8, 129), (300, 8, 520))
# the shapes at which kernels 8-9 are timed: the flagship's statistics and
# the sweep's four rows; the kernels line's main shape is the sweep's
# B=262,144 row, where the bar is timed at its largest
VARIANT_TIMED = ((B, D, M), (8192, 8, 512), (65_536, 8, 256), (65_536, 8, 512), (262_144, 8, 128))
VARIANT_MAIN = (262_144, 8, 128)
# the bench's variants and gather modes as phases 16-17 drive them: timed
# calls of each candidate (a tenth at B=262,144) and draws of each arm
VARIANT_REPS, GATHER_DRAWS = 20, 500
# calls timed at the sweep's rows (B >= 8192)
BIG_VARIANT_REPS = 10
# the bench's primary line at a cut step count (phase 18)
BENCH_ITERS, BENCH_CHUNK = 1000, 500
STATS_NAMES = ("s1", "S2", "c", "theta", "mf", "vf")


def shape_key(b, d, m):
    return f"B{b}_D{d}_M{m}"


def variant_kernels(fv):
    """{label: (kernel, plain version, keywords)} of kernel 8 (each variant)
    and kernel 9."""
    out = {f"direct_stats/{v}": (fv.direct_stats, fv.direct_stats_reference, {"variant": v}) for v in fv.VARIANTS}
    out["two_factor_nt"] = (fv.two_factor_nt, fv.two_factor_nt_reference, {})
    return out


def timed_variant_kernels(fv):
    """variant_kernels without "transpose", the same form as "nt"."""
    return {k: v for k, v in variant_kernels(fv).items() if k != "direct_stats/transpose"}


def sweep_call(fn, t, **kw):
    """fn on the sweep's inputs t (agp_tpu_torch.bench.sweep_inputs)."""
    from agp_tpu_torch import bench

    return fn(*bench.sweep_args(t), **kw)


def ill_conditioned_inputs(agt, device, m=OM, seed=0):
    """Card tensors of kernels 1, 8 and 9 at the oracle paths' shape
    (B=8192, D=2, M=m: 128, or the M=512 paths', lengthscale 1, Z on the
    batch's rows, L^-T from the float32 Cholesky with jitter 1e-3, as phase
    3 takes it), with a random mu and Sigma = 0, so that vf is Ktilde
    itself."""
    from agp_tpu_torch.ops import linalg

    X, y, _ = oracle_data("logistic", "cpu")
    rng = np.random.default_rng(seed)
    t = {"X": X[:OB], "y": y[:OB], "Z": X[:m], "mu": torch.as_tensor(rng.normal(size=m), dtype=torch.float32),
         "Sigma": torch.zeros((m, m))}
    t = {k: v.to(device).contiguous() for k, v in t.items()}
    L = linalg.safe_cholesky(agt.SqExponentialKernel().gram(t["Z"]), 1e-3)
    eye = torch.eye(m, device=device, dtype=L.dtype)
    t["L_invT"] = torch.linalg.solve_triangular(L, eye, upper=False).T.contiguous()
    return t


def ill_call(fn, t, **kw):
    return fn(t["X"], t["y"], t["Z"], t["L_invT"], t["mu"], t["Sigma"], 1.0, 1.0, 1e-3, ON / OB, **kw)


def ill_conditioned_variants(agt, ck, device):
    """Kernels 8 (each variant) and 9 at the ill-conditioned oracle shapes
    (M=128 and M=512) against the float64 plain version, within
    FLOAT32_FACTOR times the float32 plain version's own error with no
    floor, and kernel 1 at M=128 (its KERNEL_TOL floor: an FP32 design);
    each a second call bit-equal.  Returns {label M=m: {output:
    (kernel, float32 plain) error against float64}} for Ktilde (vf, with
    Sigma = 0), S2 and mf, each logged."""
    from agp_tpu_torch.benchmarks import fused_variants as fv

    ill = {}
    for m in (OM, PM):
        t = ill_conditioned_inputs(agt, device, m)
        t64 = to_float64(t)
        cases = [(label, fn, plain, kw, 0.0) for label, (fn, plain, kw) in variant_kernels(fv).items()]
        if m == OM:
            cases.insert(0, ("fused_cavi_stats", ck.fused_cavi_stats, ck.fused_cavi_stats_reference,
                             {"kind": "rbf", "lik": "logistic"}, KERNEL_TOL))
        for label, fn, plain, kw, floor in cases:
            got = ill_call(fn, t, **kw)
            torch.cuda.synchronize()
            ref, ref64 = ill_call(plain, t, **kw), ill_call(plain, t64, **kw)
            check_outputs(f"{label} at B={OB}, D=2, M={m}, Sigma = 0", STATS_NAMES, got, ref, ref64, floor=floor)
            if label != "fused_cavi_stats":
                check_repeat(f"{label} at B={OB}, D=2, M={m}", lambda: ill_call(fn, t, **kw), got)

            def against64(i):
                scale = max(float(ref64[i].abs().max()), 1.0)
                return tuple(float((o[i].double() - ref64[i]).abs().max()) / scale for o in (got, ref))

            key = f"{label} M={m}"
            ill[key] = {"Ktilde": against64(5), "S2": against64(1), "mf": against64(4)}
            log(f"ill-conditioned {label} (B={OB}, D=2, M={m}, ls 1, Sigma = 0, vf = Ktilde) against float64, "
                "kernel / float32 plain: " + " ".join(f"{k}={a:.3e}/{p:.3e}" for k, (a, p) in ill[key].items()))
        del t, t64
    return ill


def variant_timing(fv, bench, device):
    """Kernels 8 ("nt", "packed") and 9 at each shape of VARIANT_TIMED by
    CUDA events beside their plain versions (plain, kernel, kernel, plain),
    kernel 1 where it takes the shape and the sweep's bar
    (xla_stats_reference, library_ms); at VARIANT_MAIN each kernel's
    device us (profiler).  Returns ({shape: {label: (ms, plain ms)}},
    {shape: bar ms}, {shape: kernel 1 ms}, {label: (device us, {kernel:
    us})})."""
    times, bar, k1, dev = {}, {}, {}, {}
    for b, d, m in VARIANT_TIMED:
        key, reps = shape_key(b, d, m), 200 if b <= B else BIG_VARIANT_REPS
        t = bench.sweep_inputs(b, d, m, device)
        times[key] = {label: timed_pair(lambda: sweep_call(kern, t, **kw), lambda: sweep_call(plain, t, **kw), reps)
                      for label, (kern, plain, kw) in timed_variant_kernels(fv).items()}
        calls = bench.variant_calls(t)
        bar[key] = cuda_ms(calls["xla_stats_reference"], reps)
        if "fused_cavi_stats" in calls:
            k1[key] = cuda_ms(calls["fused_cavi_stats"], reps)
        if (b, d, m) == VARIANT_MAIN:
            dev = {label: device_us(lambda: sweep_call(kern, t, **kw))
                   for label, (kern, _, kw) in timed_variant_kernels(fv).items()}
        log(f"kernels 8-9 at B={b} D={d} M={m}, ms (plain): " + " ".join(
            f"{k} {a:.4f} ({p:.4f})" for k, (a, p) in times[key].items()) + f"; xla_stats_reference {bar[key]:.4f}"
            + (f", kernel 1 {k1[key]:.4f}" if key in k1 else ""))
        del t
    for label, (us, by) in dev.items():
        log(f"  device at {shape_key(*VARIANT_MAIN)}: {label} {us:.1f} us (" + ", ".join(
            f"{k} {v:.1f}" for k, v in by.items()) + ")")
    return times, bar, k1, dev


def phase_variant_kernels_vs_plain(agt, ck, device):
    """Kernels 8 (every variant) and 9 against their plain versions on the
    same card tensors at VARIANT_CASES, within KERNEL_TOL, each a second
    call bit-equal; then at the ill-conditioned oracle shapes against the
    float64 plain version (ill_conditioned_variants); then timed
    (variant_timing).  Returns ({kernel: largest abs error}, the
    ill-conditioned errors, and variant_timing's four tables)."""
    from agp_tpu_torch import bench
    from agp_tpu_torch.benchmarks import fused_variants as fv

    worst = {"direct_stats": 0.0, "two_factor_nt": 0.0}
    kernels = variant_kernels(fv)
    for b, d, m in VARIANT_CASES:
        t = bench.sweep_inputs(b, d, m, device)
        for label, (kern, plain, kw) in kernels.items():
            got = sweep_call(kern, t, **kw)
            torch.cuda.synchronize()
            ref = sweep_call(plain, t, **kw)
            torch.cuda.synchronize()
            row = check_outputs(f"{label} B={b} D={d} M={m}", STATS_NAMES, got, ref)
            check_repeat(f"{label} B={b} D={d} M={m}", lambda: sweep_call(kern, t, **kw), got)
            worst[kern.__name__] = max(worst[kern.__name__], *row.values())
            log(f"{label} vs plain B={b} D={d} M={m} (row tile {fv.variant_tile(m)[:2]}): "
                "max abs err " + " ".join(f"{k}={v:.2e}" for k, v in row.items()))
        del t, got, ref
    ill = ill_conditioned_variants(agt, ck, device)
    return (worst, ill, *variant_timing(fv, bench, device))


def phase_bench_variants(ck):
    """The bench's variants mode (agp_tpu_torch.bench.variants), the main
    path of kernels 8-9: counts reset before it and read after it, each
    candidate launched once for its error and 1 + variant_reps times for
    its time at each shape (kernel 1 where it takes the shape); every
    candidate's s1/S2 within 1e-3 of the float64 plain version, kernel 1's
    column out of range exactly at M > 128."""
    from agp_tpu_torch import bench

    reset_launches(ck)
    rows = bench.variants(reps=VARIANT_REPS)
    torch.cuda.synchronize()
    calls = {(b, d, m): 2 + bench.variant_reps(b, VARIANT_REPS) for b, d, m in bench.VARIANT_SHAPES}
    launches = expect_launches(ck, "bench variants", {
        "fused_cavi_stats": sum(n for (b, d, m), n in calls.items() if ck.fused_fits(1, d, m)),
        "direct_stats": 2 * sum(calls.values()), "two_factor_nt": sum(calls.values())})
    for row in rows:
        errs = {k: v for k, v in row.items() if k.endswith("_err")}
        if not all(e <= 1e-3 for e in errs.values()) or len(errs) != 4 + ck.fused_fits(1, row["D"], row["M"]):
            raise AssertionError(f"bench variants at B={row['B']}, M={row['M']}: {errs}")
        if ("fused_cavi_stats_out_of_range" in row) != (row["M"] > ck.MAX_M):
            raise AssertionError(f"bench variants at M={row['M']}: kernel 1's range is misreported: {row}")
        log(f"bench variants: {json.dumps(row)}")
    log(f"bench variants: {launches} launches")
    return rows


def phase_gather_vs_plain(device):
    """Kernel 10 bit-equal to its plain version (index_select on the tile
    view: a copy) at the flagship's draw with tiles of 32 and 64 rows, at a
    ragged T with int32 indices, with 99-float tiles (D=33, tr=3) and with
    16-byte tiles from an unaligned view (the scalar paths); then timed at
    the flagship's draw beside its plain version (plain, kernel, kernel,
    plain) and index_select on the view alone (library_ms).  Returns
    ({tr: (ms, plain ms)}, {tr: library ms})."""
    from agp_tpu_torch.benchmarks import gather_modes as gm

    X, _ = flagship_data(device)
    rng = np.random.default_rng(1)
    X33 = torch.as_tensor(rng.normal(size=(1000, 33)).astype(np.float32), device=device)
    X6 = torch.as_tensor(rng.normal(size=(1001, 6)).astype(np.float32), device=device)[1:]
    gen = torch.Generator(device=device).manual_seed(0)
    cases = [(X, 32, B // 32, torch.int64), (X, 64, B // 64, torch.int64), (X, 32, 77, torch.int32),
             (X33, 3, 50, torch.int64), (X6, 2, 40, torch.int64)]
    for Xc, tr, T, dt in cases:
        tidx = torch.randint(0, Xc.shape[0] // tr, (T,), generator=gen, device=device).to(dt)
        got = gm.gather_row_tiles(Xc, tidx, tile_rows=tr)
        torch.cuda.synchronize()
        if not torch.equal(got, gm.gather_row_tiles_reference(Xc, tidx, tile_rows=tr)):
            raise AssertionError(f"gather_row_tiles differs from index_select at D={Xc.shape[1]}, tr={tr}, T={T}")
        log(f"gather_row_tiles bit-equal to its plain version: D={Xc.shape[1]}, tr={tr}, T={T}, {dt}")
    times, library = {}, {}
    for tr in (32, 64):
        tidx = torch.randint(0, N // tr, (B // tr,), generator=gen, device=device)
        view = X[: N // tr * tr].reshape(N // tr, tr, D)
        times[tr] = timed_pair(lambda: gm.gather_row_tiles(X, tidx, tile_rows=tr),
                               lambda: gm.gather_row_tiles_reference(X, tidx, tile_rows=tr))
        library[tr] = cuda_ms(lambda: view.index_select(0, tidx))
        log(f"gather_row_tiles B={B} D={D} tr={tr}: kernel {times[tr][0]:.4f} ms, plain {times[tr][1]:.4f} ms, "
            f"index_select {library[tr]:.4f} ms")
    return times, library


def phase_bench_gather(ck):
    """The bench's gather mode (agp_tpu_torch.bench.gather), the main path
    of kernel 10: counts reset before it and read after it, one launch for
    its check and 2 (1 + draws) for its times at each tile height."""
    from agp_tpu_torch import bench

    reset_launches(ck)
    rows = bench.gather(draws=GATHER_DRAWS)
    torch.cuda.synchronize()
    launches = expect_launches(ck, "bench gather",
                               {"gather_row_tiles": len(bench.GATHER_TILES) * (1 + 4 * GATHER_DRAWS)})
    log(f"bench gather: {json.dumps(rows)}; {launches} launches")
    return rows


def phase_bench_entry():
    """The bench's primary line (``python3 -m agp_tpu_torch.bench``) in a
    child process, at BENCH_ITERS timed steps: its last line must parse,
    name the port's metric and give a finite positive rate."""
    proc = subprocess.run([sys.executable, "-m", "agp_tpu_torch.bench", "--iters", str(BENCH_ITERS),
                           "--chunk", str(BENCH_CHUNK)], cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"the bench exited {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    for line in lines[:-1]:
        log(f"  [bench] {line}")
    result = json.loads(lines[-1])
    value = result.get("value")
    if result.get("metric") != "torch_cavi_iters_per_sec_svgp_m64_logistic_b4096" or not (
            isinstance(value, float) and value > 0 and value < float("inf")):
        raise AssertionError(f"the bench's line is wrong: {lines[-1]}")
    log(f"bench entry point ({BENCH_ITERS} timed steps): {lines[-1]}")
    return result


def variant_bound(b, d, m, two_factor):
    """Kernels 8-9 as fused_bound for one latent (logistic: 5 words a row
    beyond x), with kappa in the two-factor form as two triangular products
    (W = Knm L^-T, kappa = W L^-1: ``sym_fmas`` each) instead of one M^2;
    the design's bound counts kappa and kappa Sigma in full in three TF32
    passes, kernel 9's W in four (L^-T split in three) and S2's upper
    triangle in three."""
    tc = b * ((2 * sym_fmas(m) if two_factor else m * m) + 2 * sym_fmas(m))
    design = b * ((4 + 3) * m * m if two_factor else 3 * m * m) + 3 * b * (m * m + sym_fmas(m))
    simt = b * (m * d + 5 * m)
    nbytes = 4 * (b * d + 5 * b + m * d + 3 * m * m + 2 * m)
    return tc_bound(tc, simt, nbytes), tc_bound(design, simt, nbytes), bound(tc + simt, nbytes)


def gather_bound(t, tr, d):
    """Kernel 10: no arithmetic; reads T tiles of tr D floats and T int64
    indices, writes the T tiles."""
    return bound(0, 2 * 4 * t * tr * d + 8 * t)


def timing_fields(extra, main_shape):
    """Kernels 4-7's further keys of the kernels line from kappa_timing's
    (4, 6) or stats_timing's (5, 7) dicts by shape: device us, and the
    device us of the products alone (4, 6) or of the library call (5, 7),
    at the main shape and at each timed shape, and what each bound counts;
    none for the other kernels."""
    if not extra:
        return {}
    rows = {"device_us": extra[main_shape]["device_us"],
            "per_shape_device_us": {k: v["device_us_by_kernel"] for k, v in extra.items()}}
    if "products_ms" in extra[main_shape]:
        return {**rows, "products_ms": {k: v["products_ms"] for k, v in extra.items()},
                "products_device_us": {k: v["products_device_us"] for k, v in extra.items()},
                "products": "kappa's product alone (torch.matmul; kernel 4: torch.bmm for kappa and for kappa "
                            "Sigma): a yardstick, not the whole function",
                "bound": "kappa's M^2 FMAs (kernel 4: and the quadratic form's upper triangle) once at 495 TFLOP/s "
                         "TF32, the gram and row sums at 67 FP32, bytes at 3.35 TB/s",
                "bound_3xtf32": "the design's three TF32 passes of kappa (kernel 4: and of kappa Sigma in full), the "
                                "rest at FP32, bytes",
                "bound_fp32": "everything at 67 TFLOP/s FP32, bytes"}
    return {**rows, "library_device_us": extra[main_shape]["library_device_us"],
            "per_shape_library_device_us": {k: v["library_device_us"] for k, v in extra.items()},
            "bound": "S2's upper-triangle FMAs once at 495 TFLOP/s TF32, s1 at 67 FP32, bytes at 3.35 TB/s",
            "bound_3xtf32": "the design's three TF32 passes of S2, s1 at FP32, bytes",
            "bound_fp32": "S2 and s1 at 67 TFLOP/s FP32, bytes"}


def ms_table(pairs):
    return {k: {"ms": kern, "plain_ms": plain} for k, (kern, plain) in pairs.items()}


PHASE_SECONDS = {}


def timed_phase(name, fn, *args, **kw):
    """Runs one phase of main, logs and keeps its wall time."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[name] = round(time.perf_counter() - t0, 2)
    log(f"phase {name}: {PHASE_SECONDS[name]:.2f} s")
    return out


def main():
    t_start = time.perf_counter()
    device = phase_device()
    args = sys.argv[1:]
    if args[:1] == ["ab"]:  # ab ROOT MODE...: MODE with agp_tpu_torch from ROOT
        sys.path.insert(0, os.path.abspath(args[1]))
        args = args[2:]
    import agp_tpu_torch as agt
    from agp_tpu_torch.ops import cuda_kernels as ck

    if args == ["moved-paths"]:
        time_moved_paths(agt, device)
        return
    if args == ["probe"]:
        probe_mode(ck)
        return
    lib_path = timed_phase("build", phase_build, ck)
    timed_phase("fused_fits", check_fused_fits, ck)
    if args == ["studentt-rate"]:
        launches, ips = phase_studentt_rate(agt, ck, device)
        print(json.dumps({"launches": launches, "ips": ips}))
        return
    if args == ["stats"]:
        stats_mode(agt, ck, device)
        return
    if args == ["kappa"]:
        kappa_mode(agt, ck, device)
        return
    if args == ["variants"]:
        variants_mode(agt, device)
        return
    if args[:2] == ["profile", "kernels"]:
        profile_bench_kernels(device)
        return
    if args[:2] == ["profile", "hyper"]:
        profile_hyper_path(agt, device, args[2] if len(args) > 2 else "A")
        return
    if args[:1] == ["profile"]:
        profile_pair_path(agt, device, args[1])
        return
    timed_phase("tensor-core SASS", check_tc_sass, lib_path)
    timed_phase("kappa tiles", check_kappa_tiles, ck)
    timed_phase("variant tiles", check_variant_tiles, ck)
    errs, kern_ms, plain_ms = timed_phase("kernel 1 vs plain", phase_kernel_vs_plain, ck, device)
    branch_err, per_lik, per_kind, oracle_ms = timed_phase("kernel 1 branches", phase_branches_vs_plain,
                                                           agt, ck, device)
    multi = timed_phase("kernels 2-3 vs plain", phase_multi_kernels_vs_plain, ck, device)
    timed_phase("flagship path", phase_main_path, agt, ck, device)
    LAUNCHES["fused_cavi_stats"] += timed_phase("Student-t rate (child)", studentt_rate_first_in_process)
    timed_phase("oracle and flagship parity", phase_oracle_and_parity, agt, device)
    for which in ("multiclass", "het"):
        timed_phase(f"{which} path", phase_multi_path, agt, ck, device, which)
    timed_phase("multi-latent parity", phase_multi_parity, agt, device)
    timed_phase("oracles M=128", phase_oracles, agt, ck, device)
    timed_phase("single-latent parity", phase_single_parity, agt, ck, device)

    pair = timed_phase("kernels 4-5 vs plain", phase_pair_kernels_vs_plain, ck, device)
    timed_phase("kernel 4 autograd", phase_pair_autograd, ck, device)
    single = timed_phase("kernels 6-7 vs plain", phase_single_kernels_vs_plain, ck, device)
    timed_phase("kernel 6 autograd", phase_kappa_autograd, ck, device)
    timed_phase("logistic_m512_b65536", phase_big_logistic, agt, ck, device)
    for which in ("multiclass", "het"):
        timed_phase(f"{which} M=512", phase_pair_multi, agt, ck, device, which)
    timed_phase("oracles M=512", phase_oracles, agt, ck, device, m=PM, floors=PAIR_ORACLE_FLOORS,
                paths=[(lik, "SqExponentialKernel") for lik in ORACLE_LIKS])
    timed_phase("pair parity", phase_pair_parity, agt, ck, device)
    for which in ("A", "B"):
        timed_phase(f"hyper path {which}", phase_hyper_path, agt, ck, device, which)
    timed_phase("hyper parity", phase_hyper_parity, agt, ck, device)

    variant_err, ill, variant_ms, bar_ms, k1_ms, variant_dev = timed_phase(
        "kernels 8-9 vs plain", phase_variant_kernels_vs_plain, agt, ck, device)
    timed_phase("bench variants", phase_bench_variants, ck)
    gather_ms, gather_library = timed_phase("kernel 10 vs plain", phase_gather_vs_plain, device)
    timed_phase("bench gather", phase_bench_gather, ck)
    timed_phase("bench entry point (child)", phase_bench_entry)
    log(f"phase seconds: {json.dumps(PHASE_SECONDS)}; total {time.perf_counter() - t_start:.2f} s")

    bounds = {
        "fused_cavi_stats": fused_bound(B, D, M, 1, 5),
        "fused_cavi_stats_multiclass": fused_bound(MB, MD, MM, MK, 3 + 4 * MK),
        "fused_cavi_stats_het": fused_bound(MB, MD, MM, 2, 6),
    }
    bounds["fused_kappa_moments_batched"], bounds["cavi_stats_batched"] = pair_bounds(LB, LD, PM, 1)
    bounds["fused_kappa"], bounds["cavi_stats"] = single_bounds(LB, LD, PM)
    bounds["direct_stats"] = variant_bound(*VARIANT_MAIN, False)
    bounds["two_factor_nt"] = variant_bound(*VARIANT_MAIN, True)
    bounds["gather_row_tiles"] = gather_bound(B // 32, 32, D)
    main_variant = shape_key(*VARIANT_MAIN)
    main_shape = "logistic_m512_b65536"
    kernels = {"kernels": [{
        "name": "fused_cavi_stats",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats.cu",
        "replaces": "agp_tpu/ops/pallas_kernels.py:750",
        "max_abs_err": max(branch_err, *(v for row in errs.values() for v in row.values())),
        "ms": kern_ms,
        "plain_ms": plain_ms,
        "per_lik_ms": ms_table(per_lik),
        "per_kind_ms": ms_table(per_kind),
        "oracle_shape_ms": ms_table({"studentt/rbf": oracle_ms}),
        "library_ms": bar_ms[shape_key(B, D, M)],
        "library": "xla_stats_reference at the flagship shape (phase 16)",
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_cavi_stats_multi.cu",
        "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
        "max_abs_err": multi[name][0],
        "ms": multi[name][1],
        "plain_ms": multi[name][2],
        "per_kind_ms": ms_table(multi[name][3]),
    } for name, line in (("fused_cavi_stats_multiclass", 953), ("fused_cavi_stats_het", 1133))] + [{
        "name": name,
        "route": "cuda",
        "source": f"agp_tpu_torch/csrc/{source}",
        "replaces": f"agp_tpu/ops/pallas_kernels.py:{line}",
        "max_abs_err": table[name][0],
        "ms": table[name][1][main_shape][0],
        "plain_ms": table[name][1][main_shape][1],
        "per_shape_ms": ms_table(table[name][1]),
        "library_ms": table[name][2].get(main_shape),
        "per_shape_library_ms": table[name][2] or None,
        **timing_fields(table[name][3], main_shape),
    } for name, line, source, table in (
        ("fused_kappa_moments_batched", 361, "batched_pair.cu", pair),
        ("cavi_stats_batched", 486, "batched_pair.cu", pair),
        ("fused_kappa", 213, "kappa_single.cu", single),
        ("cavi_stats", 545, "kappa_single.cu", single),
    )] + [{
        "name": name,
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/fused_variants.cu",
        "replaces": f"benchmarks/fused_variants.py:{line}",
        "max_abs_err": variant_err[name],
        "ms": variant_ms[main_variant][label][0],
        "plain_ms": variant_ms[main_variant][label][1],
        "main_shape": main_variant,
        "per_shape_ms": ms_table({f"{shape} {k}": v for shape, row in variant_ms.items() for k, v in row.items()
                                  if k.startswith(name)}),
        "library_ms": bar_ms[main_variant],
        "per_shape_library_ms": bar_ms,
        "library": "xla_stats_reference (the sweep's bar, a chain of FP32 cuBLAS calls)",
        "device_us": variant_dev[label][0],
        "device_us_by_kernel": variant_dev[label][1],
        "per_variant_device_us": {k: v[0] for k, v in variant_dev.items() if k.startswith(name)},
        "kernel_1_ms": k1_ms,
        "ill_conditioned_vs_float64": {k: v for k, v in ill.items() if k.startswith(name) or
                                       k.startswith("fused_cavi_stats")},
        "bound": "the function's products (kappa; the quadratic form's and S2's upper triangles) once at 495 TFLOP/s "
                 "TF32, the gram and row sums at 67 FP32, bytes at 3.35 TB/s",
        "bound_3xtf32": "kappa and kappa Sigma in full (kernel 9: and W in four passes) and S2's upper triangle in "
                        "three TF32 passes, the rest at FP32, bytes",
        "bound_fp32": "everything at 67 TFLOP/s FP32, bytes",
    } for name, line, label in (("direct_stats", 132, "direct_stats/nt"), ("two_factor_nt", 214, "two_factor_nt"))] + [{
        "name": "gather_row_tiles",
        "route": "cuda",
        "source": "agp_tpu_torch/csrc/gather_tiles.cu",
        "replaces": "benchmarks/gather_modes.py:218",
        "max_abs_err": 0.0,
        "ms": gather_ms[32][0],
        "plain_ms": gather_ms[32][1],
        "per_tile_ms": ms_table({f"tile{tr}": v for tr, v in gather_ms.items()}),
        "library_ms": gather_library[32],
        "per_tile_library_ms": {f"tile{tr}": v for tr, v in gather_library.items()},
    }]}
    for name in [n for n, v in bounds.items() if len(v) == 3]:
        # (function's, 3xTF32 design's, FP32) bounds
        bounds[name], design, fp32 = bounds[name]
        row = next(k for k in kernels["kernels"] if k["name"] == name)
        row["bound_3xtf32_ms"], row["bound_fp32_ms"] = design[0], fp32[0]
    for k in kernels["kernels"]:
        k["launches"] = LAUNCHES.get(k["name"], 0)
        k["bound_ms"], k["bound_by"] = bounds[k["name"]]
        k.setdefault("library_ms", None)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
