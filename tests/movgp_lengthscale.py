"""Phase 52's MOVGP at the reference's lengthscale (ROADMAP.md queue 3
item 9): tpu_acceptance.py:187-202's Gaussian(0.1) + logistic model as a
MOVGP (Z = X, Q = 2) on chip_smoke.mo_data's 3,000 points on [-2, 2]^2,
full-batch CAVI from the same A (chip_smoke.seeded_A), task 0's RMSE on
256 points.  A measurement script, not a test:

    python tests/movgp_lengthscale.py cpu [--dtype float64] [--pallas] [--perm SEED] [--iters N]
        the JAX package and the port on the host's CPU, 60 iterations
        (--pallas: the JAX package alone, through its Pallas batched pair
        in TPU interpret mode, the algorithm the port's kernels copy;
        --perm: the rows permuted with that seed)
    python tests/movgp_lengthscale.py card
        the port on the card in float32: with its kernels, with the plain
        versions in their place, with the host CPU's kmat, with Kmm's
        distances by direct differences, each against the CPU's float64
        run; then step 1 stage by stage on the card and on the CPU (each
        float32 stage against float64 from its own float32 inputs)

"cpu" imports JAX; "card" imports only the port (the machine with the card
has no JAX).  Run from the repository's root."""
import argparse
import contextlib
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import agp_tpu_torch as agt  # noqa: E402
import chip_smoke as cs  # noqa: E402

N, LS, ITERS, CHECK = 3000, 1.0, 60, (1, 2, 3, 5, 10, 20, 40, 60)


def data(dtype, perm=None):
    X, f, ys = cs.mo_data(N, "cpu", dtype, seed=4)
    if perm is not None:
        p = torch.randperm(N, generator=torch.Generator().manual_seed(perm))
        X, f, ys = X[p], f[p], tuple(y[p] for y in ys)
    return X, f, ys


def port_model(X, ys):
    liks = [agt.GaussianLikelihood.create(0.1), agt.LogisticLikelihood.create()]
    model, ys_t = cs.mo_treated(
        cs.seeded_A(agt.MOVGP.create(X, liks, agt.SqExponentialKernel(lengthscale=LS), agt.AnalyticVI(),
                                     n_latent=2, optimiser=None)), ys)
    return model, agt.mo_init_state(model, X, ys_t), ys_t


def rmse(mu, f):
    return float(np.sqrt(np.mean((np.asarray(mu, np.float64) - np.asarray(f, np.float64)) ** 2)))


def cpu_mode(args):
    if args.pallas:
        os.environ["AGP_TPU_PALLAS"] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", args.dtype == "float64")
    import jax.numpy as jnp

    import agp_tpu as agp
    from agp_tpu.inference import analytic_vi as jav
    from agp_tpu.models import multioutput as jmo

    torch.set_num_threads(4)
    agt.config.set_default_device("cpu")
    tdt, ndt = getattr(torch, args.dtype), getattr(np, args.dtype)
    X, f, ys = data(tdt, args.perm)
    mt, st, yt = port_model(X, ys)
    Xj = jnp.asarray(X.numpy())
    mj = agp.MOVGP.create(Xj, [agp.GaussianLikelihood.create(0.1), agp.LogisticLikelihood.create()],
                          agp.SqExponentialKernel(lengthscale=LS), agp.AnalyticVI(), n_latent=2, optimiser=None)
    mj = mj.replace(A=jnp.asarray(mt.A.double().numpy().astype(ndt)))
    treated = [lik.treat_labels(jnp.asarray(y.numpy())) for lik, y in zip(mj.likelihoods, ys)]
    mj = mj.replace(likelihoods=tuple(lik for _, lik in treated))
    yj = tuple(jnp.asarray(y, ndt) for y, _ in treated)
    sj = jmo.mo_init_state(mj, Xj, yj)
    if args.pallas:
        from jax.experimental.pallas import tpu as pltpu

        assert jav._pallas_kind_batched(mj) == "rbf"
        ctx = pltpu.force_tpu_interpret_mode()
    else:
        ctx = contextlib.nullcontext()
    f256, t0, parted = f[:256].double().numpy(), time.time(), None
    with ctx:
        for i in range(1, args.iters + 1):
            mj, sj = jmo._mo_step(mj, sj, Xj, yj)
            if not args.pallas:
                mt, st = cs.mo_steps(mt, st, X, yt, 1)
                mu_j, mu_t = np.asarray(sj.mu, np.float64), st.mu.double().numpy()
                d = float(np.abs(mu_j - mu_t).max() / np.abs(mu_j).max())
                parted = i if parted is None and d > 1e-2 else parted
            if i in CHECK:
                line = f"{args.dtype} iter {i}: reference RMSE {rmse(jmo.mo_predict_f(mj, sj, Xj[:256])[0][0], f256):.6g}"
                if not args.pallas:
                    line += (f", port RMSE {rmse(agt.mo_predict_f(mt, st, X[:256])[0][0].double(), f256):.6g}; "
                             f"port vs reference max|dmu|/max|mu| {d:.3e}")
                print(f"{line} ({time.time() - t0:.0f} s)", flush=True)
    if not args.pallas:
        print(f"first iteration where mu parts by more than 1e-2: {parted}")


def card_runs(steps=ITERS):
    """The card's float32 run four ways and the CPU's float32 run, against
    the CPU's float64 run: RMSE after ``steps`` and the distance of mu
    after each of the first 6."""
    from agp_tpu_torch import kernels
    from agp_tpu_torch.ops import cuda_kernels as ck

    Xc, fc, ysc = data(torch.float64)

    def run(dev, dtype, steps, kmat=None, plain=False):
        X = Xc.to(dev, dtype)
        model, state, ys_t = port_model(X, tuple(y.to(dev, dtype) for y in ysc))
        if kmat is not None:
            state = state.replace(kmat={k: v.to(dev) for k, v in kmat.items()})
        mus = []
        with cs.plain_kernels(ck, cs.SPLIT_PAIRS) if plain else contextlib.nullcontext():
            for i in range(steps):
                model, state = cs.mo_steps(model, state, X, ys_t, 1)
                if i < 6:
                    mus.append(state.mu.double().cpu())
            err = cs.cols_movgp_error(agt, model, state, X, fc.to(dev, dtype))
        return mus, err

    def direct(X, Z):
        return ((X[:, None, :] - Z[None, :, :]) ** 2).sum(-1)

    ref = run("cpu", torch.float64, 6)[0]
    k_cpu = port_model(Xc.float(), tuple(y.float() for y in ysc))[1].kmat
    k_card = port_model(Xc.cuda().float(), tuple(y.cuda().float() for y in ysc))[1].kmat
    sq_dist = kernels.sq_dist
    cases = (("card, kernels", "cuda", {}), ("card, plain versions", "cuda", {"plain": True}),
             ("card, the CPU's kmat", "cuda", {"kmat": k_cpu}), ("card, Kmm by direct differences", "cuda", "direct"),
             ("card float64", "cuda", {"dtype": torch.float64}),
             ("CPU", "cpu", {}), ("CPU, the card's kmat", "cpu", {"kmat": k_card}))
    for name, dev, kw in cases:
        if kw == "direct":
            kernels.sq_dist, kw = direct, {}
        dtype = kw.pop("dtype", torch.float32)
        try:
            mus, err = run(dev, dtype, steps, **kw)
        finally:
            kernels.sq_dist = sq_dist
        print(f"{name}: RMSE after {steps} steps {err:.4g}; |mu - mu64| / max|mu64| after steps 1-6 "
              + " ".join(f"{float((m - r).abs().max() / r.abs().max()):.2e}" for m, r in zip(mus, ref)), flush=True)


def stages(dev):
    """Step 1 in float32 on ``dev``, each stage against float64 from its own
    float32 inputs, plain versions in the kernels' place."""
    from agp_tpu_torch.inference import analytic_vi
    from agp_tpu_torch.models import multioutput as mo
    from agp_tpu_torch.ops import cuda_kernels as ck
    from agp_tpu_torch.ops import linalg

    Xc, _, ysc = data(torch.float64)
    X = Xc.to(dev, torch.float32)
    model, state, ys_t = port_model(X, tuple(y.to(dev, torch.float32) for y in ysc))
    km, out = state.kmat, {}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    with torch.no_grad():
        K = analytic_vi.batch_gram_zz(model.kernel, model.Z).double()
        L64 = torch.linalg.cholesky(K + 1e-3 * torch.eye(N, dtype=torch.float64, device=dev))
        out["L_K"], out["K_inv"] = rel(km["L_K"], L64), rel(km["K_inv"], torch.cholesky_inverse(L64))
        ls = model.kernel.lengthscale.reshape(-1, 1) * torch.ones_like(model.Z[:, 0, :])
        args = (X, model.Z, km["L_inv"].mT.contiguous(), ls, model.kernel.variance.reshape(-1), state.mu,
                state.Sigma, 1e-3)
        kappa, _, vf = ck.fused_kappa_moments_batched_reference(*args)
        k64, _, vf64 = ck.fused_kappa_moments_batched_reference(*(a.double() if torch.is_tensor(a) else a
                                                                  for a in args))
        out["kappa"], out["vf"] = rel(kappa, k64), rel(vf, vf64)
        with cs.plain_kernels(ck, cs.SPLIT_PAIRS):
            mu_q, var_q, _ = analytic_vi.latent_moments(model, state, X, km)
        mu_f, var_f = mo.mo_mean_var_f(model, mu_q, var_q)
        liks, local = mo.mo_local_updates(model, ys_t, mu_f, var_f, state.local_vars)
        gmu_r, gs_r = mo.mo_grad_rows(model.replace(likelihoods=liks), ys_t, local)
        g1, g2 = mo.mo_grad_latents(model, gmu_r, gs_r, mu_q)
        s1, stat2 = ck.cavi_stats_batched_reference(kappa, g1.contiguous(), g2.contiguous())
        s1_64, st2_64 = ck.cavi_stats_batched_reference(kappa.double(), g1.double(), g2.double())
        out["s1"], out["stat2"] = rel(s1, s1_64), rel(stat2, st2_64)
        eta2 = linalg.symmetrize(-(stat2 + 0.5 * km["K_inv"]))
        eta2_64 = linalg.symmetrize(-(stat2.double() + 0.5 * km["K_inv"].double()))
        mu, _ = linalg.nat_to_moments(s1, eta2)
        out["mu"] = rel(mu, linalg.nat_to_moments(s1.double(), eta2_64)[0])
        out["smallest eigenvalue of -eta2"] = float(torch.linalg.eigvalsh(-eta2_64)[:, 0].min())
    return out


def card_mode(_args):
    card_runs()
    cpu, card = stages("cpu"), stages("cuda")
    for k in cpu:
        print(f"step 1, {k}: CPU {cpu[k]:.3e}, card {card[k]:.3e}")


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mode", choices=("cpu", "card"))
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--pallas", action="store_true")
    ap.add_argument("--perm", type=int, default=None)
    ap.add_argument("--iters", type=int, default=ITERS)
    args = ap.parse_args()
    (cpu_mode if args.mode == "cpu" else card_mode)(args)


if __name__ == "__main__":
    main()
