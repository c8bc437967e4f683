"""HMC and NUTS sampling of the latent GP values: the counterpart of
``agp_tpu/inference/hmc.py``.

* The log-joint log p(y | f) + log N(f | mu0, K) in the whitened
  parameterization f = mu0 + L_K v (v ~ N(0, I)).  Its gradient is
  ``torch.autograd.grad`` of the sum over the chains, exact because the
  chains are independent.
* ``hmc_chain``: fixed-length leapfrog HMC.  ``nuts_chain``: bounded-depth
  iterative multinomial NUTS, with the generalized no-U-turn criterion on
  the momentum sums at every merge, a [max_depth + 1]-slot merge stack,
  multinomial proposals within a subtree and biased progressive sampling
  across doublings.  Both adapt the step size by dual averaging during
  burn-in.

Every chain is a leading tensor axis ([C, L, N]).  The reference's
``while_loop``s, vmapped over chains, become masked loops over [C]: a
finished chain keeps its state.  The leaves of a subtree run without a
host read (a chain that stopped is frozen by a mask); "every chain done"
is read once per tree doubling, at most ``max_depth`` host reads a step.
"""
from __future__ import annotations

import math

import torch

from ..means import batch_call
from ..utils.tensors import host_read


def _latents(L_K, mu0, v):
    """f = mu0 + L_K v for v [..., L, N]: one product per latent over all
    the leading axes (one GEMM reads L_K once)."""
    return mu0 + torch.einsum("lmn,...ln->...lm", L_K, v)


def make_log_lik(model, L_K, mu0):
    """v -> log p(y | mu0 + L_K v) for whitened latents v [..., L, N]
    (leading axes: chains or particles), returning [...]."""
    lik, y = model.likelihood, model.train_y

    def log_lik(v):
        f = _latents(L_K, mu0, v)
        if lik.n_latent == 1:
            return torch.sum(lik.log_prob(y, f[..., 0, :]), dim=-1)
        # the latent axis first, as the likelihood's log_prob takes it
        fl = f.movedim(-2, 0)
        yT = y.T if y.ndim == 2 else y
        if yT.ndim == 2:  # one-hot [K, N] against [K, ..., N]
            yT = yT.reshape((yT.shape[0],) + (1,) * (fl.ndim - 2) + (yT.shape[1],))
        return torch.sum(lik.log_prob(yT, fl), dim=-1)

    return log_lik


def make_log_joint(model, L_K, mu0):
    """The whitened log-joint v -> log p(y | mu0 + L_K v) - |v|^2 / 2, for
    v [..., L, N], returning [...]."""
    log_lik = make_log_lik(model, L_K, mu0)

    def log_joint(v):
        return log_lik(v) - 0.5 * torch.sum(v**2, dim=(-2, -1))

    return log_joint


def value_and_grad(log_joint):
    """v -> (log_joint(v), its gradient in v), both detached: the gradient
    of the sum over the leading axes, which is each chain's own."""

    def vg(v):
        with torch.enable_grad():
            v = v.detach().requires_grad_(True)
            lp = log_joint(v)
            (g,) = torch.autograd.grad(lp.sum(), v)
        return lp.detach(), g

    return vg


def _per_chain(x, v):
    """A number, or a [C] tensor shaped to broadcast against v [C, L, N]."""
    return x.reshape(x.shape + (1,) * (v.ndim - x.ndim)) if isinstance(x, torch.Tensor) and x.ndim else x


def leapfrog(vg, v, p, grad, eps, n_steps: int):
    """``n_steps`` leapfrog steps of size eps (a number, or [C] for chains
    [C, L, N]) from (v, p) with grad = d log_joint / dv at v.  Returns
    (v, p, grad)."""
    eps = _per_chain(eps, v)
    for _ in range(n_steps):
        p = p + 0.5 * eps * grad
        v = v + eps * p
        _, grad = vg(v)
        p = p + 0.5 * eps * grad
    return v, p, grad


class _DualAveraging:
    """Nesterov / Hoffman-Gelman dual averaging of log eps toward
    ``target_accept``, per chain ([C]), as the reference's chains take it;
    the step is exp(log eps) during burn-in and exp(log eps_bar) after."""

    gamma, t0, kappa = 0.05, 10.0, 0.75

    def __init__(self, step_size: float, C: int, dtype, device, target_accept: float):
        self.mu = math.log(10.0 * step_size)
        self.target = target_accept
        self.step = torch.full((C,), step_size, dtype=dtype, device=device)
        self.log_eps_bar = torch.log(self.step)
        self.h_bar = torch.zeros((C,), dtype=dtype, device=device)
        self.t = 0.0

    def update(self, accept_stat, is_burn: bool):
        if is_burn:
            self.t += 1.0
            t = self.t
            self.h_bar = (1.0 - 1.0 / (t + self.t0)) * self.h_bar + (self.target - accept_stat) / (t + self.t0)
            log_eps = self.mu - math.sqrt(max(t, 1.0)) / self.gamma * self.h_bar
            eta = max(t, 1.0) ** (-self.kappa)
            self.log_eps_bar = eta * log_eps + (1.0 - eta) * self.log_eps_bar
            self.step = torch.exp(log_eps)
        else:
            self.step = torch.exp(self.log_eps_bar)


def hmc_chain(model, L_K, mu0, generator, n_samples: int, n_burnin: int, step_size: float = 0.1,
              n_leapfrog: int = 16, target_accept: float = 0.8, n_chains: int = 1):
    """``n_chains`` HMC chains from v = 0; returns f [n_samples, C, L, N]."""
    log_joint = make_log_joint(model, L_K, mu0)
    vg = value_and_grad(log_joint)
    L, N = mu0.shape
    kw = dict(dtype=mu0.dtype, device=mu0.device)
    v = torch.zeros((n_chains, L, N), **kw)
    logp, grad = vg(v)
    da = _DualAveraging(step_size, n_chains, mu0.dtype, mu0.device, target_accept)
    out = torch.empty((n_samples, n_chains, L, N), **kw)
    for i in range(n_burnin + n_samples):
        p0 = torch.randn(v.shape, generator=generator, **kw)
        u = torch.rand((n_chains,), generator=generator, **kw)
        v1, p1, grad1 = leapfrog(vg, v, p0, grad, da.step, n_leapfrog)
        with torch.no_grad():
            logp1 = log_joint(v1)
        log_accept = logp1 - 0.5 * torch.sum(p1**2, dim=(-2, -1)) - (logp - 0.5 * torch.sum(p0**2, dim=(-2, -1)))
        accept_prob = torch.clamp(torch.exp(log_accept), max=1.0)
        acc = u < accept_prob
        v = torch.where(acc[:, None, None], v1, v)
        logp = torch.where(acc, logp1, logp)
        grad = torch.where(acc[:, None, None], grad1, grad)
        da.update(accept_prob, i < n_burnin)
        if i >= n_burnin:
            out[i - n_burnin] = _latents(L_K, mu0, v)
    return out


# ---------------------------------------------------------------- NUTS
def _is_turning(rho, p_first, p_last):
    """The generalized no-U-turn criterion on the momentum sum, per chain."""
    return (torch.sum(rho * p_first, dim=(-2, -1)) < 0.0) | (torch.sum(rho * p_last, dim=(-2, -1)) < 0.0)


def _select(mask, a, b):
    """where(mask, a, b) over a subtree summary, mask [C]."""
    return {k: torch.where(mask.reshape(mask.shape + (1,) * (a[k].ndim - 1)), a[k], b[k]) for k in a}


def _merge_trees(generator, older, newer):
    """Two time-adjacent subtree summaries (older first in the direction of
    integration) as one: the newer candidate is taken with probability
    w_new / (w_old + w_new)."""
    logw = torch.logaddexp(older["logw"], newer["logw"])
    u = torch.rand(logw.shape, generator=generator, dtype=logw.dtype, device=logw.device)
    take_new = torch.log(u) < newer["logw"] - logw
    rho = older["rho"] + newer["rho"]
    cand = _select(take_new, {k: newer[k] for k in ("prop_v", "prop_logp", "prop_grad")},
                   {k: older[k] for k in ("prop_v", "prop_logp", "prop_grad")})
    return {
        "rho": rho,
        "p_first": older["p_first"],
        "p_last": newer["p_last"],
        "logw": logw,
        **cand,
        "turning": older["turning"] | newer["turning"] | _is_turning(rho, older["p_first"], newer["p_last"]),
        "diverging": older["diverging"] | newer["diverging"],
    }


def _build_subtree(generator, vg, v, p, grad, direction, eps, n_leaves: int, H0, live):
    """A balanced subtree of ``n_leaves`` leapfrog states in ``direction``
    ([C] of +-1) from (v, p, grad), the completed power-of-two blocks
    merged through a stack with a U-turn check at every merge.  Returns
    (summary, end v, end p, end grad, the leaves' summed acceptance, their
    count, stopped [C]).

    A chain stops at a U-turn or a divergence.  The reference's loop ends
    there and its subtree is rejected whole, as is this one's: a stopped
    chain (and a chain with ``live`` false, whose doubling is discarded
    too) runs on through the remaining leaves unmasked (its values may
    blow up after a divergence), its acceptance sums masked by a select,
    and nothing else of its subtree is used.
    The leaf count is the same for every chain, so the merges after leaf i
    (one per trailing one-bit of i) and the stack's height are host
    integers, and no leaf reads the device."""
    step = direction.reshape(direction.shape + (1, 1)) * _per_chain(eps, v)
    half = 0.5 * step
    stop = torch.zeros(live.shape, dtype=torch.bool, device=v.device)
    sum_alpha = torch.zeros(live.shape, dtype=v.dtype, device=v.device)
    n_alpha = torch.zeros_like(sum_alpha)
    stack = []
    for i in range(n_leaves):
        run = live & ~stop
        p = torch.addcmul(p, half, grad)
        v = torch.addcmul(v, step, p)
        logp, grad = vg(v)
        p = torch.addcmul(p, half, grad)
        delta = logp - 0.5 * torch.sum(p * p, dim=(-2, -1)) - H0
        sum_alpha = sum_alpha + torch.where(run, torch.exp(torch.clamp(delta, max=0.0)), 0.0)  # NaN-safe
        n_alpha = n_alpha + run
        summ = {"rho": p, "p_first": p, "p_last": p, "logw": delta, "prop_v": v, "prop_logp": logp,
                "prop_grad": grad, "turning": torch.zeros_like(stop), "diverging": delta < -1000.0}
        j = i
        while j & 1:  # merge completed blocks: once per trailing one-bit of i
            summ = _merge_trees(generator, stack.pop(), summ)
            j >>= 1
        stack.append(summ)
        stop = stop | (run & (summ["turning"] | summ["diverging"]))
    return stack[0], v, p, grad, sum_alpha, n_alpha, stop


def nuts_step(generator, vg, v0, logp0, grad0, eps, max_depth: int = 8):
    """One iterative multinomial-NUTS transition of every chain
    (v0 [C, L, N], logp0 [C], eps a number or [C]).  Returns (v, logp,
    grad, accept_stat), accept_stat [C] the mean Metropolis ratio over the
    visited leaves (the dual-averaging statistic)."""
    C = v0.shape[0]
    kw = dict(dtype=v0.dtype, device=v0.device)
    p0 = torch.randn(v0.shape, generator=generator, **kw)
    H0 = logp0 - 0.5 * torch.sum(p0**2, dim=(-2, -1))
    tree = {"rho": p0, "logw": torch.zeros((C,), **kw), "prop_v": v0, "prop_logp": logp0, "prop_grad": grad0}
    vl, pl, gl, vr, pr, gr = v0, p0, grad0, v0, p0, grad0
    done = torch.zeros((C,), dtype=torch.bool, device=v0.device)
    sum_alpha = torch.zeros((C,), **kw)
    n_alpha = torch.zeros((C,), **kw)
    for depth in range(max_depth):
        if host_read(done.all()):  # the one host read of a doubling
            break
        live = ~done
        go_right = torch.rand((C,), generator=generator, **kw) < 0.5
        right3 = go_right[:, None, None]
        direction = torch.where(go_right, 1.0, -1.0).to(v0.dtype)
        sub, v_n, p_n, g_n, sa, na, stopped = _build_subtree(
            generator, vg, torch.where(right3, vr, vl), torch.where(right3, pr, pl), torch.where(right3, gr, gl),
            direction, eps, 1 << depth, H0, live)
        sum_alpha = sum_alpha + torch.where(live, sa, 0.0)
        n_alpha = n_alpha + torch.where(live, na, 0.0)
        # a subtree that stopped is rejected whole (the reference marks it
        # turning); a finished chain changes nothing
        bad = stopped | sub["turning"] | sub["diverging"]
        keep = bad | done
        u = torch.rand((C,), generator=generator, **kw)
        take = (~bad) & (torch.log(u) < sub["logw"] - tree["logw"])
        new_tree = {
            "rho": tree["rho"] + sub["rho"],
            "logw": torch.logaddexp(tree["logw"], sub["logw"]),
            **_select(take, {k: sub[k] for k in ("prop_v", "prop_logp", "prop_grad")},
                      {k: tree[k] for k in ("prop_v", "prop_logp", "prop_grad")}),
        }
        tree = _select(keep, tree, new_tree)
        left_ext = (~keep & ~go_right)[:, None, None]
        right_ext = (~keep & go_right)[:, None, None]
        vl, pl, gl = torch.where(left_ext, v_n, vl), torch.where(left_ext, p_n, pl), torch.where(left_ext, g_n, gl)
        vr, pr, gr = torch.where(right_ext, v_n, vr), torch.where(right_ext, p_n, pr), torch.where(right_ext, g_n, gr)
        # the whole trajectory's generalized U-turn (the momenta at its ends)
        done = done | bad | _is_turning(tree["rho"], pl, pr)
    accept_stat = sum_alpha / torch.clamp(n_alpha, min=1.0)
    return tree["prop_v"], tree["prop_logp"], tree["prop_grad"], accept_stat


def nuts_chain(model, L_K, mu0, generator, n_samples: int, n_burnin: int, step_size: float = 0.1,
               max_depth: int = 8, target_accept: float = 0.8, n_chains: int = 1):
    """``n_chains`` NUTS chains on the whitened latents from v = 0, with
    ``hmc_chain``'s dual averaging; returns f [n_samples, C, L, N]."""
    vg = value_and_grad(make_log_joint(model, L_K, mu0))
    L, N = mu0.shape
    kw = dict(dtype=mu0.dtype, device=mu0.device)
    v = torch.zeros((n_chains, L, N), **kw)
    logp, grad = vg(v)
    da = _DualAveraging(step_size, n_chains, mu0.dtype, mu0.device, target_accept)
    out = torch.empty((n_samples, n_chains, L, N), **kw)
    for i in range(n_burnin + n_samples):
        v, logp, grad, accept_stat = nuts_step(generator, vg, v, logp, grad, da.step, max_depth)
        da.update(accept_stat, i < n_burnin)
        if i >= n_burnin:
            out[i - n_burnin] = _latents(L_K, mu0, v)
    return out


def _setup(model, generator):
    from ..models.mcgp import _default_generator, prior_chol

    return prior_chol(model), batch_call(model.mean, model.train_x, model.n_latent), _default_generator(model, generator)


def sample_nuts(model, n_samples: int, generator=None, n_chains: int = 1, max_depth: int = 8):
    """NUTS samples of an MCGP-style dense model's latents: [n_chains,
    n_samples, L, N], the chain axis squeezed when n_chains is 1;
    ``generator`` on the model's device (seed 0 when None)."""
    L_K, mu0, generator = _setup(model, generator)
    inf = model.inference
    fs = nuts_chain(model, L_K, mu0, generator, n_samples, inf.n_burnin, step_size=getattr(inf, "step_size", 0.1),
                    max_depth=max_depth, n_chains=n_chains)
    return fs[:, 0] if n_chains == 1 else fs.movedim(1, 0)


def sample_hmc(model, n_samples: int, generator=None, n_chains: int = 1):
    """HMC samples, as :func:`sample_nuts` returns them."""
    L_K, mu0, generator = _setup(model, generator)
    inf = model.inference
    fs = hmc_chain(model, L_K, mu0, generator, n_samples, inf.n_burnin, step_size=getattr(inf, "step_size", 0.1),
                   n_leapfrog=getattr(inf, "n_leapfrog", 16), n_chains=n_chains)
    return fs[:, 0] if n_chains == 1 else fs.movedim(1, 0)
