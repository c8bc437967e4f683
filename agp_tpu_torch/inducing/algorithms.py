"""Inducing-point selection algorithms: the counterpart of
``agp_tpu/inducing/algorithms.py``.

* Offline selection (``inducingpoints``: ``KmeansAlg``, ``RandomSubset``,
  ``UniGrid``, ``OIPS``, ``GreedyVariance``, and the online algorithms'
  first pass) runs once on the host in numpy, with the reference's
  ``RandomState`` seeds, so that it selects the same points; k-means and
  OIPS with a scalar-lengthscale RBF (or no kernel) take the port's C++
  copy (``utils/native.py``) when it builds.  A tensor input gives a tensor
  on its device and in its dtype; a numpy input one placed as
  ``models.base.to_tensor`` places it.
* The online updates, run every streaming batch on one latent's slot
  buffer Z [Mc, D] with its active mask [Mc] (``oips_update_latents`` and
  ``streamkmeans_update_latents`` on every latent's [L, Mc, D] at once),
  work on tensors and read nothing back to the host, so that a captured
  CUDA graph holds them (``training/graphs.py``).  ``unigrid_update`` and
  ``webscale_update`` are vectorized.  The reference runs
  ``oips_update`` and ``streamkmeans_update`` as a scan with one decision
  per point; here each is a walk over the batch's points, a CUDA kernel on
  the card (``ops/cuda_kernels.py::oips_accept``, ``streamkmeans_pass``;
  ``csrc/online_select.cu``) and its plain version
  (``oips_accept_reference``, ``streamkmeans_pass_reference``) on the CPU:
  - OIPS never moves a slot, so each point's correlations with the slots
    active before the batch and with the batch's own points are known
    before the first decision: ``gram(X, Z)`` and ``gram(X, X)`` are made,
    the walk writes the row each slot takes, and the rows go into their
    slots with static shapes (a ``where``);
  - an absorbing StreamKmeans centre moves, so the walk updates Z, the
    mask and the counts in place (on copies of the caller's).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..kernels import SqExponentialKernel
from ..models.base import to_tensor
from ..ops import cuda_kernels
from ..utils import native

def _host(X) -> np.ndarray:
    """X as a host array, in its own dtype."""
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().numpy()
    return np.asarray(X)


def _result(Z: np.ndarray, X) -> torch.Tensor:
    """The selection as a tensor: on X's device and in its dtype when X is
    a tensor, else placed as ``to_tensor`` places an array."""
    if isinstance(X, torch.Tensor):
        return torch.as_tensor(np.asarray(Z), dtype=X.dtype, device=X.device)
    return to_tensor(np.asarray(Z))


def _seed(key) -> int:
    """The reference's seed rule, int(key[-1]); an int is its own seed."""
    return 0 if key is None else int(np.asarray(key).reshape(-1)[-1])


@dataclasses.dataclass(frozen=True)
class KmeansAlg:
    """Lloyd's k-means on the inputs (reference: InducingPoints.KmeansAlg)."""

    k: int
    n_iters: int = 20

    def __call__(self, X, key=None):
        Xh = _host(X)
        seed = _seed(key)
        if native.available():  # OpenMP C++ Lloyd (csrc/host/agp_native.cpp)
            return _result(native.kmeans(Xh, self.k, self.n_iters, seed), X)
        rng = np.random.RandomState(seed)
        idx = rng.choice(Xh.shape[0], size=min(self.k, Xh.shape[0]), replace=False)
        C = Xh[idx].copy()
        for _ in range(self.n_iters):
            d2 = ((Xh[:, None, :] - C[None, :, :]) ** 2).sum(-1)
            assign = d2.argmin(1)
            for j in range(C.shape[0]):
                pts = Xh[assign == j]
                if len(pts):
                    C[j] = pts.mean(0)
        return _result(C, X)


@dataclasses.dataclass(frozen=True)
class RandomSubset:
    k: int

    def __call__(self, X, key=None):
        Xh = _host(X)
        rng = np.random.RandomState(_seed(key))
        idx = rng.choice(Xh.shape[0], size=min(self.k, Xh.shape[0]), replace=False)
        return _result(Xh[idx], X)


@dataclasses.dataclass(frozen=True)
class UniGrid:
    """Uniform grid over the bounding box (reference: UniGrid)."""

    points_per_dim: int

    def __call__(self, X, key=None):
        Xh = _host(X)
        axes = [
            np.linspace(Xh[:, d].min(), Xh[:, d].max(), self.points_per_dim)
            for d in range(Xh.shape[1])
        ]
        mesh = np.meshgrid(*axes, indexing="ij")
        return _result(np.stack([m.ravel() for m in mesh], axis=1), X)


@dataclasses.dataclass(frozen=True)
class OIPS:
    """Online inducing-point selection (Galy-Fajou & Opper): accept a point
    when its largest kernel correlation with the current set is below rho;
    at most ``capacity`` points."""

    rho: float = 0.8
    capacity: int = 128

    def __call__(self, X, key=None, kernel=None):
        """The sequential pass over X (one latent's ``kernel`` or none):
        in C++ when the kernel is a scalar-lengthscale RBF or none and the
        library builds, else in numpy."""
        Xh = _host(X)
        ls, simple = 1.0, kernel is None
        if type(kernel) is SqExponentialKernel:
            arr = np.asarray(kernel.lengthscale.detach().cpu())
            if arr.ndim == 0:
                ls, simple = float(arr), True
        if simple and native.available():
            return _result(native.oips(Xh, self.rho, ls, self.capacity), X)
        kc = None if kernel is None else kernel.to(device="cpu")
        Z = [Xh[0]]
        for x in Xh[1:]:
            if kc is None:
                corr = max(float(np.exp(-0.5 * ((x - z) ** 2).sum())) for z in Z)
            else:
                xt = torch.as_tensor(x)[None, :]
                kz = kc.gram(xt, torch.as_tensor(np.stack(Z)))
                corr = float(torch.max(kz)) / float(kc.diag(xt)[0])
            if corr < self.rho and len(Z) < self.capacity:
                Z.append(x)
        return _result(np.stack(Z), X)


def inducingpoints(alg, X, key=None, kernel=None):
    """Select an initial inducing set (reference: InducingPoints.inducingpoints)."""
    if isinstance(alg, (OIPS, GreedyVariance)):
        return alg(X, key=key, kernel=kernel)
    return alg(X, key=key)


def oips_accept_reference(g_z, g_x, kx, kd, mask, rho: float):
    """Plain PyTorch version of ``ops/cuda_kernels.py::oips_accept``, on
    the host in the inputs' dtype: row_of_slot [L, Mc] (int64, on g_z's
    device), the batch row each slot takes, -1 where none.  Each point's
    correlation g / sqrt(max(kx kd, 1e-30)) is rounded at each operation as
    the kernel rounds it; a NaN one rejects the point (the reference's max
    propagates it)."""
    device = g_z.device
    g_z, g_x, kx, kd, mask = (t.detach().cpu() for t in (g_z, g_x, kx, kd, mask))
    L, B, Mc = g_z.shape
    dt = g_z.dtype
    tiny, rho_t = torch.tensor(1e-30, dtype=dt), torch.tensor(rho, dtype=dt)
    out = torch.full((L, Mc), -1, dtype=torch.int64)
    for l in range(L):
        corr_z = g_z[l] / torch.sqrt(torch.clamp(kx[l][:, None] * kd[l][None, :], min=tiny))
        max_z = torch.where(mask[l][None, :], corr_z, float("-inf")).amax(1)
        free = torch.nonzero(~mask[l]).flatten().tolist()  # inactive slots, first first
        n_active = int(mask[l].sum())
        rows, slots = [], []
        for i in range(B):
            if n_active >= Mc:
                break
            best = max_z[i]
            if not bool(best < rho_t):  # never accepted: correlations only grow
                continue
            if rows:
                corr = g_x[l, i, rows] / torch.sqrt(torch.clamp(kx[l, i] * kd[l, slots], min=tiny))
                best = torch.maximum(best, corr.amax())
            if bool(best < rho_t):
                rows.append(i)
                slots.append(free.pop(0))
                n_active += 1
        out[l, slots] = torch.tensor(rows, dtype=torch.int64)
    return out.to(device)


def _take_rows(Z, mask, X_batch, row_of_slot):
    """Z and the mask with each slot's accepted row written in (row_of_slot
    >= 0), with static shapes."""
    taken = row_of_slot >= 0
    return torch.where(taken[..., None], X_batch[torch.clamp(row_of_slot, min=0)], Z), mask | taken


def oips_update_latents(kernels, Z, mask, X_batch, rho: float):
    """Streaming OIPS over one batch on every latent's slot buffer Z
    [L, Mc, D] with its active mask [L, Mc] (``kernels`` the latents', one
    each): each point is accepted, in order, into the first inactive slot
    when its largest correlation k(x, z) / sqrt(k(x, x) k(z, z)) with the
    active slots and the points accepted before it is below ``rho`` and a
    slot is free.  The correlations' grams are made for all latents, then
    one walk (``cuda_kernels.oips_accept``) decides."""
    g_z = torch.stack([k.gram(X_batch, Z[l]) for l, k in enumerate(kernels)])
    g_x = torch.stack([k.gram(X_batch, X_batch) for k in kernels])
    kx = torch.stack([k.diag(X_batch) for k in kernels])
    kd = torch.stack([k.diag(Z[l]) for l, k in enumerate(kernels)])  # the slots' prior variances as the batch starts
    rows = cuda_kernels.oips_accept(g_z, g_x, kx, kd, mask.contiguous(), rho)
    return _take_rows(Z, mask, X_batch, rows)


def oips_update(kernel, Z, mask, X_batch, rho: float):
    """``oips_update_latents`` on one latent's buffer Z [Mc, D] and mask
    [Mc]."""
    Z, mask = oips_update_latents([kernel], Z[None], mask[None], X_batch, rho)
    return Z[0], mask[0]


@dataclasses.dataclass(frozen=True)
class UniGridOnline:
    """Streaming uniform grid (reference: InducingPoints.UniGrid used online):
    a regular grid over the running bounding box of the stream, regenerated
    as each batch widens it.  All ``points_per_dim ** D`` slots are active
    from the first batch; only their positions move."""

    points_per_dim: int

    def __call__(self, X, key=None):
        return UniGrid(self.points_per_dim)(X, key=key)


def unigrid_update(Z, mask, X_batch, points_per_dim: int):
    """Widen the per-dimension bounds to cover the batch and regenerate the
    grid in the first points_per_dim**D slots (all active)."""
    D, P = X_batch.shape[1], points_per_dim
    lo = torch.minimum(Z.masked_fill(~mask[:, None], float("inf")).amin(0), X_batch.amin(0))
    hi = torch.maximum(Z.masked_fill(~mask[:, None], float("-inf")).amax(0), X_batch.amax(0))
    # jnp.linspace(0, 1, P): i / (P - 1), exactly
    t = torch.arange(P, dtype=Z.dtype, device=Z.device) / max(P - 1, 1)
    axes = lo[None, :] + t[:, None] * (hi - lo)[None, :]  # [P, D]
    mesh = torch.meshgrid(*[axes[:, d] for d in range(D)], indexing="ij")
    grid = torch.stack([g.reshape(-1) for g in mesh], dim=1)  # [P**D, D]
    k0 = grid.shape[0]
    Z = torch.cat([grid, Z[k0:]])
    mask = torch.cat([torch.ones(k0, dtype=torch.bool, device=mask.device), mask[k0:]])
    return Z, mask


@dataclasses.dataclass(frozen=True)
class Webscale:
    """Web-scale (minibatch) k-means (Sculley '10; reference:
    InducingPoints.Webscale): k centres, each moved toward the mean of the
    batch points assigned to it at a per-centre rate 1/count."""

    k: int

    def __call__(self, X, key=None):
        Xh = _host(X)
        rng = np.random.RandomState(_seed(key))
        idx = rng.choice(Xh.shape[0], size=min(self.k, Xh.shape[0]), replace=False)
        return _result(Xh[idx], X)


# jnp.float32(1e30): the distance a point takes when no centre is active
_BIG = float(np.float32(1e30))


def webscale_update(Z, mask, counts, X_batch, k=None):
    """Minibatch k-means over the active centres, the batch's updates
    folded into one count-weighted mean; then free slots (up to ``k``
    active, default the buffer's size) take the batch points farthest from
    the active centres, farthest first."""
    Mc, B = Z.shape[0], X_batch.shape[0]
    k = Mc if k is None else k
    d2 = torch.sum((X_batch[:, None, :] - Z[None, :, :]) ** 2, dim=-1)  # [B, Mc]
    d2 = d2.masked_fill(~mask[None, :], float("inf"))
    assign = torch.argmin(d2, dim=1)  # the first of equal minima, as jnp.argmin
    onehot = (assign[:, None] == torch.arange(Mc, device=Z.device)[None, :]).to(Z.dtype)
    nb = onehot.sum(0)  # [Mc]
    bmean = (onehot.T @ X_batch) / torch.clamp(nb, min=1.0)[:, None]
    new_counts = counts + nb
    eta = nb / torch.clamp(new_counts, min=1.0)
    move = (mask & (nb > 0))[:, None]
    Z = torch.where(move, Z + eta[:, None] * (bmean - Z), Z)
    dmin = d2.amin(1)  # [B]
    dmin = torch.where(torch.isfinite(dmin), dmin, _BIG)
    order = torch.argsort(-dmin, stable=True)  # farthest first, ties in batch order
    inact_rank = torch.cumsum((~mask).to(torch.int64), 0) - 1
    free = k - mask.sum()
    newly = (~mask) & (inact_rank < torch.clamp(free, max=B))
    cand = X_batch[order[torch.clamp(inact_rank, 0, B - 1)]]
    Z = torch.where(newly[:, None], cand, Z)
    new_counts = torch.where(newly, torch.ones_like(new_counts), new_counts)
    return Z, mask | newly, new_counts


@dataclasses.dataclass(frozen=True)
class StreamKmeans:
    """Streaming k-means with an opening radius (reference:
    InducingPoints.StreamKmeans): a point opens a new centre when its
    squared distance to the nearest one exceeds ``radius2`` (capacity
    permitting); otherwise that centre absorbs it by a running mean."""

    capacity: int = 128
    radius2: float = 1.0

    def __call__(self, X, key=None):
        Xh = _host(X)
        Z = [Xh[0]]
        counts = [1]
        for x in Xh[1:]:
            d2 = ((np.stack(Z) - x) ** 2).sum(-1)
            j = int(d2.argmin())
            if d2[j] > self.radius2 and len(Z) < self.capacity:
                Z.append(x)
                counts.append(1)
            else:
                counts[j] += 1
                Z[j] = Z[j] + (x - Z[j]) / counts[j]
        return _result(np.stack(Z), X)


def streamkmeans_pass_reference(Z, mask, counts, X_batch, radius2: float, cap: int):
    """Plain PyTorch version of ``ops/cuda_kernels.py::streamkmeans_pass``
    on the host, in place on Z [L, Mc, D], the mask [L, Mc] and the counts
    [L, Mc] (copied there and back when they lie on a device), in the
    inputs' dtype: each squared distance summed over D in order, each
    operation rounded as the kernel rounds it.  Returns (Z, mask,
    counts)."""
    host = [t.detach().cpu() for t in (Z, mask, counts, X_batch)]
    Zh, mh, ch, Xh = host
    D = Zh.shape[-1]
    r2 = torch.tensor(radius2, dtype=Zh.dtype)
    for l in range(Zh.shape[0]):
        z, m, c = Zh[l], mh[l], ch[l]
        for x in Xh:
            diff = z - x
            d2 = diff[:, 0] * diff[:, 0]
            for d in range(1, D):
                d2 = d2 + diff[:, d] * diff[:, d]
            d2 = d2.masked_fill(~m, float("inf"))
            j = int(torch.argmin(d2))  # the first of equal minima
            if bool(d2[j] > r2) and int(m.sum()) < cap:
                slot = int(torch.argmin(m.to(torch.uint8)))  # the first inactive slot
                z[slot], m[slot], c[slot] = x, True, 1.0
            else:
                cj = c[j] + 1.0
                z[j] = z[j] + (x - z[j]) / cj
                c[j] = cj
    if Z.device.type != "cpu":
        for t, h in zip((Z, mask, counts), host):
            t.copy_(h)
        return Z, mask, counts
    return Zh, mh, ch


def streamkmeans_update_latents(Z, mask, counts, X_batch, radius2: float, cap=None):
    """Streaming k-means over one batch on every latent's centres Z
    [L, Mc, D] with their mask and counts [L, Mc], point by point
    (``cuda_kernels.streamkmeans_pass`` on copies of them): ``cap`` bounds
    the active centres (at most the buffer's size, its default).  Returns
    (Z, mask, counts)."""
    cap = Z.shape[1] if cap is None else min(cap, Z.shape[1])
    return cuda_kernels.streamkmeans_pass(Z.clone(memory_format=torch.contiguous_format),
                                          mask.clone(memory_format=torch.contiguous_format),
                                          counts.clone(memory_format=torch.contiguous_format),
                                          X_batch.contiguous(), radius2, cap)


def streamkmeans_update(Z, mask, counts, X_batch, radius2: float, cap=None):
    """``streamkmeans_update_latents`` on one latent's centres Z [Mc, D],
    mask and counts [Mc]."""
    Z, mask, counts = streamkmeans_update_latents(Z[None], mask[None], counts[None], X_batch, radius2, cap)
    return Z[0], mask[0], counts[0]


@dataclasses.dataclass(frozen=True)
class GreedyVariance:
    """Greedy conditional-variance selection (Burt et al. '20): repeatedly
    add the point with the largest posterior variance given the points
    already chosen."""

    k: int

    def __call__(self, X, key=None, kernel=None):
        Xh = _host(X)
        N = Xh.shape[0]
        if kernel is None:
            def kfn(A, B):
                return np.exp(-0.5 * ((A[:, None] - B[None]) ** 2).sum(-1))

            kdiag = np.ones(N)
        else:
            kc = kernel.to(device="cpu")

            def kfn(A, B):
                return kc.gram(torch.as_tensor(A), torch.as_tensor(B)).numpy()

            kdiag = kc.diag(torch.as_tensor(Xh)).numpy()
        k = min(self.k, N)
        chosen = [int(np.argmax(kdiag))]
        V = np.zeros((k, N))  # rows: (K_zx - partial) / sqrt(conditional variance)
        cond_var = kdiag.copy().astype(np.float64)
        for i in range(k - 1):
            z = chosen[-1]
            kzx = kfn(Xh[z:z + 1], Xh)[0]
            resid = kzx - V[:i].T @ V[:i, z]
            V[i] = resid / np.sqrt(max(cond_var[z], 1e-12))
            cond_var = np.maximum(cond_var - V[i] ** 2, 0.0)
            cond_var[chosen] = -np.inf
            chosen.append(int(np.argmax(cond_var)))
        return _result(Xh[chosen], X)
