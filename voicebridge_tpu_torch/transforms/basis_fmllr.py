"""Basis fMLLR: low-dimensional speaker adaptation for sparse data.

Counterpart of the reference's ``transform/basis-fmllr-diag-gmm.{h,cc}``
(Povey & Yao, "A basis representation of constrained MLLR transforms for
robust adaptation"): the speaker transform is expanded as

    W_s = W0 + sum_k c_sk * B_k,          W0 = [I, 0]

where the bases B_k are the principal components of per-speaker
(preconditioned, count-normalized) auxiliary-function gradients over the
training corpus, and the number of coefficients grows with the speaker's
frame count (``size_scale * beta``) — so a 2-second speaker gets a few
robust coefficients instead of an over-fit full D*(D+1) transform.

All statistics are the same (beta, K, G) sufficient statistics as full fMLLR
(``transforms/fmllr.py``), accumulated on device; basis training and
coefficient estimation are tiny host solves.

Preconditioning note: the exact method preconditions gradients by the inverse
Cholesky factor of the full Hessian (which couples rows through the log-det
term); here we use the row-block Hessian (the G part, which dominates for
beta >> D), a documented approximation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _grad(beta: float, k: np.ndarray, g: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Gradient of the fMLLR auxiliary function at W ([D, D+1]):
    beta*[A^{-T}, 0] + K - rows(w_d G_d)."""
    d = w.shape[0]
    a_invt = np.linalg.inv(w[:, :d]).T
    gr = k - np.einsum("de,def->df", w, g)
    gr[:, :d] += beta * a_invt
    return gr


def _objf(beta: float, k: np.ndarray, g: np.ndarray, w: np.ndarray) -> float:
    d = w.shape[0]
    sign, logdet = np.linalg.slogdet(w[:, :d])
    if sign <= 0:
        return -np.inf
    quad = np.einsum("de,de->", w, k) - 0.5 * np.einsum(
        "de,def,df->", w, g, w)
    return float(beta * logdet + quad)


@dataclass
class FmllrBasis:
    """Trained basis: bases [N, D, D+1] (orthonormal in the preconditioned
    space), row preconditioner chol factors L [D, D+1, D+1]."""

    bases: np.ndarray
    precond: np.ndarray

    @property
    def dim(self) -> int:
        return self.bases.shape[1]

    @property
    def size(self) -> int:
        return self.bases.shape[0]

    def save(self, path) -> None:
        np.savez_compressed(path, bases=self.bases, precond=self.precond)

    @classmethod
    def load(cls, path) -> "FmllrBasis":
        z = np.load(path)
        return cls(bases=z["bases"], precond=z["precond"])


def train_fmllr_basis(betas: np.ndarray, ks: np.ndarray, gs: np.ndarray,
                      num_bases: int | None = None,
                      min_count: float = 10.0) -> FmllrBasis:
    """Estimate the basis from per-training-speaker fMLLR statistics
    (BasisFmllrAccus::AccuGradientScatter + BasisFmllrEstimate role).

    betas [S], ks [S, D, D+1], gs [S, D, D+1, D+1].
    """
    s_num, d = ks.shape[0], ks.shape[1]
    w0 = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    beta_tot = float(betas.sum())

    # row-block Hessian from the corpus-average G, Cholesky preconditioner
    gbar = gs.sum(axis=0) / max(beta_tot, 1e-10)  # [D, D+1, D+1]
    eye = np.eye(d + 1)
    prec = np.zeros_like(gbar)
    for i in range(d):
        h = gbar[i] + 1e-4 * np.trace(gbar[i]) / (d + 1) * eye + 1e-8 * eye
        prec[i] = np.linalg.cholesky(h)

    # scatter of preconditioned, count-normalized gradients
    scatter = np.zeros((d * (d + 1), d * (d + 1)))
    for s in range(s_num):
        if betas[s] < min_count:
            continue
        gr = _grad(float(betas[s]), ks[s], gs[s], w0) / np.sqrt(betas[s])
        # precondition per row: solve L^T x = grad_row
        pg = np.stack([
            np.linalg.solve(prec[i].T, gr[i]) for i in range(d)])
        v = pg.reshape(-1)
        scatter += np.outer(v, v)

    evals, evecs = np.linalg.eigh(scatter)
    order = np.argsort(evals)[::-1]
    n = num_bases or min(d * (d + 1), s_num * 4)
    n = min(n, d * (d + 1))
    bases = np.zeros((n, d, d + 1))
    for j in range(n):
        pb = evecs[:, order[j]].reshape(d, d + 1)
        # undo preconditioning: basis lives in W space, B = L^{-T} pb rows
        for i in range(d):
            bases[j, i] = np.linalg.solve(prec[i], pb[i])
        # normalize in W space
        bases[j] /= max(np.linalg.norm(bases[j]), 1e-10)
    return FmllrBasis(bases=bases.astype(np.float64), precond=prec)


def estimate_fmllr_basis(basis: FmllrBasis, beta: float, k: np.ndarray,
                         g: np.ndarray, size_scale: float = 0.2,
                         num_iters: int = 10, min_count: float = 50.0):
    """Per-speaker coefficient estimation (BasisFmllrEstimate::ComputeTransform):
    diagonal-Newton steps on the coefficients with backtracking line search.
    The coefficient count adapts to the data: n = min(size, size_scale*beta).

    Returns (W [D, D+1], objf improvement per frame, n_used).
    """
    d = basis.dim
    w0 = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    if beta < min_count:
        return w0.astype(np.float32), 0.0, 0
    n = int(min(basis.size, max(1.0, size_scale * beta)))
    bas = basis.bases[:n].astype(np.float64)
    k = k.astype(np.float64)
    g = g.astype(np.float64)
    # per-basis row-quadratic curvature: h_j = sum_d B_j[d] G[d] B_j[d]^T
    curv = np.maximum(
        np.einsum("jde,def,jdf->j", bas, g, bas), 1e-8)
    c = np.zeros(n)
    w = w0.copy()
    f0 = _objf(beta, k, g, w)
    f = f0
    for _ in range(num_iters):
        gr = _grad(beta, k, g, w)
        gc = np.einsum("jde,de->j", bas, gr)
        step = gc / curv
        scale = 1.0
        improved = False
        for _ls in range(12):
            c_try = c + scale * step
            w_try = w0 + np.einsum("j,jde->de", c_try, bas)
            f_try = _objf(beta, k, g, w_try)
            if f_try > f:
                c, w, f = c_try, w_try, f_try
                improved = True
                break
            scale *= 0.5
        if not improved:
            break
    return w.astype(np.float32), (f - f0) / max(beta, 1.0), n
