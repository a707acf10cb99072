"""Full-covariance GMM.

Port of ``voicebridge_tpu/models/full_gmm.py``, the counterpart of Kaldi
``FullGmm`` (``gmm/full-gmm.h:40``) and its MLE re-estimation
(``gmm/mle-full-gmm.h``): UBM-style modeling and the target of diag->full
conversions.  The host half (``FullGmm``: conversions, gconsts, M-step,
save/load in the npz either package reads) is a numpy copy of the JAX
package's.

Layout: dense padded arrays over [P pdfs, M mixtures]:

    weights    [P, M]        (0 marks inactive padding)
    means      [P, M, D]
    inv_covars [P, M, D, D]  (symmetric precision matrices)
    gconsts    [P, M]        log w + 0.5 log|inv_cov| - D/2 log(2pi)
                             - 0.5 mu^T inv_cov mu   (full-gmm.cc gconst)

Log-likelihood per frame/component:

    gconst + x^T (inv_cov mu) - 0.5 x^T inv_cov x

The device half (``pack_full_gmm``, ``loglikes_full``, ``acc_full_stats``)
is IEEE-fp32 torch over frame chunks sized from the device's free memory:
the linear term one product ``[n, D] x [D, P*M]``, the quadratic form
``((x @ IC) * x).sum(-1)`` with ``IC [D, P*M*D]``, and the second moments
one ``[M*D, n] x [n, D]`` product per pdf's frames; never the JAX einsums'
``[N, P*M, D]`` intermediates.  These are XLA functions in the JAX package,
with no hand kernel.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from ..device import free_bytes, ieee_fp32_entry

M_LOG_2PI = math.log(2.0 * math.pi)


class FullGmm:
    def __init__(self, weights: np.ndarray, means: np.ndarray,
                 inv_covars: np.ndarray):
        self.weights = np.asarray(weights, np.float64)  # [P, M]
        self.means = np.asarray(means, np.float64)  # [P, M, D]
        self.inv_covars = np.asarray(inv_covars, np.float64)  # [P, M, D, D]
        self.gconsts = self.compute_gconsts()

    @property
    def num_pdfs(self) -> int:
        return self.weights.shape[0]

    @property
    def max_mix(self) -> int:
        return self.weights.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[2]

    @classmethod
    def from_diag(cls, am) -> "FullGmm":
        """Diag -> full conversion (``FullGmm::CopyFromDiagGmm``)."""
        p, m, d = am.inv_vars.shape
        ic = np.zeros((p, m, d, d))
        idx = np.arange(d)
        ic[:, :, idx, idx] = am.inv_vars
        return cls(am.weights, am.means(), ic)

    def to_diag(self):
        """Full -> diag (``DiagGmm::CopyFromFullGmm``): keep the covariance
        diagonal (inverse of the covariance's diagonal, not the precision's)."""
        from .gmm import AmDiagGmm

        p, m, d = self.means.shape
        var = np.empty((p, m, d))
        for i in range(p):
            for j in range(m):
                if self.weights[i, j] > 0:
                    var[i, j] = np.diag(np.linalg.inv(self.inv_covars[i, j]))
                else:
                    var[i, j] = 1.0
        iv = 1.0 / np.maximum(var, 1e-10)
        return AmDiagGmm((self.means * iv).astype(np.float32),
                         iv.astype(np.float32),
                         self.weights.astype(np.float32))

    def compute_gconsts(self) -> np.ndarray:
        p, m, d = self.means.shape
        g = np.full((p, m), -np.inf)
        for i in range(p):
            for j in range(m):
                w = self.weights[i, j]
                if w <= 0:
                    continue
                sign, logdet = np.linalg.slogdet(self.inv_covars[i, j])
                if sign <= 0:
                    raise ValueError(f"non-PD precision at pdf {i} mix {j}")
                mu = self.means[i, j]
                g[i, j] = (math.log(w) + 0.5 * logdet - 0.5 * d * M_LOG_2PI
                           - 0.5 * mu @ self.inv_covars[i, j] @ mu)
        return g

    def loglike(self, pdf: int, x: np.ndarray) -> float:
        """Naive single-frame loglik (test oracle)."""
        vals = []
        for j in range(self.max_mix):
            if self.weights[pdf, j] <= 0:
                continue
            ic = self.inv_covars[pdf, j]
            vals.append(self.gconsts[pdf, j] + x @ ic @ self.means[pdf, j]
                        - 0.5 * x @ ic @ x)
        vals = np.asarray(vals)
        mx = vals.max()
        return float(mx + np.log(np.exp(vals - mx).sum()))

    def save(self, path: str | Path) -> None:
        np.savez_compressed(path, weights=self.weights, means=self.means,
                            inv_covars=self.inv_covars)

    @classmethod
    def load(cls, path: str | Path) -> "FullGmm":
        z = np.load(path)
        return cls(z["weights"], z["means"], z["inv_covars"])

    # -- EM -------------------------------------------------------------------
    def mle_update(self, occ: np.ndarray, x_acc: np.ndarray, xx_acc: np.ndarray,
                   min_occ: float = 10.0, cov_floor: float = 1e-3) -> dict:
        """M-step from full-covariance sufficient statistics
        (``MleFullGmmUpdate``): occ [P, M], x_acc [P, M, D],
        xx_acc [P, M, D, D] (sum of x x^T).  Components below ``min_occ``
        keep their parameters.  Covariances floored by adding
        ``cov_floor * avg_var * I``."""
        p, m, d = self.means.shape
        updated = 0
        for i in range(p):
            tot = occ[i].sum()
            if tot <= 0:
                continue
            for j in range(m):
                if self.weights[i, j] <= 0 or occ[i, j] < min_occ:
                    continue
                mu = x_acc[i, j] / occ[i, j]
                cov = xx_acc[i, j] / occ[i, j] - np.outer(mu, mu)
                floor = cov_floor * max(np.trace(cov) / d, 1e-6)
                cov = cov + floor * np.eye(d)
                self.means[i, j] = mu
                self.inv_covars[i, j] = np.linalg.inv(cov)
                self.weights[i, j] = occ[i, j] / tot
                updated += 1
        # renormalize weights over active comps
        wsum = self.weights.sum(axis=1, keepdims=True)
        self.weights = np.where(wsum > 0, self.weights / np.maximum(wsum, 1e-10),
                                self.weights)
        self.gconsts = self.compute_gconsts()
        return {"updated": updated}


# ---------------------------------------------------------------------------
# Device functions
# ---------------------------------------------------------------------------


def pack_full_gmm(gmm: FullGmm, device) -> dict:
    """fp32 tensors on ``device`` for :func:`loglikes_full` /
    :func:`acc_full_stats`: ``gconsts [P, M]`` (-inf on inactive
    components), ``ic [P, M, D, D]`` and ``ic_mu [P, M, D]``."""
    ic_mu = np.einsum("pmde,pme->pmd", gmm.inv_covars, gmm.means)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    return dict(gconsts=dev(gmm.gconsts), ic=dev(gmm.inv_covars), ic_mu=dev(ic_mu))


def _chunk_rows(device: torch.device, cols: int) -> int:
    """Frames per chunk: ``cols`` floats of intermediates a frame, three
    times over, in a quarter of the memory free on ``device``."""
    return max(256, free_bytes(device) // (4 * 3 * 4 * cols))


def _component_scores(x: torch.Tensor, gconsts, ic_mu, ic) -> torch.Tensor:
    """``x [n, D]`` against G Gaussians (``gconsts [G]``, ``ic_mu [G, D]``,
    ``ic [G, D, D]``) -> ``[n, G]``: ``gconst + x.ic_mu - 0.5 x^T ic x``."""
    n, d = x.shape
    g = gconsts.shape[0]
    ic_flat = ic.permute(1, 0, 2).reshape(d, g * d)  # [D, G*D]: ic[g, d, e] at (d, g*D + e)
    quad = ((x @ ic_flat).view(n, g, d) * x[:, None, :]).sum(-1)
    return gconsts[None] + x @ ic_mu.T - 0.5 * quad


@ieee_fp32_entry
def loglikes_full(packed: dict, x: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
    """``x [N, D]`` (on the parameters' device) -> per-pdf loglikes
    ``[N, P]``, over frame chunks (``chunk`` frames; default: what a quarter
    of the device's free memory holds)."""
    gc, ic, ic_mu = packed["gconsts"], packed["ic"], packed["ic_mu"]
    p, m, d = ic_mu.shape
    x = torch.as_tensor(x, dtype=gc.dtype).to(gc.device)
    c = chunk or _chunk_rows(gc.device, p * m * d)
    out = x.new_empty((x.shape[0], p))
    for lo in range(0, x.shape[0], c):
        comp = _component_scores(x[lo:lo + c], gc.reshape(-1), ic_mu.reshape(-1, d),
                                 ic.reshape(-1, d, d))
        out[lo:lo + c] = torch.logsumexp(comp.view(-1, p, m), dim=2)
    return out


@ieee_fp32_entry
def acc_full_stats(packed: dict, x, pdf_ids, num_pdfs: int, weights=None,
                   chunk: int | None = None):
    """E-step statistics for hard alignments: component posteriors within
    the aligned pdf, then (occ ``[P, M]``, x_acc ``[P, M, D]``, xx_acc
    ``[P, M, D, D]``), fp32 tensors on the parameters' device.  Frames are
    taken a pdf at a time, in chunks of ``chunk`` (default: from the free
    memory); ``xx_acc`` is one ``[M*D, n] x [n, D]`` product a chunk.  The
    chunks' sums are added in float64."""
    gc, ic, ic_mu = packed["gconsts"], packed["ic"], packed["ic_mu"]
    dev = gc.device
    p, m, d = ic_mu.shape
    x = torch.as_tensor(x, dtype=gc.dtype).to(dev)
    pdf = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    w = None if weights is None else torch.as_tensor(weights, dtype=gc.dtype).to(dev)
    c = chunk or _chunk_rows(dev, m * d)
    order = torch.sort(pdf, stable=True).indices
    counts = torch.bincount(pdf, minlength=num_pdfs).tolist()
    occ = torch.zeros((num_pdfs, m), dtype=torch.float64, device=dev)
    x_acc = torch.zeros((num_pdfs, m, d), dtype=torch.float64, device=dev)
    xx_acc = torch.zeros((num_pdfs, m * d, d), dtype=torch.float64, device=dev)
    start = 0
    for q, cnt in enumerate(counts):
        for lo in range(start, start + cnt, c):
            rows = order[lo:min(lo + c, start + cnt)]
            xs = x[rows]
            gamma = torch.softmax(_component_scores(xs, gc[q], ic_mu[q], ic[q]), dim=1)
            if w is not None:
                gamma = gamma * w[rows][:, None]
            occ[q] += gamma.sum(0)
            x_acc[q] += gamma.T @ xs
            xx_acc[q] += (gamma[:, :, None] * xs[:, None, :]).reshape(-1, m * d).T @ xs
        start += cnt
    return occ.to(gc.dtype), x_acc.to(gc.dtype), xx_acc.view(num_pdfs, m, d, d).to(gc.dtype)
