"""Plain diagonal-GMM arithmetic: per-pdf log-likelihoods, the statistics of
a hard alignment, and the maximum-likelihood update with mixture splitting
(Kaldi's ``gmm-est`` with ``--mix-up``).  Imports nothing of the program.

A model is a dict of float arrays: ``means [P, M, D]``, ``vars [P, M, D]``
and ``weights [P, M]``, a weight of 0 marking an unused slot.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import EXACT, Precision, round_tf32


def gconsts(model: dict) -> np.ndarray:
    """log w - 0.5 (D log 2 pi + sum_d (log var_d + mean_d^2 / var_d)),
    -inf on unused slots (float64)."""
    mean = model["means"].astype(np.float64)
    var = model["vars"].astype(np.float64)
    w = model["weights"].astype(np.float64)
    d = mean.shape[2]
    quad = (np.log(var) + mean * mean / var).sum(axis=2)
    with np.errstate(divide="ignore"):
        gc = np.log(w) - 0.5 * (d * math.log(2.0 * math.pi) + quad)
    return np.where(w > 0, gc, -np.inf)


class Scorer:
    """Per-pdf log-likelihoods of frames, as one product of ``[x, x^2, 1]``
    with every Gaussian's ``[mean/var, -1/(2 var), gconst]``, then a
    log-sum-exp over each pdf's slots."""

    def __init__(self, model: dict, device, prec: Precision = EXACT):
        mean = model["means"].astype(np.float64)
        var = model["vars"].astype(np.float64)
        p, m, d = mean.shape
        self.p, self.m, self.d, self.prec = p, m, d, prec
        gc = np.nan_to_num(gconsts(model), neginf=0.0)[..., None]
        w = np.concatenate([mean / var, -0.5 / var, gc], axis=2)  # [P, M, 2D+1]
        self.w = prec.t(torch.from_numpy(w.reshape(p * m, 2 * d + 1).T.copy())).to(device)
        self.live = torch.from_numpy(model["weights"] > 0).to(device)

    def components(self, x: torch.Tensor) -> torch.Tensor:
        """``[N, D] -> [N, P, M]`` (-inf on unused slots)."""
        x = self.prec.t(x)
        rows = torch.cat([x, x * x, torch.ones_like(x[:, :1])], dim=1)
        out = self.prec.mm(rows, self.w).view(-1, self.p, self.m)
        return torch.where(self.live[None], out, torch.full_like(out, -math.inf))

    def loglikes(self, x: torch.Tensor, block: int = 8192) -> torch.Tensor:
        """``[N, D] -> [N, P]``, in blocks of frames."""
        return torch.cat([torch.logsumexp(self.components(x[i:i + block]), dim=2)
                          for i in range(0, len(x), block)]) if len(x) else \
            torch.zeros((0, self.p), dtype=self.prec.dtype, device=x.device)


def aligned_stats(model: dict, x: torch.Tensor, pdf: torch.Tensor, weight: torch.Tensor,
                  prec: Precision = EXACT, block: int = 1 << 16):
    """Statistics of a hard alignment (``gmm-acc-stats-ali``): each frame's
    posteriors over its pdf's Gaussians, then per Gaussian the occupancy,
    the sum of x and the sum of x^2 (numpy float64 ``[P, M]``, ``[P, M, D]``
    twice), and the total log-likelihood.  Frames of weight 0 are skipped.
    In the control's precision every product takes TF32 operands and every
    sum is float32."""
    mean = model["means"].astype(np.float64)
    var = model["vars"].astype(np.float64)
    p, m, d = mean.shape
    dev = x.device
    w3 = np.concatenate([mean / var, -0.5 / var, np.nan_to_num(gconsts(model), neginf=0.0)[..., None]],
                        axis=2)  # [P, M, 2D+1]
    w3 = prec.t(torch.from_numpy(w3)).to(dev)
    live = torch.from_numpy(model["weights"] > 0).to(dev)
    acc_dtype = prec.dtype
    occ = torch.zeros(p * m, dtype=acc_dtype, device=dev)
    sx = torch.zeros((p * m, d), dtype=acc_dtype, device=dev)
    sxx = torch.zeros((p * m, d), dtype=acc_dtype, device=dev)
    total = torch.zeros((), dtype=acc_dtype, device=dev)
    keep = weight != 0
    x, pdf, weight = x[keep], pdf[keep].long(), weight[keep]
    r = round_tf32 if prec.tf32 else (lambda v: v)
    for i in range(0, len(x), block):
        xb = prec.t(x[i:i + block])
        pb = pdf[i:i + block]
        wb = prec.t(weight[i:i + block])
        rows = torch.cat([xb, xb * xb, torch.ones_like(xb[:, :1])], dim=1)
        ll = torch.einsum("nk,nmk->nm", r(rows), r(w3[pb]))
        ll = torch.where(live[pb], ll, torch.full_like(ll, -math.inf))
        lse = torch.logsumexp(ll, dim=1)
        post = torch.exp(ll - lse[:, None]) * wb[:, None]  # [n, M]
        total += (lse * wb).sum()
        flat = (pb[:, None] * m + torch.arange(m, device=dev)[None]).reshape(-1)
        pf = post.reshape(-1)
        xr = torch.repeat_interleave(xb, m, dim=0)
        occ.index_add_(0, flat, pf)
        sx.index_add_(0, flat, r(pf)[:, None] * r(xr))
        sxx.index_add_(0, flat, r(pf)[:, None] * r(xr * xr))
    return (occ.view(p, m).double().cpu().numpy(), sx.view(p, m, d).double().cpu().numpy(),
            sxx.view(p, m, d).double().cpu().numpy(), float(total))


def mle_update(model: dict, occ: np.ndarray, sx: np.ndarray, sxx: np.ndarray,
               min_occ: float = 10.0, min_var: float = 0.001,
               min_weight: float = 1e-5) -> dict:
    """Kaldi's ``MleDiagGmmUpdate`` for every pdf: Gaussians under
    ``min_occ`` are dropped unless they are their pdf's last; weights are
    occupancy shares, floored at ``min_weight``; means and floored
    variances from the statistics; live Gaussians first in each pdf."""
    occ = occ.astype(np.float64)
    w_old = model["weights"]
    active = w_old > 0
    keep = active & (occ >= min_occ)
    lone = active.any(axis=1) & ~keep.any(axis=1)
    keep[lone, np.argmax(np.where(active, occ, -np.inf), axis=1)[lone]] = True
    w = np.where(keep, occ / np.maximum(occ.sum(axis=1, keepdims=True), 1e-10), 0.0)
    w = np.where(keep, w / np.maximum(w.sum(axis=1, keepdims=True), 1e-10), 0.0)
    w = np.where(keep & (w < min_weight), min_weight, w)
    w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-10)
    n = np.maximum(occ, 1e-10)[..., None]
    mean = sx / n
    var = np.maximum(sxx / n - mean * mean, min_var)
    upd = keep[..., None]
    out = {"means": np.where(upd, mean, model["means"]),
           "vars": np.where(upd, var, model["vars"]),
           "weights": np.where(keep, w, 0.0)}
    order = np.argsort(~(out["weights"] > 0), kind="stable", axis=1)
    return {k: np.take_along_axis(v, order if v.ndim == 2 else order[..., None], axis=1)
            for k, v in out.items()}


def mix_up(model: dict, target: int, occ: np.ndarray, power: float, seed: int,
           min_count: float = 20.0, perturb: float = 0.01) -> dict:
    """Kaldi's ``gmm-mixup``: per-pdf targets in proportion to occupancy to
    ``power`` (at most occupancy / ``min_count``, at least the Gaussians
    there are), the remainder to the largest fractional parts; each split
    halves the heaviest Gaussian and moves the two halves apart by
    ``perturb`` standard deviations along one normal draw (numpy
    ``default_rng(seed)``, float32 draws, pdfs in order)."""
    w = model["weights"].copy()
    cur = (w > 0).sum(axis=1)
    if target <= int(cur.sum()):
        return model
    pdf_occ = occ.sum(axis=1)
    score = np.maximum(pdf_occ, 1.0) ** power
    raw = score / score.sum() * target
    cap = np.maximum((pdf_occ / min_count).astype(int), 1)
    tgt = np.maximum(np.minimum(np.maximum(np.floor(raw).astype(int), 1), np.maximum(cap, cur)),
                     cur)
    rest = target - int(tgt.sum())
    if rest > 0:
        frac = np.where(tgt < np.maximum(cap, cur), raw - np.floor(raw), -1.0)
        for i in np.argsort(-frac)[:rest]:
            if frac[i] >= 0:
                tgt[i] += 1
    mean, var = model["means"].copy(), model["vars"].copy()
    p, m, d = mean.shape
    if tgt.max() > m:
        grow = (1 << (int(tgt.max()) - 1).bit_length()) - m
        mean = np.concatenate([mean, np.zeros((p, grow, d))], axis=1)
        var = np.concatenate([var, np.ones((p, grow, d))], axis=1)
        w = np.concatenate([w, np.zeros((p, grow))], axis=1)
    rng = np.random.default_rng(seed)
    for q in range(p):
        n = int(cur[q])
        while n < int(tgt[q]):
            k = int(np.argmax(w[q, :n]))
            std = np.sqrt(var[q, k])
            step = perturb * std * rng.standard_normal(d).astype(np.float32)
            w[q, k] *= 0.5
            w[q, n] = w[q, k]
            var[q, n] = var[q, k]
            mean[q, n] = mean[q, k] + step
            mean[q, k] = mean[q, k] - step
            n += 1
    return {"means": mean, "vars": var, "weights": w}


def transition_update(log_probs: np.ndarray, state_starts: np.ndarray, counts: np.ndarray,
                      floor: float = 0.01, min_count: float = 5.0) -> np.ndarray:
    """Kaldi's ``TransitionModel::MleUpdate``: each transition state's
    probabilities become its transitions' count shares, floored at
    ``floor`` and renormalised, where the state was seen ``min_count``
    times or more.  ``state_starts[s]:state_starts[s + 1]`` are state s's
    transition ids."""
    out = log_probs.astype(np.float64).copy()
    for lo, hi in zip(state_starts[:-1], state_starts[1:]):
        c = counts[lo:hi].astype(np.float64)
        if c.sum() < min_count:
            continue
        new = np.maximum(c / c.sum(), floor)
        out[lo:hi] = np.log(new / new.sum())
    return out
