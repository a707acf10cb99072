"""Batched diagonal-GMM log-likelihoods and EM statistics in plain PyTorch.

Port of ``voicebridge_tpu/ops/gmm_kernels.py``: the plain version of the
fused GMM kernel (``ops/gmm_kernel.py``, K2) and of the aligned E-step
kernel (``ops/gmm_stats_kernel.py``, K6).  Per (frame, pdf)
(reference: ``DecodableAmDiagGmmScaled::LogLikelihoodZeroBased``):

    loglike = logsumexp_m( gconst[p,m] + miv[p,m]·x - 0.5·iv[p,m]·x² )

With x' = [x, x²] and W = [miv; -0.5·iv] as ``[2D, P·M]``, all scores are one
fp32 matmul plus the gconst bias, then a logsumexp over the mixture axis.
Inactive components carry gconst = -1e30 and vanish from the sum.

E-step statistics from a hard (Viterbi) alignment are segment sums over the
aligned pdf ids (``index_add_``), the content of the reference's
``AccumAmDiagGmm`` (``gmm/mle-am-diag-gmm.h:34``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voicebridge_tpu.models.gmm import AmDiagGmm

from ..device import free_bytes


class GmmParams(NamedTuple):
    """GMM parameters on one device; sizes come from the array shapes."""

    w_matrix: torch.Tensor  # [2D, P*M]  = [miv; -0.5*iv] transposed
    gconsts: torch.Tensor  # [P, M], -1e30 for inactive components

    @property
    def num_pdfs(self) -> int:
        return self.gconsts.shape[0]

    @property
    def max_mix(self) -> int:
        return self.gconsts.shape[1]

    @property
    def dim(self) -> int:
        return self.w_matrix.shape[0] // 2


def pack_gmm(am: AmDiagGmm, device) -> GmmParams:
    p, m, d = am.num_pdfs, am.max_mix, am.dim
    w = np.concatenate([am.means_invvars, -0.5 * am.inv_vars], axis=2)  # [P,M,2D]
    w = w.reshape(p * m, 2 * d).T.astype(np.float32)  # [2D, P*M]
    gc = np.where(np.isfinite(am.gconsts), am.gconsts, -1e30).astype(np.float32)
    return GmmParams(torch.from_numpy(np.ascontiguousarray(w)).to(device),
                     torch.from_numpy(gc).to(device))


def component_logliks(params: GmmParams, x: torch.Tensor) -> torch.Tensor:
    """``[N, D] -> [N, P, M]`` per-component log-likelihoods."""
    scores = torch.cat([x, x * x], dim=-1) @ params.w_matrix  # [N, P*M]
    return scores.view(x.shape[0], params.num_pdfs, params.max_mix) + params.gconsts[None]


def loglikes(params: GmmParams, x: torch.Tensor) -> torch.Tensor:
    """``[N, D] -> [N, P]`` total per-pdf log-likelihoods (the decoder input)."""
    return torch.logsumexp(component_logliks(params, x), dim=2)


def loglikes_batch(params: GmmParams, feats: torch.Tensor) -> torch.Tensor:
    """``[B, T, D] -> [B, T, P]``."""
    b, t, d = feats.shape
    return loglikes(params, feats.reshape(b * t, d)).view(b, t, params.num_pdfs)


# ---------------------------------------------------------------------------
# E-step statistics from a hard (Viterbi) alignment
# ---------------------------------------------------------------------------


def _segment_stats(gamma, x_acc, pdf, num_pdfs: int):
    """Posteriors [N, M] and features [N, D] -> (occ [P, M], mean_acc
    [P, M, D], var_acc [P, M, D]) summed per aligned pdf."""
    m, d = gamma.shape[1], x_acc.shape[1]
    occ = gamma.new_zeros((num_pdfs, m)).index_add_(0, pdf, gamma)
    gx = gamma[:, :, None] * x_acc[:, None, :]
    mean_acc = gamma.new_zeros((num_pdfs, m, d)).index_add_(0, pdf, gx)
    var_acc = gamma.new_zeros((num_pdfs, m, d)).index_add_(0, pdf, gx * x_acc[:, None, :])
    return occ, mean_acc, var_acc


def acc_gmm_stats(params: GmmParams, x: torch.Tensor, pdf_ids: torch.Tensor,
                  num_pdfs: int, frame_weights: torch.Tensor | None = None):
    """GMM sufficient statistics for aligned frames from the all-pdf
    component scores ``[N, P, M]`` (the small-scale oracle).  Returns (occ
    ``[P, M]``, mean_acc ``[P, M, D]``, var_acc ``[P, M, D]``)."""
    pdf = pdf_ids.long()
    sel = component_logliks(params, x)[torch.arange(x.shape[0], device=x.device), pdf]
    gamma = torch.softmax(sel, dim=1)
    if frame_weights is not None:
        gamma = gamma * frame_weights[:, None]
    return _segment_stats(gamma, x, pdf, num_pdfs)


def aligned_mixture_logliks(params: GmmParams, x: torch.Tensor,
                            pdf_ids: torch.Tensor) -> torch.Tensor:
    """Component log-likelihoods of each frame's ALIGNED pdf only:
    ``[N, D], [N] -> [N, M]`` (gathers ``[N, M, 2D]`` parameters instead of
    scoring all pdfs)."""
    p, m, d = params.num_pdfs, params.max_mix, params.dim
    pdf = pdf_ids.long()
    wsel = params.w_matrix.T.reshape(p, m, 2 * d)[pdf]  # [N, M, 2D]
    return (torch.einsum("nmd,nd->nm", wsel, torch.cat([x, x * x], dim=-1))
            + params.gconsts[pdf])


def acc_gmm_stats_aligned_twofeats(params: GmmParams, x_post: torch.Tensor,
                                   x_acc: torch.Tensor, pdf_ids: torch.Tensor,
                                   num_pdfs: int, frame_weights: torch.Tensor):
    """Aligned-pdf E-step statistics with separate posterior and
    accumulation features (``gmm-acc-stats-twofeats``): posteriors from
    ``x_post``, statistics over ``x_acc``.  The plain version of K6.

    Returns (occ [P, M], mean_acc [P, M, D], var_acc [P, M, D], ll scalar)."""
    sel = aligned_mixture_logliks(params, x_post, pdf_ids)
    ll = torch.sum(torch.logsumexp(sel, dim=1) * frame_weights)
    gamma = torch.softmax(sel, dim=1) * frame_weights[:, None]
    return (*_segment_stats(gamma, x_acc, pdf_ids.long(), num_pdfs), ll)


def acc_gmm_stats_aligned(params: GmmParams, x: torch.Tensor, pdf_ids: torch.Tensor,
                          num_pdfs: int, frame_weights: torch.Tensor):
    """Single-feature variant (the ``gmm-acc-stats-ali`` path)."""
    return acc_gmm_stats_aligned_twofeats(params, x, x, pdf_ids, num_pdfs, frame_weights)


def _stats_chunk(device: torch.device, m: int, d: int) -> int:
    """Frames per E-step chunk: the plain version's per-frame intermediates
    (gathered parameters, posteriors times features) in a quarter of the
    memory free on ``device``."""
    per_frame = 4 * m * (2 * d + 1) * 4
    return max(1 << 12, free_bytes(device) // (4 * per_frame))


def acc_gmm_stats_twofeats_chunked(params: GmmParams, x_post, x_acc, pdf_ids,
                                   num_pdfs: int, frame_weights=None,
                                   chunk: int | None = None):
    """E-step statistics over frame chunks through the K6 wrapper
    (``ops/gmm_stats_kernel.acc_stats``); chunks are summed in float64.
    Inputs may be arrays or tensors; they go to the device of ``params``.
    ``chunk`` (frames) defaults to what the device's free memory holds.
    Returns numpy float32 (occ, mean_acc, var_acc) and a float ll."""
    from .. import convert  # imported here: both modules import this one
    from .gmm_stats_kernel import acc_stats

    device = params.gconsts.device
    x_post = torch.as_tensor(x_post, dtype=torch.float32).to(device)
    x_acc = torch.as_tensor(x_acc, dtype=torch.float32).to(device)
    pdf_ids = torch.as_tensor(pdf_ids).to(device=device, dtype=torch.int32)
    n = x_post.shape[0]
    w = (torch.ones(n, dtype=torch.float32, device=device) if frame_weights is None
         else torch.as_tensor(frame_weights, dtype=torch.float32).to(device))
    wk = convert.kernel_params_from_twin(params)
    c = chunk or _stats_chunk(device, params.max_mix, params.dim)
    m, d = params.max_mix, params.dim
    sums = [torch.zeros(shape, dtype=torch.float64, device=device)
            for shape in ((num_pdfs, m), (num_pdfs, m, d), (num_pdfs, m, d), ())]
    for lo in range(0, n, c):
        part = acc_stats(wk, x_post[lo:lo + c].contiguous(), x_acc[lo:lo + c].contiguous(),
                         pdf_ids[lo:lo + c].contiguous(), w[lo:lo + c].contiguous(), num_pdfs)
        sums = [a + b for a, b in zip(sums, part)]
    occ, macc, vacc, ll = sums
    return (occ.float().cpu().numpy(), macc.float().cpu().numpy(),
            vacc.float().cpu().numpy(), float(ll))


def acc_gmm_stats_chunked(params: GmmParams, x, pdf_ids, num_pdfs: int,
                          frame_weights=None, chunk: int | None = None):
    """Single-feature chunked E-step statistics (``gmm-acc-stats-ali``)."""
    return acc_gmm_stats_twofeats_chunked(params, x, x, pdf_ids, num_pdfs,
                                          frame_weights, chunk)


def acc_transition_stats(tids: torch.Tensor, num_tids: int,
                         frame_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Transition-id occupancies from an alignment (``[N]`` ->
    ``[num_tids+1]``)."""
    w = (torch.ones(tids.shape, dtype=torch.float32, device=tids.device)
         if frame_weights is None else frame_weights)
    return torch.bincount(tids.long(), weights=w, minlength=num_tids + 1)


def aligned_loglike(params: GmmParams, x: torch.Tensor, pdf_ids: torch.Tensor,
                    frame_weights: torch.Tensor | None = None) -> torch.Tensor:
    """Total data log-likelihood of an alignment (for EM monitoring)."""
    ll = torch.logsumexp(aligned_mixture_logliks(params, x, pdf_ids), dim=1)
    if frame_weights is not None:
        ll = ll * frame_weights
    return torch.sum(ll)
