"""LDA estimation for spliced features.

Port of ``voicebridge_tpu/transforms/lda.py`` (counterparts: ``acc-lda`` /
``est-lda``, ``transform/lda-estimate.{h,cc}``).  Class = pdf from the
Viterbi alignment; silence frames are down-weighted upstream
(weight-silence-post).

Statistics (device): per-class count and mean accumulator, global second
moment.  The JAX package's ``segment_sum`` over the class ids becomes a
stable sort by class followed by one float64 sum per class over its run of
frames (``segment_reduce``, in frame order): no float atomics, so the same
bits in every run on the card.  The second moment is a float64 product
``(x*w)ᵀ·x``, so that no statistic depends on how the frames are spread
over ranks (``parallel/``, ``mesh=``).  Estimation (host numpy, a copy of the JAX package's):
within/between scatter, whiten within, top-k eigenvectors.  Output is affine
``[dim_out, dim_in + 1]``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import ieee_fp32_entry


@ieee_fp32_entry
def lda_sums(feats: torch.Tensor, pdf_ids, weights, num_pdfs: int):
    """feats [N, D] (spliced), pdf_ids [N], weights [N] -> float64 (counts
    [C], mean_acc [C, D], scatter [D, D]) on the features' device.  Frames
    whose id lies outside ``[0, num_pdfs)`` are left out of counts and
    means, as the JAX package's segment sums leave them."""
    dev = feats.device
    ids = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    w = torch.as_tensor(weights).to(dev, torch.float32)
    key = torch.where((ids >= 0) & (ids < num_pdfs), ids, num_pdfs)
    order = torch.sort(key, stable=True).indices
    lengths = torch.bincount(key, minlength=num_pdfs + 1)
    xw = feats * w[:, None]
    rows = torch.cat([w[:, None], xw], dim=1).double()[order]  # [N, 1+D]
    sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0)[:num_pdfs]
    return sums[:, 0], sums[:, 1:], xw.double().T @ feats.double()


@ieee_fp32_entry
def acc_lda_stats(feats, pdf_ids, weights, num_pdfs: int, mesh=None):
    """``lda_sums`` as float32 tensors: (counts [C], mean_acc [C, D],
    scatter [D, D]).

    With ``mesh`` set (``parallel/mesh.make_mesh``), frames are sharded over
    the data axis and the statistics summed over it
    (``parallel/mesh.acc_lda_stats_sharded``; the reference's per-job
    ``lda.JOBID.acc`` + est-lda file reduction, ``train_lda_mllt.cpp:305-376``,
    as one collective); the result lies on the mesh's device."""
    if mesh is not None:
        from ..parallel.mesh import acc_lda_stats_sharded, pad_to_mesh

        f, ids, w = pad_to_mesh(mesh, feats, pdf_ids, weights)
        sums = acc_lda_stats_sharded(mesh, num_pdfs)(f, ids, w)
    else:
        sums = lda_sums(feats, pdf_ids, weights, num_pdfs)
    return tuple(x.float() for x in sums)


def estimate_lda(counts: np.ndarray, mean_acc: np.ndarray, scatter: np.ndarray,
                 dim_out: int = 40, within_class_factor: float = 1.0e-4):
    """-> affine LDA matrix [dim_out, dim_in + 1].

    ``within_class_factor`` mirrors the reference's LdaEstimateOptions: it
    scales each output row by 1/sqrt(within_class_factor + lambda_i)-style
    damping; with the default tiny value rows are unit-within-class-variance.
    """
    counts = counts.astype(np.float64)
    mean_acc = mean_acc.astype(np.float64)
    scatter = scatter.astype(np.float64)
    tot = counts.sum()
    dim_in = mean_acc.shape[1]
    mask = counts > 0
    mu = mean_acc.sum(axis=0) / tot
    # between-class scatter
    class_means = np.where(mask[:, None], mean_acc / np.maximum(counts[:, None], 1e-10), 0.0)
    bc = np.einsum("c,cd,ce->de", counts, class_means, class_means) / tot - np.outer(mu, mu)
    tc = scatter / tot - np.outer(mu, mu)
    wc = tc - bc
    # regularize + whiten within-class
    wc = wc + 1e-6 * np.eye(dim_in) * max(np.trace(wc) / dim_in, 1e-10)
    evals_w, evecs_w = np.linalg.eigh(wc)
    evals_w = np.maximum(evals_w, 1e-10)
    w_inv_half = evecs_w @ np.diag(evals_w ** -0.5) @ evecs_w.T
    m = w_inv_half @ bc @ w_inv_half
    evals_b, evecs_b = np.linalg.eigh(m)
    order = np.argsort(-evals_b)[:dim_out]
    a = (evecs_b[:, order].T @ w_inv_half)  # [dim_out, dim_in]
    if within_class_factor != 1.0:
        # scale rows: variance of row i becomes 1/(1 + wcf*lambda)-ish damping
        lam = np.maximum(evals_b[order], 0.0)
        scale = np.sqrt((1.0 + lam) / (1.0 + within_class_factor * lam)) \
            if within_class_factor < 1.0 else np.ones_like(lam)
        # reference behavior: keep unit within-class variance (scale 1); the
        # option exists for HLDA-style damping — apply only if requested
        if within_class_factor not in (1.0, 1.0e-4):
            a = a * scale[:, None]
    offset = -(a @ mu)
    return np.concatenate([a, offset[:, None]], axis=1).astype(np.float32)


@ieee_fp32_entry
def apply_affine_transform(feats: torch.Tensor, mat) -> torch.Tensor:
    """feats [..., D] x affine [E, D+1] (array or tensor) -> [..., E] on the
    features' device: ``x @ Aᵀ + b`` at IEEE fp32."""
    mat = torch.as_tensor(mat, dtype=torch.float32).to(feats.device)
    x = feats.reshape(-1, feats.shape[-1])
    return torch.addmm(mat[:, -1], x, mat[:, :-1].T).view(*feats.shape[:-1], mat.shape[0])
