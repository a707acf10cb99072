"""K6 wrapper: aligned-GMM E-step statistics (``csrc/gmm_stats.cu``).

Replaces the XLA program ``voicebridge_tpu/ops/gmm_kernels.py``
(``acc_gmm_stats_aligned_twofeats``): for every frame, the component scores
of its aligned pdf on ``x_post``, their softmax times the frame weight, and
the sums of the posteriors, posteriors times ``x_acc`` and posteriors times
``x_acc²`` per (pdf, component), plus the weighted total log-likelihood.

The kernel is deterministic and uses no float atomics.  Here the frames of
nonzero weight are grouped by aligned pdf (a stable sort) and every pdf's
run is cut into blocks of ``FRAMES_PER_BLOCK`` frames; the kernel sums each
block in float64 and then sums each pdf's blocks in a fixed order.  The
grouping bounds the skew of silence pdfs, which hold a large share of the
frames, to whole blocks.  Zero-weight (padding) frames, and frames whose pdf
lies outside ``[0, num_pdfs)`` (as the JAX package's segment sums), are left
out.  The work list is built on the device without a host synchronisation:
its length is the bound ``ceil(N / FRAMES_PER_BLOCK) + num_pdfs``, and the
blocks past the real ones are empty.

A CPU tensor goes to the plain version
``ops.gmm_kernels.acc_gmm_stats_aligned_twofeats``; a CUDA tensor goes to the
kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build, convert
from ..device import stream_handle
from . import gmm_kernels

FRAMES_PER_BLOCK = 256


def block_table(key: torch.Tensor, num_pdfs: int, num_blocks: int,
                frames_per_block: int = FRAMES_PER_BLOCK):
    """Work list of the kernel for sorted frame keys ``key [N]`` (the aligned
    pdf, or anything outside ``[0, num_pdfs)`` for a frame left out): per
    block its pdf and its [lo, hi) range of positions in ``key``, and per pdf
    its [first, last) range of blocks.  ``num_blocks`` must be at least
    ``ceil(N / frames_per_block) + num_pdfs``; blocks past the real ones get
    lo = hi = 0.  All int32 on ``key``'s device; no host synchronisation."""
    dev = key.device
    bounds = torch.searchsorted(key, torch.arange(num_pdfs + 1, device=dev, dtype=key.dtype))
    seg_start, seg_end = bounds[:-1], bounds[1:]
    nblk = (seg_end - seg_start + frames_per_block - 1) // frames_per_block
    blk_end = torch.cumsum(nblk, 0)
    blk_start = blk_end - nblk
    j = torch.arange(num_blocks, device=dev)
    blk_pdf = torch.searchsorted(blk_end, j, right=True).clamp(max=num_pdfs - 1)
    lo = seg_start[blk_pdf] + (j - blk_start[blk_pdf]) * frames_per_block
    hi = torch.minimum(lo + frames_per_block, seg_end[blk_pdf])
    real = j < blk_end[-1]
    i32 = torch.int32
    return (blk_pdf.to(i32), torch.where(real, lo, 0).to(i32), torch.where(real, hi, 0).to(i32),
            blk_start.to(i32), blk_end.to(i32))


def acc_stats(w: torch.Tensor, x_post: torch.Tensor, x_acc: torch.Tensor,
              pdf_ids: torch.Tensor, weights: torch.Tensor, num_pdfs: int):
    """``w [P, M, 2D+1]`` (K2 layout), ``x_post, x_acc [N, D]`` f32,
    ``pdf_ids [N]`` int32, ``weights [N]`` f32 -> float64 (occ [num_pdfs, M],
    mean_acc [num_pdfs, M, D], var_acc [num_pdfs, M, D], ll 0-d)."""
    if x_post.device.type == "cpu":
        out = gmm_kernels.acc_gmm_stats_aligned_twofeats(
            convert.twin_params_from_kernel(w), x_post, x_acc, pdf_ids, num_pdfs, weights)
        return tuple(t.double() for t in out)
    if x_post.device.type != "cuda":
        raise ValueError(f"unsupported device {x_post.device}")
    n, d = x_post.shape
    p, m, kdim = w.shape
    dev = x_post.device
    for name, x, dtype in (("w", w, torch.float32), ("x_post", x_post, torch.float32),
                           ("x_acc", x_acc, torch.float32),
                           ("pdf_ids", pdf_ids, torch.int32),
                           ("weights", weights, torch.float32)):
        if x.device != dev or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {dev}, "
                             f"got {x.dtype} on {x.device}")
    if (kdim != 2 * d + 1 or x_acc.shape != (n, d) or pdf_ids.shape != (n,)
            or weights.shape != (n,) or not 0 < num_pdfs <= p):
        raise ValueError("acc_stats: inconsistent shapes")
    key = torch.where(weights != 0, pdf_ids, num_pdfs)  # int32: a 4-pass radix sort
    key, order = torch.sort(key, stable=True)
    num_blocks = -(-n // FRAMES_PER_BLOCK) + num_pdfs
    blk_pdf, blk_lo, blk_hi, pdf_blk_lo, pdf_blk_hi = block_table(key, num_pdfs, num_blocks)
    order = order.to(torch.int32)
    width = m * kdim + 1  # per component [occ, mean[D], var[D]], then ll
    partial = torch.empty((num_blocks, width), dtype=torch.float64, device=dev)
    out = torch.empty((num_pdfs, width), dtype=torch.float64, device=dev)
    _build.launch("gmm_stats", x_post.data_ptr(), x_acc.data_ptr(), weights.data_ptr(), d,
                  w.data_ptr(), m, order.data_ptr(), blk_pdf.data_ptr(), blk_lo.data_ptr(),
                  blk_hi.data_ptr(), num_blocks, pdf_blk_lo.data_ptr(),
                  pdf_blk_hi.data_ptr(), num_pdfs, partial.data_ptr(), out.data_ptr(),
                  stream_handle(dev))
    comp = out[:, : m * kdim].view(num_pdfs, m, kdim)
    return comp[..., 0], comp[..., 1:d + 1], comp[..., d + 1:], out[:, -1].sum()
