"""K6 wrapper: aligned-GMM E-step statistics (``csrc/gmm_stats.cu``).

Replaces the XLA program ``voicebridge_tpu/ops/gmm_kernels.py``
(``acc_gmm_stats_aligned_twofeats``): for every frame, the component scores
of its aligned pdf on ``x_post``, their softmax times the frame weight, and
the sums of the posteriors, posteriors times ``x_acc`` and posteriors times
``x_acc²`` per (pdf, component), plus the weighted total log-likelihood.

The kernel is deterministic and uses no float atomics.  Its work list
groups the frames by aligned pdf (a stable sort) and cuts every pdf's run
into blocks of ``FRAMES_PER_BLOCK`` frames; the kernel sums each block in
float64 and then sums each pdf's blocks in block order.  The grouping bounds
the skew of silence pdfs, which hold a large share of the frames, to whole
blocks.  Zero-weight (padding) frames, and frames whose pdf lies outside
``[0, num_pdfs)`` (as the JAX package's segment sums), are left out.  The
card builds the work list itself (a counting sort, ``work_list``) and the
whole call is two launches without a host synchronisation; the list has
the bound ``ceil(N / FRAMES_PER_BLOCK) + num_pdfs`` blocks, and the blocks
past the real ones are empty.  ``work_list_plain`` (``torch.sort`` and
``block_table``) is the list's plain version.

A CPU tensor goes to the plain version
``ops.gmm_kernels.acc_gmm_stats_aligned_twofeats``; a CUDA tensor goes to the
kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build
from ..device import stream_handle
from . import gmm_kernels

FRAMES_PER_BLOCK = 64  # a warp sums a block of at most this many frames (two tiles)
SORT_WARP_FRAMES = 256  # frames a warp of the card's counting sort takes (its kWarpFrames)


class WorkList(NamedTuple):
    """K6's work list, all int32: ``order [N]`` the frames grouped by key (the
    aligned pdf, then the frames left out), in frame order within a key;
    per block its pdf and its [lo, hi) range of positions in ``order``
    (``blk_pdf``, ``blk_lo``, ``blk_hi``); per pdf its [first, last) range of
    blocks (``pdf_blk_lo``, ``pdf_blk_hi``)."""

    order: torch.Tensor
    blk_pdf: torch.Tensor
    blk_lo: torch.Tensor
    blk_hi: torch.Tensor
    pdf_blk_lo: torch.Tensor
    pdf_blk_hi: torch.Tensor


def list_blocks(n: int, num_pdfs: int) -> int:
    """The work list's length: a bound on the blocks of N frames."""
    return -(-n // FRAMES_PER_BLOCK) + num_pdfs


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


def frame_keys(pdf_ids: torch.Tensor, weights: torch.Tensor, num_pdfs: int) -> torch.Tensor:
    """Each frame's key: its pdf, or ``num_pdfs`` for a frame left out (weight
    0, or a pdf outside ``[0, num_pdfs)``)."""
    keep = (weights != 0) & (pdf_ids >= 0) & (pdf_ids < num_pdfs)
    return torch.where(keep, pdf_ids, num_pdfs)


def work_list_plain(pdf_ids: torch.Tensor, weights: torch.Tensor, num_pdfs: int) -> WorkList:
    """The plain version of K6's work list: a stable ``torch.sort`` of the
    frame keys and ``block_table``."""
    key, order = torch.sort(frame_keys(pdf_ids, weights, num_pdfs), stable=True)
    return WorkList(order.to(torch.int32),
                    *block_table(key, num_pdfs, list_blocks(key.shape[0], num_pdfs)))


def _list_scratch(n: int, num_pdfs: int, device) -> tuple:
    """One int32 allocation for the work list and the kernel's scratch, and
    the sizes of its parts: the list (as ``WorkList``), the sort's (chunk,
    key) counts (room for chunks of one warp's frames, the smallest the
    kernel takes) and key totals, and the kernel's tickets."""
    k1, nblk = num_pdfs + 1, list_blocks(n, num_pdfs)
    sizes = (n, nblk, nblk, nblk, num_pdfs, num_pdfs, k1 * -(-n // SORT_WARP_FRAMES), k1,
             num_pdfs + 2)
    return torch.empty(sum(sizes), dtype=torch.int32, device=device), sizes


def _pointers(base: torch.Tensor, sizes) -> list:
    """The address of each part of ``base`` (int32) cut into ``sizes``."""
    ptr, out = base.data_ptr(), []
    for size in sizes:
        out.append(ptr)
        ptr += 4 * size
    return out


def _check(tensors, device) -> None:
    for name, x, dtype in tensors:
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {device}, "
                             f"got {x.dtype} on {x.device}")


def work_list(pdf_ids: torch.Tensor, weights: torch.Tensor, num_pdfs: int) -> WorkList:
    """K6's work list for ``pdf_ids [N]`` int32 and ``weights [N]`` f32, built
    on the card by the kernel's first launch (equal to ``work_list_plain``);
    a CPU tensor goes to the plain version."""
    if pdf_ids.device.type == "cpu":
        return work_list_plain(pdf_ids, weights, num_pdfs)
    if pdf_ids.device.type != "cuda":
        raise ValueError(f"unsupported device {pdf_ids.device}")
    n = pdf_ids.shape[0]
    _check((("pdf_ids", pdf_ids, torch.int32), ("weights", weights, torch.float32)),
           pdf_ids.device)
    if weights.shape != (n,) or num_pdfs < 1:
        raise ValueError("work_list: inconsistent shapes")
    scratch, sizes = _list_scratch(n, num_pdfs, pdf_ids.device)
    ptrs = _pointers(scratch, sizes)
    _build.launch("gmm_stats_list", pdf_ids.data_ptr(), weights.data_ptr(), n, num_pdfs,
                  FRAMES_PER_BLOCK, sizes[1], ptrs[6], ptrs[7], *ptrs[:6], ptrs[8],
                  stream_handle(pdf_ids.device), count="gmm_stats")
    return WorkList(*scratch.split(sizes)[:6])


def acc_stats(gmm: gmm_kernels.GmmParams, x_post: torch.Tensor, x_acc: torch.Tensor,
              pdf_ids: torch.Tensor, weights: torch.Tensor, num_pdfs: int):
    """A model (``ops/gmm_kernels.GmmParams``), ``x_post, x_acc [N, D]`` f32,
    ``pdf_ids [N]`` int32, ``weights [N]`` f32 -> float64 (occ [num_pdfs, M],
    mean_acc [num_pdfs, M, D], var_acc [num_pdfs, M, D], ll 0-d)."""
    if x_post.device.type == "cpu":
        out = gmm_kernels.acc_gmm_stats_aligned_twofeats(gmm, x_post, x_acc, pdf_ids,
                                                         num_pdfs, weights)
        return tuple(t.double() for t in out)
    if x_post.device.type != "cuda":
        raise ValueError(f"unsupported device {x_post.device}")
    n, d = x_post.shape
    w = gmm.w
    p, m, kdim = w.shape
    dev = x_post.device
    _check((("w", w, torch.float32), ("x_post", x_post, torch.float32),
            ("x_acc", x_acc, torch.float32), ("pdf_ids", pdf_ids, torch.int32),
            ("weights", weights, torch.float32)), dev)
    if (kdim != 2 * d + 1 or x_acc.shape != (n, d) or pdf_ids.shape != (n,)
            or weights.shape != (n,) or not 0 < num_pdfs <= p):
        raise ValueError("acc_stats: inconsistent shapes")
    scratch, sizes = _list_scratch(n, num_pdfs, dev)
    ptrs = _pointers(scratch, sizes)
    nblk = sizes[1]
    width = m * kdim + 1  # per component [occ, mean[D], var[D]], then ll
    # float64: the rows [num_pdfs, width], the total ll, the blocks' partials
    out = torch.empty((num_pdfs + nblk) * width + 1, dtype=torch.float64, device=dev)
    ll_at = num_pdfs * width
    base = out.data_ptr()
    _build.launch("gmm_stats", x_post.data_ptr(), x_acc.data_ptr(), weights.data_ptr(), d,
                  w.data_ptr(), m, pdf_ids.data_ptr(), n, num_pdfs, FRAMES_PER_BLOCK, nblk,
                  ptrs[6], ptrs[7], *ptrs[:6], ptrs[8], base + 8 * (ll_at + 1), base,
                  base + 8 * ll_at, stream_handle(dev))
    return (out.as_strided((num_pdfs, m), (width, kdim)),
            out.as_strided((num_pdfs, m, d), (width, kdim, 1), 1),
            out.as_strided((num_pdfs, m, d), (width, kdim, 1), 1 + d), out[ll_at])
