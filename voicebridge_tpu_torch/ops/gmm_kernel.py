"""K2 wrapper: fused diagonal-GMM log-likelihoods (``csrc/gmm_loglik.cu``).

Replaces the Pallas kernel ``voicebridge_tpu/ops/pallas_gmm.py``
(``_gmm_kernel``).  Callers pass the model as ``ops/gmm_kernels.GmmParams``
(``pack_gmm``): weights ``w [P, M, 2D+1]`` float32, rows ``[miv, -0.5*iv,
gconst]``, and the host's record ``live [P, M]`` of which components are
live.  The kernel scores each pdf's live Gaussians only: ``layout`` lays the
components out ragged from ``live`` (each pdf's live components first, the
pdfs of each 64-pdf tile ordered by their count, each 16-pdf sub-tile as
many slabs as its largest count), never from a device read, and
``pack_weights`` gathers the weights into it on the device.  The layout and
the packed weights are made at the model's first call and kept on it: once
a decoder, once a realignment.

A CPU tensor goes to the plain version ``ops.gmm_kernels.loglikes``; a CUDA
tensor goes to the kernel or raises.  Either way a call counts, while
recording (``utils/profiling.py``), ``gmm.slots``: the component slots the
kernel computes, frames times the layout's slots a frame, and ``gmm.live``:
frames times the live Gaussians it sums.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..device import stream_handle
from ..utils import profiling
from . import gmm_kernels

NEG = -1e30
SUB = 16  # pdfs per sub-tile (kSubP in the source)
TILE = 64  # pdfs per block, whose columns the layout may reorder


class Layout(NamedTuple):
    """K2's ragged layout of a model's components (``layout``)."""

    tiles: np.ndarray  # int32 [S, 2]: each sub-tile's first slab and its slabs
    order: np.ndarray  # int32 [S * 16]: the model pdf of each packed column, -1 none
    src: np.ndarray  # int32 [R * 16]: the component p * M + m of each slab column, P * M dead
    live: int  # live Gaussians

    @property
    def slots(self) -> int:
        """Component slots computed a frame (dead ones included)."""
        return self.src.size


def k_pad(k: int) -> int:
    """Rows of a weight slab: ``k = 2D + 1`` padded to a multiple of 8."""
    return -(-k // 8) * 8


def layout(live: np.ndarray) -> Layout:
    """The layout of a model whose live components are ``live [P, M]``
    (bool): S = ceil(P / 16) sub-tiles; within each 64-pdf tile the pdfs in
    order of their live count, most first (ties in model order); sub-tile s
    owns ``tiles[s, 1]`` slabs (its largest count) from slab ``tiles[s, 0]``;
    slab c's column j holds the c-th live component of the pdf
    ``order[16 s + j]``, or a dead slot past that pdf's count."""
    p, m = live.shape
    s = -(-p // SUB)
    count = np.zeros(-(-p // TILE) * TILE, np.int64)
    count[:p] = live.sum(axis=1)
    by_count = np.argsort(-count.reshape(-1, TILE), axis=1, kind="stable")
    order = (by_count + TILE * np.arange(len(by_count))[:, None]).reshape(-1)[: s * SUB]
    order[order >= p] = -1
    slabs = np.where(order >= 0, count[order], 0).reshape(s, SUB).max(axis=1)
    first = np.cumsum(slabs) - slabs
    src = np.full((int(slabs.sum()), SUB), p * m, np.int64)
    column = np.empty(p, np.int64)
    column[order[order >= 0]] = np.flatnonzero(order >= 0)
    pdf, comp = np.nonzero(live)
    rank = (np.cumsum(live, axis=1) - 1)[pdf, comp]
    col = column[pdf]
    src[first[col // SUB] + rank, col % SUB] = pdf * m + comp
    return Layout(np.stack([first, slabs], axis=1).astype(np.int32), order.astype(np.int32),
                  src.reshape(-1).astype(np.int32), len(pdf))


def pack_weights(w: torch.Tensor, lay: Layout) -> tuple:
    """``w [P, M, K]`` -> (``wt [R, K_pad, 16]``, ``tiles [S, 2]``, ``order
    [S * 16]``) on ``w``'s device: ``wt[r, k, j] = w[src // M, src % M, k]``
    for ``src = lay.src[16 r + j]``, K padded with zeros, a dead slot zeros
    with gconst ``NEG``; the tables one host-to-device copy."""
    p, m, k = w.shape
    rows = w.new_zeros((p * m + 1, k_pad(k)))
    rows[:-1, :k] = w.reshape(p * m, k)
    rows[-1, k - 1] = NEG
    tables = torch.from_numpy(np.concatenate([lay.tiles.reshape(-1), lay.order, lay.src]))
    tiles, order, src = tables.to(w.device).split([lay.tiles.size, lay.order.size,
                                                   lay.src.size])
    wt = rows.index_select(0, src).view(-1, SUB, rows.shape[1]).transpose(1, 2).contiguous()
    return wt, tiles, order


def _packed(gmm: gmm_kernels.GmmParams) -> tuple:
    """(layout, packed weights or None on the CPU) of ``gmm``, made from
    ``gmm.live`` at its first call and kept on it."""
    if gmm.k2 is None:
        lay = layout(gmm.live)
        gmm.k2 = (lay, None if gmm.w.device.type == "cpu" else pack_weights(gmm.w, lay))
    return gmm.k2


def loglikes(x: torch.Tensor, gmm: gmm_kernels.GmmParams) -> torch.Tensor:
    """``x [N, D]`` and a model -> ``[N, P]`` per-pdf log-likelihoods."""
    if x.device.type == "cuda":
        _check(x, gmm.w)
    elif x.device.type != "cpu":
        raise ValueError(f"unsupported device {x.device}")
    lay, packed = _packed(gmm)
    profiling.count("gmm.slots", x.shape[0] * lay.slots)
    profiling.count("gmm.live", x.shape[0] * lay.live)
    if packed is None:
        return gmm_kernels.loglikes(gmm, x)
    n, d = x.shape
    p = gmm.num_pdfs
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    wt, tiles, order = packed
    _build.launch("gmm_loglikes", x.data_ptr(), n, d, wt.data_ptr(), tiles.data_ptr(),
                  order.data_ptr(), p, out.data_ptr(), stream_handle(x.device))
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"x and w must be float32, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != 2 * x.shape[1] + 1:
        raise ValueError(f"need x [N, D] and w [P, M, 2D+1], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("x and w lie on different devices")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def loglikes_batch(feats: torch.Tensor, gmm: gmm_kernels.GmmParams) -> torch.Tensor:
    """``[B, T, D] -> [B, T, P]`` (the decoder's acoustic input)."""
    b, t, d = feats.shape
    return loglikes(feats.reshape(b * t, d), gmm).view(b, t, gmm.num_pdfs)
