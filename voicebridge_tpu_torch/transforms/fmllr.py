"""fMLLR (CMLLR) speaker-adaptation transforms.

Port of ``voicebridge_tpu/transforms/fmllr.py`` (counterparts:
``gmm-est-fmllr{,-gpost}`` / ``gmm-post-to-gpost`` and the row-by-row solve
in ``transform/fmllr-diag-gmm.{h,cc}:43-61``).

Per-speaker sufficient statistics (device):

    beta_s          = sum gamma
    K_s[d, e]       = sum gamma * mu_d / var_d * xhat_e        (xhat = [x; 1])
    G_s[d, e, f]    = sum gamma / var_d * xhat_e * xhat_f

The rows with a nonzero weight are grouped by speaker with a stable sort (in
row order within a speaker), each speaker's run is padded to whole blocks of
``SUB_FRAMES`` rows with weight 0, and each block's K and G are one float64
product of the rows' fp32 posterior sums (G as ``[D*E, n] x [n, E]``, never
an ``[N, D, E, E]`` intermediate).  The blocks' sums go to their speakers as
float64 segment sums: no float atomics, so two runs on the card give the same
bits, and the sums do not depend on how the rows are cut into chunks or
spread over ranks (``parallel/``).

Estimation (host numpy, a copy of the JAX package's): iterative row update
of the affine transform W [D, D+1] maximizing
beta log|det A| - 0.5 sum_d (w_d G_d w_d^T - 2 w_d K_d)  (FmllrInnerUpdate);
``estimate_fmllr_rows`` makes the same sweeps in native code (the decoder's).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..device import free_bytes, ieee_fp32_entry, resolve_device
from ..ops.gmm_kernels import GmmParams, aligned_mixture_logliks

# rows per block of the float64 K and G products
SUB_FRAMES = 256


def _fmllr_frame_stats(params: GmmParams, means, inv_vars, feats, pdf_ids, weights):
    """Per-row collapsed statistics: (posterior mass [N], w_miv [N, D],
    w_iv [N, D]) from the posteriors of each row's pdf's mixtures."""
    sel = aligned_mixture_logliks(params, feats, pdf_ids)  # [N, M]
    gamma = torch.softmax(sel, dim=1) * weights[:, None]  # [N, M]
    mu = means[pdf_ids]  # [N, M, D]
    iv = inv_vars[pdf_ids]
    w_miv = torch.einsum("nm,nmd->nd", gamma, mu * iv)
    w_iv = torch.einsum("nm,nmd->nd", gamma, iv)
    return gamma.sum(dim=1), w_miv, w_iv


def _fmllr_blocks(gmass, w_miv, w_iv, feats):
    """Blocks of ``SUB_FRAMES`` rows -> per block (beta [nb], K [nb, D, E],
    G [nb, D*E, E]), float64."""
    n, d = feats.shape
    nb = n // SUB_FRAMES
    xhat = torch.cat([feats, feats.new_ones((n, 1))], dim=1).double()  # [N, E]
    xb = xhat.view(nb, SUB_FRAMES, d + 1)
    beta = gmass.view(nb, SUB_FRAMES).sum(dim=1, dtype=torch.float64)
    k = torch.bmm(w_miv.double().view(nb, SUB_FRAMES, d).transpose(1, 2), xb)
    y = (w_iv.double()[:, :, None] * xhat[:, None, :]).view(nb, SUB_FRAMES, d * (d + 1))
    return beta, k, torch.bmm(y.transpose(1, 2), xb)


def fmllr_chunk_rows(device: torch.device, max_mix: int, dim: int) -> int:
    """Rows per chunk, a whole number of blocks: the chunk's per-row
    intermediates (gathered means and inverse variances, the float64
    ``[D, E]`` products, the blocks' G in float64) in a quarter of the memory
    free on ``device``."""
    e = dim + 1
    per_row = 4 * (2 * max_mix * dim + 4 * dim * e + 8 * dim) + 16 * dim * e * e // SUB_FRAMES
    rows = free_bytes(device) // (4 * per_row)
    return max(8, rows // SUB_FRAMES) * SUB_FRAMES


def _speaker_blocks(weights: torch.Tensor, spk_ids: torch.Tensor, num_speakers: int):
    """The rows that add to the statistics (nonzero weight, a speaker in
    ``[0, num_speakers)``), grouped by speaker in row order, each speaker's
    run padded to whole blocks of ``SUB_FRAMES``.  Returns (row of each slot
    [nb * SUB_FRAMES], -1 on padding; speaker of each block [nb])."""
    dev = weights.device
    keep = (weights != 0) & (spk_ids >= 0) & (spk_ids < num_speakers)
    rows = torch.nonzero(keep).squeeze(1)
    order = rows[torch.sort(spk_ids[rows], stable=True).indices]
    counts = torch.bincount(spk_ids[order], minlength=num_speakers)
    blocks = (counts + SUB_FRAMES - 1) // SUB_FRAMES
    rank = torch.arange(len(order), device=dev) - torch.repeat_interleave(
        torch.cumsum(counts, 0) - counts, counts)
    first = (torch.cumsum(blocks, 0) - blocks) * SUB_FRAMES
    slot = torch.repeat_interleave(first, counts) + rank
    idx = torch.full((int(blocks.sum()) * SUB_FRAMES,), -1, dtype=torch.int64, device=dev)
    idx[slot] = order
    return idx, torch.repeat_interleave(torch.arange(num_speakers, device=dev), blocks)


@ieee_fp32_entry
def fmllr_sums(params: GmmParams, means, inv_vars, feats, pdf_ids, weights, spk_ids,
               num_speakers: int, chunk: int | None = None):
    """The float64 sums of ``acc_fmllr_stats`` on the device of ``params``,
    where the other inputs (arrays or tensors) go: (beta [S], K [S, D, D+1],
    G [S, D, D+1, D+1])."""
    dev = params.w.device
    means = torch.as_tensor(means, dtype=torch.float32).to(dev)
    inv_vars = torch.as_tensor(inv_vars, dtype=torch.float32).to(dev)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    pdf_ids = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    spk_ids = torch.as_tensor(spk_ids).to(dev, torch.int64)
    d = feats.shape[1]
    e = d + 1
    idx, block_spk = _speaker_blocks(weights, spk_ids, num_speakers)
    beta = torch.zeros(num_speakers, dtype=torch.float64, device=dev)
    k = torch.zeros((num_speakers, d * e), dtype=torch.float64, device=dev)
    g = torch.zeros((num_speakers, d * e * e), dtype=torch.float64, device=dev)
    c = max(1, (chunk or fmllr_chunk_rows(dev, means.shape[1], d)) // SUB_FRAMES)
    for lo in range(0, len(block_spk), c):
        rows = idx[lo * SUB_FRAMES:(lo + c) * SUB_FRAMES]
        real = rows >= 0
        rows = rows.clamp(min=0)
        x = feats[rows]
        gmass, w_miv, w_iv = _fmllr_frame_stats(
            params, means, inv_vars, x, pdf_ids[rows], torch.where(real, weights[rows], 0.0))
        b_blk, k_blk, g_blk = _fmllr_blocks(gmass, w_miv, w_iv, x)
        lengths = torch.bincount(block_spk[lo:lo + c], minlength=num_speakers)
        beta += torch.segment_reduce(b_blk, "sum", lengths=lengths)
        k += torch.segment_reduce(k_blk.reshape(len(b_blk), -1), "sum",
                                  lengths=lengths, axis=0)
        g += torch.segment_reduce(g_blk.reshape(len(b_blk), -1), "sum",
                                  lengths=lengths, axis=0)
    return beta, k.view(num_speakers, d, e), g.view(num_speakers, d, e, e)


@ieee_fp32_entry
def acc_fmllr_stats(params: GmmParams, means, inv_vars, feats, pdf_ids, weights, spk_ids,
                    num_speakers: int, chunk: int | None = None, mesh=None, *, device=None):
    """feats [N, D]; pdf_ids, weights, spk_ids [N] (arrays or tensors) ->
    (beta [S], K [S, D, D+1], G [S, D, D+1, D+1]), float32 tensors on
    ``device`` (``None``: the card), where everything is computed.

    ``chunk`` (rows, rounded down to whole blocks) defaults to what the
    device's free memory holds; the chunks are summed in float64, and the
    sums are handed back as float32, as the JAX package hands them to
    ``estimate_fmllr_batch``.  Rows of weight 0 (padding, unused posterior
    slots) and rows of a speaker outside ``[0, num_speakers)`` add nothing
    and are left out before any product.

    With ``mesh`` set, speaker-major slabs of frames are sharded over the
    data axis and the per-speaker sums reduced over it
    (``_acc_fmllr_stats_mesh``; the reference's per-job fMLLR accs composed
    per speaker, ``train_sat.cpp:906-954``, as one collective); the result
    lies on the mesh's device and ``device`` is not read."""
    if mesh is not None:
        sums = _acc_fmllr_stats_mesh(params, means, inv_vars, feats, pdf_ids, weights,
                                     spk_ids, num_speakers, mesh)
    else:
        dev = resolve_device(device)
        params = params.to(dev)
        sums = fmllr_sums(params, means, inv_vars, feats, pdf_ids, weights, spk_ids,
                          num_speakers, chunk)
    return tuple(x.float() for x in sums)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _acc_fmllr_stats_mesh(params, means, inv_vars, feats, pdf_ids, weights, spk_ids,
                          num_speakers: int, mesh, t_slab: int = 1024):
    """Speaker-major slab packing for the mesh-sharded fMLLR accumulator
    (on the host, as the JAX package packs): each speaker's frames (stably
    sorted by speaker) are cut into rows of ``t_slab`` frames (weight 0 on
    padding), the rows padded to a multiple of the data axis and tagged
    with their speaker slot; the sharded program sums its rows into their
    speakers' slots in float64 before the reduction.  The JAX package pads
    the row count to a power of two so that XLA compiles few shapes; the
    port has no compile cache to protect and pads only to the data axis."""
    from ..parallel.mesh import DATA_AXIS, acc_fmllr_stats_sharded

    feats = _host(feats).astype(np.float32)
    pdf_ids, weights = _host(pdf_ids).astype(np.int32), _host(weights).astype(np.float32)
    spk_ids = _host(spk_ids).astype(np.int64)
    d = feats.shape[1]
    order = np.argsort(spk_ids, kind="stable")
    starts = np.searchsorted(spk_ids[order], np.arange(num_speakers + 1))
    rows = []
    for s in range(num_speakers):
        span = order[starts[s]: starts[s + 1]]
        for lo in range(0, max(len(span), 1), t_slab):
            rows.append((s, span[lo: lo + t_slab]))
    nd = mesh.shape[DATA_AXIS]
    n_rows = -(-len(rows) // nd) * nd
    f_r = np.zeros((n_rows, t_slab, d), np.float32)
    p_r = np.zeros((n_rows, t_slab), np.int32)
    w_r = np.zeros((n_rows, t_slab), np.float32)
    slot_r = np.zeros(n_rows, np.int32)
    for i, (s, idx) in enumerate(rows):
        f_r[i, : len(idx)] = feats[idx]
        p_r[i, : len(idx)] = pdf_ids[idx]
        w_r[i, : len(idx)] = weights[idx]
        slot_r[i] = s
    acc = acc_fmllr_stats_sharded(mesh, num_speakers)
    return acc(params, means, inv_vars, f_r, p_r, w_r, slot_r)


def estimate_fmllr(beta: float, k: np.ndarray, g: np.ndarray,
                   num_iters: int = 20, min_count: float = 500.0):
    """Solve one speaker's transform (row-wise quadratic maximization with
    cofactors — FmllrInnerUpdate).  Returns (W [D, D+1], objf impr/frame) or
    (identity, 0.0) when below min_count (reference --fmllr-min-count).
    Thin wrapper over the speaker-batched solver."""
    w, imprs = estimate_fmllr_batch(np.asarray([beta]), k[None], g[None],
                                    min_count=min_count, num_iters=num_iters)
    return w[0], imprs[0]


def _row_inverses(k: np.ndarray, g: np.ndarray):
    """(the regularized per-row G inverses ``[S, D, D+1, D+1]``, their
    products with K ``[S, D, D+1]``) from float64 statistics."""
    d = k.shape[1]
    tr = np.einsum("sdii->sd", g) / (d + 1)
    reg = 1e-5 * np.maximum(tr, 1e-10)[:, :, None, None] * np.eye(d + 1)
    ginv = np.linalg.inv(g + reg)
    return ginv, np.einsum("sdef,sdf->sde", ginv, k)


def estimate_fmllr_batch(beta: np.ndarray, k: np.ndarray, g: np.ndarray,
                         min_count: float = 500.0, num_iters: int = 20):
    """All speakers at once, vectorized over the speaker axis (the
    reference's per-speaker job loop becomes batched [S, D, ...] linear
    algebra).  Returns (transforms [S, D, D+1], impr list).  Speakers below
    ``min_count`` keep the identity transform."""
    s_num, d = k.shape[0], k.shape[1]
    ident = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    if s_num == 0:
        return np.zeros((0, d, d + 1), np.float32), []
    beta = beta.astype(np.float64)
    k = k.astype(np.float64)
    g = g.astype(np.float64)
    active = beta >= min_count
    w = np.broadcast_to(ident, (s_num, d, d + 1)).copy()
    if not active.any():
        return w.astype(np.float32), [0.0] * s_num

    ginv, gk = _row_inverses(k, g)

    def objf(ww):
        a = ww[:, :, :d]
        sign, logdet = np.linalg.slogdet(a)
        quad = np.einsum("sde,sde->s", ww, k) \
            - 0.5 * np.einsum("sde,sdef,sdf->s", ww, g, ww)
        val = beta * np.where(sign > 0, logdet, -np.inf) + quad
        return np.where(active, val, 0.0)

    start = objf(w)
    prev = start
    for _ in range(num_iters):
        for i in range(d):
            a = w[:, :, :d]  # [S, D, D]
            inv_t = np.linalg.inv(a).transpose(0, 2, 1)
            cof = np.linalg.det(a)[:, None] * inv_t[:, i]  # [S, D]
            chat = np.concatenate([cof, np.zeros((s_num, 1))], axis=1)
            gc = np.einsum("sef,sf->se", ginv[:, i], chat)  # [S, D+1]
            c1 = np.einsum("se,se->s", chat, gc)
            c2 = np.einsum("se,se->s", chat, gk[:, i])
            ok = active & (c1 > 0)
            disc = np.maximum(c2 * c2 + 4.0 * beta * c1, 0.0)
            step = (-c2 + np.sqrt(disc)) / np.maximum(2.0 * c1, 1e-20)
            new_row = gk[:, i] + step[:, None] * gc
            w[:, i] = np.where(ok[:, None], new_row, w[:, i])
        cur = objf(w)
        if np.all(cur - prev < 1e-6 * np.maximum(np.abs(prev), 1.0)):
            prev = cur
            break
        prev = cur
    imprs = [float((prev[s] - start[s]) / max(beta[s], 1.0)) if active[s] else 0.0
             for s in range(s_num)]
    return w.astype(np.float32), imprs


_ROWS_LIB = None


def _rows_lib():
    """The native row update (``csrc/fmllr_rows.cpp``), built at first use."""
    global _ROWS_LIB
    if _ROWS_LIB is None:
        from .._build import CSRC, build_host_library

        lib = ctypes.CDLL(str(build_host_library(CSRC / "fmllr_rows.cpp", "libvbt_fmllr")))
        f64 = ctypes.POINTER(ctypes.c_double)
        lib.vb_fmllr_rows.restype = ctypes.c_int
        lib.vb_fmllr_rows.argtypes = [ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, f64,
                                      ctypes.POINTER(ctypes.c_uint8), f64, f64, f64, f64,
                                      f64, f64]
        _ROWS_LIB = lib
    return _ROWS_LIB


def estimate_fmllr_rows(beta: np.ndarray, k: np.ndarray, g: np.ndarray,
                        min_count: float = 500.0, num_iters: int = 20):
    """``estimate_fmllr_batch``'s update and stopping rule, its sweeps in
    native code (``csrc/fmllr_rows.cpp``: a row in O(D^2), A's inverse and
    determinant carried through a sweep by Sherman-Morrison): the same
    transforms to rounding in about a tenth of the time (8 speakers at
    D = 40).  Returns (transforms [S, D, D+1] float32, impr list)."""
    s_num, d = k.shape[0], k.shape[1]
    if s_num == 0:
        return np.zeros((0, d, d + 1), np.float32), []
    beta = np.ascontiguousarray(beta, np.float64)
    k = np.ascontiguousarray(k, np.float64)
    g = np.ascontiguousarray(g, np.float64)
    active = np.ascontiguousarray(beta >= min_count, np.uint8)
    w = np.ascontiguousarray(np.broadcast_to(
        np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1), (s_num, d, d + 1)))
    if not active.any():
        return w.astype(np.float32), [0.0] * s_num
    ginv, gk = (np.ascontiguousarray(x) for x in _row_inverses(k, g))
    objf = np.zeros((2, s_num))

    def ptr(x):
        return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))

    _rows_lib().vb_fmllr_rows(s_num, d, num_iters, ptr(beta),
                              active.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              ptr(k), ptr(g), ptr(ginv), ptr(gk), ptr(w), ptr(objf))
    imprs = [float((objf[1, s] - objf[0, s]) / max(beta[s], 1.0)) if active[s] else 0.0
             for s in range(s_num)]
    return w.astype(np.float32), imprs


@ieee_fp32_entry
def apply_fmllr_batch(feats, transforms, spk_ids, *, device=None) -> torch.Tensor:
    """feats [B, T, D] (array or tensor) with per-speaker affine transforms
    ``[S, D, D+1]`` gathered by ``spk_ids [B]`` -> ``[B, T, D]`` on
    ``device`` (``None``: the card): one IEEE-fp32 ``baddbmm``."""
    dev = resolve_device(device)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    w = torch.as_tensor(transforms, dtype=torch.float32).to(dev)[
        torch.as_tensor(spk_ids).to(dev, torch.int64)]  # [B, D, D+1]
    return torch.baddbmm(w[:, None, :, -1], feats, w[:, :, :-1].transpose(1, 2))
