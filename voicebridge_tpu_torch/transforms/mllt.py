"""MLLT / global STC estimation.

Port of ``voicebridge_tpu/transforms/mllt.py`` (counterparts:
``gmm-acc-mllt`` / ``est-mllt`` / ``gmm-transform-means`` /
``compose-transforms``, ``transform/mllt.{h,cc}``).

Accumulators (device): for every frame aligned to pdf p with mixture
posteriors gamma_m:

    G[d] += sum_m gamma_m * inv_var[p,m,d] * (x - mu[p,m]) (x - mu[p,m])^T
    beta += sum gamma

computed chunk by chunk (chunks sized from the device's free memory, whole
blocks of ``SUB_FRAMES`` frames) as IEEE-fp32 products over the blocks, the
blocks' partial sums and the chunks added in float64.  Each block's product
is one batch entry of a batched product of fixed shape (``block_bmm``), so a
block gives the same bits wherever it lies: in any chunk, or in any rank's
share of the frames (``parallel/``, whole blocks a rank).  Update (host numpy, a copy of the JAX package's): Kaldi's iterative row
solve — for each row d of M:
    c_d = cofactor row of M (row of det(M) * M^{-T})
    m_d = sqrt(beta / (c_d^T G_d^{-1} c_d)) * G_d^{-1} c_d
maximizing  beta*log|det M| - 0.5 sum_d m_d^T G_d m_d.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import free_bytes, ieee_fp32_entry
from ..ops.gmm_kernels import GmmParams, aligned_mixture_logliks


# frames per partial sum of the G product: each partial sum adds SUB_FRAMES x
# M products in the features' precision, the partial sums are added in float64
SUB_FRAMES = 256
# blocks per batched product (``block_bmm``)
GROUP_BLOCKS = 16


def block_bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[nb, m, k] x [nb, k, n] -> [nb, m, n]`` in batched products of
    exactly ``GROUP_BLOCKS`` entries (the last group padded with zero
    blocks): every call has the same shape, so the library picks the same
    kernel and a block's product has the same bits whatever ``nb`` is."""
    nb = a.shape[0]
    out = a.new_empty((nb, a.shape[1], b.shape[2]))
    for lo in range(0, nb, GROUP_BLOCKS):
        n = min(GROUP_BLOCKS, nb - lo)
        if n == GROUP_BLOCKS:
            torch.bmm(a[lo:lo + n], b[lo:lo + n], out=out[lo:lo + n])
            continue
        pa = a.new_zeros((GROUP_BLOCKS,) + tuple(a.shape[1:]))
        pb = b.new_zeros((GROUP_BLOCKS,) + tuple(b.shape[1:]))
        pa[:n], pb[:n] = a[lo:], b[lo:]
        out[lo:] = torch.bmm(pa, pb)[:n]
    return out


def _mllt_chunk(params: GmmParams, means, inv_vars, feats, pdf_ids, weights):
    """One chunk's (G [D, D, D] float64, beta float64 0-d): posteriors of
    the aligned pdf's mixtures, then ``G[d, i, j] = sum_k w[k, d] diff[k, i]
    diff[k, j]`` over the (frame, mixture) pairs k (a ``[K, D²]``
    intermediate), as batched products over blocks of ``SUB_FRAMES`` frames
    (``block_bmm``) whose partial sums are added in float64: the rounding of
    a short sum, whatever the chunk's size.  The frames are padded to whole
    blocks with weight 0."""
    d = feats.shape[1]
    if feats.shape[0] == 0:  # e.g. a rank's empty share
        return (torch.zeros((d, d, d), dtype=torch.float64, device=feats.device),
                torch.zeros((), dtype=torch.float64, device=feats.device))
    pad = -feats.shape[0] % SUB_FRAMES
    if pad:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        pdf_ids = torch.nn.functional.pad(pdf_ids, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
    sel = aligned_mixture_logliks(params, feats, pdf_ids)  # [N, M]
    gamma = torch.softmax(sel, dim=1) * weights[:, None]  # [N, M]
    mu = means[pdf_ids]  # [N, M, D]
    iv = inv_vars[pdf_ids]
    n, m, d = mu.shape
    diff = (feats[:, None, :] - mu).reshape(n * m, d)  # [K, D]
    w = (gamma[:, :, None] * iv).reshape(n * m, d)  # [K, D]
    y = (w[:, :, None] * diff[:, None, :]).reshape(n * m, d * d)  # [K, D*D]
    blocks = n // SUB_FRAMES
    g = block_bmm(y.view(blocks, -1, d * d).transpose(1, 2), diff.view(blocks, -1, d))
    return g.sum(dim=0, dtype=torch.float64).reshape(d, d, d), gamma.sum(dtype=torch.float64)


def mllt_chunk_frames(device: torch.device, max_mix: int, dim: int) -> int:
    """Frames per chunk, whole blocks of ``SUB_FRAMES``: the chunk's
    per-(frame, mixture) intermediates (gathered means and inverse
    variances, the difference, its weights and the ``[D, D]`` outer
    products) in a quarter of the memory free on ``device``."""
    per_frame = 4 * max_mix * (dim * dim + 6 * dim)
    frames = max(1 << 11, free_bytes(device) // (4 * per_frame))
    return frames // SUB_FRAMES * SUB_FRAMES


@ieee_fp32_entry
def acc_mllt_stats(params: GmmParams, means, inv_vars, feats, pdf_ids, weights,
                   chunk: int | None = None, mesh=None):
    """feats [N, D]; means/inv_vars [P, M, D] -> (G [D, D, D] float32, beta).

    ``params`` (``ops/gmm_kernels.pack_gmm``) lies on the device the
    statistics are computed on; the other inputs (arrays or tensors) go
    there.  ``chunk`` (frames, rounded up to whole blocks of ``SUB_FRAMES``)
    defaults to what the device's free memory holds; the chunks are summed
    in float64 and G is handed back as float32, as the JAX package hands it
    to ``est_mllt``.

    With ``mesh`` set, each chunk's blocks are sharded over the data axis and
    its (G, beta) summed over it (``parallel/mesh.acc_mllt_stats_sharded``;
    the reference's per-job ``m.JOBID.macc`` + est-mllt file reduction,
    ``train_lda_mllt.cpp:694-``, as one collective per chunk): the same
    blocks as without a mesh, so the same sums up to float64 rounding.  The
    result lies on the mesh's device."""
    dev = params.w.device if mesh is None else mesh.device
    means = torch.as_tensor(means, dtype=torch.float32).to(dev)
    inv_vars = torch.as_tensor(inv_vars, dtype=torch.float32).to(dev)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(dev)
    pdf_ids = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    weights = torch.as_tensor(weights, dtype=torch.float32).to(dev)
    n, d = feats.shape
    c = -(-(chunk or mllt_chunk_frames(dev, means.shape[1], d)) // SUB_FRAMES) * SUB_FRAMES
    acc_fn = _mllt_chunk
    if mesh is not None:
        from ..parallel.mesh import acc_mllt_stats_sharded

        acc_fn = acc_mllt_stats_sharded(mesh)
    g = torch.zeros((d, d, d), dtype=torch.float64, device=dev)
    beta = torch.zeros((), dtype=torch.float64, device=dev)
    for lo in range(0, n, c):
        g_c, b_c = acc_fn(params, means, inv_vars, feats[lo:lo + c], pdf_ids[lo:lo + c],
                          weights[lo:lo + c])
        g += g_c
        beta += b_c
    return g.float(), float(beta)


def est_mllt(g: np.ndarray, beta: float, num_iters: int = 200,
             tol: float = 1e-7) -> tuple[np.ndarray, float]:
    """-> (M [D, D], objf improvement per frame).  est-mllt's row iteration."""
    g = g.astype(np.float64)
    d = g.shape[0]
    m = np.eye(d)
    ginv = np.stack([np.linalg.inv(g[i] + 1e-6 * np.eye(d) * max(np.trace(g[i]) / d, 1e-10))
                     for i in range(d)])

    def objf(mm):
        sign, logdet = np.linalg.slogdet(mm)
        if sign <= 0:
            return -np.inf
        quad = 0.5 * sum(mm[i] @ g[i] @ mm[i] for i in range(d))
        return beta * logdet - quad

    prev = objf(m)
    start = prev
    for _ in range(num_iters):
        for i in range(d):
            inv_t = np.linalg.inv(m).T
            cof = np.linalg.det(m) * inv_t[i]  # cofactor row
            gc = ginv[i] @ cof
            denom = cof @ gc
            if denom <= 0:
                continue
            scale = np.sqrt(beta / denom)
            # choose sign maximizing objf (log|det| term)
            m[i] = scale * gc
        cur = objf(m)
        if cur - prev < tol * max(abs(prev), 1.0):
            prev = cur
            break
        prev = cur
    impr = (prev - start) / max(beta, 1.0)
    return m.astype(np.float32), float(impr)


def compose_transforms(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """compose-transforms: result(x) = a(b(x)), handling affine shapes
    ([E, D] or [E, D+1])."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape[1] == b.shape[0]:  # linear . (linear|affine)
        return (a @ b).astype(np.float32)
    if a.shape[1] == b.shape[0] + 1:  # affine a over linear/affine b
        lin = a[:, :-1] @ b
        if b.shape[1] == b.shape[0]:  # b linear: append a's offset
            return np.concatenate([lin, a[:, -1:]], axis=1).astype(np.float32)
        # b affine: fold offsets
        out = lin.copy()
        out[:, -1] += a[:, -1]
        return out.astype(np.float32)
    raise ValueError(f"incompatible transform shapes {a.shape} {b.shape}")


def transform_model_means(am, m: np.ndarray) -> None:
    """gmm-transform-means: mu <- M mu (in place), gconsts recomputed."""
    means = am.means()  # [P, M, D]
    new_means = np.einsum("de,pme->pmd", m.astype(np.float64), means)
    am.means_invvars = (new_means * am.inv_vars).astype(np.float32)
    am.compute_gconsts()
