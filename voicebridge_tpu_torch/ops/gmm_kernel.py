"""K2 wrapper: fused diagonal-GMM log-likelihoods (``csrc/gmm_loglik.cu``).

Replaces the Pallas kernel ``voicebridge_tpu/ops/pallas_gmm.py``
(``_gmm_kernel``).  Callers pass the weights as ``w [P, M, 2D+1]`` float32,
rows ``[miv, -0.5*iv, gconst]`` (``convert.kernel_params_from_am``); the
wrapper repacks them for the kernel (``pack_weights``: component-major,
k-major, pdfs contiguous and padded) on every call, a copy of a few MB.
A CPU tensor goes to the plain version ``ops.gmm_kernels.loglikes``; a CUDA
tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from .. import _build, convert
from ..device import stream_handle
from . import gmm_kernels

MAX_CHUNK = 5  # components per pass of the kernel (kMaxChunk in the source)
NEG = -1e30


def chunking(m: int) -> tuple[int, int]:
    """Components per pass and the padded component count for ``m``
    components: as few passes of at most ``MAX_CHUNK`` as will do, equal in
    size."""
    passes = -(-m // MAX_CHUNK)
    mc = -(-m // passes)
    return mc, mc * passes


def pack_weights(w: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``w [P, M, K]`` -> (``wt [M_pad, K_pad, P_pad]``, components per
    pass): ``wt[c, k, p] = w[p, c, k]``, K padded with zeros to a multiple of
    8, P to a multiple of 64, the padded components inactive (gconst row
    ``NEG``)."""
    p, m, k = w.shape
    mc, m_pad = chunking(m)
    wt = w.new_zeros((m_pad, -(-k // 8) * 8, -(-p // 64) * 64))
    wt[:m, :k, :p] = w.permute(1, 2, 0)
    wt[m:, k - 1] = NEG
    return wt, mc


def loglikes(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [N, D]``, ``w [P, M, 2D+1]`` -> ``[N, P]`` per-pdf log-likelihoods."""
    if x.device.type == "cpu":
        return gmm_kernels.loglikes(convert.twin_params_from_kernel(w), x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"x and w must be float32, got {x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[2] != 2 * x.shape[1] + 1:
        raise ValueError(f"need x [N, D] and w [P, M, 2D+1], got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("x and w lie on different devices")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    n, d = x.shape
    p, m, _ = w.shape
    out = torch.empty((n, p), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    wt, mc = pack_weights(w)
    _build.launch("gmm_loglikes", x.data_ptr(), n, d, wt.data_ptr(), p, wt.shape[0], mc,
                  out.data_ptr(), stream_handle(x.device))
    return out


def loglikes_batch(feats: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``[B, T, D] -> [B, T, P]`` (the decoder's acoustic input)."""
    b, t, d = feats.shape
    return loglikes(feats.reshape(b * t, d), w).view(b, t, w.shape[0])
