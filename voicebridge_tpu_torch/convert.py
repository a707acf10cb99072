"""Parameter conversion into the port's layouts.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of its
device arrays), so both packages can compute from identical numbers:

* ``AmDiagGmm`` -> the plain version's ``GmmParams`` and the GMM kernel's
  packed ``w [P, M, 2D+1]`` (rows ``[miv, -0.5*iv, gconst]``);
* the JAX ``GmmParams`` (``w_matrix [2D, P*M]``, ``gconsts [P, M]``) and the
  Pallas ``w3 [128, M, P_pad]`` -> the same two;
* a JAX ``EmitPlan`` -> the port's ``EmitPlan`` (then
  ``ops.decode_core.plan_to_device``);
* a JAX ``BandPlan`` -> the port's ``BandPlan`` (then
  ``ops.align_band.plan_to_device``).
"""

from __future__ import annotations

import numpy as np
import torch

from voicebridge_tpu.models.gmm import AmDiagGmm

from .ops.align_band import BandPlan
from .ops.decode_core import EmitPlan
from .ops.gmm_kernels import GmmParams, pack_gmm


def kernel_params_from_twin(params: GmmParams) -> torch.Tensor:
    """``GmmParams`` -> contiguous ``w [P, M, 2D+1]``."""
    p, m, d = params.num_pdfs, params.max_mix, params.dim
    w = params.w_matrix.T.reshape(p, m, 2 * d)
    return torch.cat([w, params.gconsts[..., None]], dim=-1).contiguous()


def twin_params_from_kernel(w: torch.Tensor) -> GmmParams:
    """``w [P, M, 2D+1]`` -> ``GmmParams`` (views into ``w``, no copy)."""
    p, m, k = w.shape
    d = (k - 1) // 2
    return GmmParams(w[..., : 2 * d].reshape(p * m, 2 * d).T, w[..., 2 * d])


def kernel_params_from_am(am: AmDiagGmm, device) -> torch.Tensor:
    return kernel_params_from_twin(pack_gmm(am, device))


def gmm_from_jax(w_matrix: np.ndarray, gconsts: np.ndarray,
                 device) -> tuple[GmmParams, torch.Tensor]:
    """JAX ``GmmParams`` arrays -> (``GmmParams``, kernel ``w``)."""
    params = GmmParams(torch.tensor(np.asarray(w_matrix, np.float32), device=device),
                       torch.tensor(np.asarray(gconsts, np.float32), device=device))
    return params, kernel_params_from_twin(params)


def gmm_from_pallas(w3: np.ndarray, num_pdfs: int, dim: int,
                    device) -> tuple[GmmParams, torch.Tensor]:
    """Pallas ``w3 [K, M, P_pad]`` (rows ``[miv, -0.5*iv, gconst, 0...]``)
    -> (``GmmParams``, kernel ``w``)."""
    w = np.transpose(np.asarray(w3, np.float32)[: 2 * dim + 1, :, :num_pdfs], (2, 1, 0))
    w = torch.tensor(w, device=device)
    p, m, _ = w.shape
    params = GmmParams(w[..., : 2 * dim].reshape(p * m, 2 * dim).T.contiguous(),
                       w[..., 2 * dim].contiguous())
    return params, w


def emit_plan_from_jax(plan) -> EmitPlan:
    """A JAX ``EmitPlan`` (a NamedTuple of numpy arrays) -> the port's."""
    return EmitPlan(**{f: getattr(plan, f) for f in EmitPlan._fields})


def band_plan_from_jax(plan) -> BandPlan:
    """A JAX ``BandPlan`` (a NamedTuple of numpy arrays) -> the port's."""
    return BandPlan(**{f: getattr(plan, f) for f in BandPlan._fields})
