"""The port's fp32 products run in IEEE fp32 whatever TF32 setting the
caller made, and the caller's setting comes back after the call.

This torch build keeps the flags on the CPU too: after
``torch.set_float32_matmul_precision("high")`` the cuBLAS matmul precision
reads ``"tf32"``.  A spy (a ``TorchFunctionMode``) records that precision at
every product an entry point runs; every record must read ``"ieee"`` (or,
on a torch without ``fp32_precision``, ``allow_tf32`` False), and the
caller's ``"high"`` must read again after the call.  The global setting is
restored in a ``finally``, so that no later test runs under it.
"""

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from voicebridge_tpu_torch import device as D
from voicebridge_tpu_torch.config import DeltaOptions
from voicebridge_tpu_torch.models.full_gmm import FullGmm, acc_full_stats, pack_full_gmm
from voicebridge_tpu_torch.models.gmm import AmDiagGmm
from voicebridge_tpu_torch.ops import features as F
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.transforms import fmllr as TFM
from voicebridge_tpu_torch.transforms import lda as TL
from voicebridge_tpu_torch.transforms import mllt as TM

PRODUCTS = {torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__, torch.mm, torch.bmm,
            torch.einsum, torch.baddbmm, torch.addmm, torch.Tensor.mm, torch.Tensor.bmm}


def _precision() -> str:
    m = torch.backends.cuda.matmul
    if hasattr(m, "fp32_precision"):
        return m.fp32_precision
    return "tf32" if m.allow_tf32 else "ieee"


class Spy(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in PRODUCTS:
            self.seen.append(_precision())
        return func(*args, **(kwargs or {}))


def _inputs():
    rng = np.random.default_rng(0)
    d, p, m, n = 6, 4, 2, 300
    am = AmDiagGmm.flat_start(p, rng.standard_normal(d), np.ones(d))
    am.split_to_target(p * m, np.ones((p, 1)), seed=1)
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    pdf = rng.integers(0, p, n).astype(np.int32)
    return am, x, pdf, np.ones(n, np.float32)


def _calls():
    am, x, pdf, w = _inputs()
    params = K.pack_gmm(am, "cpu")
    full = pack_full_gmm(FullGmm.from_diag(am), "cpu")
    return {
        "add_deltas_batch": lambda: F.add_deltas_batch(x[None], torch.tensor([x.shape[0]]),
                                                       DeltaOptions()),
        "apply_affine_transform": lambda: TL.apply_affine_transform(
            x[None], np.eye(x.shape[1], x.shape[1] + 1, dtype=np.float32)),
        "acc_lda_stats": lambda: TL.acc_lda_stats(x, pdf, w, am.num_pdfs),
        "acc_mllt_stats": lambda: TM.acc_mllt_stats(params, am.means(), am.inv_vars, x, pdf, w),
        "acc_fmllr_stats": lambda: TFM.acc_fmllr_stats(params, am.means(), am.inv_vars, x, pdf,
                                                       w, pdf % 2, 2, device="cpu"),
        "loglikes": lambda: K.loglikes(params, x),
        "acc_gmm_stats_chunked": lambda: K.acc_gmm_stats_chunked(params, x, pdf, am.num_pdfs, w),
        "acc_full_stats": lambda: acc_full_stats(full, x, pdf, am.num_pdfs, w),
    }


@pytest.mark.parametrize("entry", sorted(_calls()))
def test_entry_point_runs_ieee_under_a_callers_tf32(entry):
    call = _calls()[entry]
    try:
        torch.set_float32_matmul_precision("high")
        assert _precision() == "tf32"
        with Spy() as spy:
            call()
        assert spy.seen, "the entry point ran no product"
        assert set(spy.seen) == {"ieee"}, spy.seen
        assert _precision() == "tf32"  # the caller's setting is back
    finally:
        torch.set_float32_matmul_precision("highest")
    assert _precision() == "ieee"


def test_context_restores_after_an_error():
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(ValueError):
            with D.ieee_fp32():
                assert _precision() == "ieee"
                raise ValueError("inside")
        assert _precision() == "tf32"
    finally:
        torch.set_float32_matmul_precision("highest")
