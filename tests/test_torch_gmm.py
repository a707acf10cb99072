"""Parity of the port's GMM log-likelihoods (the K2 plain version and its
CPU wrapper path) with the JAX package's XLA path and Pallas kernel
(interpret mode), and the parameter conversions between the layouts.
Tolerance as ``tests/test_pallas_gmm.py``: rtol 2e-5, atol 2e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu.ops import gmm_kernels as K
from voicebridge_tpu.ops.pallas_gmm import loglikes_pallas, pack_gmm_pallas
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.ops import gmm_kernel
from voicebridge_tpu_torch.ops import gmm_kernels as TK

torch.set_num_threads(2)
GMM_TOL = dict(rtol=2e-5, atol=2e-4)


def _port(am):
    """The port's AmDiagGmm from the JAX package's arrays."""
    return convert.am_from_arrays(am.means_invvars, am.inv_vars, am.weights)


def _random_am(num_pdfs=37, max_mix=5, dim=13, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    means = rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32)
    inv_vars = (np.abs(rng.standard_normal((num_pdfs, max_mix, dim)))
                .astype(np.float32) + 0.3)
    weights = rng.random((num_pdfs, max_mix)).astype(np.float32)
    if ragged:
        for p in range(num_pdfs):
            weights[p, rng.integers(1, max_mix + 1):] = 0.0
    weights /= weights.sum(axis=1, keepdims=True)
    return AmDiagGmm(means * inv_vars, inv_vars, weights)


CASES = {"plain": dict(), "ragged": dict(num_pdfs=21, max_mix=7, dim=11, seed=3, ragged=True),
         "wide": dict(num_pdfs=130, max_mix=3, dim=39, seed=5)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loglikes_match_jax_and_pallas(case):
    am = _random_am(**CASES[case])
    x = np.random.default_rng(1).standard_normal((300, am.dim)).astype(np.float32)
    ref = np.asarray(K.loglikes(K.pack_gmm(am), jnp.asarray(x)))
    ref_pallas = np.asarray(loglikes_pallas(pack_gmm_pallas(am), jnp.asarray(x),
                                            am.num_pdfs, interpret=True))
    twin = TK.loglikes(TK.pack_gmm(_port(am), "cpu"), torch.from_numpy(x)).numpy()
    wrapped = gmm_kernel.loglikes(torch.from_numpy(x),
                                  convert.kernel_params_from_am(_port(am), "cpu")).numpy()
    assert twin.shape == ref.shape == (300, am.num_pdfs)
    np.testing.assert_allclose(twin, ref, **GMM_TOL)
    np.testing.assert_allclose(twin, ref_pallas, **GMM_TOL)
    np.testing.assert_allclose(wrapped, twin, **GMM_TOL)


def test_inactive_pdf_gives_neg_sentinel():
    am = _random_am(num_pdfs=6, max_mix=3, dim=5, seed=9)
    am.weights[2] = 0.0
    am.compute_gconsts()
    x = np.random.default_rng(2).standard_normal((10, 5)).astype(np.float32)
    ref = np.asarray(K.loglikes(K.pack_gmm(am), jnp.asarray(x)))
    got = gmm_kernel.loglikes(torch.from_numpy(x), convert.kernel_params_from_am(_port(am), "cpu"))
    np.testing.assert_array_equal(got.numpy()[:, 2], np.full(10, -1e30, np.float32))
    np.testing.assert_allclose(got.numpy(), ref, **GMM_TOL)


def test_loglikes_batch_shape():
    am = _random_am(num_pdfs=9, max_mix=2, dim=4, seed=4)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 7, 4)).astype(np.float32))
    w = convert.kernel_params_from_am(_port(am), "cpu")
    got = gmm_kernel.loglikes_batch(feats, w)
    assert got.shape == (2, 7, 9)
    np.testing.assert_allclose(got.reshape(14, 9).numpy(),
                               gmm_kernel.loglikes(feats.reshape(14, 4), w).numpy())


def test_convert_from_jax_gmm_params():
    am = _random_am(**CASES["ragged"])
    jp = K.pack_gmm(am)
    params, w = convert.gmm_from_jax(np.asarray(jp.w_matrix), np.asarray(jp.gconsts), "cpu")
    np.testing.assert_array_equal(w.numpy(), convert.kernel_params_from_am(_port(am), "cpu").numpy())
    back = convert.twin_params_from_kernel(w)
    np.testing.assert_array_equal(back.w_matrix.numpy(), np.asarray(jp.w_matrix))
    np.testing.assert_array_equal(back.gconsts.numpy(), np.asarray(jp.gconsts))
    assert (params.num_pdfs, params.max_mix, params.dim) == (21, 7, 11)


def test_convert_from_pallas_w3():
    am = _random_am(**CASES["wide"])
    params, w = convert.gmm_from_pallas(np.asarray(pack_gmm_pallas(am).w3),
                                        am.num_pdfs, am.dim, "cpu")
    np.testing.assert_array_equal(w.numpy(), convert.kernel_params_from_am(_port(am), "cpu").numpy())
    jp = K.pack_gmm(am)
    np.testing.assert_array_equal(params.w_matrix.numpy(), np.asarray(jp.w_matrix))
    np.testing.assert_array_equal(params.gconsts.numpy(), np.asarray(jp.gconsts))


def test_wrapper_rejects_other_devices():
    am = _random_am(num_pdfs=3, max_mix=2, dim=4)
    w = convert.kernel_params_from_am(_port(am), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        gmm_kernel.loglikes(torch.empty((5, 4), device="meta"), w)
