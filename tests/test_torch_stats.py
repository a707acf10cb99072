"""Parity of the port's E-step statistics (``ops/gmm_kernels.py``, the plain
version of K6, and its CPU wrapper path ``ops/gmm_stats_kernel.acc_stats``)
with the JAX package's on the same inputs, on the CPU.

Tolerance: rtol 1e-5, and an atol of 1e-5 times the largest magnitude of the
accumulator compared (float32 sums in another order; an accumulator's small
entries carry the rounding of its large ones).  Transition counts are
equal.  K6's plain work list (the one the card's is held to) equals a numpy
stable argsort's, array for array."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu.ops import gmm_kernels as JK
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.ops import gmm_stats_kernel as K6

torch.set_num_threads(2)


def assert_stats_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = 1e-5 * max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _port(am):
    """The port's AmDiagGmm from the JAX package's arrays."""
    return convert.am_from_arrays(am.means_invvars, am.inv_vars, am.weights)


def _inputs(num_pdfs=17, max_mix=3, dim=9, n=501, seed=0, skew=False):
    rng = np.random.default_rng(seed)
    am = AmDiagGmm(rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32),
                   np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32)
                   + 0.5,
                   np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32))
    x_post = rng.standard_normal((n, dim)).astype(np.float32)
    x_acc = rng.standard_normal((n, dim)).astype(np.float32)
    pdfs = rng.integers(0, num_pdfs, n).astype(np.int32)
    if skew:
        pdfs[rng.random(n) < 0.7] = 2  # a silence-like pdf holds most frames
    w = rng.random(n).astype(np.float32)
    w[::7] = 0.0
    return am, x_post, x_acc, pdfs, w


@pytest.mark.parametrize("skew", [False, True])
def test_aligned_twofeats_matches_jax(skew):
    am, x_post, x_acc, pdfs, w = _inputs(skew=skew)
    p = am.num_pdfs
    want = JK.acc_gmm_stats_aligned_twofeats(JK.pack_gmm(am), jnp.asarray(x_post),
                                             jnp.asarray(x_acc), jnp.asarray(pdfs), p,
                                             jnp.asarray(w))
    args = (torch.from_numpy(x_post), torch.from_numpy(x_acc), torch.from_numpy(pdfs), p,
            torch.from_numpy(w))
    got = K.acc_gmm_stats_aligned_twofeats(K.pack_gmm(_port(am), "cpu"), *args)
    wrapped = K6.acc_stats(K.pack_gmm(_port(am), "cpu"), *args[:3],
                           torch.from_numpy(w), p)
    for name, g, gw, ref in zip(("occ", "mean_acc", "var_acc", "ll"), got, wrapped, want):
        assert g.dtype == torch.float32 and gw.dtype == torch.float64
        assert_stats_close(g.numpy(), np.asarray(ref), name)
        np.testing.assert_array_equal(gw.numpy(), g.double().numpy())


def test_single_feature_and_all_pdf_oracle():
    am, x, _, pdfs, w = _inputs(num_pdfs=11, max_mix=4, dim=6, n=300, seed=1)
    p = am.num_pdfs
    jp, tp = JK.pack_gmm(am), K.pack_gmm(_port(am), "cpu")
    xt, pt, wt = torch.from_numpy(x), torch.from_numpy(pdfs), torch.from_numpy(w)
    want = JK.acc_gmm_stats(jp, jnp.asarray(x), jnp.asarray(pdfs), p, jnp.asarray(w))
    got = K.acc_gmm_stats(tp, xt, pt, p, wt)
    aligned = K.acc_gmm_stats_aligned(tp, xt, pt, p, wt)
    for name, g, a, ref in zip(("occ", "mean_acc", "var_acc"), got, aligned, want):
        assert_stats_close(g.numpy(), np.asarray(ref), name)
        assert_stats_close(a.numpy(), np.asarray(ref), name)
    ll_j = float(JK.aligned_loglike(jp, jnp.asarray(x), jnp.asarray(pdfs), jnp.asarray(w)))
    assert abs(float(K.aligned_loglike(tp, xt, pt, wt)) - ll_j) <= 1e-5 * abs(ll_j)
    assert abs(float(aligned[3]) - ll_j) <= 1e-5 * abs(ll_j)
    np.testing.assert_allclose(K.aligned_mixture_logliks(tp, xt, pt).numpy(),
                               np.asarray(JK.aligned_mixture_logliks(jp, jnp.asarray(x),
                                                                     jnp.asarray(pdfs))),
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("chunk", [None, 128])
def test_chunked_matches_jax(chunk):
    am, x_post, x_acc, pdfs, w = _inputs(num_pdfs=23, max_mix=5, dim=13, n=1000, seed=2)
    p = am.num_pdfs
    want = JK.acc_gmm_stats_twofeats_chunked(JK.pack_gmm(am), x_post, x_acc, pdfs, p, w,
                                             chunk=chunk or 1 << 18)
    got = K.acc_gmm_stats_twofeats_chunked(K.pack_gmm(_port(am), "cpu"), x_post, x_acc, pdfs, p, w,
                                           chunk=chunk)
    for name, g, ref in zip(("occ", "mean_acc", "var_acc"), got[:3], want[:3]):
        assert g.dtype == np.float32 and g.shape == ref.shape
        assert_stats_close(g, ref, name)
    assert abs(got[3] - want[3]) <= 1e-5 * abs(want[3])
    single = K.acc_gmm_stats_chunked(K.pack_gmm(_port(am), "cpu"), x_post, pdfs, p, None, chunk)
    want1 = JK.acc_gmm_stats_chunked(JK.pack_gmm(am), x_post, pdfs, p, None)
    for name, g, ref in zip(("occ", "mean_acc", "var_acc"), single[:3], want1[:3]):
        assert_stats_close(g, ref, name)


def test_transition_stats_equal():
    rng = np.random.default_rng(3)
    tids = rng.integers(0, 40, 777).astype(np.int32)
    w = (rng.random(777) < 0.8).astype(np.float32)
    for weights in (w, None):
        want = np.asarray(JK.acc_transition_stats(
            jnp.asarray(tids), 41, None if weights is None else jnp.asarray(weights)))
        got = K.acc_transition_stats(torch.from_numpy(tids), 41,
                                     None if weights is None else torch.from_numpy(weights))
        assert got.dtype == torch.float32 and got.shape == (42,)
        np.testing.assert_array_equal(got.numpy(), want)


def test_transition_stats_fractional_weights():
    """Fractional weights, ids in no order and ids no frame takes: the
    sort-and-segment float64 sum against the JAX package's segment_sum."""
    rng = np.random.default_rng(4)
    tids = rng.integers(1, 300, 5000).astype(np.int32)
    tids[tids % 7 == 0] = 3  # a long run, and ids that no frame takes
    w = rng.random(5000).astype(np.float32) * rng.choice([1e-3, 1.0, 30.0], 5000)
    want = np.asarray(JK.acc_transition_stats(jnp.asarray(tids), 300, jnp.asarray(w)))
    got = K.acc_transition_stats(torch.from_numpy(tids), 300, torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (301,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert got[0] == 0 and got[7] == 0


@pytest.mark.parametrize("skew", [False, True])
def test_block_table_covers_each_pdf_run(skew):
    """The K6 work list: every pdf's run of sorted frames is cut into blocks
    of at most 64 frames, in order, each pdf owns a contiguous range of
    blocks, frames keyed outside [0, 12) (left out) are in no block, and the
    blocks past the real ones are empty."""
    rng = np.random.default_rng(4)
    key = rng.integers(-1, 14, 2000)  # -1, 12 and 13: frames left out
    if skew:
        key[rng.random(2000) < 0.8] = 4
    key = torch.from_numpy(np.sort(key))
    n_blocks = -(-2000 // 64) + 12
    blk_pdf, lo, hi, first, last = (t.numpy() for t in K6.block_table(key, 12, n_blocks, 64))
    key = key.numpy()
    counts = np.array([(key == p).sum() for p in range(12)])
    n_real = sum(-(-c // 64) for c in counts)
    assert last[-1] == n_real <= n_blocks
    assert (hi[:n_real] - lo[:n_real] > 0).all() and (hi - lo <= 64).all()
    assert (lo[n_real:] == 0).all() and (hi[n_real:] == 0).all()
    for p in range(12):
        blocks = np.arange(first[p], last[p])
        assert (blk_pdf[blocks] == p).all()
        covered = np.concatenate([np.arange(lo[i], hi[i]) for i in blocks] or [[]])
        np.testing.assert_array_equal(np.sort(covered), np.flatnonzero(key == p))


def _work_list_numpy(pdfs, weights, num_pdfs, frames_per_block):
    """K6's work list from a numpy stable argsort: frames keyed by pdf (the
    frames left out keyed num_pdfs), each pdf's run cut into blocks of
    ``frames_per_block``; the list padded to ceil(N / block) + num_pdfs
    blocks with empty blocks of pdf num_pdfs - 1."""
    keep = (weights != 0) & (pdfs >= 0) & (pdfs < num_pdfs)
    key = np.where(keep, pdfs, num_pdfs)
    order = np.argsort(key, kind="stable")
    nblk = -(-len(key) // frames_per_block) + num_pdfs
    blk_pdf = np.full(nblk, num_pdfs - 1)
    blk_lo, blk_hi = np.zeros(nblk), np.zeros(nblk)
    first, last = np.zeros(num_pdfs), np.zeros(num_pdfs)
    j = 0
    for p in range(num_pdfs):
        run = np.flatnonzero(key[order] == p)
        first[p] = j
        for lo in range(0, len(run), frames_per_block):
            blk_pdf[j] = p
            blk_lo[j], blk_hi[j] = run[0] + lo, run[0] + min(lo + frames_per_block, len(run))
            j += 1
        last[p] = j
    return order, blk_pdf, blk_lo, blk_hi, first, last


@pytest.mark.parametrize("case", ["uniform", "skew", "zero_weights", "outside", "below_block"])
def test_plain_work_list_matches_numpy(case):
    """The plain version of K6's work list (``torch.sort`` + ``block_table``),
    which the card's list is held to bit for bit, against a numpy stable
    argsort: a silence-like pdf holding most frames, zero weights, pdfs
    outside [0, num_pdfs) (left out) and fewer frames than one block."""
    rng = np.random.default_rng(5)
    n = 100 if case == "below_block" else 3000
    num_pdfs = 23
    pdfs = rng.integers(0, num_pdfs, n).astype(np.int32)
    weights = rng.random(n).astype(np.float32)
    if case == "skew":
        pdfs[rng.random(n) < 0.8] = 4  # about 2400 frames: many blocks of one pdf
    elif case == "zero_weights":
        weights[rng.random(n) < 0.4] = 0.0
    elif case == "outside":
        out = rng.random(n) < 0.2
        pdfs[out] = rng.choice([-3, -1, num_pdfs, num_pdfs + 7], int(out.sum()))
    got = K6.work_list(torch.from_numpy(pdfs), torch.from_numpy(weights), num_pdfs)
    want = _work_list_numpy(pdfs, weights, num_pdfs, K6.FRAMES_PER_BLOCK)
    assert got.blk_pdf.shape[0] == K6.list_blocks(n, num_pdfs)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
