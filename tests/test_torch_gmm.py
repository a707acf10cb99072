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
from voicebridge_tpu_torch import FrameOptions, MfccOptions, convert
from voicebridge_tpu_torch.ops import gmm_kernel
from voicebridge_tpu_torch.ops import gmm_kernels as TK
from voicebridge_tpu_torch.steps.make_feats import make_features
from voicebridge_tpu_torch.testing import load_yesno_mono
from voicebridge_tpu_torch.utils import profiling

import k2_cases
from synth import make_corpus

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
    wrapped = gmm_kernel.loglikes(torch.from_numpy(x), TK.pack_gmm(_port(am), "cpu")).numpy()
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
    got = gmm_kernel.loglikes(torch.from_numpy(x), TK.pack_gmm(_port(am), "cpu"))
    np.testing.assert_array_equal(got.numpy()[:, 2], np.full(10, -1e30, np.float32))
    np.testing.assert_allclose(got.numpy(), ref, **GMM_TOL)


def test_loglikes_batch_shape():
    am = _random_am(num_pdfs=9, max_mix=2, dim=4, seed=4)
    feats = torch.from_numpy(np.random.default_rng(3).standard_normal((2, 7, 4)).astype(np.float32))
    gmm = TK.pack_gmm(_port(am), "cpu")
    got = gmm_kernel.loglikes_batch(feats, gmm)
    assert got.shape == (2, 7, 9)
    np.testing.assert_allclose(got.reshape(14, 9).numpy(),
                               gmm_kernel.loglikes(feats.reshape(14, 4), gmm).numpy())


def _same_model(got, want, jax_params):
    """``got`` and ``want`` hold the same weights and live components, and
    the plain versions' view of the weights is the JAX package's matrix."""
    np.testing.assert_array_equal(got.w.numpy(), want.w.numpy())
    np.testing.assert_array_equal(got.live, want.live)
    p, m = got.num_pdfs, got.max_mix
    np.testing.assert_array_equal(got.w[..., :-1].reshape(p * m, -1).T.numpy(),
                                  np.asarray(jax_params.w_matrix))
    np.testing.assert_array_equal(got.gconsts.numpy(), np.asarray(jax_params.gconsts))


def test_convert_from_jax_gmm_params():
    am = _random_am(**CASES["ragged"])
    jp = K.pack_gmm(am)
    got = convert.gmm_from_jax(np.asarray(jp.w_matrix), np.asarray(jp.gconsts), "cpu")
    _same_model(got, TK.pack_gmm(_port(am), "cpu"), jp)
    assert (got.num_pdfs, got.max_mix, got.dim) == (21, 7, 11)
    assert got.live.sum() == am.num_gauss < got.live.size


def test_convert_from_pallas_w3():
    am = _random_am(**CASES["wide"])
    got = convert.gmm_from_pallas(np.asarray(pack_gmm_pallas(am).w3), am.num_pdfs, am.dim,
                                  "cpu")
    _same_model(got, TK.pack_gmm(_port(am), "cpu"), K.pack_gmm(am))
    assert got.live.all()


def test_k2_lays_a_model_out_once_and_a_model_packed_after_an_update_anew(monkeypatch):
    """K2 lays a model out at its first call and keeps the layout on it (two
    calls, one layout); a model packed after ``mle_update`` and
    ``split_to_target`` is laid out from its own live components and scores
    the updated model (against the host's float64 ``AmDiagGmm.loglike``)."""
    made = []
    layout = gmm_kernel.layout
    monkeypatch.setattr(gmm_kernel, "layout", lambda live: made.append(live) or layout(live))
    am = _port(_random_am(**CASES["ragged"]))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((200, am.dim)).astype(np.float32))
    gmm = TK.pack_gmm(am, "cpu")
    first = gmm_kernel.loglikes(x, gmm)
    torch.testing.assert_close(gmm_kernel.loglikes(x, gmm), first, rtol=0, atol=0)
    assert len(made) == 1
    pdf = torch.from_numpy(rng.integers(0, am.num_pdfs, 200))
    occ, macc, vacc, _ll = (t.numpy() for t in TK.acc_gmm_stats_aligned(
        gmm, x, pdf, am.num_pdfs, torch.ones(200)))
    am.mle_update(occ, macc, vacc, min_gaussian_occupancy=1.0)
    am.split_to_target(am.num_gauss + 20, occ, min_count=1.0, seed=1)
    new = TK.pack_gmm(am, "cpu")
    np.testing.assert_array_equal(new.live, am.weights > 0)
    with profiling.recording():
        got = gmm_kernel.loglikes(x, new).numpy()
    assert len(made) == 2
    np.testing.assert_array_equal(made[1], new.live)
    assert profiling.session().counters["gmm.live"] == 200 * am.num_gauss
    x64 = x.numpy().astype(np.float64)
    want = np.array([[am.loglike(p, f) for p in range(am.num_pdfs)] for f in x64])
    np.testing.assert_allclose(got, want, **GMM_TOL)
    assert np.abs(got - first.numpy()).max() > 1.0


def test_wrapper_rejects_other_devices():
    am = _random_am(num_pdfs=3, max_mix=2, dim=4)
    with pytest.raises(ValueError, match="unsupported device"):
        gmm_kernel.loglikes(torch.empty((5, 4), device="meta"), TK.pack_gmm(_port(am), "cpu"))


@pytest.mark.parametrize("max_mix", [1, 2, 5, 6, 7, 8, 11, 20])
def test_pack_weights_layout(max_mix):
    """The K2 wrapper's packing: slab r's column j holds the weights of the
    component ``lay.src[16 r + j]`` (``p * M + m``), K padded to a multiple
    of 8 with zeros; each sub-tile's slabs hold its pdfs' live components in
    order, then dead slots (zeros, gconst ``NEG``); live slots anywhere in a
    pdf, some pdfs with none."""
    rng = np.random.default_rng(max_mix)
    live = rng.random((37, max_mix)) < 0.6
    live[5] = False
    am = k2_cases.am_with_live(live, 13, seed=max_mix)
    w = TK.pack_gmm(am, "cpu").w
    lay = gmm_kernel.layout(live)
    wt, tiles, order = gmm_kernel.pack_weights(w, lay)
    np.testing.assert_array_equal(tiles.view(-1, 2).numpy(), lay.tiles)
    np.testing.assert_array_equal(order.numpy(), lay.order)
    assert wt.shape == (lay.tiles[:, 1].sum(), 32, 16)
    assert sorted(lay.order[lay.order >= 0]) == list(range(37))
    for s, (first, slabs) in enumerate(lay.tiles):
        for j, pdf in enumerate(lay.order[16 * s: 16 * s + 16]):
            comps = np.flatnonzero(live[pdf]) if pdf >= 0 else []
            for c in range(slabs):
                col = wt[first + c, :, j]
                if c < len(comps):
                    torch.testing.assert_close(col[:27], w[pdf, comps[c]], rtol=0, atol=0)
                    assert (col[27:] == 0).all()
                else:
                    assert col[26] == gmm_kernel.NEG
                    assert (col[:26] == 0).all() and (col[27:] == 0).all()


@pytest.mark.parametrize("case", k2_cases.CASES)
def test_layout_round_trips_live_components(case):
    """The layout of a model gives back each pdf's set of live components
    and their count; a sub-tile's slabs are its largest count (no rounding
    up), so the tile table never exceeds the dense one; the columns of each
    64-pdf tile hold that tile's pdfs, most components first; a uniform model
    gets one count a tile and the model order.  The benchmark's mixtures
    leave at least 0.8 of the slots live."""
    live = k2_cases.live_mask(case)
    p, m = live.shape
    lay = gmm_kernel.layout(live)
    s = -(-p // 16)
    count = live.sum(axis=1)
    first, slabs = lay.tiles[:, 0], lay.tiles[:, 1]
    assert lay.tiles.shape == (s, 2) and lay.order.shape == (16 * s,)
    np.testing.assert_array_equal(first, np.cumsum(slabs) - slabs)
    assert lay.src.size == 16 * slabs.sum() == lay.slots <= 16 * s * m
    assert (slabs <= m).all() and lay.live == live.sum()
    got = {}
    src = lay.src.reshape(-1, 16)
    for t in range(s):
        pdfs = lay.order[16 * t: 16 * t + 16]
        assert slabs[t] == max([count[q] for q in pdfs if q >= 0], default=0)
        assert ((pdfs < 0) | (pdfs // 64 == t // 4)).all()
        for j, pdf in enumerate(pdfs):
            held = src[first[t]: first[t] + slabs[t], j]
            if pdf < 0:
                assert (held == p * m).all()
                continue
            real = held[held < p * m]
            assert (real // m == pdf).all() and (held[len(real):] == p * m).all()
            got[int(pdf)] = list(real % m)
    assert got == {q: list(np.flatnonzero(live[q])) for q in range(p)}
    for t0 in range(0, 16 * s, 64):
        cols = lay.order[t0: t0 + 64]
        c = count[cols[cols >= 0]]
        assert (np.diff(c) <= 0).all()
    if (count == count[0]).all():
        assert (slabs == count[0]).all()
        np.testing.assert_array_equal(lay.order[:p], np.arange(p))
    if case.endswith("libri"):
        assert lay.live >= 0.8 * lay.slots


def _tf32_split(a):
    """The K2 kernel's operand split (``split`` in ``csrc/gmm_loglik.cu``):
    hi = a rounded to nearest TF32 (add 0x1000 to the bits, clear the low
    13), lo = the rest rounded the same way."""
    def rn(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32).astype(np.uint64)
        return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)
    hi = rn(a)
    return hi, rn(a - hi)


def test_tf32x3_halves_of_packed_weights():
    """The halves the 3xTF32 kernel makes of the packed Yes-No weights sum
    back to them within 2^-22 (hi keeps 10 mantissa bits), and the three
    products of the halves score the model's training features within the
    kernel's tolerance of float64, closer than fp32 does (the expanded form
    cancels terms of up to 1e4 there)."""
    m = load_yesno_mono()
    gmm = TK.pack_gmm(m.am, "cpu")
    lay = gmm_kernel.layout(gmm.live)
    wt = gmm_kernel.pack_weights(gmm.w, lay)[0].numpy()
    hi, lo = _tf32_split(wt)
    assert (hi.view(np.uint32) & 0x1FFF == 0).all() and (lo.view(np.uint32) & 0x1FFF == 0).all()
    np.testing.assert_array_less(np.abs(hi.astype(np.float64) + lo - wt), 2.0 ** -22 * np.abs(wt) + 1e-45)
    train, _test = make_corpus(**m.corpus)
    feats = make_features({u: w for u, (w, _) in train.items()}, {u: u for u in train},
                          MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0)),
                          device="cpu")
    x = torch.cat([feats[u] for u in sorted(feats)]).numpy()
    xx = np.concatenate([x, x * x, np.ones((len(x), 1), np.float32)], 1)
    p, mix, k = m.am.num_pdfs, m.am.max_mix, xx.shape[1]
    w = wt.transpose(1, 0, 2).reshape(wt.shape[1], -1)[:k]  # [K, slots]
    active = w[-1] > -1e29
    xh, xl = _tf32_split(xx)
    wh, wl = _tf32_split(w)

    def ll(scores):
        s = np.full((len(x), p * mix + 1), -1e30)
        s[:, lay.src[active]] = scores[:, active]
        return torch.logsumexp(torch.from_numpy(s[:, :-1].reshape(len(x), p, mix)), 2).numpy()

    exact = ll(xx.astype(np.float64) @ w.astype(np.float64))
    tol = GMM_TOL["atol"] + GMM_TOL["rtol"] * np.abs(exact)
    x64 = xh.astype(np.float64)
    three = ll(x64 @ wh + x64 @ wl + xl.astype(np.float64) @ wh)
    fp32 = ll((torch.from_numpy(xx) @ torch.from_numpy(w)).numpy())
    assert (np.abs(three - exact) / tol).max() < 1.0 < (np.abs(fp32 - exact) / tol).max()
