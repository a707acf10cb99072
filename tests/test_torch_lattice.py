"""Parity of the port's lattice generation with the JAX package's, on the
CPU, where the K5 wrapper takes its plain version: the lattice plans array
for array, one phase-2 window (K5's module) against JAX ``_fb_win_backward``,
the whole row-based forward-backward against JAX
``lattice_forward_backward_rows`` (identical arc_t/arc_id arrays after host
assembly, over window sizes and edge lanes), the brute-force survivor set on
``tests/test_lattice.py``'s tiny graph, the copied lattice algebra on the
same ``Lattice`` arrays, and the Yes-No fixture end to end through
``decode_sweep_lattice`` and ``decode_mbr``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu import lat as JL
from voicebridge_tpu.config import DecodeOptions, FrameOptions, MfccOptions
from voicebridge_tpu.ops import decode_core as JDC
from voicebridge_tpu.ops import lattice as JLAT
from voicebridge_tpu.ops import viterbi as JV
from voicebridge_tpu.steps.decode import Decoder as JaxDecoder
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu.steps.score import score_sweep
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch import lat as TL
from voicebridge_tpu_torch.ops import lattice as LAT
from voicebridge_tpu_torch.ops.graph import NEG_INF, compile_dense_graph
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.testing import load_yesno_mono, synth_decode_graph

from synth import make_corpus
from test_lattice import enumerate_paths, tiny_graph

torch.set_num_threads(2)


def _jax_graph(g):
    return JV.DenseGraph(**g._asdict())


def _assert_same_tuple(a, b):
    assert type(a)._fields == type(b)._fields
    for name in type(a)._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


def _graph(which):
    if which == "tiny":
        return compile_dense_graph(*tiny_graph())
    if which == "yesno":
        m = load_yesno_mono()
        return compile_dense_graph(m.hclg, m.trans_model.tid2pdf)
    return synth_decode_graph(2000, num_pdfs=50)


@pytest.mark.parametrize("which", ["tiny", "yesno", "synth2000"])
def test_lattice_plans_match_jax(which):
    g = _graph(which)
    fwd, _fd, bwd, _bd, row_dst = LAT.build_lattice_plans(g, device="cpu")
    jfwd, _jfd, jbwd, _jbd, jrow_dst = JLAT.build_lattice_plans(_jax_graph(g))
    _assert_same_tuple(fwd, convert.emit_plan_from_jax(jfwd))
    _assert_same_tuple(bwd, convert.emit_plan_from_jax(jbwd))
    assert row_dst.dtype == jrow_dst.dtype
    np.testing.assert_array_equal(row_dst, jrow_dst)


def _fb_graph():
    """300 states, every arc jumping 1..63 states on; only states >= 250 are
    final, so a lane of 3 frames or fewer cannot reach a final state."""
    g = synth_decode_graph(300, arcs_per_state=6, num_pdfs=20, seed=4)
    final = np.full(300, NEG_INF, np.float32)
    final[250:] = -np.random.default_rng(5).random(50).astype(np.float32)
    return g._replace(final_score=final)


T_FB = 21
NF_FB = np.array([0, 1, T_FB - 3, T_FB, 3], np.int32)  # lanes 0, 1 and 4 reach no final


@pytest.fixture(scope="module")
def fb_inputs():
    g = _fb_graph()
    plans = LAT.build_lattice_plans(g, d=4, device="cpu")
    ll = (np.random.default_rng(6).standard_normal((len(NF_FB), T_FB, 20)) * 3
          ).astype(np.float32)
    return g, plans, ll


@pytest.mark.parametrize("window", [4, 8, 5])
def test_forward_backward_matches_jax(fb_inputs, window):
    """Identical survivors (arc_t, arc_id and acoustic costs per lattice),
    total_best within 1e-6 and the same use_final as the JAX package, for
    windows that do not divide T, lanes of 0, 1, T-3 and T frames, and lanes
    whose final states are unreachable."""
    g, plans, ll = fb_inputs
    acwt, lbeam = 0.5, 3.0
    fwd, fwd_dev, bwd, bwd_dev, row_dst = plans
    surv, best, at_end, use_final = LAT.lattice_forward_backward_rows(
        g, fwd, fwd_dev, bwd, bwd_dev, row_dst, torch.from_numpy(ll), NF_FB, acwt, lbeam,
        window=window)
    lats = LAT.survivor_lattices(g, surv, NF_FB, use_final, torch.from_numpy(ll))
    jfwd, jfwd_dev, jbwd, jbwd_dev, jrow_dst = JLAT.build_lattice_plans(_jax_graph(g), d=4)
    packed, jbest, jat_end, juse_final = JLAT.lattice_forward_backward_rows(
        _jax_graph(g), jfwd, jfwd_dev, jbwd, jbwd_dev, jrow_dst, jnp.asarray(ll), NF_FB,
        acoustic_scale=acwt, lattice_beam=lbeam, window=window)
    jlats = JL.build_lattices_packed(_jax_graph(g), jfwd.row_arc, packed, ll, NF_FB, juse_final)
    np.testing.assert_array_equal(use_final.numpy(), juse_final)
    assert list(juse_final) == [False, False, True, True, False]
    np.testing.assert_allclose(best.numpy(), jbest, rtol=1e-6, atol=0)
    np.testing.assert_allclose(at_end.numpy(), jat_end, rtol=1e-6, atol=0)
    assert sum(lat.num_arcs for lat in lats) > 2 * T_FB
    for lat, jlat in zip(lats, jlats):
        assert lat.nf == jlat.nf and lat.use_final == jlat.use_final
        np.testing.assert_array_equal(lat.arc_t, jlat.arc_t)
        np.testing.assert_array_equal(lat.arc_id, jlat.arc_id)
        np.testing.assert_array_equal(lat.acoustic_cost, jlat.acoustic_cost)
    assert lats[0].num_arcs == 0
    for lat in lats[1:]:
        assert (TL.lattice_depth_per_frame(lat) >= 1).all()


def test_k5_window_matches_jax_window(fb_inputs):
    """One phase-2 window through the K5 module (``fb_window``: K3 over the
    backward plan, then ``fb_frame``) against JAX ``_fb_win_backward`` on the
    same snapshot, beta carry and thresholds: beta at the window start within
    1e-6 and the same survivor bits."""
    g, plans, ll = fb_inputs
    fwd, fwd_dev, bwd, bwd_dev, row_dst = plans
    rng = np.random.default_rng(8)
    s1, b, w, t0 = fwd.num_states + 1, len(NF_FB), 6, 10
    nf = np.array([0, 11, 16, 12, 21], np.int32)  # ends before, inside and after the window
    snap = (rng.standard_normal((s1, b)) * 4 - 20).astype(np.float32)
    snap[rng.random((s1, b)) < 0.3] = NEG_INF
    snap[-1] = NEG_INF
    beta = (rng.standard_normal((s1, b)) * 4 - 10).astype(np.float32)
    final_eff = np.where(rng.random((s1, b)) < 0.5, 0.0, NEG_INF).astype(np.float32)
    thresh = np.full(b, -25.0, np.float32)
    ll_win = np.ascontiguousarray(ll[:, t0:t0 + w].transpose(1, 2, 0))  # [W, P, B]
    acwt = float(np.float32(0.5))
    words = torch.empty((w, fwd.num_rows, b), dtype=torch.uint8)
    tplans = (fwd, fwd_dev, bwd, bwd_dev, torch.from_numpy(row_dst))
    beta_lo = LAT.fb_window(tplans, torch.from_numpy(snap), torch.from_numpy(beta),
                            torch.from_numpy(ll_win), t0, torch.from_numpy(nf),
                            torch.from_numpy(final_eff), torch.from_numpy(thresh), acwt, words)
    jfwd, jfwd_dev, jbwd, jbwd_dev, jrow_dst = JLAT.build_lattice_plans(_jax_graph(g), d=4)
    jbeta, bits = JLAT._fb_win_backward(
        jfwd_dev, jbwd_dev, jnp.asarray(jrow_dst), jnp.asarray(snap), jnp.asarray(beta),
        jnp.asarray(ll_win), jnp.int32(t0), jnp.asarray(nf), jnp.asarray(final_eff),
        jnp.asarray(thresh), jnp.float32(acwt), jfwd.rspec, jbwd.rspec)
    np.testing.assert_allclose(beta_lo.numpy(), np.asarray(jbeta), rtol=1e-6, atol=0)
    keep = (words.numpy()[:, :, None, :] >> np.arange(fwd.d)[None, None, :, None]) & 1
    got = np.packbits(keep.reshape(w, -1, b).astype(bool), axis=1)
    np.testing.assert_array_equal(got, np.asarray(bits))
    assert got.any()


def test_bwd_window_matches_jax(fb_inputs):
    """``bwd_window`` (its plain version on the CPU) against the JAX package
    on the same numpy inputs: beta at the window start against
    ``_fb_win_backward``'s within 1e-6, and the beta_eff slab against the
    values ``bwd_frame`` scans out (the same select and
    ``emit_value_step``), for lanes that end before, inside and after the
    window."""
    g, plans, ll = fb_inputs
    fwd, _fd, bwd, bwd_dev, _row_dst = plans
    rng = np.random.default_rng(11)
    s1, b, w, t0 = fwd.num_states + 1, len(NF_FB), 6, 10
    nf = np.array([0, 11, 16, 13, 21], np.int32)
    snap = np.full((s1, b), NEG_INF, np.float32)
    beta = (rng.standard_normal((s1, b)) * 4 - 10).astype(np.float32)
    final_eff = np.where(rng.random((s1, b)) < 0.5, 0.0, NEG_INF).astype(np.float32)
    ll_win = np.ascontiguousarray(ll[:, t0:t0 + w].transpose(1, 2, 0))  # [W, P, B]
    acwt = float(np.float32(0.5))
    slab = torch.full((w, s1, b), 7.0)
    beta_lo = LAT.bwd_window(torch.from_numpy(beta), torch.from_numpy(ll_win), bwd_dev,
                             torch.from_numpy(nf), t0, acwt, bwd.rspec, bwd.packed,
                             torch.from_numpy(final_eff), slab)
    jfwd, jfwd_dev, jbwd, jbwd_dev, jrow_dst = JLAT.build_lattice_plans(_jax_graph(g), d=4)
    jbeta, _bits = JLAT._fb_win_backward(
        jfwd_dev, jbwd_dev, jnp.asarray(jrow_dst), jnp.asarray(snap), jnp.asarray(beta),
        jnp.asarray(ll_win), jnp.int32(t0), jnp.asarray(nf), jnp.asarray(final_eff),
        jnp.full(b, -25.0, jnp.float32), jnp.float32(acwt), jfwd.rspec, jbwd.rspec)
    np.testing.assert_allclose(beta_lo.numpy(), np.asarray(jbeta), rtol=1e-6, atol=0)
    bt, want = jnp.asarray(beta), [None] * w
    for i in range(w - 1, -1, -1):  # bwd_frame, frame by frame
        t = t0 + i
        eff = jnp.where(jnp.asarray(t + 1 == nf)[None, :], jnp.asarray(final_eff), bt)
        want[i] = np.asarray(eff)
        nb = JDC.emit_value_step(eff, jnp.asarray(ll_win[i]), jbwd_dev, jnp.float32(acwt),
                                 jbwd.rspec)
        bt = jnp.where(jnp.asarray(t < nf)[None, :], nb, bt)
    np.testing.assert_allclose(np.asarray(bt), np.asarray(jbeta), rtol=1e-6, atol=0)
    np.testing.assert_allclose(slab.numpy(), np.stack(want), rtol=1e-6, atol=0)


def test_tiny_graph_lattices_equal_brute_force():
    """The port's lattices on the tiny graph hold exactly the arc instances
    of the complete paths within the lattice beam (the set of
    ``tests/test_lattice.py``), and its best totals agree."""
    g = compile_dense_graph(*tiny_graph())
    rng = np.random.default_rng(42)
    t, p = 7, 3
    ll = rng.normal(size=(2, t, p)).astype(np.float32) * 2.0
    nf = np.asarray([t, t - 2], np.int32)
    lbeam = 4.0
    plans = LAT.build_lattice_plans(g, device="cpu")
    surv, best, _end, use_final = LAT.lattice_forward_backward_rows(
        g, *plans, torch.from_numpy(ll), nf, 1.0, lbeam, window=4)
    for i, lat in enumerate(LAT.survivor_lattices(g, surv, nf, use_final, torch.from_numpy(ll))):
        paths = enumerate_paths(g, int(nf[i]), ll[i], 1.0)
        top = max(sc for sc, _a, _w in paths)
        expect = {(ti, a) for sc, arcs, _w in paths if sc >= top - lbeam - 1e-4
                  for ti, a in enumerate(arcs)}
        assert set(zip(lat.arc_t.tolist(), lat.arc_id.tolist())) == expect
        assert abs(float(best[i]) - top) < 1e-3


def _jax_lattice(lat):
    return JL.Lattice(graph=_jax_graph(lat.graph), nf=lat.nf, arc_t=lat.arc_t,
                      arc_id=lat.arc_id, acoustic_cost=lat.acoustic_cost,
                      use_final=lat.use_final)


def _same_paths(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x["words"] == y["words"] and x["tids"] == y["tids"] and x["arcs"] == y["arcs"]
        assert x["score"] == y["score"]


@pytest.fixture(scope="module")
def yesno():
    m = load_yesno_mono()
    _train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    dopts = DecodeOptions(beam=1e9)
    waves = {u: w for u, (w, _) in test.items()}
    utt2spk = {u: u for u in test}
    utts = sorted(test)
    feats, nf = pad_features(make_features(waves, utt2spk, opts, device="cpu"), utts)
    jfeats = jax_make_features(waves, utt2spk, opts)
    jbatch = np.zeros((len(utts), max(f.shape[0] for f in jfeats.values()), 39), np.float32)
    for i, u in enumerate(utts):
        jbatch[i, : jfeats[u].shape[0]] = jfeats[u]
    port = Decoder(m.hclg, m.trans_model, m.am, dopts, device="cpu")
    jax = JaxDecoder(m.hclg, m.trans_model, m.am, dopts)
    grid = dict(lmwts=[7, 10, 13], word_ins_penalties=(0.0, 0.5, 1.0))
    sweep, lats = port.decode_sweep_lattice(utts, feats, nf, **grid)
    jsweep, jlats = jax.decode_sweep_lattice(utts, jbatch, nf.numpy(), **grid)
    return dict(m=m, port=port, jax=jax, utts=utts, feats=feats, nf=nf, jfeats=jbatch,
                refs={u: list(test[u][1]) for u in utts}, sweep=sweep, lats=lats,
                jsweep=jsweep, jlats=jlats)


def _gammas(lat, ll, acwt, beam):
    """gamma - (best - beam) in float64 for every (t, arc) of the graph, by a
    dense max-plus forward-backward over the utterance ([nf, A])."""
    g = lat.graph
    n, s = lat.nf, g.num_states
    src, dst = g.arc_src.astype(np.int64), g.arc_dst.astype(np.int64)
    am = acwt * ll[:n][:, g.arc_pdf].astype(np.float64)
    w = g.arc_score.astype(np.float64)
    alphas = [np.where(g.alpha0 > NEG_INF / 2, g.alpha0.astype(np.float64), -np.inf)]
    for t in range(n):
        a = np.full(s, -np.inf)
        np.maximum.at(a, dst, alphas[-1][src] + w + am[t])
        alphas.append(a)
    fs = np.where(g.final_score > NEG_INF / 2, g.final_score.astype(np.float64), -np.inf)
    beta = fs if lat.use_final else np.zeros(s)
    best = np.max(alphas[-1] + beta)
    out = np.empty((n, len(src)))
    for t in range(n - 1, -1, -1):
        out[t] = alphas[t][src] + w + am[t] + beta[dst]
        nb = np.full(s, -np.inf)
        np.maximum.at(nb, src, w + am[t] + beta[dst])
        beta = nb
    return out - (best - beam)


def test_yesno_survivors_match_jax(yesno):
    """The features of the two packages differ by about 1e-6, so the
    survivor sets may differ only in arc instances whose gamma lies within
    1e-4 of the threshold; they are counted and printed."""
    dec = yesno["port"]
    ll = dec._loglikes(yesno["feats"]).numpy()
    near, total = 0, 0
    for i, u in enumerate(yesno["utts"]):
        lat, jlat = yesno["lats"][u], yesno["jlats"][u]
        assert lat.use_final == jlat.use_final and lat.nf == jlat.nf
        got = set(zip(lat.arc_t.tolist(), lat.arc_id.tolist()))
        want = set(zip(jlat.arc_t.tolist(), jlat.arc_id.tolist()))
        total += len(got)
        diff = got ^ want
        if diff:
            gam = _gammas(lat, ll[i], dec.opts.acoustic_scale, dec.opts.lattice_beam)
            assert all(abs(gam[t, a]) < 1e-4 for t, a in diff), u
            near += len(diff)
        assert (TL.lattice_depth_per_frame(lat) >= 1).all()
    print(f"yes-no survivors: {total}, differing from the JAX package's: {near}")
    assert total > 0


def test_yesno_sweep_matches_jax_and_fixture(yesno):
    m, utts = yesno["m"], yesno["utts"]

    def words(sweep):
        return {gp: {r.utt: [m.words.sym(w) for w in r.words] for r in rs}
                for gp, rs in sweep.items()}

    hyps, jhyps = words(yesno["sweep"]), words(yesno["jsweep"])
    assert len(hyps) == 9 and hyps == jhyps
    res, jres = score_sweep(yesno["refs"], hyps), score_sweep(yesno["refs"], jhyps)
    assert (res.best_lmwt, res.best_wip) == (jres.best_lmwt, jres.best_wip)
    assert res.best_wer.wer == jres.best_wer.wer and res.best_wer.wer <= 5.0
    acwt = yesno["port"].opts.acoustic_scale
    for u in utts:
        bp = TL.lattice_best_path(yesno["lats"][u], 1.0, acwt)
        assert [m.words.sym(w) for w in bp["words"]] == m.hyps[u], u


def test_yesno_mbr_matches_jax(yesno):
    got = yesno["port"].decode_mbr(yesno["utts"], yesno["feats"], yesno["nf"])
    want = yesno["jax"].decode_mbr(yesno["utts"], yesno["jfeats"], yesno["nf"].numpy())
    assert [r.words for r in got] == [r.words for r in want]
    assert [r.utt for r in got] == yesno["utts"]


def test_decode_lattice_sub_batches_agree(yesno, monkeypatch):
    """Sub-batches of 3 utterances give the lattices of one batch."""
    dec = yesno["port"]
    monkeypatch.setattr(dec, "_lattice_chunk", lambda t, d: 3)
    lats = dec.decode_lattice(yesno["utts"], yesno["feats"], yesno["nf"])
    for u in yesno["utts"]:
        a, b = lats[u], yesno["lats"][u]
        np.testing.assert_array_equal(a.arc_t, b.arc_t)
        np.testing.assert_array_equal(a.arc_id, b.arc_id)
        np.testing.assert_array_equal(a.acoustic_cost, b.acoustic_cost)


@pytest.mark.parametrize("source", ["tiny", "yesno"])
def test_lattice_algebra_matches_jax(yesno, source):
    """The copied best-path grid, MBR, N-best and depth equal the JAX
    package's on the same Lattice arrays."""
    if source == "yesno":
        lats = [yesno["lats"][u] for u in yesno["utts"][:3]]
    else:
        g = compile_dense_graph(*tiny_graph())
        ll = np.random.default_rng(3).normal(size=(2, 9, 3)).astype(np.float32) * 2.0
        nf = np.array([9, 6], np.int32)
        surv, _b, _e, uf = LAT.lattice_forward_backward_rows(
            g, *LAT.build_lattice_plans(g, device="cpu"), torch.from_numpy(ll), nf, 1.0, 5.0)
        lats = LAT.survivor_lattices(g, surv, nf, uf, torch.from_numpy(ll))
    points = [(1.0, 1.0 / w, wip) for w in (7, 10, 13) for wip in (0.0, 0.5)] + [(1.0, 1.0, 0)]
    for lat in lats:
        jlat = _jax_lattice(lat)
        _same_paths(TL.lattice_best_path_grid(lat, points), JL.lattice_best_path_grid(jlat, points))
        assert TL.lattice_mbr(lat, n=8, acoustic_scale=0.1) == JL.lattice_mbr(
            jlat, n=8, acoustic_scale=0.1)
        assert TL.lattice_nbest(lat, 4) == JL.lattice_nbest(jlat, 4)
        np.testing.assert_array_equal(TL.lattice_depth_per_frame(lat),
                                      JL.lattice_depth_per_frame(jlat))


def test_k5_wrapper_rejects_other_devices(fb_inputs):
    _g, (fwd, fwd_dev, _bwd, _bd, row_dst), _ll = fb_inputs
    s1, b = fwd.num_states + 1, 2
    meta = torch.empty((s1, b), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        LAT.fb_frame(meta, torch.empty((20, b)), fwd_dev, torch.from_numpy(row_dst), meta,
                     torch.zeros(b, dtype=torch.int32), 0, 1.0, torch.zeros(b), fwd.rspec,
                     torch.empty((fwd.num_rows, b), dtype=torch.uint8))
