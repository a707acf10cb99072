"""N-best decoding and the windowed decode of the port against the JAX
package on the CPU: the plain version of K7 (``viterbi_nbest_forward``) on
random graphs and against a brute-force enumeration, the N-best walk (the
``backtrace_nbest`` plain version, through ``backtrace_nbest_device`` with and
without the graph's plan) against JAX ``backtrace_nbest`` on random
backpointer tables, a state of more than 32 in-arcs among them, the walk's
compact row starts, ``decode_nbest``
on the Yes-No fixture, and ``viterbi_decode_windowed`` against
``decode_batch``.

Tolerances: alpha_end rtol 1e-6 plus atol 4e-6, a few ulps of the partial
sums (about 10 here) that cancel in a small score (the same float32 additions
in the same order, but XLA may contract a multiply and an add), backpointers equal
wherever the port's slot is live and its score stands apart from its
neighbours in the state's list by more than that rounding, hypothesis scores
rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.config import DecodeOptions as JaxDecodeOptions
from voicebridge_tpu.fst.core import Fst as JaxFst
from voicebridge_tpu.models.gmm import AmDiagGmm as JaxAmDiagGmm
from voicebridge_tpu.models.topology import HmmTopology as JaxTopology
from voicebridge_tpu.models.transition import TransitionModel as JaxTransitionModel
from voicebridge_tpu.models.tree import load_tree as jax_load_tree
from voicebridge_tpu.ops import viterbi as JV
from voicebridge_tpu.steps.decode import Decoder as JaxDecoder

from voicebridge_tpu_torch.config import DecodeOptions, FrameOptions, MfccOptions
from voicebridge_tpu_torch.ops import decode_core as DC
from voicebridge_tpu_torch.ops import viterbi as V
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.testing import ASSET_DIR, load_yesno_mono

from synth import make_corpus
from test_viterbi_variants import random_graph

torch.set_num_threads(2)


def _port_graph(g) -> V.DenseGraph:
    return V.DenseGraph(**g._asdict())


def _jax_nbest(g, ll, nf, acwt, beam, nbest):
    levels = tuple(JV.build_reduction_plan(g.arc_dst, g.num_states).levels)
    return JV.viterbi_nbest_forward(
        jnp.asarray(g.arc_src), levels, jnp.asarray(g.arc_pdf), jnp.asarray(g.arc_score),
        jnp.asarray(g.alpha0), jnp.asarray(ll), jnp.asarray(nf), np.float32(acwt),
        np.float32(beam), g.num_states, nbest)


def _port_nbest(g, ll, nf, acwt, beam, nbest):
    plan = V.build_nbest_plan(_port_graph(g), "cpu")
    return V.viterbi_nbest_forward(plan, g.alpha0, torch.from_numpy(ll), nf, acwt, beam, nbest)


def _distinct_slots(g, ll, nf, acwt, beam, nbest):
    """[T, B, S, nbest] bool: the slot's score differs from both neighbours in
    its state's list by more than 1e-4 relative.  The list one longer gives
    the last slot its lower neighbour; its first ``nbest`` slots are the
    shorter list."""
    k = nbest + 1
    plan = V.build_nbest_plan(_port_graph(g), "cpu")
    b, t_total, _ = ll.shape
    s = g.num_states
    alpha = torch.full((s, b, k), V.NEG_INF)  # K7's lane-minor layout
    alpha[:, :, 0] = torch.from_numpy(g.alpha0)[:, None]
    alpha_end = torch.full_like(alpha, V.NEG_INF)
    nf_t = torch.from_numpy(nf)
    arc, slot = torch.empty((s, b, k), dtype=torch.int32), torch.empty((s, b, k), dtype=torch.int8)
    out = []
    for t in range(t_total):
        alpha, alpha_end = V.nbest_step(plan, alpha, alpha_end, torch.from_numpy(ll[:, t].T),
                                        nf_t, t, float(np.float32(acwt)),
                                        float(np.float32(beam)), arc, slot)
        a = alpha.permute(1, 0, 2).numpy().astype(np.float64)
        gap = np.abs(np.diff(a, axis=2)) > 1e-4 * (1.0 + np.abs(a[:, :, 1:]))  # [B, S, k-1]
        above = np.concatenate([np.ones((b, s, 1), bool), gap[:, :, :-1]], axis=2)
        out.append(above & gap)
    return np.stack(out)


@pytest.mark.parametrize("nbest,beam,seed", [(1, 1e9, 1), (3, 1e9, 2), (4, 1e9, 3),
                                             (4, 6.0, 4), (8, 3.0, 5)])
def test_nbest_forward_matches_jax(nbest, beam, seed):
    g = random_graph(num_states=50, arcs_per_state=4, num_pdfs=9, seed=seed)
    rng = np.random.default_rng(100 + seed)
    t = 14
    ll = rng.standard_normal((4, t, 9)).astype(np.float32) * 2
    nf = np.array([t, 9, 0, 1], np.int32)  # ragged, one empty
    ae_j, bpa_j, bps_j = _jax_nbest(g, ll, nf, 0.7, beam, nbest)
    ae_t, bpa_t, bps_t = _port_nbest(g, ll, nf, 0.7, beam, nbest)
    assert bpa_t.dtype == torch.int32 and bps_t.dtype == torch.int8
    ae_j, bpa_j, bps_j = np.asarray(ae_j), np.asarray(bpa_j), np.asarray(bps_j)
    np.testing.assert_allclose(ae_t.numpy(), ae_j, rtol=1e-6, atol=4e-6)
    # a live slot of the port (arc >= 0) whose score is distinct holds the JAX
    # package's provenance; dead slots and frames past an utterance's end
    # carry arc -1
    live = bpa_t.numpy() >= 0
    active = np.arange(t)[:, None] < nf[None, :]
    assert not live[~active].any()
    distinct = _distinct_slots(g, ll, nf, 0.7, beam, nbest)
    assert (live & distinct).sum() > 0.8 * live.sum() > 0
    live &= distinct
    np.testing.assert_array_equal(bpa_t.numpy()[live], bpa_j[live])
    np.testing.assert_array_equal(bps_t.numpy()[live], bps_j[live])
    # and the two backtraces agree hypothesis for hypothesis
    want = JV.backtrace_nbest(g, ae_j, bpa_j, bps_j, nf, nbest)
    got = V.backtrace_nbest(_port_graph(g), ae_t, bpa_t, bps_t, nf, nbest)
    dev = V.backtrace_nbest_device(_port_graph(g), ae_t, bpa_t, bps_t, nf, nbest)
    for w_i, g_i, d_i in zip(want, got, dev):
        assert [h["arcs"] for h in g_i] == [h["arcs"] for h in w_i]
        assert [h["arcs"] for h in d_i] == [h["arcs"] for h in w_i]
        assert [h["tids"] for h in d_i] == [h["tids"] for h in w_i]
        np.testing.assert_allclose([h["score"] for h in d_i], [h["score"] for h in w_i],
                                   rtol=1e-5)


def _random_nbest_tables(g, rng, t, b, k):
    """Backpointer tables as K7 lays them out ([T, S, B, K]) with random
    provenance: each slot an arc entering its state (or -1, one in ten) and
    a random source slot; end scores with dead slots and ties."""
    s = g.num_states
    by_dst = [np.flatnonzero(g.arc_dst == x) for x in range(s)]
    arc = np.full((t, s, b, k), -1, np.int32)
    for x in range(s):
        if len(by_dst[x]):
            arc[:, x] = rng.choice(by_dst[x], size=(t, b, k))
    arc[rng.random(arc.shape) < 0.1] = -1
    slot = rng.integers(0, k, arc.shape).astype(np.int8)
    alpha_end = np.round(rng.standard_normal((s, b, k)) * 4, 1).astype(np.float32)
    alpha_end[rng.random(alpha_end.shape) < 0.3] = V.NEG_INF
    return alpha_end, arc, slot


def _hub_graph(seed):
    """``random_graph`` of 12 states with 40 more arcs into state 3 (past the
    32 in-arcs a warp of the card's walk reads), arc ids shuffled."""
    g = random_graph(num_states=12, arcs_per_state=3, num_pdfs=4, seed=seed)
    rng = np.random.default_rng(seed)
    extra = 40
    src = np.concatenate([g.arc_src, rng.integers(0, 12, extra).astype(np.int32)])
    dst = np.concatenate([g.arc_dst, np.full(extra, 3, np.int32)])
    perm = rng.permutation(src.shape[0])
    more = lambda x, fill: np.concatenate([x, np.full(extra, fill, x.dtype)])[perm]  # noqa: E731
    return g._replace(arc_src=src[perm], arc_dst=dst[perm], arc_tid=more(g.arc_tid, 1),
                      arc_pdf=more(g.arc_pdf, 0), arc_score=more(g.arc_score, -1.0),
                      arc_oseq=more(g.arc_oseq, 0))


def _walk_against_jax(nbest, seed, graph, with_plan, monkeypatch=None):
    """``backtrace_nbest_device`` (its walk's plain version on the CPU) on
    views of K7's lane-minor tables against JAX ``backtrace_nbest`` on
    contiguous [T, B, S, K] copies: the same hypotheses (arcs, words, tids,
    scores), failed walks (arc -1) and duplicate arc sequences dropped
    alike; lanes of T, fewer and no frames.  ``with_plan``: the graph's
    ``NbestPlan`` is passed, and the graph the call sees has no final
    scores or arc sources (the plan's tables are read) and no plan is
    built."""
    rng = np.random.default_rng(seed)
    g = _hub_graph(seed) if graph == "hub" else random_graph(
        num_states=12, arcs_per_state=3, num_pdfs=4, seed=seed)
    g = g._replace(arc_oseq=rng.integers(0, 3, g.num_arcs).astype(np.int32),
                   oseqs=[(), (5,), (6, 7)], start_oseq=np.full(g.num_states, 1, np.int32),
                   final_oseq=rng.integers(0, 3, g.num_states).astype(np.int32))
    t, b = 6, 4
    nf = np.array([t, 3, 0, t - 1], np.int32)
    ae, arc, slot = _random_nbest_tables(g, rng, t, b, nbest)
    if graph == "hub":
        assert np.bincount(g.arc_dst)[3] > 32
        hub_in = np.flatnonzero(g.arc_dst == 3)
        arc[:, 3] = rng.choice(hub_in[32:], size=arc[:, 3].shape)
        ae[3] += 50.0  # the hub's entries lead each lane's list
    want = JV.backtrace_nbest(g, ae.transpose(1, 0, 2), arc.transpose(0, 2, 1, 3),
                              slot.transpose(0, 2, 1, 3), nf, nbest)
    port = _port_graph(g)
    kwargs = {}
    if with_plan:
        kwargs["plan"] = V.build_nbest_plan(port, "cpu")
        port = port._replace(final_score=None, arc_src=None)
        monkeypatch.setattr(V, "build_nbest_plan", None)
    got = V.backtrace_nbest_device(
        port, torch.from_numpy(ae).permute(1, 0, 2), torch.from_numpy(arc).permute(0, 2, 1, 3),
        torch.from_numpy(slot).permute(0, 2, 1, 3), nf, nbest, **kwargs)
    assert sum(len(h) for h in want) > b
    for w_i, g_i in zip(want, got):
        assert [h["arcs"] for h in g_i] == [h["arcs"] for h in w_i]
        assert [h["words"] for h in g_i] == [h["words"] for h in w_i]
        assert [h["tids"] for h in g_i] == [h["tids"] for h in w_i]
        assert [h["score"] for h in g_i] == [h["score"] for h in w_i]
    return want


@pytest.mark.parametrize("nbest,seed", [(2, 1), (4, 2), (5, 3)])
def test_nbest_walk_matches_jax_backtrace(nbest, seed):
    """``backtrace_nbest_device`` without a plan (one built for the call)
    against JAX ``backtrace_nbest`` (see ``_walk_against_jax``)."""
    _walk_against_jax(nbest, seed, "random", with_plan=False)


@pytest.mark.parametrize("nbest,seed", [(2, 1), (4, 2), (5, 3)])
def test_nbest_walk_with_plan_matches_jax_backtrace(monkeypatch, nbest, seed):
    """The same with the graph's ``NbestPlan`` passed: the call reads the
    plan's final scores and walk tables, not the graph's arrays."""
    _walk_against_jax(nbest, seed, "random", with_plan=True, monkeypatch=monkeypatch)


@pytest.mark.parametrize("with_plan", [False, True])
def test_nbest_walk_hub_state_matches_jax(monkeypatch, with_plan):
    """A state of 40-odd in-arcs whose backpointers all lie past its first
    32 (the card's walk takes its exact step there), walked from the hub's
    entries, with and without the plan, against JAX ``backtrace_nbest``."""
    want = _walk_against_jax(4, 7, "hub", with_plan, monkeypatch)
    assert any(h["arcs"] for hyps in want for h in hyps)


def test_compact_row_starts():
    """The walk's compact row starts give back ``in_start``; a group of
    states with 65536 in-arcs or more has no compact form."""
    rng = np.random.default_rng(0)
    for n in (1, 63, 64, 65, 1000):
        in_start = np.concatenate([[0], np.cumsum(rng.integers(0, 40, n - 1))]).astype(np.int32)
        base, off = V.compact_row_starts(in_start)
        assert base.shape[0] % 4 == 0 and off.shape[0] % 8 == 0 and off.shape[0] >= n
        got = base[np.arange(n) // V.WALK_GROUP] + off.view(np.uint16)[:n].astype(np.int64)
        np.testing.assert_array_equal(got, in_start)
    wide = np.array([0, 10, 70_000, 70_001], np.int32)
    assert V.compact_row_starts(wide)[1].shape == (0,)


def test_nbest_forward_layout():
    """``viterbi_nbest_forward`` returns its documented shapes, the
    backpointers as views of K7's lane-minor [T, S, B, K] tables, and the
    window's plain version gives what its frames give one at a time."""
    g = random_graph(num_states=20, arcs_per_state=3, num_pdfs=5, seed=4)
    ll = np.random.default_rng(5).standard_normal((3, 7, 5)).astype(np.float32)
    nf = np.array([7, 4, 0], np.int32)
    ae, arc, slot = _port_nbest(g, ll, nf, 0.6, 1e9, 3)
    assert ae.shape == (3, 20, 3) and arc.shape == slot.shape == (7, 3, 20, 3)
    assert arc.permute(0, 2, 1, 3).is_contiguous() and slot.permute(0, 2, 1, 3).is_contiguous()
    plan = V.build_nbest_plan(_port_graph(g), "cpu")
    alpha = torch.full((20, 3, 3), V.NEG_INF)
    alpha[:, :, 0] = torch.from_numpy(g.alpha0)[:, None]
    end = torch.where(torch.from_numpy(nf == 0)[None, :, None], alpha, V.NEG_INF)
    ll_w = torch.from_numpy(ll.transpose(1, 2, 0).copy())
    step_arc = torch.empty((7, 20, 3, 3), dtype=torch.int32)
    step_slot = torch.empty((7, 20, 3, 3), dtype=torch.int8)
    a_s, e_s = alpha, end
    for i in range(7):
        a_s, e_s = V.nbest_step(plan, a_s, e_s, ll_w[i], torch.from_numpy(nf), i,
                                float(np.float32(0.6)), 1e9, step_arc[i], step_slot[i])
    assert torch.equal(e_s, ae.permute(1, 0, 2))
    assert torch.equal(step_arc, arc.permute(0, 2, 1, 3))
    assert torch.equal(step_slot, slot.permute(0, 2, 1, 3))


def _brute_force_paths(g, ll, acwt, t_end, topn):
    """All T-length arc paths from the start to a final state, best first."""
    by_src = {}
    for i in range(g.num_arcs):
        by_src.setdefault(int(g.arc_src[i]), []).append(i)
    init = int(np.argmax(g.alpha0))
    results = []

    def dfs(s, t, score, arcs):
        if t == t_end:
            if g.final_score[s] > V.NEG_INF / 2:
                results.append((score + g.final_score[s], tuple(arcs)))
            return
        for i in by_src.get(s, ()):
            dfs(int(g.arc_dst[i]), t + 1,
                score + g.arc_score[i] + acwt * ll[t, g.arc_pdf[i]], arcs + [i])

    dfs(init, 0, float(g.alpha0[init]), [])
    results.sort(key=lambda x: -x[0])
    return results[:topn]


@pytest.mark.parametrize("seed,nbest", [(9, 4), (11, 2), (12, 6)])
def test_nbest_matches_bruteforce(seed, nbest):
    g = random_graph(num_states=8, arcs_per_state=3, num_pdfs=4, seed=seed)
    t = 6
    ll = np.random.default_rng(seed).standard_normal((1, t, 4)).astype(np.float32) * 2
    nf = np.array([t], np.int32)
    ae, bpa, bps = _port_nbest(g, ll, nf, 1.0, 1e9, nbest)
    hyps = V.backtrace_nbest_device(_port_graph(g), ae, bpa, bps, nf, nbest)[0]
    want = _brute_force_paths(g, ll[0], 1.0, t, nbest)
    assert len(hyps) == min(nbest, len(want)) and hyps
    np.testing.assert_allclose([h["score"] for h in hyps], [w[0] for w in want],
                               rtol=1e-4, atol=1e-3)
    assert [tuple(h["arcs"]) for h in hyps] == [w[1] for w in want]


def test_nbest_1_equals_best_path():
    g = _port_graph(random_graph(num_states=30, arcs_per_state=4, num_pdfs=6, seed=2))
    rng = np.random.default_rng(3)
    t = 12
    ll = torch.from_numpy(rng.standard_normal((2, t, 6)).astype(np.float32))
    nf = np.array([t, t - 3], np.int32)
    plan = DC.build_emit_plan(g)
    ref = DC.decode_best_path(g, plan, DC.plan_to_device(plan, "cpu"), ll, nf, 0.7)
    ae, bpa, bps = V.viterbi_nbest_forward(V.build_nbest_plan(g, "cpu"), g.alpha0, ll, nf,
                                           0.7, 1e9, 3)
    nb = V.backtrace_nbest_device(g, ae, bpa, bps, nf, 3)
    for r, hyps in zip(ref, nb):
        assert r["score"] > -np.inf
        assert abs(hyps[0]["score"] - r["score"]) < 1e-3
        assert hyps[0]["tids"] == r["tids"]
        scores = [h["score"] for h in hyps]
        assert scores == sorted(scores, reverse=True)
        assert len({tuple(h["arcs"]) for h in hyps}) == len(hyps)


@pytest.fixture(scope="module")
def yesno():
    m = load_yesno_mono()
    jtm = JaxTransitionModel(JaxTopology.load(ASSET_DIR / "topo.json"),
                             jax_load_tree(ASSET_DIR / "tree.json"))
    jtm.load_probs(ASSET_DIR / "trans.json")
    _train, test = make_corpus(**m.corpus)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    waves = {u: w for u, (w, _) in test.items()}
    utts = sorted(test)
    feats, nf = pad_features(make_features(waves, {u: u for u in test}, opts, device="cpu"),
                             utts)
    return {"model": m, "utts": utts, "feats": feats, "nf": nf,
            "port": Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(), device="cpu"),
            "jax": JaxDecoder(JaxFst.load(ASSET_DIR / "hclg.npz"), jtm,
                              JaxAmDiagGmm.load(ASSET_DIR / "am.npz"), JaxDecodeOptions())}


@pytest.mark.parametrize("nbest,batch_chunk", [(3, None), (3, 3), (8, 5)])
def test_decode_nbest_matches_jax(yesno, nbest, batch_chunk):
    """The same features through both decoders (default beam 13): the same
    word lists, scores within rtol 1e-5, whatever the batch split."""
    utts, feats, nf = yesno["utts"], yesno["feats"], yesno["nf"]
    got = yesno["port"].decode_nbest(utts, feats, nf, nbest=nbest, batch_chunk=batch_chunk)
    want = yesno["jax"].decode_nbest(utts, feats.numpy(), nf.numpy(), nbest=nbest)
    m = yesno["model"]
    for u in utts:
        assert got[u], f"no n-best hypotheses for {u}"
        assert [w for w, _ in got[u]] == [w for w, _ in want[u]]
        np.testing.assert_allclose([s for _, s in got[u]], [s for _, s in want[u]], rtol=1e-5)
        assert [m.words.sym(w) for w in got[u][0][0]] == m.hyps[u]
        scores = [s for _, s in got[u]]
        assert scores == sorted(scores, reverse=True)


@pytest.mark.parametrize("window", [3, 8, None])
def test_windowed_decode_equals_decode_batch(yesno, window):
    utts, feats, nf = yesno["utts"], yesno["feats"], yesno["nf"]
    dec = yesno["port"]
    want = dec.decode_batch(utts, feats, nf, keep_tids=True)
    ll = dec._loglikes(feats)
    w = int(feats.shape[1]) if window is None else window
    got = V.viterbi_decode_windowed(dec.graph, dec.plan, dec.plan_dev, ll, nf.numpy(),
                                    dec.opts.acoustic_scale, 1e9, window=w)
    for r, g in zip(want, got):
        assert g["words"] == r.words and g["tids"] == r.tids
        assert g["score"] == r.score


def test_windowed_decode_pruned_matches_jax():
    """With a finite beam the frame step prunes as the JAX package's does."""
    g = random_graph(num_states=40, arcs_per_state=4, num_pdfs=9, seed=3)
    rng = np.random.default_rng(8)
    ll = rng.standard_normal((4, 33, 9)).astype(np.float32) * 2
    nf = np.array([33, 20, 8, 0], np.int32)
    levels = tuple(JV.build_reduction_plan(g.arc_dst, g.num_states).levels)
    pg = _port_graph(g)
    plan = DC.build_emit_plan(pg)
    for beam, max_active in ((4.0, 0), (1e9, 0), (6.0, 7)):
        want = JV.viterbi_decode_windowed(g, levels, jnp.asarray(ll), nf, 0.8, beam, window=8,
                                          max_active=max_active)
        got = V.viterbi_decode_windowed(pg, plan, DC.plan_to_device(plan, "cpu"),
                                        torch.from_numpy(ll), nf, 0.8, beam, window=8,
                                        max_active=max_active)
        for w_i, g_i in zip(want, got):
            assert g_i["tids"] == w_i["tids"]
            np.testing.assert_allclose(g_i["score"], w_i["score"], rtol=1e-5)


def test_wrappers_reject_other_devices():
    g = _port_graph(random_graph(num_states=6, arcs_per_state=2, num_pdfs=3, seed=1))
    plan = V.build_nbest_plan(g, "cpu")
    meta = torch.empty((1, 6, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        V.nbest_step(plan, meta, meta, meta, meta, 0, 1.0, 1e9, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        V.viterbi_forward_batched(np.zeros((1, 2)), np.zeros((1, 2)), np.zeros((1, 2)),
                                  np.zeros((1, 2)), np.zeros((1, 3)),
                                  torch.empty((1, 2, 3), device="meta"), [2], 1.0, 1e9, 3)
    with pytest.raises(ValueError, match="unsupported device"):
        V.backtrace_batched_device(np.zeros((1, 2)), meta, meta,
                                   torch.empty((2, 1, 3), device="meta"), [2])
