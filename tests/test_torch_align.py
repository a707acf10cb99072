"""Parity of the port's alignment (``ops/align_band.py``, ``ops/viterbi.py``,
``steps/align.py``) with the JAX package's on the same inputs, on the CPU.

The band plans are equal array for array; the banded forward (the plain
version of K4) gives bit-equal alpha_end and equal uint8 band-slot codes,
and its backtrace equal arcs, end states, ok flags and bit-equal scores.
The cases are those of ``tests/test_align_band.py`` plus negative offsets,
empty utterances and a graph with no path.  On the committed Yes-No model,
``AlignmentSet.align_feats`` gives the JAX package's transition ids; the
generic aligner matches ``viterbi_forward_batched`` on a non-banded set.  The
device plan keeps its pdf range on the host, and a plan whose pdfs reach past
the logliks is refused on either device."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.config import FrameOptions, LangOptions, MfccOptions
from voicebridge_tpu.data.lang import prepare_lang
from voicebridge_tpu.fst.hclg import TrainingGraphCompiler
from voicebridge_tpu.ops import align_band as JAB
from voicebridge_tpu.ops import gmm_kernels as JK
from voicebridge_tpu.ops import viterbi as JV
from voicebridge_tpu.steps import align as JA
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.ops import align_band as AB
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.ops import viterbi as V
from voicebridge_tpu_torch.steps import align as A
from voicebridge_tpu_torch.testing import (load_yesno_mono, random_am, random_band_walk,
                                           synth_train_graph)
from voicebridge_tpu_torch.utils import health
from voicebridge_tpu_torch.utils import profiling as P

from synth import LEXICON, make_corpus
from test_align_band import _random_banded_graph

torch.set_num_threads(2)


def _chain_graph(n_states, num_pdfs=11, seed=0):
    """Left-to-right chain without skips: a path needs >= n_states frames."""
    rng = np.random.default_rng(seed)
    g = _random_banded_graph(rng, n_states, band=(0, 0), num_pdfs=num_pdfs)
    keep = (g.arc_dst == g.arc_src) | (g.arc_dst == g.arc_src + 1)
    return g._replace(**{f: getattr(g, f)[keep] for f in
                         ("arc_src", "arc_dst", "arc_tid", "arc_pdf", "arc_score", "arc_oseq")})


def _case(name):
    rng = np.random.default_rng({"random": 1, "multi_chunk": 8, "negative_offsets": 3,
                                 "empty_utterance": 4, "no_path": 5}[name])
    t = 37
    if name == "multi_chunk":
        graphs, t = [_random_banded_graph(rng, 120) for _ in range(3)], 300
    elif name == "negative_offsets":
        graphs = [_random_banded_graph(rng, 30, band=(-6, 6)) for _ in range(4)]
    elif name == "no_path":
        graphs = [_random_banded_graph(rng, 12), _chain_graph(50), _random_banded_graph(rng, 9)]
    else:
        graphs = [_random_banded_graph(rng, int(rng.integers(8, 40))) for _ in range(7)]
    nf = rng.integers(max(5, t // 2), t + 1, size=len(graphs)).astype(np.int32)
    nf[0] = t
    if name == "empty_utterance":
        nf[[1, 4]] = 0
    ll = rng.standard_normal((len(graphs), t, 11)).astype(np.float32)
    return graphs, ll, nf


CASES = ["random", "multi_chunk", "negative_offsets", "empty_utterance", "no_path"]


def _jax_banded(plan, ll, nf, acwt):
    """The JAX forward + backtrace (T padded to its 128-frame chunk)."""
    b, t, p = ll.shape
    t_pad = -(-t // 128) * 128
    llp = np.zeros((b, t_pad, p), np.float32)
    llp[:, :t] = ll
    alpha_end, bps = JAB.viterbi_forward_banded(plan.W, plan.pdf, plan.alpha0,
                                                jnp.asarray(llp), jnp.asarray(nf),
                                                np.float32(acwt), plan.offsets)
    packed, score = JAB.backtrace_banded_device(alpha_end, plan.final, bps, jnp.asarray(nf),
                                                jnp.asarray(plan.offsets, jnp.int32),
                                                plan.arc_of)
    packed = np.asarray(packed)
    return (np.asarray(alpha_end), np.asarray(bps)[:t], packed[:t], packed[-2],
            packed[-1].astype(bool), np.asarray(score))


@pytest.mark.parametrize("case", CASES)
def test_band_plan_equal(case):
    graphs, _, _ = _case(case)
    want = JAB.build_band_plan(graphs)
    got = AB.build_band_plan(graphs)
    assert got.offsets == want.offsets
    if case == "negative_offsets":
        assert min(got.offsets) < 0
    for f in ("W", "pdf", "arc_of", "alpha0", "final", "n2o"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    back = convert.band_plan_from_jax(want)
    assert back.offsets == got.offsets and np.array_equal(back.W, got.W)


@pytest.mark.parametrize("case", CASES)
def test_banded_forward_backtrace_bit_equal(case):
    graphs, ll, nf = _case(case)
    plan = AB.build_band_plan(graphs)
    ae_j, bps_j, arcs_j, end_j, ok_j, score_j = _jax_banded(JAB.build_band_plan(graphs),
                                                            ll, nf, 0.37)
    dev = AB.plan_to_device(plan, "cpu")
    nf_t = torch.from_numpy(nf)
    alpha_end, bps = AB.viterbi_forward_banded(dev.W, dev.pdf, dev.alpha0,
                                               torch.from_numpy(ll), nf_t, 0.37, dev.offsets)
    np.testing.assert_array_equal(alpha_end.numpy(), ae_j)
    assert bps.dtype == torch.uint8
    np.testing.assert_array_equal(bps.numpy(), bps_j)
    arcs, end, ok, score = AB.backtrace_banded(alpha_end, dev.final, bps, nf_t, dev.offsets,
                                               dev.arc_of)
    np.testing.assert_array_equal(arcs.numpy(), arcs_j)
    np.testing.assert_array_equal(end.numpy(), end_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    np.testing.assert_array_equal(score.numpy(), score_j)
    if case == "no_path":
        assert not ok[1] and ok[0]
    if case == "empty_utterance":
        np.testing.assert_array_equal(alpha_end[1].numpy(), plan.alpha0[1])
    got = A.align_banded(plan, graphs, torch.from_numpy(ll), nf, 0.37)
    want = JA.align_banded(JAB.build_band_plan(graphs), graphs, ll, nf, 0.37)
    assert got == want


# (lanes B, states S, frames T, band offsets, fail rate): walks that meet an
# empty slot in mid-utterance; K = 1, whose walk reaches state 0 and fails
# at every frame after; lanes with no frames, fewer frames than T, and no
# final state reachable
WALK_CASES = {"mid_failure": (6, 60, 300, range(-3, 5), 1 / 50),
              "fail_every_frame": (4, 40, 100, (1,), 0.0),
              "short_lanes": (7, 50, 80, range(-2, 3), 0.0),
              "no_final": (5, 30, 60, range(0, 3), 1 / 100)}


@pytest.mark.parametrize("case", sorted(WALK_CASES))
def test_backtrace_plain_matches_jax_on_failures(case):
    """``backtrace_banded_plain`` against the JAX ``backtrace_banded_device``
    on directly drawn backpointers: equal arcs, end states, ok flags and
    scores, in the regime K4's replay after a failure must match."""
    b, s, t, offsets, fail_rate = WALK_CASES[case]
    rng = np.random.default_rng(sorted(WALK_CASES).index(case) + 41)
    alpha_end, final, bps, nf, arc_of = random_band_walk(rng, b, s, t, offsets, fail_rate)
    if case == "short_lanes":
        nf[1:4] = [0, 1, t // 2]
    if case == "no_final":
        final[[1, 3]] = -1e30
    offs = np.asarray(list(offsets), np.int32)
    packed, score_j = JAB.backtrace_banded_device(alpha_end, final, jnp.asarray(bps),
                                                  jnp.asarray(nf), jnp.asarray(offs), arc_of)
    packed = np.asarray(packed)
    arcs, end, ok, score = AB.backtrace_banded_plain(
        *(torch.from_numpy(x) for x in (alpha_end, final, bps, nf)), tuple(offs),
        torch.from_numpy(arc_of))
    np.testing.assert_array_equal(arcs.numpy(), packed[:t])
    np.testing.assert_array_equal(end.numpy(), packed[t])
    np.testing.assert_array_equal(ok.numpy(), packed[t + 1].astype(bool))
    np.testing.assert_array_equal(score.numpy(), np.asarray(score_j))
    active = np.arange(t)[:, None] < nf[None, :]
    failed = (arcs.numpy() < 0) & active  # [T, B]
    if case == "mid_failure":  # a lane fails inside its frames, and one walks through
        first = [int(np.flatnonzero(failed[:, i]).max()) for i in range(b) if failed[:, i].any()]
        assert any(0 < f < t - 1 for f in first) and bool(ok.any())
    if case == "fail_every_frame":  # held at state 0, every frame below fails
        assert int(failed[:, 0].sum()) > t // 2 and not bool(ok[0])
    if case == "short_lanes":
        assert (arcs.numpy()[:, 1] == -1).all() and (arcs.numpy()[1:, 2] == -1).all()
    if case == "no_final":
        assert not bool(ok[1]) and not bool(ok[3])


@pytest.fixture(scope="module")
def yesno_train():
    m = load_yesno_mono()
    train, _ = make_corpus(**m.corpus)
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    utts = sorted(train)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=m.samp_freq, dither=0.0))
    feats = jax_make_features({u: w for u, (w, _) in train.items()}, {u: u for u in utts}, opts)
    compiler = TrainingGraphCompiler(lang, m.trans_model.tree, m.trans_model)
    fsts = compiler.compile_batch([[lang.words.id(w) for w in train[u][1]] for u in utts])
    nf = np.array([feats[u].shape[0] for u in utts], np.int32)
    batch = np.zeros((len(utts), nf.max(), 39), np.float32)
    for i, u in enumerate(utts):
        batch[i, : nf[i]] = feats[u]
    return m, fsts, batch, nf


def test_align_feats_yesno_matches_jax(yesno_train):
    m, fsts, batch, nf = yesno_train
    want = JA.AlignmentSet.from_fsts(fsts, m.trans_model).align_feats(
        JK.pack_gmm(m.am), batch, nf, acoustic_scale=0.1)
    aset = A.AlignmentSet.from_fsts(fsts, m.trans_model, device="cpu")
    assert aset.band is not None
    got = aset.align_feats(K.pack_gmm(m.am, "cpu"), torch.from_numpy(batch), nf,
                           acoustic_scale=0.1)
    assert [r["tids"] for r in got] == [r["tids"] for r in want]
    assert all(len(r["tids"]) == n for r, n in zip(got, nf))
    np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                               rtol=1e-5)


def test_equal_align_matches_jax(yesno_train):
    m, fsts, _, nf = yesno_train
    graphs = [V.compile_dense_graph(f, m.trans_model.tid2pdf) for f in fsts]
    for i, g in enumerate(graphs):
        got = A.equal_align(g, int(nf[i]), seed=i)
        assert got == JA.equal_align(g, int(nf[i]), seed=i)
        assert A.alignment_to_tids(g, got) == JA.alignment_to_tids(g, got)
    assert A.equal_align(graphs[0], 1, seed=0) is None  # too few frames


def _non_banded():
    rng = np.random.default_rng(6)
    g = _random_banded_graph(rng, 12)
    pdf = g.arc_pdf.copy()
    pdf[1] = (pdf[1] + 1) % 11  # break dst-purity
    g2 = _random_banded_graph(rng, 9)
    return [g._replace(arc_pdf=pdf), g2], rng


def test_generic_aligner_matches_jax():
    graphs, rng = _non_banded()
    assert AB.build_band_plan(graphs) is None
    t = 10
    ll = rng.standard_normal((2, t, 11)).astype(np.float32)
    nf = np.asarray([10, 7], np.int32)
    p = JV.pad_graphs(graphs)
    tp = V.pad_graphs(graphs)
    for name in ("arc_src", "arc_dst", "arc_pdf", "arc_score", "alpha0", "final_score"):
        np.testing.assert_array_equal(tp[name], p[name])
    ae_j, bps_j = JV.viterbi_forward_batched(
        p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"], p["alpha0"],
        jnp.asarray(ll), jnp.asarray(nf), np.float32(0.5), np.float32(1e9), p["num_states"])
    ae_t, bps_t = V.viterbi_forward_batched(
        tp["arc_src"], tp["arc_dst"], tp["arc_pdf"], tp["arc_score"], tp["alpha0"],
        torch.from_numpy(ll), nf, 0.5, 1e9, tp["num_states"])
    np.testing.assert_allclose(ae_t.numpy(), np.asarray(ae_j), rtol=1e-6)
    # the port writes -1 at frames past an utterance's end, which no backtrace reads
    active = np.arange(t)[:, None] < nf[None, :]
    np.testing.assert_array_equal(bps_t.numpy()[active], np.asarray(bps_j)[active])
    assert (bps_t.numpy()[~active] == -1).all()
    arcs_j, ok_j, end_j, score_j = JV.backtrace_batched_device(
        p["arc_src"], ae_j, p["final_score"], bps_j, jnp.asarray(nf))
    arcs_t, ok_t, end_t, score_t = V.backtrace_batched_device(
        tp["arc_src"], ae_t, tp["final_score"], bps_t, nf)
    np.testing.assert_array_equal(arcs_t.numpy(), np.asarray(arcs_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(end_t.numpy(), np.asarray(end_j))
    np.testing.assert_allclose(score_t.numpy(), np.asarray(score_j), rtol=1e-6)
    aset = A.AlignmentSet(graphs, device="cpu")
    assert aset.band is None
    got = aset.align(ll, nf, acoustic_scale=0.5)
    want = JA.AlignmentSet(graphs).align(ll, nf, acoustic_scale=0.5)
    assert [r["tids"] for r in got] == [r["tids"] for r in want]
    assert len(got[0]["tids"]) == 10


def test_generic_aligner_pruned_and_feats():
    """A finite beam routes a banded set to the generic aligner (pruned), and
    align_feats over a non-banded set matches the JAX package's."""
    rng = np.random.default_rng(4)
    graphs = [_random_banded_graph(rng, 20) for _ in range(3)]
    ll = rng.standard_normal((3, 16, 11)).astype(np.float32)
    nf = np.asarray([16, 12, 9], np.int32)
    aset = A.AlignmentSet(graphs, device="cpu")
    exact = aset.align(ll, nf, acoustic_scale=0.5)
    want = JA.AlignmentSet(graphs).align(ll, nf, acoustic_scale=0.5, beam=4.0)
    got = aset.align(ll, nf, acoustic_scale=0.5, beam=4.0)
    assert [r["tids"] for r in got] == [r["tids"] for r in want]
    assert [r["tids"] for r in exact] == [
        r["tids"] for r in JA.AlignmentSet(graphs).align(ll, nf, acoustic_scale=0.5)]

    from voicebridge_tpu.models.gmm import AmDiagGmm
    graphs, rng = _non_banded()
    am = AmDiagGmm(rng.standard_normal((11, 2, 6)).astype(np.float32),
                   np.abs(rng.standard_normal((11, 2, 6))).astype(np.float32) + 0.5,
                   np.full((11, 2), 0.5, np.float32))
    feats = rng.standard_normal((2, 14, 6)).astype(np.float32)
    nf = np.asarray([14, 11], np.int32)
    want = JA.AlignmentSet(graphs).align_feats(JK.pack_gmm(am), feats, nf, acoustic_scale=0.3)
    got = A.AlignmentSet(graphs, device="cpu").align_feats(K.pack_gmm(am, "cpu"), feats, nf,
                                                          acoustic_scale=0.3)
    assert [r["tids"] for r in got] == [r["tids"] for r in want]


def _generic_case(name):
    """Graph sets the banded form refuses, loglikes [B, T, 11] and frame
    counts: ``ragged`` (graphs of 9-40 states, one not dst-pure, arcs back
    over up to 12 states); ``dead_ends`` (a chain too long for its frames, so
    no path, arcs into states with no way on, an utterance with no frames and
    one with T + 3); ``fan_in`` (a state entered by 300 arcs: more than a
    byte code names)."""
    rng = np.random.default_rng({"ragged": 21, "dead_ends": 22, "fan_in": 23}[name])
    t = 30
    if name == "ragged":
        graphs = _non_banded()[0] + [_random_banded_graph(rng, n, band=(-12, 4))
                                     for n in (40, 25, 33)]
        nf = np.asarray([30, 21, 30, 24, 28], np.int32)
    elif name == "dead_ends":
        sink = _random_banded_graph(rng, 14)
        extra = 3  # arcs into three new states no arc leaves
        sink = sink._replace(
            num_states=sink.num_states + extra,
            arc_src=np.concatenate([sink.arc_src, [2, 5, 7]]).astype(np.int32),
            arc_dst=np.concatenate([sink.arc_dst, [14, 15, 16]]).astype(np.int32),
            **{f: np.concatenate([getattr(sink, f), getattr(sink, f)[:extra]])
               for f in ("arc_tid", "arc_pdf", "arc_score", "arc_oseq")},
            **{f: np.concatenate([getattr(sink, f), np.full(extra, v, getattr(sink, f).dtype)])
               for f, v in (("alpha0", V.NEG_INF), ("final_score", V.NEG_INF),
                            ("start_oseq", 0), ("final_oseq", 0))})
        graphs = [_chain_graph(50), sink, _random_banded_graph(rng, 25, band=(-8, 3)),
                  _non_banded()[0][0]]
        nf = np.asarray([30, 30, 0, t + 3], np.int32)
    else:
        graphs = [synth_train_graph(320, 11, rng, back_arcs=1, fan_in=300),
                  synth_train_graph(20, 11, rng)]
        nf = np.asarray([30, 25], np.int32)
    assert AB.build_band_plan(graphs) is None
    ll = rng.standard_normal((len(graphs), t, 11)).astype(np.float32)
    return graphs, ll, nf


GENERIC_CASES = ["ragged", "dead_ends", "fan_in"]


def _csr_today(padded):
    """The destination CSR as the wrapper built it before the plan: a stable
    argsort by destination and a cumulative count."""
    dst = torch.from_numpy(padded["arc_dst"]).long()
    in_arc = torch.argsort(dst, dim=1, stable=True)
    counts = torch.zeros((dst.shape[0], padded["num_states"]), dtype=torch.int64).scatter_add_(
        1, dst, torch.ones_like(dst))
    in_start = torch.cat([torch.zeros((dst.shape[0], 1), dtype=torch.int64), counts.cumsum(1)],
                         dim=1)
    return in_arc.numpy(), in_start.numpy(), counts.numpy()


@pytest.mark.parametrize("case", GENERIC_CASES)
def test_generic_plan_equals_pad_graphs_and_csr(case):
    """The plan's arcs (``plan_arcs``) are ``pad_graphs``'s, its CSR the one
    the wrapper built per call, its rows the arcs in that order, its pdf
    lists index the arcs' pdfs; a row reads one arc exactly where all its
    arcs are one (source, score, pdf); ``take`` equals the plan of the
    subset padded alike."""
    graphs, _, _ = _generic_case(case)
    padded = V.pad_graphs(graphs)
    plan = V.generic_plan_to_device(graphs, "cpu")
    arcs = dict(zip(("arc_src", "arc_dst", "arc_pdf", "arc_score"), V.plan_arcs(plan)))
    for name, got_x in (*arcs.items(), ("arc_src", plan.arc_src), ("alpha0", plan.alpha0),
                        ("final_score", plan.final)):
        np.testing.assert_array_equal(got_x.numpy(), padded[name], err_msg=name)
    in_arc, in_start, counts = _csr_today(padded)
    np.testing.assert_array_equal(plan.in_arc.numpy(), in_arc)
    np.testing.assert_array_equal(plan.in_start.numpy(), in_start)
    for field, name in (("in_src", "arc_src"), ("in_score", "arc_score")):
        np.testing.assert_array_equal(getattr(plan, field).numpy(),
                                      np.take_along_axis(padded[name], in_arc, axis=1))
    got_pdf = np.take_along_axis(plan.pdf_list.numpy(), plan.in_lpdf.numpy().astype(np.int64), 1)
    np.testing.assert_array_equal(got_pdf, np.take_along_axis(padded["arc_pdf"], in_arc, axis=1))
    for i in range(len(graphs)):
        n = int(plan.n_pdf[i])
        np.testing.assert_array_equal(plan.pdf_list[i, :n].numpy(), np.unique(padded["arc_pdf"][i]))
        for st in range(padded["num_states"]):
            row = in_arc[i, in_start[i, st]: in_start[i, st + 1]]
            same = len({(padded["arc_src"][i, j], padded["arc_pdf"][i, j],
                         padded["arc_score"][i, j].tobytes()) for j in row}) == 1
            assert int(plan.in_len[i, st]) == (1 if same else len(row)), (i, st)
    assert plan.max_in_degree == int(plan.in_len.max())
    assert plan.pdf_range == (int(padded["arc_pdf"].min()), int(padded["arc_pdf"].max()))
    if case == "fan_in":
        assert plan.max_in_degree > V.CODE_MAX_DEGREE
    else:
        assert plan.max_in_degree < counts.max()  # the dead state's padding arcs read as one
    idx = np.array([len(graphs) - 1, 0])
    sub = plan.take(idx)
    want = V.generic_plan_to_device(
        V.pad_graphs([graphs[i] for i in idx], pad_states=padded["num_states"] - 1,
                     pad_arcs=padded["arc_src"].shape[1]), "cpu")
    for field in V.GenericPlanDev._fields[:-2]:
        got_x, want_x = getattr(sub, field), getattr(want, field)
        if field == "pdf_list":  # as wide as the whole plan's longest list
            assert not got_x[:, want_x.shape[1]:].any()
            got_x = got_x[:, : want_x.shape[1]]
        assert torch.equal(got_x, want_x), field
    assert (sub.max_in_degree, sub.pdf_range) == (plan.max_in_degree, plan.pdf_range)


@pytest.mark.parametrize("beam", [1e9, 2.5])
@pytest.mark.parametrize("case", GENERIC_CASES)
def test_generic_plan_forward_backtrace_match_jax(case, beam):
    """The plain forward and backtrace driven from the plan against JAX's
    ``viterbi_forward_batched`` and ``backtrace_batched_device``: equal
    backpointers at active frames and alpha_end within rtol 1e-6 and atol
    1e-5 (XLA on the CPU fuses ``ll * acwt`` into the add, one rounding where
    the port, as the JAX source reads, has two: 30 frames of such roundings
    on terms of magnitude up to 10 leave scores near 0 a few 1e-7 apart);
    the backtrace, fed the same alpha_end and
    backpointers, gives equal arcs, ok flags and end states and bit-equal
    scores.  The old signatures given the port's padded arrays agree."""
    graphs, ll, nf = _generic_case(case)
    acwt = 0.43
    p = JV.pad_graphs(graphs)
    ae_j, bps_j = JV.viterbi_forward_batched(
        p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"], p["alpha0"], jnp.asarray(ll),
        jnp.asarray(nf), np.float32(acwt), np.float32(beam), p["num_states"])
    plan = V.generic_plan_to_device(graphs, "cpu")
    nf_t = torch.from_numpy(nf)
    ae, bps, codes = V.generic_forward(plan, torch.from_numpy(ll), nf_t, acwt, beam)
    np.testing.assert_allclose(ae.numpy(), np.asarray(ae_j), rtol=1e-6, atol=1e-5)
    t = ll.shape[1]
    active = np.arange(t)[:, None] < nf[None, :]
    np.testing.assert_array_equal(bps.numpy()[active], np.asarray(bps_j)[active])
    assert (bps.numpy()[~active] == -1).all()
    assert (codes is None) == (case == "fan_in")
    want = JV.backtrace_batched_device(p["arc_src"], jnp.asarray(ae.numpy()), p["final_score"],
                                       jnp.asarray(bps.numpy()), jnp.asarray(nf))
    got = V.generic_backtrace(plan, ae, bps, codes, nf_t)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    q = V.pad_graphs(graphs)
    ae2, bps2 = V.viterbi_forward_batched(q["arc_src"], q["arc_dst"], q["arc_pdf"],
                                          q["arc_score"], q["alpha0"], torch.from_numpy(ll), nf,
                                          acwt, beam, q["num_states"])
    assert torch.equal(ae2, ae) and torch.equal(bps2, bps)
    got2 = V.backtrace_batched_device(q["arc_src"], ae, q["final_score"], bps, nf)
    assert all(torch.equal(x, y) for x, y in zip(got2, got))
    if case == "dead_ends":
        np.testing.assert_array_equal(ae[2].numpy(), p["alpha0"][2])
    if beam < 1e8:
        return
    ok = got[1].numpy()  # exact search: only the dead ends' first, third and fourth fail
    assert ok.tolist() == ([False, True, False, False] if case == "dead_ends" else [True] * len(ok))


@pytest.mark.parametrize("case", GENERIC_CASES)
def test_generic_codes_and_code_backtrace_match_plain(case):
    """``generic_codes_plain`` names each backpointer's rank in its CSR row
    (0xFF exactly where it is -1), and the code-driven backtrace equals
    ``backtrace_batched_plain`` on the forward's backpointers and on
    backpointers with -1s and other arcs of the same row put in (walks that
    fail in mid-utterance and hold their state)."""
    graphs, ll, nf = _generic_case(case)
    plan = V.generic_plan_to_device(graphs, "cpu")
    nf_t = torch.from_numpy(nf)
    ae, bps, codes = V.generic_forward(plan, torch.from_numpy(ll), nf_t, 0.43, 1e9)
    if case == "fan_in":
        assert codes is None and V.generic_codes_plain(bps, plan) is None
        return
    rng = np.random.default_rng(7)
    drawn = bps.clone()
    t, b, s = bps.shape
    arc_dst = V.plan_arcs(plan)[1]
    path = V.backtrace_batched_plain(plan.arc_src.long(), ae, plan.final, bps, nf_t)[0].long()
    for bi in range(b):  # on each path: another arc of the row, then a -1 further back
        for ti, cut in ((int(rng.integers(t // 2, t)), False), (int(rng.integers(1, t // 2)), True)):
            if ti >= nf[bi] or path[ti, bi] < 0:
                continue
            si = int(arc_dst[bi, path[ti, bi]])
            row = torch.nonzero(arc_dst[bi] == si).ravel()
            drawn[ti, bi, si] = -1 if cut else int(row[rng.integers(len(row))])
    for walk in (bps, drawn):
        c = V.generic_codes_plain(walk, plan)
        assert c.dtype == torch.uint8 and c.shape == (b, t, s)
        by_utt = walk.permute(1, 0, 2).long()
        assert torch.equal(c == V.NO_ARC, by_utt < 0)
        hit = by_utt >= 0
        dst = torch.gather(arc_dst, 1, by_utt.clamp(min=0).reshape(b, -1)).view(b, t, s)
        pos = torch.gather(plan.in_start.long(), 1, dst.reshape(b, -1)).view(b, t, s) + c.long()
        arc = torch.gather(plan.in_arc.long(), 1, pos.clamp(max=plan.in_arc.shape[1] - 1)
                           .reshape(b, -1)).view(b, t, s)
        assert torch.equal(arc[hit], by_utt[hit])
        got = V.generic_backtrace_codes_plain(plan, ae, plan.final, c, nf_t)
        want = V.backtrace_batched_plain(plan.arc_src.long(), ae, plan.final, walk, nf_t)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(V.generic_codes_plain(bps, plan), codes)
    assert not bool(V.backtrace_batched_plain(plan.arc_src.long(), ae, plan.final, drawn,
                                              nf_t)[1].all())


def test_align_feats_generic_plan_built_once(monkeypatch):
    """``AlignmentSet.align_feats`` on refused graphs gives the JAX package's
    alignments in sub-batches of two, twice, over one plan built once: no
    sub-batch pads its graphs again."""
    from voicebridge_tpu.models.gmm import AmDiagGmm

    graphs, _, nf = _generic_case("ragged")
    nf[nf == 0] = 5
    rng = np.random.default_rng(31)
    am = AmDiagGmm(rng.standard_normal((11, 2, 6)).astype(np.float32),
                   np.abs(rng.standard_normal((11, 2, 6))).astype(np.float32) + 0.5,
                   np.full((11, 2), 0.5, np.float32))
    feats = rng.standard_normal((len(graphs), int(nf.max()), 6)).astype(np.float32)
    want = JA.AlignmentSet(graphs).align_feats(JK.pack_gmm(am), feats, nf, acoustic_scale=0.3)
    aset = A.AlignmentSet(graphs, device="cpu")
    monkeypatch.setattr(aset, "_batch_chunk", lambda *args: 2)
    built, pad_graphs = [], V.pad_graphs
    monkeypatch.setattr(V, "pad_graphs", lambda *a, **k: built.append(1) or pad_graphs(*a, **k))
    params = K.pack_gmm(am, "cpu")
    for _ in range(2):
        got = aset.align_feats(params, feats, nf, acoustic_scale=0.3)
        assert [r["tids"] for r in got] == [r["tids"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   rtol=1e-6)
    assert len(built) == 1 and aset.generic_dev is aset._generic_dev


def test_apply_alignments_zeroes_failures():
    results = [{"tids": [3, 4, 4]}, {"tids": []}, {"tids": [5, 6]}]
    tids = np.full((3, 3), 9, np.int32)
    weights = np.ones((3, 3), np.float32)
    assert A.apply_alignments(results, tids, weights, np.array([3, 2, 2]), "test") == 1
    np.testing.assert_array_equal(tids, [[3, 4, 4], [0, 0, 0], [5, 6, 0]])
    np.testing.assert_array_equal(weights, [[1, 1, 1], [0, 0, 0], [1, 1, 0]])


def _tids_case(kind):
    """Training graphs over several sub-batches, with arc transition ids
    distinct across the set, one utterance that cannot align (a chain longer
    than its frames, index 3) and one of no frames (index 5, a graph whose
    start state is final: its path is found, and empty, which fails as
    ``apply_alignments`` counts): ``banded`` fits the band plan; ``generic``
    adds a graph that is not dst-pure, so ``build_band_plan`` refuses the
    set."""
    rng = np.random.default_rng({"banded": 41, "generic": 42}[kind])
    graphs = [_random_banded_graph(rng, int(n)) for n in rng.integers(8, 20, 7)]
    graphs.insert(3, _chain_graph(50))
    graphs[5] = _random_banded_graph(rng, 1)
    if kind == "generic":
        graphs += _non_banded()[0][:1]
    graphs = [g._replace(arc_tid=(1000 * i + 1 + rng.permutation(g.num_arcs)).astype(np.int32))
              for i, g in enumerate(graphs)]
    nf = rng.integers(25, 41, len(graphs)).astype(np.int32)
    nf[5] = 0
    feats = rng.standard_normal((len(graphs), int(nf.max()), 6)).astype(np.float32)
    return graphs, feats, nf


@pytest.mark.parametrize("kind", ["banded", "generic"])
def test_align_feats_to_tids_equals_dicts(kind, monkeypatch):
    """``align_feats_to_tids`` fills ``tids`` and ``weights`` bit-equal to
    ``align_feats`` followed by ``apply_alignments`` and returns the same
    count, over sub-batches of three; one tid block a sub-batch."""
    graphs, feats, nf = _tids_case(kind)
    aset = A.AlignmentSet(graphs, device="cpu")
    assert (aset.band is None) == (kind == "generic")
    monkeypatch.setattr(aset, "_batch_chunk", lambda *args: 3)
    params = K.pack_gmm(random_am(11, 2, 6, seed=43), "cpu")
    names = [f"u{i}" for i in range(len(graphs))]
    want_t, want_w = np.full(feats.shape[:2], 9, np.int32), np.ones(feats.shape[:2], np.float32)
    n_want = A.apply_alignments(aset.align_feats(params, feats, nf, acoustic_scale=0.3),
                                want_t, want_w, nf, "test", names)
    got_t, got_w = np.full_like(want_t, 7), np.full_like(want_w, 0.5)
    with P.recording():
        n_got = aset.align_feats_to_tids(params, feats, nf, got_t, got_w, "test", names,
                                         acoustic_scale=0.3)
    counters = P.session().counters
    assert n_got == n_want == 2
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(got_w, want_w)
    assert (want_w.sum(axis=1) == np.where(np.isin(np.arange(len(nf)), [3, 5]), 0, nf)).all()
    blocks = -(-len(graphs) // 3)
    assert counters["align.tid_blocks"] == counters["align.sub_batches"] == blocks
    assert counters["align.failed"] == 2


def test_align_feats_to_tids_accounts_failures(monkeypatch):
    """As ``apply_alignments``: failed rows zeroed, ``align.failed``
    counted, each failed utterance recorded by name, and a failed share past
    ``max_fail_frac`` aborts."""
    graphs, feats, nf = _tids_case("banded")
    aset = A.AlignmentSet(graphs, device="cpu")
    params = K.pack_gmm(random_am(11, 2, 6, seed=43), "cpu")
    names = [f"u{i}" for i in range(len(graphs))]
    recorded, record = [], health.FailureTracker.record
    monkeypatch.setattr(health.FailureTracker, "record",
                        lambda self, utt, why: recorded.append(utt) or record(self, utt, why))
    tids = np.full(feats.shape[:2], 9, np.int32)
    weights = np.ones(feats.shape[:2], np.float32)
    with P.recording():
        assert aset.align_feats_to_tids(params, feats, nf, tids, weights, "test", names,
                                        acoustic_scale=0.3) == 2
    assert P.session().counters["align.failed"] == 2
    assert recorded == ["u3", "u5"]
    assert not tids[[3, 5]].any() and not weights[[3, 5]].any()
    assert (weights.sum(axis=1) > 0).sum() == len(graphs) - 2
    recorded.clear()
    with pytest.raises(health.TooManyFailures, match="2/8"):
        aset.align_feats_to_tids(params, feats, nf, tids, weights, "test", None,
                                 acoustic_scale=0.3, max_fail_frac=0.2)
    assert recorded == ["utt[3]", "utt[5]"]


def test_band_plan_tid_table():
    """``plan_to_device`` with the graphs' padded transition ids gives
    ``tid_of``: each ``arc_of`` arc's id, -1 where none; ``take`` gathers it;
    a negative transition id is refused."""
    graphs, _, _ = _case("random")
    plan = AB.build_band_plan(graphs)
    tids = A.padded_tids(graphs)
    np.testing.assert_array_equal(tids, V.pad_graphs(graphs)["arc_tid"])
    dev = AB.plan_to_device(plan, "cpu", arc_tid=tids)
    got = np.take_along_axis(tids, np.maximum(plan.arc_of, 0).reshape(len(graphs), -1), axis=1)
    want = np.where(plan.arc_of >= 0, got.reshape(plan.arc_of.shape), -1)
    assert dev.tid_of.dtype == torch.int32
    np.testing.assert_array_equal(dev.tid_of.numpy(), want)
    np.testing.assert_array_equal(dev.take(np.array([2, 0])).tid_of.numpy(), want[[2, 0]])
    assert AB.plan_to_device(plan, "cpu").tid_of is None
    tids[1, 0] = -2
    with pytest.raises(ValueError, match="negative transition id"):
        AB.plan_to_device(plan, "cpu", arc_tid=tids)


def test_wrappers_reject_other_devices():
    meta = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        AB.viterbi_forward_banded(meta, meta, meta, meta, meta, 0.1, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        AB.backtrace_banded(meta, meta, meta, meta, meta, meta)


def test_band_plan_keeps_its_pdf_range_on_the_host():
    """``plan_to_device`` records the plan's pdf range from the numpy plan,
    and ``take`` keeps it, so K4's wrapper checks it without reading the
    card."""
    graphs, _, _ = _case("random")
    plan = AB.build_band_plan(graphs)
    dev = AB.plan_to_device(plan, "cpu")
    assert dev.pdf_range == (int(plan.pdf.min()), int(plan.pdf.max()))
    assert all(isinstance(v, int) for v in dev.pdf_range)
    sub = dev.take(np.array([2, 0]))
    assert sub.pdf_range == dev.pdf_range
    np.testing.assert_array_equal(sub.pdf.numpy(), plan.pdf[[2, 0]])


def test_align_banded_refuses_pdfs_past_the_logliks():
    """A plan whose largest pdf reaches past the logliks' P is refused by its
    host pdf range before the device branch, so on the CPU as on the card."""
    graphs, ll, nf = _case("random")
    plan = AB.build_band_plan(graphs)
    p = int(plan.pdf.max())  # the largest pdf is one past the last loglik
    with pytest.raises(ValueError, match="loglikes have"):
        A.align_banded(plan, graphs, torch.from_numpy(ll[:, :, :p]).contiguous(), nf, 0.37)
    dev = AB.plan_to_device(plan, "cpu")
    with pytest.raises(ValueError, match="loglikes have"):
        AB.viterbi_forward_banded(dev.W, dev.pdf, dev.alpha0,
                                  torch.from_numpy(ll[:, :, :p]).contiguous(),
                                  torch.from_numpy(nf), 0.37, dev.offsets, dev.pdf_range)
