"""Parity of the port's alignment (``ops/align_band.py``, ``ops/viterbi.py``,
``steps/align.py``) with the JAX package's on the same inputs, on the CPU.

The band plans are equal array for array; the banded forward (the plain
version of K4) gives bit-equal alpha_end and equal uint8 band-slot codes,
and its backtrace equal arcs, end states, ok flags and bit-equal scores.
The cases are those of ``tests/test_align_band.py`` plus negative offsets,
empty utterances and a graph with no path.  On the committed Yes-No model,
``AlignmentSet.align_feats`` gives the JAX package's transition ids; the
generic aligner matches ``viterbi_forward_batched`` on a non-banded set."""

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
from voicebridge_tpu_torch.testing import load_yesno_mono

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
    for lv_j, lv_t in zip(p["levels"], tp["levels"]):
        np.testing.assert_array_equal(lv_t, lv_j)
    ae_j, bps_j = JV.viterbi_forward_batched(
        p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"], p["alpha0"],
        jnp.asarray(ll), jnp.asarray(nf), np.float32(0.5), np.float32(1e9), p["num_states"])
    ae_t, bps_t = V.viterbi_forward_batched(
        tp["arc_src"], tp["levels"], tp["arc_pdf"], tp["arc_score"], tp["alpha0"],
        torch.from_numpy(ll), nf, 0.5, 1e9, tp["num_states"])
    np.testing.assert_allclose(ae_t.numpy(), np.asarray(ae_j), rtol=1e-6)
    np.testing.assert_array_equal(bps_t.numpy(), np.asarray(bps_j))
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


def test_apply_alignments_zeroes_failures():
    results = [{"tids": [3, 4, 4]}, {"tids": []}, {"tids": [5, 6]}]
    tids = np.full((3, 3), 9, np.int32)
    weights = np.ones((3, 3), np.float32)
    assert A.apply_alignments(results, tids, weights, np.array([3, 2, 2]), "test") == 1
    np.testing.assert_array_equal(tids, [[3, 4, 4], [0, 0, 0], [5, 6, 0]])
    np.testing.assert_array_equal(weights, [[1, 1, 1], [0, 0, 0], [1, 1, 0]])


def test_wrappers_reject_other_devices():
    meta = torch.empty((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        AB.viterbi_forward_banded(meta, meta, meta, meta, meta, 0.1, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        AB.backtrace_banded(meta, meta, meta, meta, meta, meta)
