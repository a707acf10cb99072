"""The port's splice, LDA and MLLT (``ops/features.py``, ``transforms/lda.py``,
``transforms/mllt.py``, ``steps/train_lda_mllt.py``) against the JAX
package's on the same inputs, on the CPU.

Tolerances: splice is an index gather, equal to the last bit.  The LDA
counts and class means are float64 segment sums in the port and float32 ones
in the JAX package (rtol 1e-5); the second moment is an fp32 product summed
in another order (rtol 1e-5, atol 1e-3 on entries up to about 1e3).  The
LDA matrix is an eigen-decomposition: each row is fixed only up to its
sign, so rows are compared after flipping the port's row to the sign of the
JAX package's (rtol 1e-4).  The affine projection is an fp32 product (rtol
2e-5, atol 2e-4, the GMM tolerance).  MLLT's G sums about 1e4 weighted
outer products in fp32 in another order (rtol 1e-4, atol 1e-3); beta is a
sum of posteriors (rtol 1e-6).  End to end, the port's mono -> tri2b meets
the JAX test's WER gate, and the committed JAX-trained tri2b model decoded
by the port gives the JAX package's words and scores (rtol 1e-5).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicebridge_tpu.config import SpliceOptions as JaxSpliceOptions
from voicebridge_tpu.ops import features as JF
from voicebridge_tpu.ops import gmm_kernels as JK
from voicebridge_tpu.models.gmm import AmDiagGmm as JaxAm
from voicebridge_tpu.transforms import lda as JL
from voicebridge_tpu.transforms import mllt as JM

from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.config import (DecodeOptions, FrameOptions, LangOptions,
                                          MfccOptions, MonoTrainOptions, SpliceOptions,
                                          TriTrainOptions)
from voicebridge_tpu_torch.data.lang import prepare_lang
from voicebridge_tpu_torch.fst.hclg import mkgraph
from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
from voicebridge_tpu_torch.lm.ngram import estimate_ngram
from voicebridge_tpu_torch.ops import features as TF
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.steps.align import align_utterances
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.steps.score import compute_wer_set
from voicebridge_tpu_torch.steps.train_lda_mllt import lda_decode_feats, train_lda_mllt
from voicebridge_tpu_torch.steps.train_mono import train_mono
from voicebridge_tpu_torch.testing import load_synth_tri2b
from voicebridge_tpu_torch.transforms import lda as L
from voicebridge_tpu_torch.transforms import mllt as M

from synth import LEXICON, SR, make_speaker_corpus

torch.set_num_threads(2)
GMM_TOL = dict(rtol=2e-5, atol=2e-4)


@pytest.mark.parametrize("left,right", [(3, 3), (1, 1)])
def test_splice_matches_jax(left, right):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 50, 13)).astype(np.float32)
    nf = np.array([50, 17, 1], np.int32)
    want = np.asarray(JF.splice_frames_batch(x, nf, JaxSpliceOptions(left, right)))
    got = TF.splice_frames_batch(torch.from_numpy(x), torch.from_numpy(nf),
                                 SpliceOptions(left, right))
    np.testing.assert_array_equal(got.numpy(), want)
    one = TF.splice_frames(torch.from_numpy(x[1]), 17, SpliceOptions(left, right))
    np.testing.assert_array_equal(one.numpy(), want[1])


def _lda_inputs():
    rng = np.random.default_rng(1)
    n, d, c = 5000, 91, 40
    ids = rng.integers(0, c, n).astype(np.int32)
    x = (rng.standard_normal((n, d)) + 0.5 * ids[:, None] / c).astype(np.float32)
    w = rng.choice([0.0, 0.3, 1.0], size=n).astype(np.float32)  # zeros: silence, padding
    return x, ids, w, c


def test_acc_lda_stats_and_estimate_match_jax():
    x, ids, w, c = _lda_inputs()
    want = [np.asarray(a) for a in JL.acc_lda_stats(jnp.asarray(x), jnp.asarray(ids),
                                                    jnp.asarray(w), c)]
    got = [a.numpy() for a in L.acc_lda_stats(torch.from_numpy(x), ids, w, c)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5 * np.abs(want[1]).max())
    np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-3)
    _assert_same_lda(L.estimate_lda(*got, 40), JL.estimate_lda(*want, 40), *want)


def _assert_same_lda(mat, want, counts, mean_acc, scatter):
    """LDA matrices ``[E, D+1]`` from (nearly) the same statistics.  Each
    direction is an eigenvector, defined up to its sign: the port's rows are
    flipped to the signs of the JAX package's before comparing (rtol 1e-4).
    With C classes the between-class scatter has rank r = C - 1 at most;
    where r < E, rows r.. are any whitened directions of its null space, so
    there they are held to what defines them: zero between-class and unit
    within-class variance, orthogonal (within-class) to every other row, and
    offsets that centre the projected features."""
    counts, mean_acc, scatter = (np.asarray(a, np.float64) for a in (counts, mean_acc, scatter))
    e = mat.shape[0]
    r = min(int((counts > 0).sum()) - 1, e)
    sign = np.sign(np.sum(mat[:, :-1] * want[:, :-1], axis=1))
    np.testing.assert_allclose((mat * sign[:, None])[:r], want[:r], rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    tot = counts.sum()
    mu = mean_acc.sum(0) / tot
    live = counts > 0
    means = mean_acc[live] / counts[live, None]
    between = np.einsum("c,cd,ce->de", counts[live], means, means) / tot - np.outer(mu, mu)
    within = scatter / tot - np.outer(mu, mu) - between
    a = mat[:, :-1].astype(np.float64)
    np.testing.assert_allclose(a @ within @ a.T, np.eye(e), rtol=0, atol=1e-3)
    proj = a @ between @ a.T
    assert np.abs(proj[r:, r:]).max(initial=0.0) < 1e-6 * np.abs(np.diag(proj)).max()
    np.testing.assert_allclose(mat[:, -1], -(a @ mu), rtol=0, atol=1e-4 * np.abs(mat).max())


def test_acc_lda_stats_leaves_out_ids_outside_the_classes():
    x, ids, w, c = _lda_inputs()
    ids = ids.copy()
    ids[:7] = [-1, c, c + 5, -3, c, c, -1]
    counts, mean_acc, _ = L.acc_lda_stats(torch.from_numpy(x), ids, w, c)
    keep = (ids >= 0) & (ids < c)
    want = np.bincount(ids[keep], weights=w[keep], minlength=c)
    np.testing.assert_allclose(counts.numpy(), want, rtol=1e-6)
    assert mean_acc.shape == (c, x.shape[1])


def test_apply_affine_transform_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 30, 91)).astype(np.float32) * 3
    mat = rng.standard_normal((40, 92)).astype(np.float32)
    want = np.asarray(JL.apply_affine_transform(jnp.asarray(x), mat))
    got = L.apply_affine_transform(torch.from_numpy(x), mat).numpy()
    np.testing.assert_allclose(got, want, **GMM_TOL)


def test_acc_mllt_stats_matches_jax():
    rng = np.random.default_rng(4)
    p, m, d, n = 20, 7, 40, 3000
    mix = rng.integers(1, m + 1, p)  # uneven mixture counts, 1-7
    weights = np.zeros((p, m), np.float32)
    for i, k in enumerate(mix):
        weights[i, :k] = rng.dirichlet(np.ones(k))
    means = rng.standard_normal((p, m, d)).astype(np.float32)
    iv = rng.uniform(0.5, 2.0, (p, m, d)).astype(np.float32)
    ids = rng.integers(0, p, n).astype(np.int32)
    x = (means[ids, 0] + rng.standard_normal((n, d))).astype(np.float32)
    w = rng.choice([0.0, 1.0], size=n, p=[0.2, 0.8]).astype(np.float32)
    jam = JaxAm((means * iv).astype(np.float32), iv, weights.copy())
    g_want, b_want = JM.acc_mllt_stats(JK.pack_gmm(jam), jnp.asarray(jam.means()),
                                       jnp.asarray(jam.inv_vars), x, ids, w)
    am = convert.am_from_arrays(jam.means_invvars, jam.inv_vars, jam.weights)
    for chunk in (None, 700):  # one chunk, and chunks summed in float64
        g, beta = M.acc_mllt_stats(K.pack_gmm(am, "cpu"), am.means(), am.inv_vars, x, ids, w,
                                   chunk=chunk)
        np.testing.assert_allclose(g.numpy(), np.asarray(g_want), rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(beta, b_want, rtol=1e-6)


def _batch(feats, utts):
    return pad_features({u: torch.as_tensor(feats[u]) for u in utts}, utts)


@pytest.fixture(scope="module")
def speaker_system():
    train, test, utt2spk = make_speaker_corpus(num_speakers=4, utts_per_speaker=6,
                                               num_test_per=2, seed=3)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    waves = {u: w for u, (w, _) in {**train, **test}.items()}
    base = make_features(waves, utt2spk, opts, deltas=None, device="cpu")
    delta = make_features(waves, utt2spk, opts, device="cpu")
    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    transcripts = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    return dict(train=train, test=test, utt2spk=utt2spk, base=base, delta=delta, lang=lang,
                transcripts=transcripts, opts=opts, waves=waves)


def test_base_and_spliced_features_match_jax(speaker_system):
    from voicebridge_tpu.config import FrameOptions as JFO, MfccOptions as JMO
    from voicebridge_tpu.steps.make_feats import make_features as jax_make_features

    s = speaker_system
    jopts = JMO(frame_opts=JFO(samp_freq=SR, dither=0.0))
    want = jax_make_features(s["waves"], s["utt2spk"], jopts, deltas=None)
    for u, f in s["base"].items():
        np.testing.assert_allclose(f.numpy(), want[u], rtol=2e-4, atol=2e-3)
    spliced = make_features(s["waves"], s["utt2spk"], s["opts"], deltas=None,
                            splice=SpliceOptions(), device="cpu")
    want = jax_make_features(s["waves"], s["utt2spk"], jopts, deltas=None,
                             splice=JaxSpliceOptions())
    for u, f in spliced.items():
        assert f.shape == (want[u].shape[0], 91)
        np.testing.assert_allclose(f.numpy(), want[u], rtol=2e-4, atol=2e-3)


def test_lda_mllt_end_to_end(speaker_system):
    """mono -> tri2b by the port on the CPU, the recipe of
    ``tests/test_sat_lda.py::test_lda_mllt_end_to_end``: WER <= 10 %."""
    s = speaker_system
    lang = s["lang"]
    tr_delta = {u: s["delta"][u] for u in s["train"]}
    mono = train_mono(tr_delta, s["transcripts"], lang,
                      MonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                       realign_iters=tuple(range(1, 10))), device="cpu")
    ali = align_utterances(mono.am, mono.trans_model, lang, tr_delta, s["transcripts"],
                           acoustic_scale=0.1, device="cpu")
    model, final_mat = train_lda_mllt(
        {u: s["base"][u] for u in s["train"]}, s["transcripts"], ali, lang,
        TriTrainOptions(num_iters=8, num_leaves=100, totgauss=300, max_iter_inc=6,
                        realign_iters=(2, 4, 6), mllt_iters=(2, 4)),
        prev_trans_model=mono.trans_model, device="cpu")
    assert final_mat.shape == (40, 92)
    g = arpa_to_fst(estimate_ngram([ws for (_w, ws) in s["train"].values()], order=2),
                    lang.words.id, lang.word_disambig_id)
    dec = Decoder(mkgraph(lang, model.tree, model.trans_model, g), model.trans_model,
                  model.am, DecodeOptions(beam=1e9), device="cpu")
    feats = lda_decode_feats({u: s["base"][u] for u in s["test"]}, final_mat, device="cpu")
    utts = sorted(feats)
    res = dec.decode_batch(utts, *_batch(feats, utts))
    stats = compute_wer_set({u: list(s["test"][u][1]) for u in utts},
                            {r.utt: [lang.words.sym(w) for w in r.words] for r in res})
    print("port lda+mllt end-to-end:", stats)
    assert stats.wer <= 10.0


def test_jax_trained_tri2b_decodes_to_the_jax_words(speaker_system):
    """The committed JAX-trained tri2b model, decoded by the port through
    ``lda_decode_feats`` at exact search: the JAX package's words for every
    test utterance, its scores within rtol 1e-5."""
    from voicebridge_tpu.config import DecodeOptions as JDO
    from voicebridge_tpu.fst.core import Fst as JFst
    from voicebridge_tpu.models.gmm import AmDiagGmm as JAm
    from voicebridge_tpu.models.topology import HmmTopology as JTopo
    from voicebridge_tpu.models.transition import TransitionModel as JTm
    from voicebridge_tpu.models.tree import load_tree as jload_tree
    from voicebridge_tpu.steps.decode import Decoder as JDecoder
    from voicebridge_tpu.steps.train_lda_mllt import lda_decode_feats as jlda_decode_feats
    from voicebridge_tpu_torch.testing import TRI2B_DIR

    s = speaker_system
    m = load_synth_tri2b()
    assert m.corpus == {"num_speakers": 4, "utts_per_speaker": 6, "num_test_per": 2,
                        "seed": 3}
    assert m.final_mat.shape == (40, 92)
    feats = lda_decode_feats({u: s["base"][u] for u in s["test"]}, m.final_mat, device="cpu")
    utts = sorted(feats)
    dec = Decoder(m.hclg, m.trans_model, m.am, DecodeOptions(beam=1e9), device="cpu")
    res = dec.decode_batch(utts, *_batch(feats, utts))
    got = {r.utt: [m.words.sym(w) for w in r.words] for r in res}
    assert got == m.hyps
    np.testing.assert_allclose([r.score for r in res], [m.scores[u] for u in utts], rtol=1e-5)
    # the JAX package decoding the same files on the port's base features
    tm = JTm(JTopo.load(TRI2B_DIR / "topo.json"), jload_tree(TRI2B_DIR / "tree.json"))
    tm.load_probs(TRI2B_DIR / "trans.json")
    jdec = JDecoder(JFst.load(TRI2B_DIR / "hclg.npz"), tm, JAm.load(TRI2B_DIR / "am.npz"),
                    JDO(beam=1e9))
    jfeats = jlda_decode_feats({u: s["base"][u].numpy() for u in s["test"]}, m.final_mat)
    jx = np.zeros((len(utts), max(f.shape[0] for f in jfeats.values()), 40), np.float32)
    for i, u in enumerate(utts):
        jx[i, : jfeats[u].shape[0]] = jfeats[u]
        np.testing.assert_allclose(feats[u].numpy(), jfeats[u], **GMM_TOL)
    jres = jdec.decode_batch(utts, jx, np.array([jfeats[u].shape[0] for u in utts]))
    assert {r.utt: [m.words.sym(w) for w in r.words] for r in jres} == got
    np.testing.assert_allclose([r.score for r in res], [r.score for r in jres], rtol=1e-5)


@pytest.fixture(scope="module")
def jax_mono_alignments(speaker_system):
    """The JAX package's monophone model on its own delta features of the
    speaker corpus, and its alignments (the recipe of
    ``tests/test_sat_lda.py``'s ``system`` fixture)."""
    from voicebridge_tpu.config import FrameOptions as JFO, LangOptions as JLO
    from voicebridge_tpu.config import MfccOptions as JMO, MonoTrainOptions as JMono
    from voicebridge_tpu.data.lang import prepare_lang as jprepare_lang
    from voicebridge_tpu.steps.align import align_utterances as jalign
    from voicebridge_tpu.steps.make_feats import (apply_feature_chain, compute_cmvn,
                                                  compute_mfcc)
    from voicebridge_tpu.steps.train_mono import train_mono as jtrain_mono

    s = speaker_system
    mfcc = compute_mfcc(s["waves"], JMO(frame_opts=JFO(samp_freq=SR, dither=0.0)))
    cmvn = compute_cmvn(mfcc, s["utt2spk"])
    base = apply_feature_chain(mfcc, s["utt2spk"], cmvn, deltas=None)
    delta = apply_feature_chain(mfcc, s["utt2spk"], cmvn)
    lang = jprepare_lang(LEXICON, ["SIL"], "SIL", JLO())
    tr_delta = {u: delta[u] for u in s["train"]}
    mono = jtrain_mono(tr_delta, s["transcripts"], lang,
                       JMono(num_iters=10, totgauss=150, max_iter_inc=8,
                             realign_iters=tuple(range(1, 10))))
    ali = jalign(mono.am, mono.trans_model, lang, tr_delta, s["transcripts"],
                 acoustic_scale=0.1)
    return dict(base={u: base[u] for u in s["train"]}, lang=lang, mono=mono, ali=ali)


@pytest.mark.parametrize("iters", [0, 2])
def test_train_lda_mllt_matches_jax(speaker_system, jax_mono_alignments, iters, tmp_path,
                                    monkeypatch):
    """The stage itself from the same base features and alignments: the LDA
    estimate, then (on the JAX package's LDA matrix) the tree on the
    projected features and, at 2 iterations (MLLT at 1, realigned at 2), the
    MLLT update, E-steps and M-steps.  The corpus has fewer live classes than
    40, so rows of the LDA matrix past the between-class rank are arbitrary
    (``_assert_same_lda``): the port's estimate is held to the JAX package's
    inside the stage, which then goes on with the JAX package's matrix, so
    that what follows is held on equal inputs.  The models are compared as
    the monophone ones are (``testing.assert_models_close``)."""
    from voicebridge_tpu.config import TriTrainOptions as JTri
    from voicebridge_tpu.steps.train_lda_mllt import train_lda_mllt as jtrain_lda_mllt
    from voicebridge_tpu_torch.steps import train_lda_mllt as TLM

    from test_torch_tri import _port_tm, _tree_arrays
    from voicebridge_tpu_torch.testing import assert_models_close

    s, j = speaker_system, jax_mono_alignments
    opts = dict(num_iters=iters, num_leaves=100, totgauss=300, max_iter_inc=6,
                realign_iters=(2,), mllt_iters=(1,))
    want, want_mat = jtrain_lda_mllt(j["base"], s["transcripts"], j["ali"], j["lang"],
                                     JTri(**opts), prev_trans_model=j["mono"].trans_model)
    _, jax_lda = jtrain_lda_mllt(j["base"], s["transcripts"], j["ali"], j["lang"],
                                 JTri(**{**opts, "num_iters": 0}),
                                 prev_trans_model=j["mono"].trans_model)
    held = []

    def estimate_and_hold(counts, mean_acc, scatter, dim, wcf):
        _assert_same_lda(L.estimate_lda(counts, mean_acc, scatter, dim, wcf), jax_lda,
                         counts, mean_acc, scatter)
        held.append(dim)
        return jax_lda

    monkeypatch.setattr(TLM, "estimate_lda", estimate_and_hold)
    got, mat = train_lda_mllt(j["base"], s["transcripts"], j["ali"], s["lang"],
                              TriTrainOptions(**opts),
                              prev_trans_model=_port_tm(j["mono"].trans_model, tmp_path),
                              out_dir=tmp_path / "out", device="cpu")
    assert held == [40]
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "final.mat.npy"), mat)
    np.testing.assert_allclose(mat, want_mat, rtol=1e-4, atol=1e-4 * np.abs(want_mat).max())
    assert _tree_arrays(got.tree) == _tree_arrays(want.tree)
    np.testing.assert_array_equal((got.am.weights > 0).sum(axis=1),
                                  (want.am.weights > 0).sum(axis=1))
    assert_models_close(got, want)


@pytest.mark.parametrize("entry", ["train_tri", "train_lda_mllt", "lda_decode_feats"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Called without ``device``, the new entry points run on ``cuda:0``:
    where CUDA is not available they raise before any work."""
    from voicebridge_tpu_torch.steps.train_tri import train_tri

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats = {"u": torch.zeros((5, 13))}
    calls = {"train_tri": lambda: train_tri(feats, {}, {}, None, prev_trans_model=object()),
             "train_lda_mllt": lambda: train_lda_mllt(feats, {}, {}, None,
                                                      prev_trans_model=object()),
             "lda_decode_feats": lambda: lda_decode_feats(feats, np.zeros((40, 92)))}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
