"""The port's triphone stage (``models/treebuild.py``, ``steps/train_tri.py``,
and ``fst/hclg.py`` over a ``ContextTree``) against the JAX package's on the
same inputs, on the CPU.  The inputs are those of ``tests/test_tri.py``:
the corpus ``make_corpus(20, 8, seed=11)``, the JAX package's features and
monophone model, and that model's alignments (lists of ints).

Tree statistics and the tree are host numpy in both packages: the same
events, stats equal to float64 rounding, identical node arrays.  The
initial model is equal to float32 rounding.  Training graphs and the HCLG
over the JAX-built tree: identical states, arcs and labels, weights within
1e-6.  ``convert_alignment``: equal transition ids.  After EM iterations
(K6 statistics and, at a realignment, K2 and the aligner) the models agree
as the monophone ones do (``tests/test_torch_train.py``).  End to end, the
port's mono -> tri1 meets the JAX test's gate: test WER <= 5 %.
"""

import json

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import (FrameOptions as JFrameOptions, LangOptions as JLangOptions,
                                    MfccOptions as JMfccOptions,
                                    MonoTrainOptions as JMonoTrainOptions,
                                    TriTrainOptions as JTriTrainOptions)
from voicebridge_tpu.data.lang import prepare_lang as jax_prepare_lang
from voicebridge_tpu.fst.hclg import TrainingGraphCompiler as JCompiler
from voicebridge_tpu.fst.hclg import mkgraph as jax_mkgraph
from voicebridge_tpu.lm.arpa import arpa_to_fst as jax_arpa_to_fst
from voicebridge_tpu.lm.ngram import estimate_ngram as jax_estimate_ngram
from voicebridge_tpu.models import treebuild as JT
from voicebridge_tpu.models.transition import TransitionModel as JTm
from voicebridge_tpu.steps.align import align_utterances as jax_align_utterances
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu.steps.train_mono import train_mono as jax_train_mono
from voicebridge_tpu.steps.train_tri import init_model_from_tree_stats as jax_init_model
from voicebridge_tpu.steps.train_tri import train_tri as jax_train_tri

from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.config import (DecodeOptions, FrameOptions, LangOptions,
                                          MfccOptions, MonoTrainOptions, TriTrainOptions)
from voicebridge_tpu_torch.data.lang import prepare_lang
from voicebridge_tpu_torch.fst.hclg import TrainingGraphCompiler, mkgraph
from voicebridge_tpu_torch.lm.arpa import arpa_to_fst
from voicebridge_tpu_torch.lm.ngram import estimate_ngram
from voicebridge_tpu_torch.models import treebuild as T
from voicebridge_tpu_torch.models.transition import TransitionModel
from voicebridge_tpu_torch.steps.align import AlignmentSet, align_utterances
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.steps.score import compute_wer_set
from voicebridge_tpu_torch.steps.train_mono import train_mono
from voicebridge_tpu_torch.steps.train_tri import init_model_from_tree_stats, train_tri
from voicebridge_tpu_torch.testing import assert_models_close

from synth import LEXICON, SR, make_corpus

torch.set_num_threads(2)
TRI_OPTS = dict(num_iters=10, num_leaves=120, totgauss=300, max_iter_inc=8,
                realign_iters=(2, 4, 6, 8))  # tests/test_tri.py's


@pytest.fixture(scope="module")
def mono_system(tmp_path_factory):
    train, test = make_corpus(num_train=20, num_test=8, seed=11)
    opts = JMfccOptions(frame_opts=JFrameOptions(samp_freq=SR, dither=0.0))
    feats = jax_make_features({u: w for u, (w, _) in train.items()}, {u: u for u in train},
                              opts)
    lang = jax_prepare_lang(LEXICON, ["SIL"], "SIL", JLangOptions())
    transcripts = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    mono = jax_train_mono(feats, transcripts, lang,
                          JMonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                            realign_iters=tuple(range(1, 10))))
    ali = jax_align_utterances(mono.am, mono.trans_model, lang, feats, transcripts,
                               acoustic_scale=0.1)
    port_lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    return dict(train=train, test=test, feats=feats, lang=lang, port_lang=port_lang,
                transcripts=transcripts, mono=mono, ali=ali,
                port_mono_tm=_port_tm(mono.trans_model, tmp_path_factory.mktemp("mono")),
                sil=set(lang.silence_phone_ids))


def _port_tm(jax_tm, tmp) -> TransitionModel:
    """The JAX package's transition model (and its tree) in the port, through
    the json files both packages write."""
    jax_tm.topo.save(tmp / "topo.json")
    jax_tm.tree.save(tmp / "tree.json")
    jax_tm.save(tmp / "trans.json")
    return convert.transition_model_from_json(
        *[json.loads((tmp / n).read_text()) for n in ("topo.json", "tree.json", "trans.json")])


def _tree_arrays(tree):
    return ([(n["pdf"],) if "pdf" in n else (n["key"], sorted(n["values"]), n["yes"], n["no"])
             for n in tree.nodes], tree.num_pdfs, tree.context_width, tree.central_position)


@pytest.fixture(scope="module")
def trees(mono_system):
    s = mono_system
    want = JT.acc_tree_stats(s["ali"], s["feats"], s["mono"].trans_model, ci_phones=s["sil"])
    got = T.acc_tree_stats(s["ali"], s["feats"], s["port_mono_tm"], ci_phones=s["sil"])
    return want, got, JT.build_tree(want, s["lang"], num_leaves=100), \
        T.build_tree(got, s["port_lang"], num_leaves=100)


def test_tree_stats_tree_and_initial_model_match_jax(trees):
    want, got, jtree, tree = trees
    assert list(got) == list(want)  # the same events, in the same order
    for key, st in want.items():
        assert got[key].count == st.count
        np.testing.assert_allclose(got[key].sum_x, st.sum_x, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(got[key].sum_x2, st.sum_x2, rtol=1e-12, atol=1e-9)
    assert _tree_arrays(tree) == _tree_arrays(jtree)
    assert tree.num_pdfs >= 10
    jam = jax_init_model(jtree, want)
    am = init_model_from_tree_stats(tree, got)
    for a, b in ((am.means_invvars, jam.means_invvars), (am.inv_vars, jam.inv_vars),
                 (am.weights, jam.weights)):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def _assert_same_fst(got, want):
    ga, wa = got.to_arrays(), want.to_arrays()
    for a, b in zip(ga, wa):
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got.finals, want.finals, rtol=0, atol=1e-6)
    assert got.start == want.start and got.num_states == want.num_states


def test_graphs_over_the_context_tree_match_jax(mono_system, trees, tmp_path):
    """``TrainingGraphCompiler.compile_batch`` and ``mkgraph`` over the JAX
    package's triphone tree (as ``tests/test_tri.py`` builds it)."""
    s = mono_system
    jtree = trees[2]
    jtm = JTm(s["lang"].topo, jtree)
    tm = _port_tm(jtm, tmp_path)
    assert tm.tuples == jtm.tuples
    texts = [s["transcripts"][u] for u in sorted(s["transcripts"])]
    want = JCompiler(s["lang"], jtree, jtm).compile_batch(texts)
    got = TrainingGraphCompiler(s["port_lang"], tm.tree, tm).compile_batch(texts)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same_fst(g, w)
    sents = [ws for (_w, ws) in s["train"].values()]
    jg = jax_arpa_to_fst(jax_estimate_ngram(sents, order=2), s["lang"].words.id,
                         s["lang"].word_disambig_id)
    g = arpa_to_fst(estimate_ngram(sents, order=2), s["port_lang"].words.id,
                    s["port_lang"].word_disambig_id)
    _assert_same_fst(mkgraph(s["port_lang"], tm.tree, tm, g),
                     jax_mkgraph(s["lang"], jtree, jtm, jg))
    # which aligner the triphone graphs take, and why, is stated
    assert AlignmentSet.from_fsts(got, tm, device="cpu").aligner.startswith(
        ("banded", "generic"))


def test_convert_alignment_matches_jax(mono_system, trees, tmp_path):
    s = mono_system
    jtm = JTm(s["lang"].topo, trees[2])
    tm = _port_tm(jtm, tmp_path)
    for u, a in s["ali"].items():
        assert s["port_mono_tm"].convert_alignment(a, tm) == \
            s["mono"].trans_model.convert_alignment(a, jtm)


@pytest.mark.parametrize("iters", [0, 2])
def test_train_tri_matches_jax(mono_system, iters):
    """The stage itself from the same features and alignments: the same
    tree, and after two EM iterations realigned at 2, models that agree."""
    s = mono_system
    opts = dict(num_iters=iters, num_leaves=100, totgauss=300, max_iter_inc=8,
                realign_iters=(2,))
    want = jax_train_tri(s["feats"], s["transcripts"], s["ali"], s["lang"],
                         JTriTrainOptions(**opts), prev_trans_model=s["mono"].trans_model)
    got = train_tri(s["feats"], s["transcripts"], s["ali"], s["port_lang"],
                    TriTrainOptions(**opts), prev_trans_model=s["port_mono_tm"], device="cpu")
    assert _tree_arrays(got.tree) == _tree_arrays(want.tree)
    np.testing.assert_array_equal((got.am.weights > 0).sum(axis=1),
                                  (want.am.weights > 0).sum(axis=1))
    assert_models_close(got, want)


def test_mono_to_tri1_end_to_end(mono_system):
    """mono -> tri1 by the port on the CPU (features, monophone model,
    alignments, tree, EM, HCLG, decode), the recipe of
    ``tests/test_tri.py::test_mono_to_tri_wer``: test WER <= 5 %."""
    s = mono_system
    lang = s["port_lang"]
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))

    def feats_of(corpus):
        return make_features({u: w for u, (w, _) in corpus.items()}, {u: u for u in corpus},
                             opts, device="cpu")

    train_feats, test_feats = feats_of(s["train"]), feats_of(s["test"])
    mono = train_mono(train_feats, s["transcripts"], lang,
                      MonoTrainOptions(num_iters=10, totgauss=150, max_iter_inc=8,
                                       realign_iters=tuple(range(1, 10))), device="cpu")
    ali = align_utterances(mono.am, mono.trans_model, lang, train_feats, s["transcripts"],
                           acoustic_scale=0.1, device="cpu")
    tri = train_tri(train_feats, s["transcripts"], ali, lang, TriTrainOptions(**TRI_OPTS),
                    prev_trans_model=mono.trans_model, device="cpu")
    g = arpa_to_fst(estimate_ngram([ws for (_w, ws) in s["train"].values()], order=2),
                    lang.words.id, lang.word_disambig_id)
    dec = Decoder(mkgraph(lang, tri.tree, tri.trans_model, g), tri.trans_model, tri.am,
                  DecodeOptions(beam=1e9), device="cpu")
    utts = sorted(test_feats)
    res = dec.decode_batch(utts, *pad_features(test_feats, utts))
    stats = compute_wer_set({u: list(s["test"][u][1]) for u in utts},
                            {r.utt: [lang.words.sym(w) for w in r.words] for r in res})
    print("port tri1 end-to-end:", stats)
    assert stats.wer <= 5.0
