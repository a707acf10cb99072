"""Silence probabilities and LM interpolation: the port against the JAX
package, on the CPU.

``tests/test_silprob.py::test_silprob_lang_end_to_end`` run by each package
from the same features (the JAX package's, as numpy): train a monophone
model, align, count pronunciations and silences (``steps/get_prons.py``),
estimate the silence probabilities, rebuild the lang with them, retrain and
decode.  Both packages must give the same counts, silence probabilities,
silprob lexicon FSTs and test WER.  Then ``lm/interp.py`` (a numpy copy)
against the JAX package on ``tests/test_lm_interp.py``'s corpora: identical
perplexities, weights and interpolated n-grams.
"""

import importlib

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import (DecodeOptions, FrameOptions, LangOptions, MfccOptions,
                                    MonoTrainOptions)
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu_torch import config as port_config

from synth import LEXICON, SR, make_corpus
from test_lm_interp import VOCAB_A, VOCAB_B

torch.set_num_threads(2)


def _chain(pkg: str, tf: dict, sf: dict, train: dict, test: dict) -> dict:
    """The silprob recipe of ``tests/test_silprob.py`` in package ``pkg``."""
    mod = {n: importlib.import_module(f"{pkg}.{n}") for n in (
        "config", "data.lang", "fst.hclg", "fst.lexicon", "lm.arpa", "lm.ngram", "steps.align",
        "steps.decode", "steps.get_prons", "steps.score", "steps.train_mono")}
    cfg = mod["config"]
    kw = {"device": "cpu"} if pkg == "voicebridge_tpu_torch" else {}
    lang = mod["data.lang"].prepare_lang(LEXICON, ["SIL"], "SIL", cfg.LangOptions())
    tr = {u: [lang.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    mono = mod["steps.train_mono"].train_mono(tf, tr, lang, cfg.MonoTrainOptions(
        num_iters=10, totgauss=150, max_iter_inc=8, realign_iters=tuple(range(1, 10))), **kw)
    ali = mod["steps.align"].align_utterances(mono.am, mono.trans_model, lang, tf, tr,
                                              acoustic_scale=0.1, **kw)
    words_by_utt = {u: list(ws) for u, (_, ws) in train.items()}
    base_lex = {w: list(prons) for w, prons in LEXICON.items()}
    gp = mod["steps.get_prons"]
    pron_counts, sil_stats = gp.get_prons(ali, words_by_utt, mono.trans_model, lang, base_lex)
    sp = gp.estimate_silence_probs(sil_stats)
    silprobs = mod["fst.lexicon"].silprobs_from_stats(sil_stats, sp["overall"])
    lang2 = mod["data.lang"].prepare_lang(LEXICON, ["SIL"], "SIL", cfg.LangOptions(),
                                          silprobs=silprobs)
    tr2 = {u: [lang2.words.id(w) for w in ws] for u, (_, ws) in train.items()}
    mono2 = mod["steps.train_mono"].train_mono(tf, tr2, lang2, cfg.MonoTrainOptions(
        num_iters=8, totgauss=120, max_iter_inc=6, realign_iters=tuple(range(1, 8))), **kw)
    arpa = mod["lm.ngram"].estimate_ngram([ws for (_w, ws) in train.values()], order=2)
    g = mod["lm.arpa"].arpa_to_fst(arpa, lang2.words.id, lang2.word_disambig_id)
    hclg = mod["fst.hclg"].mkgraph(lang2, mono2.tree, mono2.trans_model, g)
    dec = mod["steps.decode"].Decoder(hclg, mono2.trans_model, mono2.am,
                                      cfg.DecodeOptions(beam=1e9), **kw)
    utts = sorted(sf)
    t_max = max(f.shape[0] for f in sf.values())
    feats = np.zeros((len(utts), t_max, 39), np.float32)
    nf = np.zeros(len(utts), np.int32)
    for i, u in enumerate(utts):
        feats[i, : sf[u].shape[0]] = sf[u]
        nf[i] = sf[u].shape[0]
    hyps = {r.utt: [lang2.words.sym(w) for w in r.words]
            for r in dec.decode_batch(utts, feats, nf)}
    wer = mod["steps.score"].compute_wer_set({u: list(test[u][1]) for u in utts}, hyps)
    return dict(ali=ali, pron_counts=pron_counts, sil_stats=sil_stats, sp=sp,
                silprobs=silprobs, lang2=lang2, wer=wer, hyps=hyps)


@pytest.fixture(scope="module")
def chains():
    train, test = make_corpus(num_train=16, num_test=6, seed=31)
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))

    def feats_of(c):
        return jax_make_features({u: w for u, (w, _) in c.items()}, {u: u for u in c}, opts)

    tf, sf = feats_of(train), feats_of(test)
    return (_chain("voicebridge_tpu_torch", tf, sf, train, test),
            _chain("voicebridge_tpu", tf, sf, train, test))


def test_silence_statistics_match_jax(chains):
    port, jax_side = chains
    assert port["ali"] == jax_side["ali"]
    assert port["pron_counts"] and port["pron_counts"] == jax_side["pron_counts"]
    assert port["sil_stats"] == jax_side["sil_stats"]
    assert port["sp"] == jax_side["sp"] and 0.0 < port["sp"]["overall"] < 1.0
    assert port["silprobs"] == jax_side["silprobs"]


def test_silprob_lang_matches_jax(chains):
    from voicebridge_tpu_torch.data.lang import validate_lang

    port, jax_side = chains
    assert not validate_lang(port["lang2"])
    for name in ("L", "L_disambig"):
        a, b = getattr(port["lang2"], name), getattr(jax_side["lang2"], name)
        for x, y in zip((*a.to_arrays(), np.asarray(a.finals)),
                        (*b.to_arrays(), np.asarray(b.finals))):
            np.testing.assert_array_equal(x, y)


def test_silprob_decode_wer_matches_jax(chains):
    port, jax_side = chains
    assert vars(port["wer"]) == vars(jax_side["wer"])
    assert port["hyps"] == jax_side["hyps"]
    assert port["wer"].wer <= 10.0


def test_pron_and_silence_estimates_are_identical():
    from collections import Counter

    from voicebridge_tpu.steps import get_prons as jgp
    from voicebridge_tpu_torch.steps import get_prons as tgp

    lexicon = {"A": [(1.0, ("AH",)), (0.5, ("EY",))], "B": [(1.0, ("B", "IY"))]}
    counts = Counter({("A", ("AH",)): 7, ("A", ("EY",)): 1, ("B", ("B", "IY")): 3})
    for smooth in (0.0, 1.0, 2.5):
        assert tgp.estimate_pron_probs(lexicon, counts, smooth) == \
            jgp.estimate_pron_probs(lexicon, counts, smooth)
    stats = {"A": {"before_sil": 3, "before_nonsil": 5, "after_sil": 1},
             "B": {"before_nonsil": 2, "after_nonsil": 2}}
    for smooth in (0.5, 2.0):
        assert tgp.estimate_silence_probs(stats, smooth) == \
            jgp.estimate_silence_probs(stats, smooth)
    assert tgp.estimate_silence_probs({}) == jgp.estimate_silence_probs({})
    assert tgp.segment_words(["SIL", "AH", "B", "IY", "SIL"], ["A", "B"], lexicon) == \
        jgp.segment_words(["SIL", "AH", "B", "IY", "SIL"], ["A", "B"], lexicon)


# ---------------------------------------------------------------------------
# LM interpolation
# ---------------------------------------------------------------------------


def _corpus(rng, vocab, n, length=8):
    p = np.arange(len(vocab), 0, -1, dtype=float)
    p /= p.sum()
    return [[vocab[i] for i in rng.choice(len(vocab), length, p=p)] for _ in range(n)]


@pytest.mark.parametrize("order", [2, 3])
def test_lm_interpolation_is_identical(order):
    from voicebridge_tpu.lm import interp as ji
    from voicebridge_tpu.lm.ngram import estimate_ngram as jax_estimate
    from voicebridge_tpu_torch.lm import interp as ti
    from voicebridge_tpu_torch.lm.arpa import ArpaModel
    from voicebridge_tpu_torch.lm.ngram import estimate_ngram

    rng = np.random.default_rng(9 + order)
    a, b = _corpus(rng, VOCAB_A, 60), _corpus(rng, VOCAB_B, 60)
    held = _corpus(rng, VOCAB_A, 12) + _corpus(rng, VOCAB_B, 12)
    port_lms = [estimate_ngram(c, order=order) for c in (a, b)]
    jax_lms = [jax_estimate(c, order=order) for c in (a, b)]
    assert [m.ngrams for m in port_lms] == [m.ngrams for m in jax_lms]
    for pm, jm in zip(port_lms, jax_lms):
        assert ti.perplexity(pm, held) == ji.perplexity(jm, held)
    lam = ti.optimize_interpolation_weights(port_lms, held)
    assert lam == ji.optimize_interpolation_weights(jax_lms, held)
    assert abs(sum(lam) - 1.0) < 1e-8
    mix = ti.interpolate_models(port_lms, lam)
    want = ji.interpolate_models(jax_lms, lam)
    assert type(mix) is ArpaModel and mix.ngrams == want.ngrams
    assert ti.perplexity(mix, held) == ji.perplexity(want, held)
    assert ti.perplexity(mix, held) < min(ti.perplexity(m, held) for m in port_lms)
    assert ti.perplexity(port_lms[0], []) == float("inf")
