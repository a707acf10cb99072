"""Pronunciation and silence-probability statistics from alignments.

Counterpart of the reference's ``GetProns`` (``scr/steps/get_prons.cpp``,
629 LoC; Lattice1best -> LatticeAlignWords -> NbestToProns,
``kaldi_scr.h:307-312``): counts which pronunciation each word token used and
how often silence precedes/follows word tokens, producing pron-probs and
silence-prob estimates for lexicon refinement (the silprob lexicon path of
prepare_lang).

Works from best-path alignments: the aligned phone sequence is segmented into
(optional silence | word pronunciation) runs by Viterbi-matching the
transcript's candidate pronunciations.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from ..lat.word_align import segment_words  # noqa: F401  (re-exported)
from ..utils.logging import get_logger

log = get_logger()


def _phone_run(trans_model, lang, tids):
    """Alignment -> list of base phone names (positional suffixes stripped)."""
    seg_phones, _ = trans_model.split_to_phones(tids)
    return [lang.base_phone_of.get(p, lang.phones.sym(p)) for p in seg_phones]


def get_prons(alignments: dict, transcripts_words: dict, trans_model, lang,
              lexicon: dict, silence_phone: str = "SIL"):
    """Returns (pron_counts Counter[(word, pron)], sil_stats dict):
    sil_stats[word] = {"before_sil": n, "before_nonsil": n,
                       "after_sil": n, "after_nonsil": n}."""
    pron_counts: Counter = Counter()
    sil_stats: dict = defaultdict(lambda: Counter())
    n_fail = 0
    for utt, tids in alignments.items():
        if not tids:
            continue
        phones = _phone_run(trans_model, lang, tids)
        words = transcripts_words.get(utt, [])
        seg = segment_words(phones, words, lexicon, silence_phone)
        if seg is None:
            n_fail += 1
            continue
        for i, (word, pron) in enumerate(seg):
            if word is None:
                continue
            pron_counts[(word, pron)] += 1
            before_sil = i > 0 and seg[i - 1][0] is None
            after_sil = i + 1 < len(seg) and seg[i + 1][0] is None
            sil_stats[word]["before_sil" if before_sil else "before_nonsil"] += 1
            sil_stats[word]["after_sil" if after_sil else "after_nonsil"] += 1
    if n_fail:
        log.warning("get_prons: %d utterances failed segmentation", n_fail)
    return pron_counts, {w: dict(c) for w, c in sil_stats.items()}


def estimate_pron_probs(lexicon: dict, pron_counts, smooth: float = 1.0) -> dict:
    """Re-estimate per-word pronunciation probabilities (normalized so the
    best pron of each word has prob 1.0, as the reference's lexiconp
    convention requires)."""
    out: dict = {}
    for word, prons in lexicon.items():
        counts = [pron_counts.get((word, tuple(p[1])), 0) + smooth
                  for p in prons]
        mx = max(counts)
        out[word] = [(c / mx, tuple(p[1])) for c, p in zip(counts, prons)]
    return out


def estimate_silence_probs(sil_stats: dict, smooth: float = 2.0) -> dict:
    """Overall and per-word silence probabilities (silprob.txt role)."""
    tot_sil = sum(c.get("before_sil", 0) for c in sil_stats.values())
    tot = sum(c.get("before_sil", 0) + c.get("before_nonsil", 0)
              for c in sil_stats.values())
    overall = (tot_sil + smooth) / (tot + 2 * smooth) if tot else 0.5
    per_word = {}
    for w, c in sil_stats.items():
        n_sil = c.get("before_sil", 0)
        n = n_sil + c.get("before_nonsil", 0)
        per_word[w] = (n_sil + smooth * overall) / (n + smooth)
    return {"overall": overall, "per_word": per_word}
