"""Word alignment of decoded paths: exact per-word frame spans.

Counterpart of the reference's ``lattice-align-words`` /
``lattice-align-words-lexicon`` + ``nbest-to-prons`` chain
(``latbin/lattice-align-words{,-lexicon}.cpp``,
``lat/word-align-lattice{,-lexicon}.{h,cc}``, ``latbin/nbest-to-prons.cpp``;
used by ``scr/steps/get_prons.cpp`` via Lattice1best -> LatticeAlignWords ->
NbestToProns, ``kaldi_scr.h:307-312``).

The reference realigns a (1-best) lattice so that each arc carries exactly one
word together with that word's transition-ids, making word begin/end times
exact. Here the decoded path already carries frame-synchronous transition-ids,
so the equivalent is: split the alignment into phone instances
(``SplitToPhones``), then attach phones to words either

- by the **lexicon** (``align_words_lexicon``): Viterbi-match the transcript's
  candidate pronunciations against the phone run (the -lexicon variant), or
- by **word-boundary info** (``align_words_boundary``): use the
  position-dependent phone suffixes _B/_I/_E/_S, the role of Kaldi's
  ``word_boundary.int`` file in the non-lexicon variant.

Both yield ``WordSegment`` lists with exact frame times, from which CTM rows
(`utt chan start dur word`) and NbestToProns rows are emitted.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class WordSegment:
    word: object            # word string, or None for silence
    begin_frame: int
    num_frames: int
    pron: tuple             # base phone names
    phone_durations: tuple  # frames per phone, aligned with pron


def segment_words(phones: list, words: list, lexicon: dict,
                  silence_phone: str = "SIL"):
    """Viterbi segmentation of a phone run into
    [optional sil] word1 [optional sil] word2 ... [optional sil].

    Returns list of (word or None-for-sil, phones tuple) or None if the run
    doesn't match the transcript (WordAlignLatticeLexicon's alignment-failure
    case)."""
    n = len(phones)
    memo: dict = {}

    def solve(pos, widx):
        key = (pos, widx)
        if key in memo:
            return memo[key]
        result = None
        sil_end = pos
        while sil_end < n and phones[sil_end] == silence_phone:
            sil_end += 1
        for spos in (pos, sil_end) if sil_end > pos else (pos,):
            sil_seg = [(None, tuple(phones[pos:spos]))] if spos > pos else []
            if widx == len(words):
                if spos == n:
                    result = sil_seg
                    break
                continue
            word = words[widx]
            for _prob, pron in lexicon.get(word, ()):
                pron = tuple(pron)
                k = len(pron)
                if spos + k <= n and tuple(phones[spos:spos + k]) == pron:
                    rest = solve(spos + k, widx + 1)
                    if rest is not None:
                        result = sil_seg + [(word, pron)] + rest
                        break
            if result is not None:
                break
        memo[key] = result
        return result

    return solve(0, 0)


def _phone_segments(tids, trans_model, lang):
    """Alignment -> (base phone names, positional names, frames per phone)."""
    seg_phones, seg_of_frame = trans_model.split_to_phones(tids)
    durations = [0] * len(seg_phones)
    for s in seg_of_frame:
        durations[int(s)] += 1
    base = [lang.base_phone_of.get(p, lang.phones.sym(p)) for p in seg_phones]
    names = [lang.phones.sym(p) for p in seg_phones]
    return base, names, durations


def _build_segments(seg, durations):
    """(word, pron) list + per-phone frame counts -> WordSegment list."""
    out = []
    frame = 0
    pos = 0
    for word, pron in seg:
        k = len(pron)
        durs = tuple(durations[pos:pos + k])
        nf = sum(durs)
        out.append(WordSegment(word, frame, nf, tuple(pron), durs))
        frame += nf
        pos += k
    return out


def align_words_lexicon(tids, words, trans_model, lang, lexicon,
                        silence_phone: str = "SIL"):
    """Exact word alignment via the lexicon
    (``lattice-align-words-lexicon`` role over a 1-best path).

    Returns a list of ``WordSegment`` (silence spans have ``word=None``) or
    None if the phone run doesn't match any transcript pronunciation chain.
    """
    base, _names, durations = _phone_segments(tids, trans_model, lang)
    seg = segment_words(base, list(words), lexicon, silence_phone)
    if seg is None:
        return None
    return _build_segments(seg, durations)


def align_words_boundary(tids, words, trans_model, lang):
    """Exact word alignment via position-dependent phone suffixes
    (``lattice-align-words`` with ``word_boundary.int`` role: _B begins a
    word, _E ends it, _S is a singleton, suffixless phones are silence/other).

    Requires the lang to be built with position-dependent phones. Returns a
    ``WordSegment`` list or None when the suffix structure is inconsistent
    with the number of words (the reference's alignment-failure case).
    """
    base, names, durations = _phone_segments(tids, trans_model, lang)
    groups: list[tuple] = []  # (is_word, [phone indices])
    i = 0
    n = len(names)
    while i < n:
        suffix = names[i].rsplit("_", 1)[-1] if "_" in names[i] else ""
        if suffix == "S":
            groups.append((True, [i]))
            i += 1
        elif suffix == "B":
            j = i + 1
            while j < n and names[j].endswith("_I"):
                j += 1
            if j >= n or not names[j].endswith("_E"):
                return None  # _B run not closed by _E
            groups.append((True, list(range(i, j + 1))))
            i = j + 1
        elif suffix in ("I", "E"):
            return None  # word-internal phone outside a word
        else:
            groups.append((False, [i]))  # silence / non-positional phone
            i += 1
    if sum(1 for is_word, _ in groups if is_word) != len(words):
        return None
    seg = []
    widx = 0
    for is_word, idxs in groups:
        pron = tuple(base[k] for k in idxs)
        if is_word:
            seg.append((words[widx], pron))
            widx += 1
        else:
            seg.append((None, pron))
    # merge adjacent silence groups into one span (reference keeps one arc
    # per silence phone; one span per run is the more useful invariant here)
    merged = []
    for word, pron in seg:
        if word is None and merged and merged[-1][0] is None:
            merged[-1] = (None, merged[-1][1] + pron)
        else:
            merged.append((word, pron))
    return _build_segments(merged, durations)


def to_ctm(segments, utt_id: str, frame_shift: float = 0.01,
           channel: str = "1", include_silence: bool = False) -> list[str]:
    """CTM rows ``utt chan start dur word`` from word segments
    (``nbest-to-ctm`` convention; times in seconds)."""
    rows = []
    for s in segments:
        if s.word is None and not include_silence:
            continue
        rows.append("%s %s %.2f %.2f %s" % (
            utt_id, channel, s.begin_frame * frame_shift,
            s.num_frames * frame_shift,
            s.word if s.word is not None else "<sil>"))
    return rows


def prons_rows(segments, utt_id: str) -> list[str]:
    """``nbest-to-prons`` output rows:
    ``utt begin-frame num-frames word phone1 phone2 ...``
    (latbin/nbest-to-prons.cpp output format)."""
    rows = []
    for s in segments:
        if s.word is None:
            continue
        rows.append("%s %d %d %s %s" % (
            utt_id, s.begin_frame, s.num_frames, s.word, " ".join(s.pron)))
    return rows
