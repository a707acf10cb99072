"""Pronunciation dictionary preparation (with automatic G2P).

Counterpart of the reference's ``PrepareDict``
(``scr/utils/prepare_dict.cpp:20-271``): starting from a reference dictionary
(e.g. cmudict-style), train a G2P model if needed (:51-54), generate
pronunciations for the project vocabulary (:73), and merge the silence
lexicon.  Also the ``ValidateDict`` consistency checks.
"""

from __future__ import annotations

from pathlib import Path

from ..g2p.joint import G2PModel
from ..utils.logging import get_logger

log = get_logger()


def read_ref_dict(path: str | Path, strip_stress: bool = False) -> dict:
    """Read 'WORD PH1 PH2 ...' lines -> word -> list of (prob, phones).

    Handles the reference's shipped lexicons (its ``lexicons/
    EN/cmudict.dict`` — 135k lines, ``WORD(2)``-style alternates, ``;;;``
    comments, trailing ``# comment`` fragments on some entries).

    ``strip_stress``: cmudict vowels carry stress digits (``AH0``/``AW1``);
    by default they are KEPT as distinct phones, matching the lexicon the
    reference feeds Phonetisaurus verbatim (``prepare_dict.cpp:51-73``
    passes the file through unmodified).  Pass True to fold the stress
    variants into their base phone (smaller phone set for small corpora).
    Duplicate pronunciations after stripping are merged.
    """
    out: dict[str, list] = {}
    for line in Path(path).read_text(encoding="utf-8").splitlines():
        parts = line.split()
        if not parts or parts[0].startswith(";;;"):
            continue
        word = parts[0].upper()
        # cmudict alternates like WORD(2)
        if "(" in word:
            word = word[: word.index("(")]
        phones = parts[1:]
        if "#" in phones:  # trailing comment ("# abbreviation" etc.)
            phones = phones[: phones.index("#")]
        if strip_stress:
            phones = [p.rstrip("012") for p in phones]
        if not phones:
            continue
        pron = (1.0, tuple(phones))
        if pron not in out.setdefault(word, []):
            out[word].append(pron)
    return out


def prepare_dict(vocab: list, ref_dict: dict, silence_phones: list,
                 optional_silence: str = "SIL", oov_word: str = "<UNK>",
                 g2p_model: G2PModel | None = None,
                 g2p_order: int = 5) -> tuple[dict, G2PModel | None]:
    """Build the task lexicon for ``vocab``.

    Words present in ``ref_dict`` keep their reference pronunciations; missing
    words are phoneticized with a G2P model trained from ``ref_dict`` (lazy,
    only when needed).  Returns (lexicon word -> [(prob, phones)], g2p_model).
    """
    lexicon: dict[str, list] = {}
    missing = []
    for word in sorted(set(w.upper() for w in vocab)):
        if word in ref_dict:
            lexicon[word] = list(ref_dict[word])
        else:
            missing.append(word)
    if missing:
        if g2p_model is None:
            log.info("prepare_dict: training G2P for %d OOV words", len(missing))
            g2p_model = G2PModel.train(ref_dict, order=g2p_order)
        for word in missing:
            prons = g2p_model.pronounce(word, nbest=1)
            if prons and prons[0][0]:
                lexicon[word] = [(1.0, tuple(prons[0][0]))]
                log.info("prepare_dict: G2P %s -> %s", word,
                         " ".join(prons[0][0]))
            else:
                log.warning("prepare_dict: G2P failed for %r; mapping to %s",
                            word, optional_silence)
                lexicon[word] = [(1.0, (optional_silence,))]
    if oov_word not in lexicon:
        lexicon[oov_word] = [(1.0, (optional_silence,))]
    problems = validate_dict(lexicon, silence_phones)
    for p in problems[:10]:
        log.warning("prepare_dict: %s", p)
    return lexicon, g2p_model


def validate_dict(lexicon: dict, silence_phones: list) -> list:
    """ValidateDict (validate_dict_dir.cpp): empty prons, bad symbols."""
    problems = []
    for word, prons in lexicon.items():
        if not prons:
            problems.append(f"word {word!r} has no pronunciations")
        for pr in prons:
            prob, phones = pr
            if not phones:
                problems.append(f"word {word!r} has an empty pronunciation")
            if not (0.0 < prob <= 1.0):
                problems.append(f"word {word!r} has bad pron-prob {prob}")
            for ph in phones:
                if ph == "<eps>":
                    problems.append(f"word {word!r} uses <eps> as a phone")
    return problems
