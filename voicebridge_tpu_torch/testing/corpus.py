"""LibriSpeech-shaped synthetic corpus: ~200-word lexicon (ARPAbet, CMU-style
pronunciations), a template grammar producing natural-ish sentences, and a
corpus generator with per-speaker formant/pitch/rate variation.

Counterpart of the reference's example data (VoiceBridgeProjects repo,
``README.md`` step f): the reference trains/tests on real LibriSpeech audio;
this generates a structurally equivalent corpus offline (see synthesis.py for
why).  The WER oracle role (``TestDll/TestDll/LibriSpeech.cpp:40``) is played
by examples/librispeech_shaped.py.
"""

from __future__ import annotations

import numpy as np

from .synthesis import Speaker, synth_utterance

# word -> [(prob, phones)]; ARPAbet without stress, CMU-style.
_RAW = {
    # determiners / pronouns
    "THE": "DH AH", "A": "AH", "THIS": "DH IH S", "THAT": "DH AE T",
    "SOME": "S AH M", "EVERY": "EH V R IY", "HE": "HH IY", "SHE": "SH IY",
    "THEY": "DH EY", "WE": "W IY", "IT": "IH T", "YOU": "Y UW",
    "HIS": "HH IH Z", "HER": "HH ER", "THEIR": "DH EH R", "MY": "M AY",
    "OUR": "AW ER",
    # nouns
    "CAT": "K AE T", "DOG": "D AO G", "MAN": "M AE N",
    "WOMAN": "W UH M AH N", "CHILD": "CH AY L D", "HOUSE": "HH AW S",
    "RIVER": "R IH V ER", "ROAD": "R OW D", "TREE": "T R IY",
    "BIRD": "B ER D", "HORSE": "HH AO R S", "TABLE": "T EY B AH L",
    "CHAIR": "CH EH R", "WINDOW": "W IH N D OW", "DOOR": "D AO R",
    "WATER": "W AO T ER", "FIRE": "F AY ER", "MOUNTAIN": "M AW N T AH N",
    "GARDEN": "G AA R D AH N", "CITY": "S IH T IY", "NIGHT": "N AY T",
    "MORNING": "M AO R N IH NG", "PAPER": "P EY P ER", "BOOK": "B UH K",
    "STORY": "S T AO R IY", "VOICE": "V OY S", "MUSIC": "M Y UW Z IH K",
    "FRIEND": "F R EH N D", "FATHER": "F AA DH ER", "MOTHER": "M AH DH ER",
    "BROTHER": "B R AH DH ER", "SISTER": "S IH S T ER",
    "TEACHER": "T IY CH ER", "DOCTOR": "D AA K T ER",
    "FARMER": "F AA R M ER", "KING": "K IH NG", "QUEEN": "K W IY N",
    "SHIP": "SH IH P", "BOAT": "B OW T", "TRAIN": "T R EY N",
    "STREET": "S T R IY T", "MARKET": "M AA R K AH T",
    "VILLAGE": "V IH L AH JH", "FOREST": "F AO R AH S T",
    "STONE": "S T OW N", "FIELD": "F IY L D", "SUMMER": "S AH M ER",
    "WINTER": "W IH N T ER", "EVENING": "IY V N IH NG",
    "CHILDREN": "CH IH L D R AH N", "PEOPLE": "P IY P AH L",
    "MONEY": "M AH N IY", "LETTER": "L EH T ER", "GLASS": "G L AE S",
    "BREAD": "B R EH D", "APPLE": "AE P AH L", "COFFEE": "K AO F IY",
    "DINNER": "D IH N ER", "SCHOOL": "S K UW L", "CHURCH": "CH ER CH",
    "BRIDGE": "B R IH JH", "CORNER": "K AO R N ER", "LIGHT": "L AY T",
    "TELEVISION": "T EH L AH V IH ZH AH N", "GOLD": "G OW L D",
    "SHADOW": "SH AE D OW", "SONG": "S AO NG", "WIND": "W IH N D",
    "RAIN": "R EY N", "SNOW": "S N OW", "STAR": "S T AA R",
    "MOON": "M UW N", "CLOUD": "K L AW D", "OCEAN": "OW SH AH N",
    # verbs (mostly past tense, story register)
    "IS": "IH Z", "WAS": "W AA Z", "WERE": "W ER", "SAW": "S AO",
    "TOOK": "T UH K", "GAVE": "G EY V", "MADE": "M EY D",
    "FOUND": "F AW N D", "CALLED": "K AO L D", "OPENED": "OW P AH N D",
    "CLOSED": "K L OW Z D", "WATCHED": "W AA CH T",
    "FOLLOWED": "F AA L OW D", "REACHED": "R IY CH T",
    "CROSSED": "K R AO S T", "CARRIED": "K AE R IY D", "BOUGHT": "B AO T",
    "SOLD": "S OW L D", "BUILT": "B IH L T", "BROKE": "B R OW K",
    "MOVED": "M UW V D", "LOVED": "L AH V D", "HEARD": "HH ER D",
    "TOLD": "T OW L D", "ASKED": "AE S K T", "ANSWERED": "AE N S ER D",
    "WALKED": "W AO K T", "RAN": "R AE N", "CAME": "K EY M",
    "WENT": "W EH N T", "LEFT": "L EH F T", "STAYED": "S T EY D",
    "LIVED": "L IH V D", "WORKED": "W ER K T", "PLAYED": "P L EY D",
    "READ": "R EH D", "WROTE": "R OW T", "SPOKE": "S P OW K",
    "SANG": "S AE NG", "STOOD": "S T UH D", "SAT": "S AE T",
    "FELL": "F EH L", "HELD": "HH EH L D", "KEPT": "K EH P T",
    "LOST": "L AO S T", "WON": "W AH N", "KNEW": "N UW",
    "THOUGHT": "TH AO T", "SEEMED": "S IY M D", "BECAME": "B IH K EY M",
    "REMEMBERED": "R IH M EH M B ER D", "WANTED": "W AA N T IH D",
    "NEEDED": "N IY D IH D", "LIKED": "L AY K T", "SHOWED": "SH OW D",
    "TURNED": "T ER N D", "WAITED": "W EY T IH D", "LOOKED": "L UH K T",
    "SMILED": "S M AY L D", "LAUGHED": "L AE F T", "CRIED": "K R AY D",
    "SLEPT": "S L EH P T", "DREAMED": "D R IY M D",
    # adjectives
    "OLD": "OW L D", "YOUNG": "Y AH NG", "BIG": "B IH G",
    "SMALL": "S M AO L", "LONG": "L AO NG", "SHORT": "SH AO R T",
    "DARK": "D AA R K", "BRIGHT": "B R AY T", "COLD": "K OW L D",
    "WARM": "W AO R M", "QUIET": "K W AY AH T", "HAPPY": "HH AE P IY",
    "TIRED": "T AY ER D", "GREEN": "G R IY N", "WHITE": "W AY T",
    "BLACK": "B L AE K", "RED": "R EH D", "BLUE": "B L UW",
    "BEAUTIFUL": "B Y UW T AH F AH L", "STRANGE": "S T R EY N JH",
    "HEAVY": "HH EH V IY", "EMPTY": "EH M P T IY",
    "GOLDEN": "G OW L D AH N", "SILENT": "S AY L AH N T",
    "ANCIENT": "EY N SH AH N T",
    # prepositions / conjunctions / adverbs
    "IN": "IH N", "ON": "AA N", "AT": "AE T", "BY": "B AY", "TO": "T UW",
    "FROM": "F R AH M", "WITH": "W IH DH", "OVER": "OW V ER",
    "UNDER": "AH N D ER", "NEAR": "N IH R", "THROUGH": "TH R UW",
    "ACROSS": "AH K R AO S", "BEHIND": "B IH HH AY N D",
    "BETWEEN": "B IH T W IY N", "AND": "AE N D", "BUT": "B AH T",
    "WHILE": "W AY L", "WHEN": "W EH N", "THEN": "DH EH N",
    "AGAIN": "AH G EH N", "ALWAYS": "AO L W EY Z", "NEVER": "N EH V ER",
    "OFTEN": "AO F AH N", "SLOWLY": "S L OW L IY",
    "QUICKLY": "K W IH K L IY", "QUIETLY": "K W AY AH T L IY",
    "SUDDENLY": "S AH D AH N L IY", "TOGETHER": "T AH G EH DH ER",
    "HOME": "HH OW M", "AWAY": "AH W EY", "OUTSIDE": "AW T S AY D",
    "INSIDE": "IH N S AY D", "YESTERDAY": "Y EH S T ER D EY",
    "TODAY": "T AH D EY", "TONIGHT": "T AH N AY T",
    "USUALLY": "Y UW ZH AH L IY",
}

LEXICON = {w: [(1.0, tuple(p.split()))] for w, p in _RAW.items()}

_DETS = ["THE", "THE", "THE", "A", "THIS", "THAT", "SOME", "EVERY",
         "HIS", "HER", "THEIR", "MY", "OUR"]
_NOUNS = ["CAT", "DOG", "MAN", "WOMAN", "CHILD", "HOUSE", "RIVER", "ROAD",
          "TREE", "BIRD", "HORSE", "TABLE", "CHAIR", "WINDOW", "DOOR",
          "WATER", "FIRE", "MOUNTAIN", "GARDEN", "CITY", "NIGHT", "MORNING",
          "PAPER", "BOOK", "STORY", "VOICE", "MUSIC", "FRIEND", "FATHER",
          "MOTHER", "BROTHER", "SISTER", "TEACHER", "DOCTOR", "FARMER",
          "KING", "QUEEN", "SHIP", "BOAT", "TRAIN", "STREET", "MARKET",
          "VILLAGE", "FOREST", "STONE", "FIELD", "SUMMER", "WINTER",
          "EVENING", "CHILDREN", "PEOPLE", "MONEY", "LETTER", "GLASS",
          "BREAD", "APPLE", "COFFEE", "DINNER", "SCHOOL", "CHURCH",
          "BRIDGE", "CORNER", "LIGHT", "TELEVISION", "GOLD", "SHADOW",
          "SONG", "WIND", "RAIN", "SNOW", "STAR", "MOON", "CLOUD", "OCEAN"]
_VERBS = ["SAW", "TOOK", "GAVE", "MADE", "FOUND", "CALLED", "OPENED",
          "CLOSED", "WATCHED", "FOLLOWED", "REACHED", "CROSSED", "CARRIED",
          "BOUGHT", "SOLD", "BUILT", "BROKE", "MOVED", "LOVED", "HEARD",
          "TOLD", "ASKED", "ANSWERED", "REMEMBERED", "WANTED", "NEEDED",
          "LIKED", "SHOWED", "TURNED", "WATCHED", "HELD", "KEPT", "LOST",
          "WON", "KNEW", "READ", "WROTE"]
_IVERBS = ["WALKED", "RAN", "CAME", "WENT", "STAYED", "LIVED", "WORKED",
           "PLAYED", "SPOKE", "SANG", "STOOD", "SAT", "FELL", "SLEPT",
           "DREAMED", "SMILED", "LAUGHED", "CRIED", "WAITED", "LOOKED",
           "TURNED"]
_ADJS = ["OLD", "YOUNG", "BIG", "SMALL", "LONG", "SHORT", "DARK", "BRIGHT",
         "COLD", "WARM", "QUIET", "HAPPY", "TIRED", "GREEN", "WHITE",
         "BLACK", "RED", "BLUE", "BEAUTIFUL", "STRANGE", "HEAVY", "EMPTY",
         "GOLDEN", "SILENT", "ANCIENT"]
_PREPS = ["IN", "ON", "AT", "BY", "FROM", "WITH", "OVER", "UNDER", "NEAR",
          "THROUGH", "ACROSS", "BEHIND", "BETWEEN"]
_ADVS = ["SLOWLY", "QUICKLY", "QUIETLY", "SUDDENLY", "TOGETHER", "AGAIN",
         "ALWAYS", "NEVER", "OFTEN", "YESTERDAY", "TODAY", "TONIGHT",
         "USUALLY", "HOME", "AWAY", "OUTSIDE", "INSIDE"]
_PRONS = ["HE", "SHE", "THEY", "WE", "IT", "YOU"]


def _np(rng, adj_p=0.45):
    """A noun phrase."""
    out = [str(rng.choice(_DETS))]
    if rng.random() < adj_p:
        out.append(str(rng.choice(_ADJS)))
    out.append(str(rng.choice(_NOUNS)))
    return out


def _clause(rng):
    subj = ([str(rng.choice(_PRONS))] if rng.random() < 0.35 else _np(rng))
    if rng.random() < 0.35:
        words = subj + [str(rng.choice(_IVERBS))]
        if rng.random() < 0.6:
            words += [str(rng.choice(_PREPS))] + _np(rng)
    else:
        words = subj + [str(rng.choice(_VERBS))] + _np(rng)
        if rng.random() < 0.35:
            words += [str(rng.choice(_PREPS))] + _np(rng)
    if rng.random() < 0.3:
        pos = 0 if rng.random() < 0.4 else len(words)
        words[pos:pos] = [str(rng.choice(_ADVS))]
    return words


def sample_sentence(rng: np.random.Generator) -> list[str]:
    words = _clause(rng)
    r = rng.random()
    if r < 0.18:
        words += [str(rng.choice(["AND", "BUT", "WHILE", "WHEN", "THEN"]))]
        words += _clause(rng)
    return words


def make_corpus(num_speakers: int = 60, utts_per_speaker: int = 20,
                num_test_per: int = 3, seed: int = 0, snr_db: float = 30.0):
    """Generate a speaker-varied corpus.

    Returns (train, test, utt2spk): dicts utt -> (wave float32 @16 kHz,
    word list).  Default size: 60 speakers x 20 utts ~= 1.2k utts / ~1 h.
    """
    rng = np.random.default_rng(seed)
    train, test, utt2spk = {}, {}, {}
    for s in range(num_speakers):
        spk = Speaker.random(f"spk{s:03d}", rng)
        for i in range(utts_per_speaker + num_test_per):
            words = sample_sentence(rng)
            wave = synth_utterance(words, LEXICON, spk, rng, snr_db=snr_db)
            if i < utts_per_speaker:
                key = f"{spk.name}_train_{i:03d}"
                train[key] = (wave, words)
            else:
                key = f"{spk.name}_test_{i:03d}"
                test[key] = (wave, words)
            utt2spk[key] = spk.name
    return train, test, utt2spk


def write_corpus(waves_dir, train: dict, test: dict, utt2spk: dict,
                 sr: int = 16000) -> None:
    """Write wav + .txt transcript per utterance in the layout
    Project.prepare_data scans (speaker subdirectories -> idtype=0)."""
    from ..utils.wave import write_wave

    for utt, (wave, words) in {**train, **test}.items():
        spk = utt2spk[utt]
        write_wave(waves_dir / spk / f"{utt}.wav", sr, wave)
        (waves_dir / spk / f"{utt}.txt").write_text(" ".join(words))
