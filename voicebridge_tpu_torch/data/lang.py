"""Language directory preparation: phones/words tables, topology, L / L_disambig.

Counterpart of the reference's PrepareLang (``scr/utils/prepare_lang.cpp``,
1 483 LoC; call trace SURVEY.md §3.4): position-dependent phone handling,
lexicon disambiguation (``AddLexDisambig``), phones.txt / words.txt symbol
tables, HMM topology generation (3 nonsil / 5 sil states), L.fst and
L_disambig.fst construction.

A ``Lang`` object is the in-memory equivalent of Kaldi's ``data/lang`` dir and
can be saved/loaded as a directory of small files.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path

from ..config import LangOptions
from ..fst.core import Fst
from ..fst.lexicon import (add_lex_disambig, add_word_disambig_selfloops,
                           make_lexicon_fst, make_lexicon_fst_silprob)
from ..models.topology import HmmTopology, generate_topology
from ..utils.text import SymbolTable

POSITION_SUFFIXES = ("_B", "_E", "_I", "_S")


@dataclass
class Lang:
    phones: SymbolTable
    words: SymbolTable
    topo: HmmTopology
    L: Fst
    L_disambig: Fst
    silence_phone_ids: list  # all silence phone ids (incl. positional variants)
    optional_silence_id: int
    disambig_ids: list  # phone-side ids of #0..#N
    word_disambig_id: int  # word-side id of #0
    oov_word: str
    num_disambig: int
    position_dependent: bool = True
    base_phone_of: dict = field(default_factory=dict)  # phone id -> base name

    @property
    def phone_ids(self) -> list:
        """Real phone ids (no eps, no disambig)."""
        dis = set(self.disambig_ids)
        return [i for i, _s in self.phones.items() if i != 0 and i not in dis]

    def nonsilence_phone_ids(self) -> list:
        sil = set(self.silence_phone_ids)
        return [i for i in self.phone_ids if i not in sil]

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self.phones.write(path / "phones.txt")
        self.words.write(path / "words.txt")
        self.topo.save(path / "topo.json")
        self.L.save(path / "L.fst.npz")
        self.L_disambig.save(path / "L_disambig.fst.npz")
        meta = {
            "silence_phone_ids": self.silence_phone_ids,
            "optional_silence_id": self.optional_silence_id,
            "disambig_ids": self.disambig_ids,
            "word_disambig_id": self.word_disambig_id,
            "oov_word": self.oov_word,
            "num_disambig": self.num_disambig,
            "position_dependent": self.position_dependent,
            "base_phone_of": {str(k): v for k, v in self.base_phone_of.items()},
        }
        (path / "meta.json").write_text(json.dumps(meta))

    @classmethod
    def load(cls, path: str | Path) -> "Lang":
        path = Path(path)
        meta = json.loads((path / "meta.json").read_text())
        return cls(
            phones=SymbolTable.read(path / "phones.txt"),
            words=SymbolTable.read(path / "words.txt"),
            topo=HmmTopology.load(path / "topo.json"),
            L=Fst.load(path / "L.fst.npz"),
            L_disambig=Fst.load(path / "L_disambig.fst.npz"),
            silence_phone_ids=meta["silence_phone_ids"],
            optional_silence_id=meta["optional_silence_id"],
            disambig_ids=meta["disambig_ids"],
            word_disambig_id=meta["word_disambig_id"],
            oov_word=meta["oov_word"],
            num_disambig=meta["num_disambig"],
            position_dependent=meta["position_dependent"],
            base_phone_of={int(k): v for k, v in meta["base_phone_of"].items()},
        )


def validate_lang(lang: Lang) -> list:
    """ValidateLang (validate_lang.cpp, 1 153 LoC): structural consistency
    checks on a built Lang; returns a list of problems (empty = valid)."""
    problems = []
    if "<eps>" not in lang.phones or lang.phones.id("<eps>") != 0:
        problems.append("phones.txt must map <eps> to 0")
    if "<eps>" not in lang.words or lang.words.id("<eps>") != 0:
        problems.append("words.txt must map <eps> to 0")
    dis = set(lang.disambig_ids)
    for i in lang.phone_ids:
        if i in dis:
            problems.append(f"phone id {i} is both real and disambig")
    if lang.optional_silence_id not in set(lang.silence_phone_ids):
        problems.append("optional silence not among silence phones")
    for p in lang.phone_ids:
        if p not in lang.topo.entries:
            problems.append(f"phone {lang.phones.sym(p)} has no topology entry")
    # L must be functional enough: every arc's labels in range
    max_ph = lang.phones.max_id()
    max_w = lang.words.max_id()
    for f, name in ((lang.L, "L"), (lang.L_disambig, "L_disambig")):
        if f.start < 0:
            problems.append(f"{name} has no start state")
            continue
        for s in f.states():
            for a in f.arcs[s]:
                if not (0 <= a.ilabel <= max_ph):
                    problems.append(f"{name}: bad ilabel {a.ilabel}")
                if not (0 <= a.olabel <= max_w):
                    problems.append(f"{name}: bad olabel {a.olabel}")
    # lexicon coverage: every real word must be emittable by L
    # (validate_lang.cpp's words.txt<->L.fst cross-check)
    emitted = {a.olabel for s in lang.L.states() for a in lang.L.arcs[s]}
    special = {0, lang.word_disambig_id}
    for w in range(1, max_w + 1):
        try:
            sym = lang.words.sym(w)
        except KeyError:
            continue
        if w in special or sym in ("<s>", "</s>", "<unk>"):
            continue
        if w not in emitted:
            problems.append(f"word {sym!r} (id {w}) has no pronunciation in L")
    # connectivity: L must admit at least one complete path
    from ..fst.core import ZERO
    if lang.L.start >= 0:
        seen = {lang.L.start}
        stack = [lang.L.start]
        reach_final = False
        while stack:
            s = stack.pop()
            if lang.L.finals[s] != ZERO:
                reach_final = True
            for a in lang.L.arcs[s]:
                if a.nextstate not in seen:
                    seen.add(a.nextstate)
                    stack.append(a.nextstate)
        if not reach_final:
            problems.append("L has no path from start to a final state")
    return problems


def _positionize(pron: tuple[str, ...]) -> tuple[str, ...]:
    """Apply word-position-dependent suffixes (prepare_lang.cpp behavior)."""
    if len(pron) == 1:
        return (pron[0] + "_S",)
    return tuple(
        p + ("_B" if i == 0 else "_E" if i == len(pron) - 1 else "_I")
        for i, p in enumerate(pron)
    )


def prepare_lang(lexicon: dict[str, list[tuple]], silence_phones: list[str],
                 optional_silence: str, opts: LangOptions = LangOptions(),
                 silprobs: dict | None = None) -> Lang:
    """Build a Lang from a pronunciation lexicon.

    ``lexicon``: word -> list of (prob, phones tuple) pronunciations (base
    phone names, no positional suffixes).  ``silence_phones`` must include
    ``optional_silence``; the OOV word gets a pronunciation of the optional
    silence phone if absent (like the reference's default dict handling).

    ``silprobs``: optional silence-probability parameters (silprob.txt role;
    see fst/lexicon.py silprobs_from_stats) — switches L/L_disambig to the
    word-dependent silence model (prepare_lang.cpp silprob branch :1374).
    """
    if optional_silence not in silence_phones:
        raise ValueError("optional_silence must be among silence_phones")
    lexicon = dict(lexicon)
    if opts.oov_word not in lexicon:
        lexicon[opts.oov_word] = [(1.0, (optional_silence,))]

    # --- flatten + positionize prons ---------------------------------------
    entries = []  # (word, prob, positionized pron)
    nonsil_base = set()
    sil_base = set(silence_phones)
    for word in sorted(lexicon):
        for prob, pron in lexicon[word]:
            pron = tuple(pron)
            if not pron:
                raise ValueError(f"empty pronunciation for {word!r}")
            for p in pron:
                if p not in sil_base:
                    nonsil_base.add(p)
            if opts.position_dependent_phones:
                # silence phones inside prons get suffixes too (Kaldi behavior)
                entries.append((word, prob, _positionize(pron)))
            else:
                entries.append((word, prob, pron))

    # --- phone symbol table -------------------------------------------------
    phones = SymbolTable()
    phones.add("<eps>", 0)
    base_phone_of: dict[int, str] = {}
    phone_names: list[str] = []
    if opts.position_dependent_phones:
        for p in sorted(sil_base):
            phone_names.append(p)  # bare silence (optional-silence insertions)
            phone_names.extend(p + s for s in POSITION_SUFFIXES)
        for p in sorted(nonsil_base):
            phone_names.extend(p + s for s in POSITION_SUFFIXES)
    else:
        phone_names.extend(sorted(sil_base))
        phone_names.extend(sorted(nonsil_base))
    for name in phone_names:
        i = phones.add(name)
        base = name
        for s in POSITION_SUFFIXES:
            if name.endswith(s):
                base = name[: -len(s)]
                break
        base_phone_of[i] = base

    # --- lexicon disambiguation --------------------------------------------
    disambig_lex, ndis_lex = add_lex_disambig(entries)
    num_disambig = ndis_lex + 1  # +1 reserves #ndis+... for optional silence
    sil_disambig = f"#{num_disambig}"
    # disambig phone symbols #0..#num_disambig
    disambig_ids = []
    for k in range(0, num_disambig + 1):
        disambig_ids.append(phones.add(f"#{k}"))

    # --- word symbol table ---------------------------------------------------
    words = SymbolTable()
    words.add("<eps>", 0)
    for w in sorted(lexicon):
        words.add(w)
    word_disambig_id = words.add("#0")
    words.add("<s>")
    words.add("</s>")

    # --- silence ids ---------------------------------------------------------
    silence_phone_ids = []
    for i, _s in phones.items():
        base = base_phone_of.get(i)
        if base in sil_base:
            silence_phone_ids.append(i)
    optional_silence_id = phones.id(optional_silence)

    # --- topology ------------------------------------------------------------
    nonsil_ids = [i for i in range(1, phones.max_id() + 1)
                  if i in base_phone_of and base_phone_of[i] not in sil_base]
    topo = generate_topology(nonsil_ids, silence_phone_ids,
                             opts.num_nonsil_states, opts.num_sil_states)

    # --- L and L_disambig ----------------------------------------------------
    plain_lex = [(w, p, pron, 0) for (w, p, pron) in entries]
    if silprobs is not None:
        L = make_lexicon_fst_silprob(plain_lex, phones.id, words.id, silprobs,
                                     optional_silence, sil_disambig=None)
        Ld = make_lexicon_fst_silprob(disambig_lex, phones.id, words.id,
                                      silprobs, optional_silence,
                                      sil_disambig=sil_disambig)
    else:
        L = make_lexicon_fst(plain_lex, phones.id, words.id, opts.sil_prob,
                             optional_silence, sil_disambig=None)
        Ld = make_lexicon_fst(disambig_lex, phones.id, words.id, opts.sil_prob,
                              optional_silence, sil_disambig=sil_disambig)
    add_word_disambig_selfloops(Ld, phones.id("#0"), word_disambig_id)

    return Lang(
        phones=phones, words=words, topo=topo, L=L, L_disambig=Ld,
        silence_phone_ids=silence_phone_ids,
        optional_silence_id=optional_silence_id,
        disambig_ids=disambig_ids, word_disambig_id=word_disambig_id,
        oov_word=opts.oov_word, num_disambig=num_disambig,
        position_dependent=opts.position_dependent_phones,
        base_phone_of=base_phone_of,
    )
