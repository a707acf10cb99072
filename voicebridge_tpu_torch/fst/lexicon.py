"""Lexicon FSTs: L and L_disambig.

Counterparts: ``make_lexicon_fst.cpp`` (:29-220), ``add_lex_disambig.cpp``
(:1-241) and ``fstaddselfloops`` from the reference's prepare_lang pipeline
(§3.4).  Structure (sil_prob > 0):

    start(0) --eps/eps:nosilcost--> loop(1)        [loop is final]
    start(0) --eps/eps:silcost--> sil(2)
    sil(2)   --SIL/eps--> loop                      [via #n disambig if used]
    each pron: chain from loop; first arc emits the word (+pron cost); the
    last arc forks to loop (nosilcost) and sil (silcost).
"""

from __future__ import annotations

import math

from .core import EPS, Fst


def add_lex_disambig(lexicon: list[tuple]) -> tuple[list[tuple], int]:
    """Add disambiguation symbols to a pronunciation lexicon.

    ``lexicon``: list of (word, pron_prob, phones tuple).  Returns
    (entries with ``disambig`` field = 0 or k for #k, max k used).
    A pron needs a disambig symbol if it is identical to another pron or is a
    prefix of another pron (reference: add_lex_disambig.cpp; same-pron entries
    get successive #1, #2, ...).
    """
    prons = [tuple(p[2]) for p in lexicon]
    count: dict[tuple, int] = {}
    for pr in prons:
        count[pr] = count.get(pr, 0) + 1
    prefixes = set()
    all_prons = set(prons)
    for pr in all_prons:
        for k in range(1, len(pr)):
            prefixes.add(pr[:k])

    last_used: dict[tuple, int] = {}
    max_disambig = 0
    out = []
    for (word, prob, phones) in lexicon:
        pr = tuple(phones)
        if count[pr] > 1 or pr in prefixes:
            cur = last_used.get(pr, 0) + 1
            # ensure a pron that is a prefix of another never shares a
            # disambig that the longer pron's continuation could mimic; simple
            # monotone assignment as in the reference
            last_used[pr] = cur
            max_disambig = max(max_disambig, cur)
            out.append((word, prob, pr, cur))
        else:
            out.append((word, prob, pr, 0))
    return out, max_disambig


def make_lexicon_fst(lexicon: list[tuple], phone_id, word_id,
                     sil_prob: float = 0.5, sil_phone: str = "SIL",
                     sil_disambig: str | None = None) -> Fst:
    """Build L (phones -> words).

    ``lexicon``: (word, pron_prob, phones tuple, disambig_k) — disambig_k=0
    means none, else phone symbol ``#k`` appended.  ``phone_id``/``word_id``:
    symbol -> id callables.  ``sil_disambig``: e.g. "#4" on the silence arc
    for L_disambig (fixes optional-silence nondeterminism).
    """
    f = Fst()
    if sil_prob > 0.0:
        if not (0.0 < sil_prob < 1.0):
            raise ValueError("sil_prob must be in (0,1)")
        sil_cost = -math.log(sil_prob)
        nosil_cost = -math.log(1.0 - sil_prob)
        start = f.add_state()  # 0
        loop = f.add_state()  # 1
        sil = f.add_state()  # 2
        f.set_start(start)
        f.set_final(loop, 0.0)
        f.add_arc(start, EPS, EPS, nosil_cost, loop)
        f.add_arc(start, EPS, EPS, sil_cost, sil)
        if sil_disambig is None:
            f.add_arc(sil, phone_id(sil_phone), EPS, 0.0, loop)
        else:
            d = f.add_state()
            f.add_arc(sil, phone_id(sil_phone), EPS, 0.0, d)
            f.add_arc(d, phone_id(sil_disambig), EPS, 0.0, loop)
    else:
        loop = f.add_state()
        f.set_start(loop)
        f.set_final(loop, 0.0)
        sil = None
        sil_cost = nosil_cost = 0.0

    for (word, prob, phones, disambig_k) in lexicon:
        pron_cost = -math.log(prob) if prob and prob < 1.0 else 0.0
        syms = [phone_id(p) for p in phones]
        if disambig_k:
            syms.append(phone_id(f"#{disambig_k}"))
        s = loop
        w_olabel = word_id(word)
        for i, ph in enumerate(syms):
            last = i == len(syms) - 1
            ol = w_olabel if i == 0 else EPS
            wcost = pron_cost if i == 0 else 0.0
            if not last:
                ns = f.add_state()
                f.add_arc(s, ph, ol, wcost, ns)
                s = ns
            else:
                if sil is None:
                    f.add_arc(s, ph, ol, wcost, loop)
                else:
                    f.add_arc(s, ph, ol, wcost + nosil_cost, loop)
                    f.add_arc(s, ph, ol, wcost + sil_cost, sil)
    f.arcsort("olabel")
    return f


def make_lexicon_fst_silprob(lexicon: list[tuple], phone_id, word_id,
                             silprobs: dict, sil_phone: str = "SIL",
                             sil_disambig: str | None = None) -> Fst:
    """Silence-probability lexicon FST (MakeLexiconFstSilprob,
    make_lexicon_fst_silprob.cpp / prepare_lang.cpp:1374-1414).

    ``silprobs``: {"overall": P(sil between words),
                   "bos_sil": P(sil at sentence start),
                   "per_word_after": word -> P(sil after word),
                   "per_word_before_factor": word -> (F_sil, F_nonsil)}
    Structure: two between-word states (after-silence / after-non-silence);
    word-entry costs carry the before-silence correction factors, word-exit
    branches carry the per-word after-silence probability.
    """
    f = Fst()
    start = f.add_state()
    a_sil = f.add_state()  # just consumed optional silence
    a_non = f.add_state()  # directly after a word
    f.set_start(start)
    f.set_final(a_sil, 0.0)
    f.set_final(a_non, 0.0)

    bos_sil = min(max(silprobs.get("bos_sil", silprobs.get("overall", 0.5)),
                      1e-4), 1 - 1e-4)
    f.add_arc(start, EPS, EPS, -math.log(1.0 - bos_sil), a_non)
    sil_entry = f.add_state()
    f.add_arc(start, EPS, EPS, -math.log(bos_sil), sil_entry)
    if sil_disambig is None:
        f.add_arc(sil_entry, phone_id(sil_phone), EPS, 0.0, a_sil)
    else:
        d = f.add_state()
        f.add_arc(sil_entry, phone_id(sil_phone), EPS, 0.0, d)
        f.add_arc(d, phone_id(sil_disambig), EPS, 0.0, a_sil)

    per_after = silprobs.get("per_word_after", {})
    per_before = silprobs.get("per_word_before_factor", {})
    overall = min(max(silprobs.get("overall", 0.5), 1e-4), 1 - 1e-4)

    for (word, prob, phones, disambig_k) in lexicon:
        pron_cost = -math.log(prob) if prob and prob < 1.0 else 0.0
        f_sil, f_non = per_before.get(word, (1.0, 1.0))
        cost_from_sil = pron_cost - math.log(max(f_sil, 1e-4))
        cost_from_non = pron_cost - math.log(max(f_non, 1e-4))
        p_after = min(max(per_after.get(word, overall), 1e-4), 1 - 1e-4)
        syms = [phone_id(p) for p in phones]
        if disambig_k:
            syms.append(phone_id(f"#{disambig_k}"))
        w_ol = word_id(word)
        # shared chain after the first arc; fork the entries, fork the exit
        states = [f.add_state() for _ in range(len(syms))]
        f.add_arc(a_sil, syms[0], w_ol, cost_from_sil, states[0])
        f.add_arc(a_non, syms[0], w_ol, cost_from_non, states[0])
        for i in range(1, len(syms)):
            f.add_arc(states[i - 1], syms[i], EPS, 0.0, states[i])
        last = states[-1]
        # exit: silence branch or directly to the next word
        f.add_arc(last, EPS, EPS, -math.log(1.0 - p_after), a_non)
        sil_x = f.add_state()
        f.add_arc(last, EPS, EPS, -math.log(p_after), sil_x)
        if sil_disambig is None:
            f.add_arc(sil_x, phone_id(sil_phone), EPS, 0.0, a_sil)
        else:
            d = f.add_state()
            f.add_arc(sil_x, phone_id(sil_phone), EPS, 0.0, d)
            f.add_arc(d, phone_id(sil_disambig), EPS, 0.0, a_sil)
    f.arcsort("olabel")
    return f


def silprobs_from_stats(sil_stats: dict, overall: float) -> dict:
    """Convert get_prons silence statistics into the silprob lexicon's
    parameter dict (silprob.txt role)."""
    per_after = {}
    per_before_factor = {}
    for w, c in sil_stats.items():
        n_after = c.get("after_sil", 0) + c.get("after_nonsil", 0)
        if n_after:
            per_after[w] = (c.get("after_sil", 0) + 2.0 * overall) / (n_after + 2.0)
        n_before = c.get("before_sil", 0) + c.get("before_nonsil", 0)
        if n_before:
            p_before = (c.get("before_sil", 0) + 2.0 * overall) / (n_before + 2.0)
            per_before_factor[w] = (max(p_before / overall, 1e-3),
                                    max((1 - p_before) / (1 - overall), 1e-3))
    return {"overall": overall, "bos_sil": overall,
            "per_word_after": per_after,
            "per_word_before_factor": per_before_factor}


def add_word_disambig_selfloops(f: Fst, phone_disambig_id: int,
                                word_disambig_id: int) -> Fst:
    """fstaddselfloops: let the LM backoff symbol #0 pass through L
    (self-loop ilabel=#0_phone / olabel=#0_word at the start and loop
    states — every inter-word position passes through them)."""
    targets = {f.start}
    for s in f.states():
        if f.is_final(s):
            targets.add(s)
    for s in targets:
        f.add_arc(s, phone_disambig_id, word_disambig_id, 0.0, s)
    f.arcsort("olabel")
    return f
