"""ARPA language-model I/O and compilation to G.fst.

Counterparts: the reference's ``arpa2fst`` (``kaldi-win/src/lmbin/arpa2fst.cpp``
via ``lm/arpa-lm-compiler.cc``) and MITLM's ARPA writer.  Backoff arcs carry
the ``#0`` disambiguation symbol on the input side (``prepare_test_lms.cpp:51-53``).

G construction (standard): one state per seen history; <s> is the start
history; </s> n-grams become final weights; backoff arcs go to the
shortened-history state with the backoff cost.  Weights are -ln(p)
(ARPA stores log10).
"""

from __future__ import annotations

import math
from pathlib import Path

from ..fst.core import EPS, Fst

LN10 = math.log(10.0)


class ArpaModel:
    """ngrams[order k (1-based)] = dict[tuple words -> (log10 p, log10 backoff)]"""

    def __init__(self, ngrams: list[dict]):
        self.ngrams = ngrams  # index 0 => unigrams

    @property
    def order(self) -> int:
        return len(self.ngrams)

    def logprob10(self, ngram: tuple) -> float | None:
        k = len(ngram) - 1
        if 0 <= k < self.order and ngram in self.ngrams[k]:
            return self.ngrams[k][ngram][0]
        return None

    def score_sentence(self, words: list[str], sos="<s>", eos="</s>") -> float:
        """log10 probability with backoff (for perplexity tests)."""
        hist = (sos,)
        total = 0.0
        for w in list(words) + [eos]:
            total += self._score_word(hist, w)
            hist = (hist + (w,))[-(self.order - 1):] if self.order > 1 else ()
        return total

    def _score_word(self, hist: tuple, w: str) -> float:
        while True:
            ng = hist + (w,)
            lp = self.logprob10(ng)
            if lp is not None:
                return lp
            if not hist:
                return -99.0  # OOV
            # backoff
            bo = self.ngrams[len(hist) - 1].get(hist)
            bo_w = bo[1] if bo is not None else 0.0
            return bo_w + self._score_word(hist[1:], w)

    # -- serialization -------------------------------------------------------
    def write(self, path: str | Path) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n\\data\\\n")
            for k, d in enumerate(self.ngrams):
                f.write(f"ngram {k+1}={len(d)}\n")
            for k, d in enumerate(self.ngrams):
                f.write(f"\n\\{k+1}-grams:\n")
                for ng in sorted(d):
                    lp, bo = d[ng]
                    if bo != 0.0:
                        f.write(f"{lp:.6f}\t{' '.join(ng)}\t{bo:.6f}\n")
                    else:
                        f.write(f"{lp:.6f}\t{' '.join(ng)}\n")
            f.write("\n\\end\\\n")

    @classmethod
    def read(cls, path: str | Path) -> "ArpaModel":
        ngrams: list[dict] = []
        cur = -1
        with open(path, encoding="utf-8") as f:
            section = None
            for line in f:
                line = line.strip()
                if not line:
                    continue
                if line.startswith("\\data"):
                    section = "data"
                    continue
                if line.startswith("\\end"):
                    break
                if line.endswith("-grams:") and line.startswith("\\"):
                    cur = int(line[1:line.index("-")]) - 1
                    while len(ngrams) <= cur:
                        ngrams.append({})
                    section = "ngrams"
                    continue
                if section == "data":
                    continue
                if section == "ngrams":
                    parts = line.split()
                    lp = float(parts[0])
                    rest = parts[1:]
                    # an n-gram in the (cur+1)-gram section has cur+1 words,
                    # optionally followed by a backoff weight
                    if len(rest) == cur + 2:
                        words, bo = tuple(rest[:-1]), float(rest[-1])
                    elif len(rest) == cur + 1:
                        words, bo = tuple(rest), 0.0
                    else:
                        raise ValueError(f"bad ARPA line in {cur+1}-grams: {line!r}")
                    ngrams[cur][words] = (lp, bo)
        return cls(ngrams)


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


def arpa_to_fst(model: ArpaModel, word_id, backoff_id: int,
                sos: str = "<s>", eos: str = "</s>") -> Fst:
    """Compile to G: input/output = word ids; backoff arcs ilabel=#0 (the
    ``backoff_id``), olabel=eps."""
    f = Fst()
    states: dict[tuple, int] = {}

    def state(hist: tuple) -> int:
        if hist not in states:
            states[hist] = f.add_state()
        return states[hist]

    max_hist = model.order - 1
    # unigram (empty-history) state always exists
    root = state(())
    start = state((sos,) if max_hist >= 1 else ())
    f.set_start(start)

    # ensure states for all histories that have continuations or backoff
    for k, d in enumerate(model.ngrams):
        for ng, (lp, bo) in d.items():
            if k < max_hist:
                # ng can serve as a history
                if any(w == eos for w in ng):
                    continue
                state(ng)

    for k, d in enumerate(model.ngrams):
        for ng, (lp, bo) in d.items():
            w = ng[-1]
            hist = ng[:-1]
            if k == 0 and w == sos:
                # <s> unigram: only its backoff weight matters (state exists)
                continue
            if hist not in states:
                continue
            src = states[hist]
            cost = -lp * LN10
            if w == eos:
                if f.finals[src] == math.inf:
                    f.set_final(src, cost)
                else:
                    f.finals[src] = min(f.finals[src], cost)
                continue
            # destination: longest suffix of ng that is a state
            dst_hist = ng[-max_hist:] if max_hist > 0 else ()
            while dst_hist not in states and dst_hist:
                dst_hist = dst_hist[1:]
            dst = states.get(dst_hist, root)
            f.add_arc(src, word_id(w), word_id(w), cost, dst)

    # backoff arcs
    for hist, src in states.items():
        if not hist:
            continue
        ng_dict = model.ngrams[len(hist) - 1] if len(hist) - 1 < model.order else {}
        bo = ng_dict.get(hist, (0.0, 0.0))[1] if ng_dict else 0.0
        shorter = hist[1:]
        while shorter not in states and shorter:
            shorter = shorter[1:]
        dst = states.get(shorter, root)
        f.add_arc(src, backoff_id, EPS, -bo * LN10, dst)

    f.connect()
    f.arcsort("ilabel")
    return f
