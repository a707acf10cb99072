"""Grapheme-to-phoneme conversion via joint-sequence models.

Counterpart of the vendored Phonetisaurus (``VoiceBridge/VoiceBridge/
phonetisaurus/``, SURVEY.md §2.4): ``M2MFstAligner`` EM grapheme<->phoneme
chunk alignment, a joint-token n-gram model (MITLM ``EstimateNgram`` in the
reference -> lm/ngram.py here), and shortest-path pronunciation
(``PhonetisaurusScript``; ``Phonetisaurus::TrainModel``/``GetPronunciation``,
Phonetisaurus.cpp:29-153).

Decoding is a position-synchronous beam search over (position, LM-history)
states — equivalent to composing with the ARPA2WFST transducer and beam-
searching it, but without materializing the FST.  Round 3 used Dijkstra
over the same state space; with higher-order histories its frontier
exploded (2 words/s on cmudict) and its expansion cap could dead-end long
words with empty output.  The beam decoder visits at most ``beam_size``
states per input position and never dead-ends (unseen graphemes are
skipped with a penalty).  Measured on full-cmudict training (CMUDICT.md
v3): 67.7% exact / 7.6% PER held out at 131 words/s (beam 16; beams 24-48
measured identical accuracy, only slower).
"""

from __future__ import annotations

import json
import math
from collections import defaultdict
from pathlib import Path

from ..lm.arpa import ArpaModel
from ..lm.ngram import estimate_ngram
from ..utils.logging import get_logger

log = get_logger()

LN10 = math.log(10.0)
EPS_TOK = "_"
SEP = "}"  # joint token = "g1|g2}p1|p2" like phonetisaurus
SUBSEP = "|"


def _chunks(seq, max_len):
    return [tuple(seq[i:i + k]) for i in range(len(seq))
            for k in range(1, max_len + 1) if i + k <= len(seq)]


class M2MAligner:
    """EM over chunked grapheme/phoneme alignments (M2MFstAligner.cpp).

    Allowed moves: (1..max_x graphemes) : (1..max_y phonemes), plus grapheme
    deletions (g : eps) when ``del_x``.
    """

    def __init__(self, max_x: int = 2, max_y: int = 2, del_x: bool = True):
        self.max_x = max_x
        self.max_y = max_y
        self.del_x = del_x
        self.probs: dict[tuple, float] = {}  # (gchunk, pchunk) -> prob

    def _moves(self, g, p, i, j):
        for dx in range(0 if self.del_x else 1, self.max_x + 1):
            for dy in range(1 if dx == 0 else 0, self.max_y + 1):
                if dx == 0 and dy == 0:
                    continue
                if dx == 0:
                    continue  # eps:phone insertions disabled (phonetisaurus default)
                if dy == 0 and not self.del_x:
                    continue
                if i + dx > len(g) or j + dy > len(p):
                    continue
                yield dx, dy, (tuple(g[i:i + dx]), tuple(p[j:j + dy]))

    def train(self, pairs: list[tuple], num_iters: int = 10) -> None:
        """pairs: (graphemes tuple, phonemes tuple)."""
        # init: uniform over all co-occurring chunks
        counts: dict[tuple, float] = defaultdict(float)
        for g, p in pairs:
            for gc in _chunks(g, self.max_x):
                for pc in _chunks(p, self.max_y):
                    counts[(gc, pc)] += 1.0
            if self.del_x:
                for gc in _chunks(g, self.max_x):
                    counts[(gc, ())] += 0.01
        total = sum(counts.values())
        self.probs = {k: v / total for k, v in counts.items()}

        for it in range(num_iters):
            exp: dict[tuple, float] = defaultdict(float)
            ll = 0.0
            for g, p in pairs:
                ll += self._em_pair(g, p, exp)
            total = sum(exp.values())
            if total <= 0:
                break
            self.probs = {k: v / total for k, v in exp.items()}
        log.info("g2p aligner: %d chunk types", len(self.probs))

    def _em_pair(self, g, p, exp) -> float:
        n, m = len(g), len(p)
        # forward
        alpha = defaultdict(float)
        alpha[(0, 0)] = 1.0
        order = [(i, j) for i in range(n + 1) for j in range(m + 1)]
        for (i, j) in order:
            a = alpha.get((i, j), 0.0)
            if a == 0.0:
                continue
            for dx, dy, key in self._moves(g, p, i, j):
                pr = self.probs.get(key, 0.0)
                if pr > 0:
                    alpha[(i + dx, j + dy)] += a * pr
        z = alpha.get((n, m), 0.0)
        if z <= 0:
            return 0.0
        # backward
        beta = defaultdict(float)
        beta[(n, m)] = 1.0
        for (i, j) in reversed(order):
            for dx, dy, key in self._moves(g, p, i, j):
                pr = self.probs.get(key, 0.0)
                bb = beta.get((i + dx, j + dy), 0.0)
                if pr > 0 and bb > 0:
                    beta[(i, j)] += pr * bb
        for (i, j) in order:
            a = alpha.get((i, j), 0.0)
            if a == 0.0:
                continue
            for dx, dy, key in self._moves(g, p, i, j):
                pr = self.probs.get(key, 0.0)
                bb = beta.get((i + dx, j + dy), 0.0)
                if pr > 0 and bb > 0:
                    exp[key] += a * pr * bb / z
        return math.log(z)

    def best_alignment(self, g, p):
        """Viterbi chunk alignment -> list of (gchunk, pchunk)."""
        n, m = len(g), len(p)
        best = {(0, 0): (0.0, None, None)}
        order = [(i, j) for i in range(n + 1) for j in range(m + 1)]
        for (i, j) in order:
            if (i, j) not in best:
                continue
            score = best[(i, j)][0]
            for dx, dy, key in self._moves(g, p, i, j):
                pr = self.probs.get(key, 0.0)
                if pr <= 0:
                    continue
                ns = score + math.log(pr)
                dst = (i + dx, j + dy)
                if dst not in best or ns > best[dst][0]:
                    best[dst] = (ns, (i, j), key)
        if (n, m) not in best:
            return None
        out = []
        cur = (n, m)
        while best[cur][1] is not None:
            _s, prev, key = best[cur]
            out.append(key)
            cur = prev
        return out[::-1]


def joint_token(gchunk: tuple, pchunk: tuple) -> str:
    g = SUBSEP.join(gchunk) if gchunk else EPS_TOK
    p = SUBSEP.join(pchunk) if pchunk else EPS_TOK
    return f"{g}{SEP}{p}"


def split_token(tok: str) -> tuple[tuple, tuple]:
    g, p = tok.split(SEP)
    gc = () if g == EPS_TOK else tuple(g.split(SUBSEP))
    pc = () if p == EPS_TOK else tuple(p.split(SUBSEP))
    return gc, pc


class G2PModel:
    """Joint-sequence G2P: aligner + n-gram over joint tokens."""

    # max candidate joint tokens per grapheme chunk during decoding; the
    # list is unigram-sorted, so this keeps the plausible mappings while
    # bounding the per-state fan-out (Phonetisaurus bounds the same way
    # through lattice pruning)
    MAX_TOKS_PER_CHUNK = 12
    UNK_PENALTY = 12.0  # nats; skip-an-unseen-grapheme cost (never dead-end)

    def __init__(self, arpa: ArpaModel, joint_vocab: list):
        self.arpa = arpa
        self.vocab = joint_vocab
        # index tokens by grapheme chunk, best-unigram first
        by_gchunk: dict[tuple, list] = defaultdict(list)
        for tok in joint_vocab:
            gc, pc = split_token(tok)
            if gc:
                uni = arpa.logprob10((tok,))
                by_gchunk[gc].append((-(uni if uni is not None else -99.0),
                                      tok, pc))
        self.by_gchunk = {
            gc: [(tok, pc) for _s, tok, pc in
                 sorted(lst)[: self.MAX_TOKS_PER_CHUNK]]
            for gc, lst in by_gchunk.items()}

    # -- training ------------------------------------------------------------
    @classmethod
    def train(cls, lexicon: dict, order: int = 5, align_iters: int = 8,
              max_x: int = 2, max_y: int = 2) -> "G2PModel":
        """lexicon: word -> list of (prob, phones tuple) or list of phone
        tuples.  (Phonetisaurus::TrainModel, Phonetisaurus.cpp:29-96.)"""
        pairs = []
        for word, prons in lexicon.items():
            graphemes = tuple(word.upper())
            for pr in prons:
                phones = tuple(pr[1]) if isinstance(pr, tuple) and len(pr) == 2 \
                    and isinstance(pr[0], (int, float)) else tuple(pr)
                pairs.append((graphemes, phones))
        aligner = M2MAligner(max_x=max_x, max_y=max_y)
        aligner.train(pairs, num_iters=align_iters)
        sentences = []
        for g, p in pairs:
            ali = aligner.best_alignment(g, p)
            if ali:
                sentences.append([joint_token(gc, pc) for gc, pc in ali])
        arpa = estimate_ngram(sentences, order=order)
        vocab = sorted({t for s in sentences for t in s})
        log.info("g2p: trained on %d prons, %d joint tokens, order %d",
                 len(sentences), len(vocab), order)
        return cls(arpa, vocab)

    # -- decoding ------------------------------------------------------------
    def pronounce(self, word: str, nbest: int = 1,
                  beam_size: int | None = None) -> list[tuple]:
        """-> up to nbest (phones tuple, cost) by position-synchronous beam
        search over (position, LM history) states (PhonetisaurusScript
        shortest-path role).  Every move consumes 1-2 graphemes, so states
        advance monotonically in position; at each position the frontier is
        pruned to ``beam_size`` hypotheses and each (history) state keeps
        its best few phone sequences."""
        graphemes = tuple(word.upper())
        n = len(graphemes)
        max_hist = self.arpa.order - 1
        if beam_size is None:
            # beam 16 measured accuracy-equal to 24/32/48 on full-cmudict
            # held-out (67.7% exact) at 1.5-4x the speed (CMUDICT.md v3)
            beam_size = 16 if nbest == 1 else max(48, 8 * nbest)
        keep = 1 if nbest == 1 else nbest
        score = self.arpa._score_word

        def push(state_dict, hist, cost, phones):
            lst = state_dict.get(hist)
            if lst is None:
                state_dict[hist] = [(cost, phones)]
                return
            lst.append((cost, phones))
            if len(lst) > 2 * keep:
                lst.sort(key=lambda x: x[0])
                del lst[keep:]

        states: list[dict] = [dict() for _ in range(n + 1)]
        states[0][("<s>",)] = [(0.0, ())]
        for pos in range(n):
            cur = states[pos]
            if not cur:
                continue
            flat = [(c, h, ph) for h, lst in cur.items() for (c, ph) in lst]
            flat.sort(key=lambda x: x[0])
            for cost, hist, phones in flat[:beam_size]:
                matched = False
                for k in (1, 2):
                    if pos + k > n:
                        continue
                    gc = graphemes[pos:pos + k]
                    for tok, pc in self.by_gchunk.get(gc, ()):
                        matched = matched or k == 1
                        c = -score(hist, tok) * LN10
                        nh = (hist + (tok,))[-max_hist:] if max_hist else ()
                        push(states[pos + k], nh, cost + c, phones + pc)
                if not matched:
                    # grapheme unseen in training: skip it with a penalty so
                    # the decoder can never dead-end into an empty output
                    push(states[pos + 1], hist, cost + self.UNK_PENALTY,
                         phones)
        results = []
        for hist, lst in states[n].items():
            eos = -score(hist, "</s>") * LN10
            for c, ph in lst:
                results.append((ph, c + eos))
        results.sort(key=lambda x: x[1])
        out, seen = [], set()
        for ph, c in results:  # distinct pronunciations only
            if ph not in seen:
                seen.add(ph)
                out.append((ph, c))
            if len(out) == nbest:
                break
        return out

    # -- serialization -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self.arpa.write(path / "g2p.arpa")
        (path / "vocab.json").write_text(json.dumps(self.vocab))

    @classmethod
    def load(cls, path: str | Path) -> "G2PModel":
        path = Path(path)
        arpa = ArpaModel.read(path / "g2p.arpa")
        vocab = json.loads((path / "vocab.json").read_text())
        return cls(arpa, vocab)
