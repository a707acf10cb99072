"""WER/SER scoring with LM-weight and word-insertion-penalty sweeps.

Counterparts: ``compute-wer``, ``align-text``, ``ScoreKaldiWER``
(``scr/steps/scoring/score_kaldi_wer.cpp``: LMWT 7..17 x WIP {0.0,0.5,1.0},
``BestWer`` minimum selection) and the per-utterance detail reports
(``wer_per_utt_details.cpp``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class WerStats:
    num_words: int = 0
    num_ins: int = 0
    num_del: int = 0
    num_sub: int = 0
    num_sent: int = 0
    num_sent_err: int = 0

    @property
    def num_err(self) -> int:
        return self.num_ins + self.num_del + self.num_sub

    @property
    def wer(self) -> float:
        return 100.0 * self.num_err / max(self.num_words, 1)

    @property
    def ser(self) -> float:
        return 100.0 * self.num_sent_err / max(self.num_sent, 1)

    def add(self, other: "WerStats") -> None:
        self.num_words += other.num_words
        self.num_ins += other.num_ins
        self.num_del += other.num_del
        self.num_sub += other.num_sub
        self.num_sent += other.num_sent
        self.num_sent_err += other.num_sent_err

    def __repr__(self) -> str:
        return (f"%WER {self.wer:.2f} [ {self.num_err} / {self.num_words}, "
                f"{self.num_ins} ins, {self.num_del} del, {self.num_sub} sub ] "
                f"%SER {self.ser:.2f}")


def align_text(ref: list, hyp: list):
    """Levenshtein alignment; returns list of (ref_word|None, hyp_word|None)
    pairs (align-text / edit-distance.h semantics: ins=del=sub cost 1)."""
    n, m = len(ref), len(hyp)
    # DP
    dist = [[0] * (m + 1) for _ in range(n + 1)]
    back = [[0] * (m + 1) for _ in range(n + 1)]  # 0=sub/cor 1=del 2=ins
    for i in range(1, n + 1):
        dist[i][0] = i
        back[i][0] = 1
    for j in range(1, m + 1):
        dist[0][j] = j
        back[0][j] = 2
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c_sub = dist[i - 1][j - 1] + (ref[i - 1] != hyp[j - 1])
            c_del = dist[i - 1][j] + 1
            c_ins = dist[i][j - 1] + 1
            best = min(c_sub, c_del, c_ins)
            dist[i][j] = best
            back[i][j] = 0 if best == c_sub else (1 if best == c_del else 2)
    pairs = []
    i, j = n, m
    while i > 0 or j > 0:
        b = back[i][j]
        if b == 0 and i > 0 and j > 0:
            pairs.append((ref[i - 1], hyp[j - 1]))
            i, j = i - 1, j - 1
        elif b == 1 and i > 0:
            pairs.append((ref[i - 1], None))
            i -= 1
        else:
            pairs.append((None, hyp[j - 1]))
            j -= 1
    pairs.reverse()
    return pairs


def compute_wer(ref: list, hyp: list) -> WerStats:
    s = WerStats(num_words=len(ref), num_sent=1)
    for r, h in align_text(ref, hyp):
        if r is None:
            s.num_ins += 1
        elif h is None:
            s.num_del += 1
        elif r != h:
            s.num_sub += 1
    s.num_sent_err = 1 if s.num_err > 0 else 0
    return s


def compute_wer_set(refs: dict, hyps: dict) -> WerStats:
    """Corpus WER over utt -> word list dicts; missing hyps count as
    all-deletions (like compute-wer with empty hyp)."""
    total = WerStats()
    for utt, ref in sorted(refs.items()):
        total.add(compute_wer(ref, hyps.get(utt, [])))
    return total


def compute_cer_set(refs: dict, hyps: dict) -> WerStats:
    """Character error rate (ScoreKaldiCER): same machinery over the
    character sequences of the space-joined transcripts."""
    crefs = {u: list(" ".join(w)) for u, w in refs.items()}
    chyps = {u: list(" ".join(w)) for u, w in hyps.items()}
    return compute_wer_set(crefs, chyps)


@dataclass
class SweepResult:
    best_wer: WerStats = field(default_factory=WerStats)
    best_lmwt: int = 0
    best_wip: float = 0.0
    table: dict = field(default_factory=dict)  # (lmwt, wip) -> WerStats


def score_sweep(refs: dict, hyps_by_point: dict) -> SweepResult:
    """Pick the best grid point (``BestWer``, ``best_wer.cpp``).

    ``hyps_by_point`` maps either ``(lmwt, wip)`` or plain ``lmwt`` keys to
    ``{utt: [words]}`` hypothesis dicts (plain keys are treated as WIP=0,
    for callers that sweep LMWT only)."""
    out = SweepResult()
    best = None
    for key, hyps in sorted(hyps_by_point.items()):
        lmwt, wip = key if isinstance(key, tuple) else (key, 0.0)
        stats = compute_wer_set(refs, hyps)
        out.table[(lmwt, wip)] = stats
        if best is None or stats.wer < best[0].wer:
            best = (stats, lmwt, wip)
    out.best_wer, out.best_lmwt, out.best_wip = best
    return out


def per_spk_details(refs: dict, hyps: dict, utt2spk: dict) -> dict:
    """wer_per_spk_details: speaker -> WerStats."""
    out: dict = {}
    for utt, ref in refs.items():
        spk = utt2spk.get(utt, utt)
        stats = compute_wer(ref, hyps.get(utt, []))
        if spk in out:
            out[spk].add(stats)
        else:
            out[spk] = stats
    return out


def ops_details(refs: dict, hyps: dict) -> dict:
    """wer_ops_details: (op, ref_word, hyp_word) -> count, most frequent
    confusions first."""
    from collections import Counter

    ops: Counter = Counter()
    for utt, ref in refs.items():
        for r, h in align_text(ref, hyps.get(utt, [])):
            if r is None:
                ops[("insertion", None, h)] += 1
            elif h is None:
                ops[("deletion", r, None)] += 1
            elif r != h:
                ops[("substitution", r, h)] += 1
            else:
                ops[("correct", r, h)] += 1
    return dict(ops.most_common())


def wer_bootstrap_ci(refs: dict, hyps: dict, num_reps: int = 10000,
                     seed: int = 0) -> tuple:
    """compute-wer-bootci: bootstrap 95% confidence interval on WER by
    resampling utterances (Bisani & Ney 2004)."""
    import numpy as np

    utts = sorted(refs)
    errs = np.zeros(len(utts))
    words = np.zeros(len(utts))
    for i, u in enumerate(utts):
        s = compute_wer(refs[u], hyps.get(u, []))
        errs[i] = s.num_err
        words[i] = s.num_words
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(utts), size=(num_reps, len(utts)))
    wers = 100.0 * errs[idx].sum(axis=1) / np.maximum(words[idx].sum(axis=1), 1)
    return (float(np.percentile(wers, 2.5)), float(np.percentile(wers, 50)),
            float(np.percentile(wers, 97.5)))


def per_utt_details(refs: dict, hyps: dict) -> dict:
    """wer_per_utt_details: utt -> list of (op, ref, hyp)."""
    out = {}
    for utt, ref in refs.items():
        hyp = hyps.get(utt, [])
        detail = []
        for r, h in align_text(ref, hyp):
            if r is None:
                detail.append(("I", None, h))
            elif h is None:
                detail.append(("D", r, None))
            elif r != h:
                detail.append(("S", r, h))
            else:
                detail.append(("C", r, h))
        out[utt] = detail
    return out
