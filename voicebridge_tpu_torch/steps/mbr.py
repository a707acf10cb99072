"""Minimum-Bayes-risk decoding via confusion networks ("sausages").

Counterpart of the reference's ``lattice-mbr-decode`` (``lat/sausages.h:76``,
MinimumBayesRisk; used by ScoreKaldiWER's MBR mode).  Until exact device
lattices land, candidate hypotheses come from N-best decoding (multiple
acoustic scales / beams); the confusion network is built by incrementally
aligning weighted hypotheses against the current network (Mangu et al. 2000),
and the MBR output picks the highest-posterior word (or epsilon) per slot.
"""

from __future__ import annotations

import math


def _align_to_network(network: list, hyp: list, weight: float):
    """Align ``hyp`` (list of words) into ``network`` (list of slot dicts
    word->posterior; None key = epsilon) with Levenshtein DP; returns the new
    network."""
    n, m = len(network), len(hyp)
    # DP over (slot index, hyp index); cost 0 for matching word in slot,
    # 1 for substitution/insert/delete
    INF = 10 ** 9
    dist = [[INF] * (m + 1) for _ in range(n + 1)]
    back = [[None] * (m + 1) for _ in range(n + 1)]
    dist[0][0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            d = dist[i][j]
            if d == INF:
                continue
            if i < n and j < m:
                c = 0 if hyp[j] in network[i] else 1
                if d + c < dist[i + 1][j + 1]:
                    dist[i + 1][j + 1] = d + c
                    back[i + 1][j + 1] = "sub"
            if i < n:  # hyp skips this slot (slot gets eps)
                c = 0 if None in network[i] else 1
                if d + c < dist[i + 1][j]:
                    dist[i + 1][j] = d + c
                    back[i + 1][j] = "del"
            if j < m:  # new slot for this hyp word
                if d + 1 < dist[i][j + 1]:
                    dist[i][j + 1] = d + 1
                    back[i][j + 1] = "ins"
    # traceback
    ops = []
    i, j = n, m
    while i > 0 or j > 0:
        op = back[i][j]
        ops.append(op)
        if op == "sub":
            i, j = i - 1, j - 1
        elif op == "del":
            i -= 1
        else:
            j -= 1
    ops.reverse()
    out = []
    i = j = 0
    for op in ops:
        if op == "sub":
            slot = dict(network[i])
            slot[hyp[j]] = slot.get(hyp[j], 0.0) + weight
            out.append(slot)
            i, j = i + 1, j + 1
        elif op == "del":
            slot = dict(network[i])
            slot[None] = slot.get(None, 0.0) + weight
            out.append(slot)
            i += 1
        else:  # ins: new slot; prior hyps implicitly had eps here
            prior = sum(v for s in network for v in s.values()) / max(len(network), 1) \
                if network else 0.0
            slot = {hyp[j]: weight}
            slot[None] = slot.get(None, 0.0) + max(prior - weight, 0.0)
            out.append(slot)
            j += 1
    return out


def confusion_network(hypotheses: list) -> list:
    """hypotheses: list of (words list, log-score).  Returns list of slots
    (dict word|None -> posterior), posterior-normalized per slot."""
    if not hypotheses:
        return []
    # posteriors from scores
    scores = [s for _w, s in hypotheses]
    mx = max(scores)
    weights = [math.exp(s - mx) for s in scores]
    z = sum(weights)
    weights = [w / z for w in weights]
    order = sorted(range(len(hypotheses)), key=lambda i: -weights[i])
    network: list = []
    for idx in order:
        words, _ = hypotheses[idx]
        network = _align_to_network(network, list(words), weights[idx])
    # normalize slots
    for slot in network:
        tot = sum(slot.values())
        if tot > 0:
            for k in slot:
                slot[k] /= tot
    return network


def mbr_decode(hypotheses: list) -> tuple[list, list]:
    """-> (consensus words, per-word confidences) — MinimumBayesRisk output
    (sausages.h: MbrDecode / GetOneBest / GetOneBestConfidences)."""
    network = confusion_network(hypotheses)
    words, conf = [], []
    for slot in network:
        best = max(slot.items(), key=lambda kv: kv[1])
        if best[0] is not None:
            words.append(best[0])
            conf.append(best[1])
    return words, conf
