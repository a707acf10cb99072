"""N-gram language-model estimation (modified Kneser-Ney / Witten-Bell).

Counterpart of the vendored MITLM (``VoiceBridge/VoiceBridge/mitlm/``:
``EstimateNgram`` with ModKN smoothing, ``KneserNeySmoothing.cpp``), which the
reference calls from PrepareData to auto-generate the task ARPA LM
(``prepare_data.cpp:377``).  Host-side; LMs in this pipeline are small.

Modified KN with the standard count-of-count discounts
(Y = n1/(n1+2 n2); D1 = 1-2Y n2/n1; D2 = 2-3Y n3/n2; D3+ = 3-4Y n4/n3),
continuation counts for lower orders, interpolation folded into ARPA backoff
form.  Degenerate counts-of-counts (tiny corpora like Yes-No) fall back to
absolute discounting with D=0.5.
"""

from __future__ import annotations

from collections import Counter, defaultdict

from .arpa import ArpaModel

SOS, EOS = "<s>", "</s>"


def _discounts(counts: Counter, max_c: int = 3) -> list[float]:
    """Modified-KN discounts [D1, D2, D3plus] from counts-of-counts."""
    cc = Counter()
    for c in counts.values():
        cc[min(c, max_c + 1)] += 1
    n1, n2, n3, n4 = cc[1], cc[2], cc[3], cc[4]
    if n1 == 0 or n2 == 0:
        return [0.5, 0.75, 0.75]  # degenerate: absolute discounting
    y = n1 / (n1 + 2.0 * n2)
    d1 = 1.0 - 2.0 * y * n2 / n1
    d2 = 2.0 - 3.0 * y * n3 / n2 if n2 > 0 else 0.75
    d3 = 3.0 - 4.0 * y * n4 / n3 if n3 > 0 else 0.75
    out = []
    for i, d in enumerate([d1, d2, d3]):
        lo, hi = 0.0, float(i + 1)
        out.append(min(max(d, lo + 1e-4), hi - 1e-4) if hi > lo else d)
    return out


def estimate_ngram(sentences: list[list[str]], order: int = 3,
                   smoothing: str = "modkn") -> ArpaModel:
    """Estimate an ``order``-gram LM; returns an :class:`ArpaModel`."""
    import math

    if smoothing not in ("modkn", "wb"):
        raise ValueError(f"unknown smoothing {smoothing!r}")

    # raw counts per order
    raw: list[Counter] = [Counter() for _ in range(order)]
    for sent in sentences:
        toks = [SOS] + list(sent) + [EOS]
        for k in range(1, order + 1):
            for i in range(len(toks) - k + 1):
                ng = tuple(toks[i : i + k])
                if k == 1 and ng == (SOS,):
                    continue  # <s> never predicted
                raw[k - 1][ng] += 1
    # include <s> unigram count for history purposes
    hist_counts: list[Counter] = [Counter() for _ in range(order)]
    for k in range(order):
        for ng, c in raw[k].items():
            hist_counts[k][ng] = c
    num_sents = max(len(sentences), 1)
    hist_counts[0][(SOS,)] = num_sents

    # effective counts: highest order raw; lower orders continuation counts
    # (number of distinct left contexts), except n-grams starting with <s>
    eff: list[Counter] = [Counter() for _ in range(order)]
    eff[order - 1] = raw[order - 1]
    for k in range(order - 1, 0, -1):
        cont = Counter()
        for ng in raw[k]:
            cont[ng[1:]] += 1
        for ng in raw[k - 1]:
            if ng[0] == SOS:
                cont[ng] = raw[k - 1][ng]
            elif ng not in cont:
                cont[ng] = raw[k - 1][ng]  # unseen as continuation: keep raw
        eff[k - 1] = cont

    vocab = sorted({w for c in raw[0] for w in c} | {EOS})

    # probabilities, interpolated, order by order
    probs: list[dict] = [dict() for _ in range(order)]
    # unigrams
    tot_uni = sum(eff[0][ (w,) ] for w in vocab if w != SOS)
    v = len([w for w in vocab if w != SOS])
    for w in vocab:
        if w == SOS:
            continue
        c = eff[0][(w,)]
        probs[0][(w,)] = (c + 1.0) / (tot_uni + v)  # add-one floor at unigram

    for k in range(1, order):
        counts = eff[k]
        if smoothing == "modkn":
            d1, d2, d3 = _discounts(counts)
        histories = defaultdict(list)
        for ng, c in counts.items():
            histories[ng[:-1]].append((ng[-1], c))
        for h, items in histories.items():
            tot = sum(c for _w, c in items)
            if tot <= 0:
                continue
            if smoothing == "modkn":
                n_low, n_mid, n_high = 0, 0, 0
                disc_mass = 0.0
                for _w, c in items:
                    if c == 1:
                        n_low += 1
                        disc_mass += d1
                    elif c == 2:
                        n_mid += 1
                        disc_mass += d2
                    else:
                        n_high += 1
                        disc_mass += d3
                gamma = disc_mass / tot
                for w, c in items:
                    d = d1 if c == 1 else (d2 if c == 2 else d3)
                    p_lower = _lower_prob(probs, k, h, w)
                    probs[k][h + (w,)] = max(c - d, 0.0) / tot + gamma * p_lower
            else:  # Witten-Bell
                t = len(items)
                gamma = t / (tot + t)
                for w, c in items:
                    p_lower = _lower_prob(probs, k, h, w)
                    probs[k][h + (w,)] = (1 - gamma) * c / tot + gamma * p_lower

    # convert to ARPA backoff form
    ngrams: list[dict] = [dict() for _ in range(order)]
    log10 = lambda x: math.log10(max(x, 1e-99))
    for w in vocab:
        if w == SOS:
            continue
        ngrams[0][(w,)] = [log10(probs[0][(w,)]), 0.0]
    ngrams[0][(SOS,)] = [-99.0, 0.0]

    for k in range(1, order):
        for ng, p in probs[k].items():
            ngrams[k][ng] = [log10(p), 0.0]
    # backoff weights: bow(h) = (1 - sum_seen p(h,w)) / (1 - sum_seen p_lower)
    for k in range(1, order):
        by_hist = defaultdict(list)
        for ng in probs[k]:
            by_hist[ng[:-1]].append(ng[-1])
        for h, ws in by_hist.items():
            num = 1.0 - sum(probs[k][h + (w,)] for w in ws)
            den = 1.0 - sum(_lower_prob(probs, k, h, w) for w in ws)
            bow = max(num, 1e-12) / max(den, 1e-12)
            hk = len(h) - 1
            if h in ngrams[hk]:
                ngrams[hk][h][1] = log10(bow)
            else:
                # history exists only as a context (e.g. (<s>,)); add with -99
                ngrams[hk][h] = [-99.0, log10(bow)]
    out = [
        {ng: (lp, bo) for ng, (lp, bo) in d.items()}
        for d in ngrams
    ]
    return ArpaModel(out)


def _lower_prob(probs: list[dict], k: int, h: tuple, w: str) -> float:
    """Interpolated lower-order probability p(w | h[1:])."""
    if k == 1:
        return probs[0].get((w,), 1e-12)
    ng = h[1:] + (w,)
    p = probs[k - 1].get(ng)
    if p is not None:
        return p
    return _lower_prob(probs, k - 1, h[1:], w)
