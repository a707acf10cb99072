"""LM evaluation and interpolation (MITLM's EvaluateNgram / InterpolateNgram
/ PerplexityOptimizer roles; reference ``mitlm/{evaluate,interpolate}-ngram.cpp``,
``mitlm/PerplexityOptimizer.{h,cpp}``, ``mitlm/InterpolatedNgramLM.{h,cpp}``).

- ``perplexity``: backoff-scored per-word perplexity of a text set.
- ``optimize_interpolation_weights``: EM on a held-out set for mixture
  weights (the PerplexityOptimizer role, which MITLM runs over smoothing /
  interpolation parameters).
- ``interpolate_models``: static interpolation of N ARPA models into one
  ARPA model over the union of their n-grams, with backoff weights
  recomputed so every history's distribution normalizes.
"""

from __future__ import annotations

import math

from .arpa import ArpaModel

LOG10_MIN = -99.0


def perplexity(model: ArpaModel, sentences: list[list[str]],
               sos: str = "<s>", eos: str = "</s>") -> float:
    """Per-word perplexity (eos counted, sos not; EvaluateNgram convention)."""
    total_lp = 0.0
    total_words = 0
    for words in sentences:
        total_lp += model.score_sentence(words, sos, eos)
        total_words += len(words) + 1  # + eos
    if total_words == 0:
        return float("inf")
    return 10.0 ** (-total_lp / total_words)


def optimize_interpolation_weights(models: list[ArpaModel],
                                   dev_sentences: list[list[str]],
                                   num_iters: int = 30,
                                   sos: str = "<s>", eos: str = "</s>"
                                   ) -> list[float]:
    """EM for mixture weights maximizing held-out likelihood of
    ``p(w|h) = sum_i lambda_i p_i(w|h)`` (PerplexityOptimizer role)."""
    n = len(models)
    lambdas = [1.0 / n] * n
    # precompute per-event per-model probabilities once
    events: list[list[float]] = []
    for words in dev_sentences:
        seq = list(words) + [eos]
        per_model = []
        for model in models:
            hist = (sos,)
            ps = []
            for w in seq:
                ps.append(10.0 ** model._score_word(hist, w))
                hist = (hist + (w,))[-(model.order - 1):] \
                    if model.order > 1 else ()
            per_model.append(ps)
        events.extend([list(t) for t in zip(*per_model)])
    for _ in range(num_iters):
        acc = [0.0] * n
        for probs in events:
            z = sum(l * p for l, p in zip(lambdas, probs))
            if z <= 0:
                continue
            for i in range(n):
                acc[i] += lambdas[i] * probs[i] / z
        tot = sum(acc)
        if tot <= 0:
            break
        new = [a / tot for a in acc]
        if max(abs(a - b) for a, b in zip(new, lambdas)) < 1e-6:
            lambdas = new
            break
        lambdas = new
    return lambdas


def interpolate_models(models: list[ArpaModel], lambdas: list[float]
                       ) -> ArpaModel:
    """Statically interpolated backoff model over the union of n-grams
    (InterpolateNgram role).

    For every n-gram listed in any input model, the interpolated conditional
    is ``p(w|h) = sum_i lambda_i p_i(w|h)`` (each ``p_i`` fully backed off).
    Backoff weights are then recomputed per history so the model normalizes:
    ``bow(h) = (1 - sum_listed p(w|h)) / (1 - sum_listed p(w|h'))``.
    """
    assert len(models) == len(lambdas) and abs(sum(lambdas) - 1.0) < 1e-6
    order = max(m.order for m in models)

    def mix(hist: tuple, w: str) -> float:
        return sum(l * (10.0 ** m._score_word(hist, w))
                   for l, m in zip(lambdas, models))

    # union of n-grams per order
    unions: list[set] = [set() for _ in range(order)]
    for m in models:
        for k, d in enumerate(m.ngrams):
            unions[k] |= set(d)
    # interpolated conditional probs
    probs: list[dict] = [dict() for _ in range(order)]
    for k in range(order):
        for ng in unions[k]:
            p = mix(ng[:-1], ng[-1])
            probs[k][ng] = max(math.log10(max(p, 1e-99)), LOG10_MIN)

    # recompute backoff weights: a history h of length k+1 needs a backoff
    # weight iff some (k+1)-gram extends it (index extensions by prefix once)
    out: list[dict] = [dict() for _ in range(order)]
    extensions: list[dict] = [dict() for _ in range(order)]
    for k in range(1, order):
        for ng in unions[k]:
            extensions[k - 1].setdefault(ng[:-1], []).append(ng)
    for k in range(order):
        for ng in unions[k]:
            lp = probs[k][ng]
            bo = 0.0
            listed = extensions[k].get(ng) if k + 1 < order else None
            if listed:
                num = 1.0 - sum(10.0 ** probs[k + 1][w2] for w2 in listed)
                den = 1.0 - sum(mix(ng[1:], w2[-1]) for w2 in listed)
                if num <= 0 or den <= 0:
                    bo = LOG10_MIN if num <= 0 else 0.0
                else:
                    bo = math.log10(num / den)
            out[k][ng] = (lp, bo)
    return ArpaModel(out)
