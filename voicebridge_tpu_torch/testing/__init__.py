"""Inputs for the port's tests and its chip smoke run.

* ``load_yesno_mono``: the Yes-No monophone model that the JAX package
  trained (``tools/make_torch_fixture.py``), with the JAX package's decoding
  hypotheses, committed under ``assets/yesno_mono``.  The waves are not
  stored: ``tests/synth.py`` makes the corpus again from its seed.
* ``load_synth_tri2b``: the LDA+MLLT triphone model (tri2b) that the JAX
  package trained on ``tests/synth.py``'s speaker corpus
  (``tools/make_torch_tri_fixture.py``), with its ``final_mat`` and the JAX
  package's exact-search hypotheses and scores for the test utterances,
  committed under ``assets/synth_tri2b``.
* ``load_synth_sat``: the LDA+MLLT+SAT model (tri3b) that the JAX package
  trained on the same corpus (``tools/make_torch_sat_fixture.py``), with its
  ``alimdl``, ``final_mat``, and the JAX package's ``decode_fmllr`` words,
  scores and final transforms for the test utterances, committed under
  ``assets/synth_sat``.
* ``synth_decode_graph`` / ``random_am``: the repo's full-width decode shape
  (``bench.py``): an HCLG-shaped 60k-state / 480k-arc graph and a
  2000-pdf x 5-Gaussian x 39-dim diagonal GMM, from numpy seeds.
  ``feature_scaled_am`` draws a GMM of the same size on the scale of given
  features.  ``synth_hub_graph`` is a smaller decode graph with a hub
  state (thousands of in- and out-arcs, appended out of source order) and
  states of no in-arcs and of no out-arcs.
* ``synth_train_graph``: the repo's full-width training-alignment graph
  (``bench.py``): a left-to-right chain of HMM states with self-loops and
  optional skips, banded and dst-pure like a compiled training graph.
* ``random_band_walk``: inputs of K4's backtrace drawn directly (no graph
  or forward), with empty band slots on the walk at a chosen rate.
* ``assert_models_close``: two trainings of one model (the port against the
  JAX package, or the card against the CPU) held to each other.
* ``fmllr_stats_float64``: the fMLLR statistics' plain version in float64,
  which ``transforms/fmllr.acc_fmllr_stats`` is held to on the card.
* ``synthesis`` / ``corpus`` (copies of ``voicebridge_tpu/testing``'s): the
  formant-synthesized LibriSpeech-shaped corpus, ``make_corpus`` and
  ``write_corpus``, with its lexicon ``LEXICON``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .. import convert
from ..fst.core import Fst
from ..models.gmm import AmDiagGmm
from ..models.topology import HmmTopology
from ..models.transition import TransitionModel
from ..models.tree import load_tree
from ..steps.score import compute_wer_set
from ..utils.text import SymbolTable

from ..ops.graph import NEG_INF, DenseGraph
from .corpus import LEXICON, make_corpus, sample_sentence
from .synthesis import Speaker, synth_utterance

ASSET_DIR = Path(__file__).parent.parent / "assets" / "yesno_mono"
TRI2B_DIR = Path(__file__).parent.parent / "assets" / "synth_tri2b"
SAT_DIR = Path(__file__).parent.parent / "assets" / "synth_sat"

__all__ = ["ASSET_DIR", "LEXICON", "SAT_DIR", "Speaker", "TRI2B_DIR", "YesNoModel",
           "assert_models_close", "compute_wer_set", "feature_scaled_am", "fmllr_stats_float64",
           "load_synth_sat", "load_synth_tri2b", "load_yesno_mono", "make_corpus", "random_am",
           "sample_sentence", "synth_decode_graph", "synth_hub_graph", "synth_train_graph",
           "synth_utterance"]


@dataclass
class YesNoModel:
    am: AmDiagGmm
    hclg: Fst
    trans_model: TransitionModel
    words: SymbolTable
    corpus: dict  # arguments of the tests/synth.py corpus the model was trained on
    samp_freq: float
    hyps: dict  # utt -> hypothesis words of the JAX package's decode
    scores: dict | None = None  # utt -> the JAX package's best-path score
    final_mat: np.ndarray | None = None  # splice+LDA+MLLT [E, D+1] of an LDA model
    alimdl: AmDiagGmm | None = None  # a SAT model's speaker-independent first-pass model
    transforms: dict | None = None  # speaker -> the JAX package's final fMLLR [D, D+1]


def _load_model(path: Path) -> YesNoModel:
    path = Path(path)
    tm = TransitionModel(HmmTopology.load(path / "topo.json"), load_tree(path / "tree.json"))
    tm.load_probs(path / "trans.json")
    meta = json.loads((path / "hyps.json").read_text())
    mat = path / "final_mat.npy"
    alimdl = path / "final.alimdl.npz"
    transforms = None
    if (path / "transforms.npy").exists():
        transforms = dict(zip(meta["speakers"], np.load(path / "transforms.npy")))
    return YesNoModel(am=AmDiagGmm.load(path / "am.npz"), hclg=Fst.load(path / "hclg.npz"),
                      trans_model=tm, words=SymbolTable.read(path / "words.txt"),
                      corpus=meta["corpus"], samp_freq=meta["samp_freq"],
                      hyps=meta["hyps"], scores=meta.get("scores"),
                      final_mat=convert.final_mat_from_array(np.load(mat))
                      if mat.exists() else None,
                      alimdl=AmDiagGmm.load(alimdl) if alimdl.exists() else None,
                      transforms=transforms)


def load_yesno_mono(path: Path = ASSET_DIR) -> YesNoModel:
    return _load_model(path)


def load_synth_tri2b(path: Path = TRI2B_DIR) -> YesNoModel:
    """The JAX-trained tri2b model; ``corpus`` holds the arguments of
    ``tests/synth.py``'s ``make_speaker_corpus``, whose test utterances
    ``hyps`` and ``scores`` cover (features: MFCC without dither, CMVN per
    speaker over train and test, splice +-3, ``final_mat``)."""
    return _load_model(path)


def load_synth_sat(path: Path = SAT_DIR) -> YesNoModel:
    """The JAX-trained LDA+MLLT+SAT model; ``corpus`` as for
    ``load_synth_tri2b`` (the same features: base features -> splice ->
    ``final_mat``), ``hyps`` and ``scores`` from the JAX package's
    ``decode_fmllr`` (exact search, ``fmllr_min_count`` 50), ``transforms``
    its final transform of each test speaker."""
    return _load_model(path)


def synth_decode_graph(num_states: int = 60_000, arcs_per_state: int = 8,
                       num_pdfs: int = 2000, seed: int = 0) -> DenseGraph:
    """Synthetic HCLG-shaped graph (``bench.py`` ``synth_decode_graph``):
    locally branching arcs with one self-loop per state, all arcs entering a
    state sharing that state's pdf, every state final with cost 0."""
    rng = np.random.default_rng(seed)
    a = num_states * arcs_per_state
    arc_src = np.repeat(np.arange(num_states, dtype=np.int32), arcs_per_state)
    jumps = rng.integers(1, 64, size=a).astype(np.int32)
    arc_dst = ((arc_src + jumps) % num_states).astype(np.int32)
    arc_dst[::arcs_per_state] = arc_src[::arcs_per_state]
    pdf_state = rng.integers(0, num_pdfs, size=num_states).astype(np.int32)
    arc_pdf = pdf_state[arc_dst]
    arc_score = (-rng.exponential(1.0, size=a)).astype(np.float32)
    alpha0 = np.full(num_states, NEG_INF, np.float32)
    alpha0[0] = 0.0
    return DenseGraph(
        num_states=num_states, arc_src=arc_src, arc_dst=arc_dst, arc_tid=arc_pdf,
        arc_pdf=arc_pdf, arc_score=arc_score, arc_oseq=np.zeros_like(arc_src),
        alpha0=alpha0, start_oseq=np.zeros(num_states, np.int32),
        final_score=np.zeros(num_states, np.float32),
        final_oseq=np.zeros(num_states, np.int32), oseqs=[()])


def synth_hub_graph(num_states: int, hub_arcs: int, num_pdfs: int = 20,
                    seed: int = 0) -> DenseGraph:
    """``synth_decode_graph`` with the arcs into every state d with d % 7 == 3
    and out of every state s with s % 11 == 5 removed, and one hub state
    (``num_states // 2``, moved off those classes) given ``hub_arcs`` more
    in-arcs and as many out-arcs, appended after the others, so that the
    arcs are no longer in source order.  The hub's in-arcs carry random
    pdfs."""
    g = synth_decode_graph(num_states, arcs_per_state=8, num_pdfs=num_pdfs, seed=seed)
    rng = np.random.default_rng(seed + 1)
    keep = (g.arc_dst % 7 != 3) & (g.arc_src % 11 != 5)
    hub = num_states // 2
    while hub % 7 == 3 or hub % 11 == 5:
        hub += 1
    live_src = np.flatnonzero(np.arange(num_states) % 11 != 5)
    live_dst = np.flatnonzero(np.arange(num_states) % 7 != 3)
    src = np.concatenate([g.arc_src[keep], rng.choice(live_src, hub_arcs),
                          np.full(hub_arcs, hub)]).astype(np.int32)
    dst = np.concatenate([g.arc_dst[keep], np.full(hub_arcs, hub),
                          rng.choice(live_dst, hub_arcs)]).astype(np.int32)
    pdf = np.concatenate([g.arc_pdf[keep], rng.integers(0, num_pdfs, 2 * hub_arcs)])
    score = np.concatenate([g.arc_score[keep], -rng.exponential(1.0, 2 * hub_arcs)])
    return g._replace(arc_src=src, arc_dst=dst, arc_tid=pdf.astype(np.int32),
                      arc_pdf=pdf.astype(np.int32), arc_score=score.astype(np.float32),
                      arc_oseq=np.zeros_like(src))


def random_codes(rng, plan, w: int, b: int) -> np.ndarray:
    """Random K3 backpointer codes [W, S+1, B] over the emit plan ``plan``:
    for every state a code of one of its row slots, pads and dead rows
    included (uint8 for a packed plan, else int16)."""
    rows = np.diff(plan.row_start).astype(np.int64)  # [S+1]
    codes = rng.integers(0, 1 << 40, (w, len(rows), b)) % (rows * plan.d)[None, :, None]
    return codes.astype(np.uint8 if plan.packed else np.int16)


def random_am(num_pdfs: int = 2000, max_mix: int = 5, dim: int = 39,
              seed: int = 1) -> AmDiagGmm:
    """Random diagonal GMM of the given size (``bench.py``'s decode AM)."""
    rng = np.random.default_rng(seed)
    return AmDiagGmm(
        rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32),
        np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32) + 0.5,
        np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32))


def feature_scaled_am(mean: np.ndarray, var: np.ndarray, num_pdfs: int = 2000,
                      max_mix: int = 5, seed: int = 5) -> AmDiagGmm:
    """Random diagonal GMM on the scale of features with per-dimension
    ``mean`` and ``var``: component means at mean + sqrt(var) * N(0, 1),
    variances var / U(0.5, 2), equal weights."""
    rng = np.random.default_rng(seed)
    d = len(mean)
    means = mean + np.sqrt(var) * rng.standard_normal((num_pdfs, max_mix, d))
    inv_vars = rng.uniform(0.5, 2.0, (num_pdfs, max_mix, d)) / var
    return AmDiagGmm((means * inv_vars).astype(np.float32), inv_vars.astype(np.float32),
                     np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32))


def synth_train_graph(num_states: int, num_pdfs: int, rng, back_arcs: int = 0,
                      fan_in: int = 0) -> DenseGraph:
    """Synthetic training-alignment graph (``bench.py`` ``synth_train_graph``):
    a left-to-right chain with self-loops and 25 % optional skip arcs, all
    arcs entering a state sharing its pdf; start at state 0, final at the
    last state.  ``back_arcs`` adds that many arcs back over 49 to 149 states
    (a repeated phrase), which a set of such graphs cannot hold in 48 band
    offsets: ``build_band_plan`` refuses it and the generic aligner runs.
    ``fan_in`` adds that many arcs into the last state from random states
    before it, for a state of large in-degree."""
    pdf_of = rng.integers(0, num_pdfs, size=num_states)
    src, dst, score = [], [], []
    for s in range(num_states):
        src += [s, s]
        dst += [s, min(s + 1, num_states - 1)]
        score += [float(-rng.exponential(0.3)), float(-rng.exponential(0.3))]
        if s + 2 < num_states and rng.random() < 0.25:  # optional-sil skip
            src.append(s)
            dst.append(s + 2)
            score.append(float(-rng.exponential(0.5)))
    for _ in range(back_arcs):
        span = int(rng.integers(49, 150))
        s = int(rng.integers(span, num_states))
        src.append(s)
        dst.append(s - span)
        score.append(float(-rng.exponential(0.5)))
    for s in rng.integers(0, num_states - 1, size=fan_in) if fan_in else ():
        src.append(int(s))
        dst.append(num_states - 1)
        score.append(float(-rng.exponential(2.0)))
    pdf = [int(pdf_of[d]) for d in dst]
    alpha0 = np.full(num_states, NEG_INF, np.float32)
    alpha0[0] = 0.0
    final = np.full(num_states, NEG_INF, np.float32)
    final[num_states - 1] = 0.0
    a = len(src)
    return DenseGraph(
        num_states=num_states, arc_src=np.asarray(src, np.int32),
        arc_dst=np.asarray(dst, np.int32), arc_tid=np.asarray(pdf, np.int32),
        arc_pdf=np.asarray(pdf, np.int32), arc_score=np.asarray(score, np.float32),
        arc_oseq=np.zeros(a, np.int32), alpha0=alpha0,
        start_oseq=np.zeros(num_states, np.int32), final_score=final,
        final_oseq=np.zeros(num_states, np.int32), oseqs=[()])


def random_band_walk(rng, b: int, s: int, t: int, offsets, fail_rate: float,
                     fill: float = 0.7):
    """Inputs of K4's backtrace (``backtrace_banded``) drawn directly:
    (alpha_end [B, S] f32, final [B, S] f32, bps [T, B, S] uint8,
    num_frames [B] int32, arc_of [B, S, K] int32).  Slot k of state st
    holds an arc when its source st - offsets[k] lies in [0, S), with
    probability ``fill`` (the first such slot always does).  With
    probability ``fail_rate`` a backpointer names a random slot, which may
    be empty, else one of its state's arcs (a random slot where the state
    has none), so a walk meets its first failure after a few / fail_rate
    frames.  Frame counts are drawn in [0, T], the first lane's is T; half
    the final scores are NEG_INF."""
    offs = np.asarray(list(offsets), np.int64)
    k = len(offs)
    src = np.arange(s)[:, None] - offs[None, :]
    in_range = (src >= 0) & (src < s)
    has = in_range[None] & (rng.random((b, s, k)) < fill)
    first = np.argmax(in_range, axis=1)
    any_in = in_range.any(axis=1)
    has[:, np.flatnonzero(any_in), first[any_in]] = True
    arc_of = np.where(has, np.arange(b * s * k).reshape(b, s, k), -1).astype(np.int32)
    u = rng.integers(0, k, (t, b, s))
    present = has[np.arange(b)[None, :, None], np.arange(s)[None, None, :], u]
    fix = ~present & any_in[None, None, :] & (rng.random((t, b, s)) >= fail_rate)
    bps = np.where(fix, np.argmax(has, axis=2)[None], u).astype(np.uint8)
    alpha_end = (rng.standard_normal((b, s)) * 10 - 50).astype(np.float32)
    final = np.where(rng.random((b, s)) < 0.5, rng.standard_normal((b, s)) * 3,
                     NEG_INF).astype(np.float32)
    nf = rng.integers(0, t + 1, b).astype(np.int32)
    nf[0] = t
    return alpha_end, final, bps, nf, arc_of


def assert_models_close(got, want) -> None:
    """Two trainings of one model (``TrainedModel``s): the same live
    Gaussians; weights and transition log-probs within rtol/atol 1e-4; means
    within an atol of 2e-5 times the largest mean magnitude (the posteriors
    of split Gaussians are float32 softmaxes in another order); variances
    within rtol 1e-3 (they are E[x^2] - mean^2, which cancels)."""
    np.testing.assert_array_equal(got.am.weights > 0, want.am.weights > 0)
    mask = want.am.weights > 0
    means = want.am.means()[mask]
    np.testing.assert_allclose(got.am.means()[mask], means, rtol=0,
                               atol=2e-5 * np.abs(means).max())
    np.testing.assert_allclose(got.am.variances()[mask], want.am.variances()[mask], rtol=1e-3)
    np.testing.assert_allclose(got.am.weights, want.am.weights, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.trans_model.log_probs, want.trans_model.log_probs,
                               rtol=1e-4, atol=1e-4)


def fmllr_stats_float64(am: AmDiagGmm, feats, pdf_ids, weights, spk_ids, num_speakers: int,
                        magnitudes: bool = False):
    """The fMLLR statistics (beta ``[S]``, K ``[S, D, D+1]``, G ``[S, D,
    D+1, D+1]``) in float64 on the features' device, from the GMM's own
    arrays: each row's posteriors over its pdf's Gaussians, then per speaker
    beta = sum gamma, K = sum (gamma mu/var) xhat^T and G[d] = sum
    gamma/var_d xhat xhat^T, each one product over the speaker's rows.
    With ``magnitudes``, also K and G summed over the terms' absolute
    values: the scale of a float32 sum's rounding error in each entry."""
    import torch

    dev = feats.device
    x = feats.to(torch.float64)
    pdf = torch.as_tensor(pdf_ids).to(dev, torch.int64)
    w = torch.as_tensor(weights).to(dev, torch.float64)
    spk = torch.as_tensor(spk_ids).to(dev, torch.int64)
    miv = torch.from_numpy(am.means_invvars).to(dev, torch.float64)[pdf]  # [N, M, D]
    iv = torch.from_numpy(am.inv_vars).to(dev, torch.float64)[pdf]
    gc = torch.from_numpy(np.where(np.isfinite(am.gconsts), am.gconsts, -np.inf)).to(
        dev, torch.float64)[pdf]
    ll = gc + (miv * x[:, None]).sum(-1) - 0.5 * (iv * x[:, None] ** 2).sum(-1)
    gamma = torch.softmax(ll, dim=1) * w[:, None]  # [N, M]
    w_miv = (gamma[:, :, None] * miv).sum(1)
    w_iv = (gamma[:, :, None] * iv).sum(1)
    xhat = torch.cat([x, x.new_ones((len(x), 1))], dim=1)
    n, d = x.shape
    beta = x.new_zeros(num_speakers)
    k = x.new_zeros((2, num_speakers, d, d + 1))
    g = x.new_zeros((2, num_speakers, d, d + 1, d + 1))
    for s in range(num_speakers):
        r = (spk == s) & (w != 0)
        beta[s] = gamma[r].sum()
        for i, f in enumerate((lambda a: a, torch.abs)[:1 + magnitudes]):
            k[i, s] = f(w_miv[r]).T @ f(xhat[r])
            y = (w_iv[r][:, :, None] * f(xhat[r])[:, None, :]).reshape(-1, d * (d + 1))
            g[i, s] = (y.T @ f(xhat[r])).view(d, d + 1, d + 1)
    return (beta, k[0], g[0], k[1], g[1]) if magnitudes else (beta, k[0], g[0])
