"""Inputs for the port's tests and its chip smoke run.

* ``load_yesno_mono``: the Yes-No monophone model that the JAX package
  trained (``tools/make_torch_fixture.py``), with the JAX package's decoding
  hypotheses, committed under ``assets/yesno_mono``.  The waves are not
  stored: ``tests/synth.py`` makes the corpus again from its seed.
* ``synth_decode_graph`` / ``random_am``: the repo's full-width decode shape
  (``bench.py``): an HCLG-shaped 60k-state / 480k-arc graph and a
  2000-pdf x 5-Gaussian x 39-dim diagonal GMM, from numpy seeds.
* ``synth_train_graph``: the repo's full-width training-alignment graph
  (``bench.py``): a left-to-right chain of HMM states with self-loops and
  optional skips, banded and dst-pure like a compiled training graph.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from voicebridge_tpu.fst.core import Fst
from voicebridge_tpu.models.gmm import AmDiagGmm
from voicebridge_tpu.models.topology import HmmTopology
from voicebridge_tpu.models.transition import TransitionModel
from voicebridge_tpu.models.tree import load_tree
from voicebridge_tpu.steps.score import compute_wer_set
from voicebridge_tpu.utils.text import SymbolTable

from .ops.graph import NEG_INF, DenseGraph

ASSET_DIR = Path(__file__).parent / "assets" / "yesno_mono"

__all__ = ["ASSET_DIR", "YesNoModel", "compute_wer_set", "load_yesno_mono",
           "random_am", "synth_decode_graph", "synth_train_graph"]


@dataclass
class YesNoModel:
    am: AmDiagGmm
    hclg: Fst
    trans_model: TransitionModel
    words: SymbolTable
    corpus: dict  # make_corpus arguments the model was trained with
    samp_freq: float
    hyps: dict  # utt -> hypothesis words of the JAX package's decode


def load_yesno_mono(path: Path = ASSET_DIR) -> YesNoModel:
    path = Path(path)
    tm = TransitionModel(HmmTopology.load(path / "topo.json"), load_tree(path / "tree.json"))
    tm.load_probs(path / "trans.json")
    meta = json.loads((path / "hyps.json").read_text())
    return YesNoModel(am=AmDiagGmm.load(path / "am.npz"), hclg=Fst.load(path / "hclg.npz"),
                      trans_model=tm, words=SymbolTable.read(path / "words.txt"),
                      corpus=meta["corpus"], samp_freq=meta["samp_freq"],
                      hyps=meta["hyps"])


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


def random_am(num_pdfs: int = 2000, max_mix: int = 5, dim: int = 39,
              seed: int = 1) -> AmDiagGmm:
    """Random diagonal GMM of the given size (``bench.py``'s decode AM)."""
    rng = np.random.default_rng(seed)
    return AmDiagGmm(
        rng.standard_normal((num_pdfs, max_mix, dim)).astype(np.float32),
        np.abs(rng.standard_normal((num_pdfs, max_mix, dim))).astype(np.float32) + 0.5,
        np.full((num_pdfs, max_mix), 1.0 / max_mix, np.float32))


def synth_train_graph(num_states: int, num_pdfs: int, rng) -> DenseGraph:
    """Synthetic training-alignment graph (``bench.py`` ``synth_train_graph``):
    a left-to-right chain with self-loops and 25 % optional skip arcs, all
    arcs entering a state sharing its pdf; start at state 0, final at the
    last state."""
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
