"""An HCLG-shaped decode graph with transition ids and word labels, drawn
from the run's seed on the run's device (``models.decode_graph``'s shape:
a self-loop and arcs 1..max_jump-1 states ahead a state, all arcs into a
state carrying its pdf, graph costs exponential(1), start in state 0, every
state final with cost 0).

On top of that shape: a state starts a word with probability
``word_start_share``, drawn from a vocabulary of ``vocabulary`` words, and
every arc into such a state from another state outputs its word (a
self-loop outputs none); an arc's transition id is its pdf's self-loop or
forward transition of the (phone, HMM state, pdf) tuple that holds the pdf
(``1 + 3 rank + kind``, as ``runners/train_realign.tuple_ranks`` numbers
them).
"""

from __future__ import annotations

import numpy as np
import torch

from . import models


def decode_graph(gen, device, g: dict, num_pdfs: int, rank: np.ndarray) -> dict:
    """The graph dict of ``models.decode_graph`` (``src``, ``dst``, ``pdf``,
    ``score``, ``alpha0``, ``final``) plus ``tid`` and ``word`` (0: none)
    per arc and ``state_word`` per state."""
    graph = models.decode_graph(gen, device, int(g["num_states"]), int(g["arcs_per_state"]),
                                num_pdfs, int(g["max_jump"]))
    s = int(g["num_states"])
    starts = torch.rand(s, generator=gen, device=device) < float(g["word_start_share"])
    words = torch.randint(1, int(g["vocabulary"]) + 1, (s,), generator=gen, device=device)
    state_word = torch.where(starts, words, torch.zeros_like(words)).cpu().numpy()
    self_loop = graph["src"] == graph["dst"]
    graph["word"] = np.where(self_loop, 0, state_word[graph["dst"]]).astype(np.int32)
    graph["tid"] = (1 + 3 * rank[graph["pdf"]] + np.where(self_loop, 0, 1)).astype(np.int32)
    graph["state_word"] = state_word.astype(np.int32)
    return graph


def to_dense_graph(g: dict):
    """The program's ``DenseGraph`` of the graph: transition ids as input
    labels, each word a one-word output sequence."""
    from voicebridge_tpu_torch.ops.graph import NEG_INF, DenseGraph

    def scores(v):
        return np.where(np.isfinite(v), v, NEG_INF).astype(np.float32)

    s = len(g["alpha0"])
    vocab, oseq = np.unique(g["word"], return_inverse=True)  # word 0 first: the empty sequence
    if vocab[0] != 0:
        vocab, oseq = np.concatenate([[0], vocab]), oseq + 1
    oseqs = [()] + [(int(w),) for w in vocab[1:]]
    return DenseGraph(num_states=s, arc_src=g["src"], arc_dst=g["dst"], arc_tid=g["tid"],
                      arc_pdf=g["pdf"], arc_score=g["score"].astype(np.float32),
                      arc_oseq=oseq.astype(np.int32), alpha0=scores(g["alpha0"]),
                      start_oseq=np.zeros(s, np.int32), final_score=scores(g["final"]),
                      final_oseq=np.zeros(s, np.int32), oseqs=oseqs)
