"""Epsilon-free decode graph (host numpy), shared by the decoder's plan
builder and host path assembly.

Copied as numpy from ``voicebridge_tpu/ops/viterbi.py`` (``NEG_INF``,
``DenseGraph``, ``compile_dense_graph``): the input-epsilon arcs of an
HCLG-style FST are eliminated by epsilon-closure expansion (word outputs along
closure paths kept as "output sequence" ids), so every surviving arc consumes
exactly one frame.  Scores are max-plus (= negated tropical): higher is
better.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..fst.core import EPS, Fst, ZERO

NEG_INF = -1.0e30


class DenseGraph(NamedTuple):
    """Epsilon-free flat graph for the device decoder.  numpy/host fields
    ``oseqs`` hold word-output sequences referenced by arc/final/start ids."""

    num_states: int
    arc_src: np.ndarray  # [A] int32
    arc_dst: np.ndarray  # [A] int32
    arc_tid: np.ndarray  # [A] int32 (transition-id = graph input label)
    arc_pdf: np.ndarray  # [A] int32
    arc_score: np.ndarray  # [A] f32 (= -graph cost)
    arc_oseq: np.ndarray  # [A] int32 index into oseqs
    alpha0: np.ndarray  # [S] f32 initial scores (= -closure cost from start)
    start_oseq: np.ndarray  # [S] int32
    final_score: np.ndarray  # [S] f32 (= -final cost, NEG_INF if not final)
    final_oseq: np.ndarray  # [S] int32
    oseqs: list  # list[tuple[int]] — oseqs[0] = ()

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)


def _eps_closure_with_outputs(fst: Fst, state: int):
    """Best-cost closure over input-eps arcs from ``state``: returns
    {dest: (cost, olabels_tuple)} including (state, (0.0, ()))."""
    import heapq

    best: dict[int, tuple[float, tuple]] = {state: (0.0, ())}
    heap = [(0.0, state, ())]
    while heap:
        c, s, ostr = heapq.heappop(heap)
        if c > best[s][0] + 1e-12:
            continue
        for a in fst.arcs[s]:
            if a.ilabel != EPS:
                continue
            nc = c + a.weight
            no = ostr + ((a.olabel,) if a.olabel != EPS else ())
            cur = best.get(a.nextstate)
            if cur is None or nc < cur[0] - 1e-12:
                best[a.nextstate] = (nc, no)
                heapq.heappush(heap, (nc, a.nextstate, no))
    return best


def compile_dense_graph(fst: Fst, tid2pdf: np.ndarray) -> DenseGraph:
    """Flatten an HCLG-style FST (input = transition-ids, output = words) into
    an epsilon-free arc-parallel form."""
    n = fst.num_states
    oseq_ids: dict[tuple, int] = {(): 0}
    oseqs: list[tuple] = [()]

    def oseq_id(t: tuple) -> int:
        if t not in oseq_ids:
            oseq_ids[t] = len(oseqs)
            oseqs.append(t)
        return oseq_ids[t]

    closures = [_eps_closure_with_outputs(fst, s) for s in range(n)]

    src, dst, tid, wt, osq = [], [], [], [], []
    for s in range(n):
        for a in fst.arcs[s]:
            if a.ilabel == EPS:
                continue
            base_o = (a.olabel,) if a.olabel != EPS else ()
            for x, (c, ostr) in closures[a.nextstate].items():
                src.append(s)
                dst.append(x)
                tid.append(a.ilabel)
                wt.append(-(a.weight + c))
                osq.append(oseq_id(base_o + ostr))

    alpha0 = np.full(n, NEG_INF, dtype=np.float32)
    start_oseq = np.zeros(n, dtype=np.int32)
    if fst.start >= 0:
        for x, (c, ostr) in closures[fst.start].items():
            if -c > alpha0[x]:
                alpha0[x] = -c
                start_oseq[x] = oseq_id(ostr)

    final_score = np.full(n, NEG_INF, dtype=np.float32)
    final_oseq = np.zeros(n, dtype=np.int32)
    for s in range(n):
        for x, (c, ostr) in closures[s].items():
            if fst.finals[x] != ZERO:
                sc = -(c + fst.finals[x])
                if sc > final_score[s]:
                    final_score[s] = sc
                    final_oseq[s] = oseq_id(ostr)

    arc_tid = np.asarray(tid, dtype=np.int32)
    return DenseGraph(
        num_states=n,
        arc_src=np.asarray(src, dtype=np.int32),
        arc_dst=np.asarray(dst, dtype=np.int32),
        arc_tid=arc_tid,
        arc_pdf=tid2pdf[arc_tid].astype(np.int32),
        arc_score=np.asarray(wt, dtype=np.float32),
        arc_oseq=np.asarray(osq, dtype=np.int32),
        alpha0=alpha0,
        start_oseq=start_oseq,
        final_score=final_score,
        final_oseq=final_oseq,
        oseqs=oseqs,
    )
