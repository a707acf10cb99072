"""True pruned lattice determinization (CompactLattice construction).

Copied as numpy from ``voicebridge_tpu/lat/determinize.py`` (``lattice_mbr``
determinizes before it builds the confusion network).

The role of the reference's ``DeterminizeLatticePruned``
(``kaldi-master/src/lat/determinize-lattice-pruned.h:112-145``,
``latbin/lattice-determinize-pruned.cc``): turn a frame-synchronous
state-level lattice into a DETERMINISTIC word-sequence acceptor —

* every distinct word sequence appears on exactly ONE path,
* that path carries the best (Viterbi) cost over all original paths with
  that word sequence, with graph/acoustic components kept separate,
* the transition-id alignment travels in the weight as a string (the
  ``CompactLatticeWeight`` convention, ``fstext/lattice-weight.h:396``), so
  the determinized lattice can still be word-aligned / rescored,
* paths worse than ``best + beam`` are pruned during expansion.

Algorithm: weighted subset construction specialized to acyclic inputs.
A det-state is a normalized subset {nfa_state -> (residual graph cost,
residual acoustic cost, residual tid string)} with one element per NFA state
— two paths reaching the same NFA state have identical suffix languages, so
only the cheaper prefix can ever win for ANY word sequence and the other is
dropped (exactly the reference's subset "plus").  Normalization divides out
the minimum-total element's cost pair and the longest common prefix of the
tid strings; both go onto the emitted det arc.  Termination follows from
acyclicity; pruning uses exact best-completion costs (beta) computed on the
NFA.  Like the reference's wrapper (``DeterminizeLatticePhonePrunedWrapper``)
the caller can retry with a halved beam when ``max_states`` overflows
(``DetStateLimitError``).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from .lattice import Lattice

_QUANT = 1e-3  # residual-cost quantization for det-state merging (delta)


class DetStateLimitError(RuntimeError):
    """Raised when subset construction exceeds max_states (retry smaller beam)."""


@dataclass
class CompactLattice:
    """Determinized word lattice: deterministic on words, acyclic, start=0.

    Arc k: src[k] --word[k] / (graph_cost[k], acoustic_cost[k], tids[k])-->
    dst[k].  ``finals`` maps state -> (graph_cost, acoustic_cost, tids) for
    final states (residual alignment allowed in the final weight, like
    CompactLatticeWeight finals).
    """

    num_states: int
    arc_src: np.ndarray
    arc_dst: np.ndarray
    arc_word: np.ndarray
    arc_graph_cost: np.ndarray
    arc_acoustic_cost: np.ndarray
    arc_tids: list  # list[tuple[int, ...]] per arc
    finals: dict  # state -> (graph_cost, acoustic_cost, tids tuple)
    start: int = 0

    @property
    def num_arcs(self) -> int:
        return len(self.arc_src)

    def arcs_from(self, state: int) -> np.ndarray:
        if not hasattr(self, "_by_src"):
            order = np.argsort(self.arc_src, kind="stable")
            self._by_src = order
            self._src_bounds = np.searchsorted(
                self.arc_src[order], np.arange(self.num_states + 1))
        lo, hi = self._src_bounds[state], self._src_bounds[state + 1]
        return self._by_src[lo:hi]

    def paths(self, max_paths: int = 100000):
        """Enumerate all complete paths as (words, graph_cost, acoustic_cost,
        tids) — test/diagnostic helper (exponential in general)."""
        out = []
        stack = [(self.start, (), 0.0, 0.0, ())]
        while stack:
            s, ws, gc, ac, tids = stack.pop()
            if s in self.finals:
                fg, fa, ft = self.finals[s]
                out.append((ws, gc + fg, ac + fa, tids + tuple(ft)))
                if len(out) > max_paths:
                    raise RuntimeError("too many paths")
            for k in self.arcs_from(s):
                stack.append((int(self.arc_dst[k]), ws + (int(self.arc_word[k]),),
                              gc + float(self.arc_graph_cost[k]),
                              ac + float(self.arc_acoustic_cost[k]),
                              tids + tuple(self.arc_tids[k])))
        return out

    def best_path(self, lm_scale: float = 1.0, acoustic_scale: float = 1.0,
                  word_penalty: float = 0.0):
        """Shortest path: returns {"words", "score", "tids"} (score = -cost,
        matching ``lattice_best_path``).  Topological DP — arc costs can be
        negative after rescaling, so Dijkstra would be invalid."""
        cost = (self.arc_graph_cost * lm_scale
                + self.arc_acoustic_cost * acoustic_scale + word_penalty)
        n = self.num_states
        dist = np.full(n, np.inf)
        back = np.full(n, -1, np.int64)
        dist[self.start] = 0.0
        for s in self.topo_order():
            if not np.isfinite(dist[s]):
                continue
            for k in self.arcs_from(s):
                nd = dist[s] + float(cost[k])
                ds = int(self.arc_dst[k])
                if nd < dist[ds]:
                    dist[ds] = nd
                    back[ds] = k
        best, bs = np.inf, -1
        for s, (fg, fa, _ft) in self.finals.items():
            tot = dist[s] + fg * lm_scale + fa * acoustic_scale
            if tot < best:
                best, bs = tot, s
        if bs < 0:
            return {"words": [], "score": -np.inf, "tids": []}
        arcs = []
        s = bs
        while s != self.start and back[s] >= 0:
            k = int(back[s])
            arcs.append(k)
            s = int(self.arc_src[k])
        arcs.reverse()
        words = [int(self.arc_word[k]) for k in arcs]
        tids = [t for k in arcs for t in self.arc_tids[k]]
        tids += list(self.finals[bs][2])
        return {"words": words, "score": -float(best), "tids": tids}

    def topo_order(self) -> list[int]:
        """Reverse-postorder DFS topological order (the lattice is a DAG)."""
        seen = np.zeros(self.num_states, bool)
        order = []
        stack = [(self.start, iter(self.arcs_from(self.start)))]
        seen[self.start] = True
        while stack:
            s, it = stack[-1]
            adv = False
            for k in it:
                d = int(self.arc_dst[k])
                if not seen[d]:
                    seen[d] = True
                    stack.append((d, iter(self.arcs_from(d))))
                    adv = True
                    break
            if not adv:
                order.append(s)
                stack.pop()
        order.reverse()
        return order

    def nbest(self, n: int, lm_scale: float = 1.0, acoustic_scale: float = 1.0,
              word_penalty: float = 0.0) -> list[dict]:
        """Exact N best word sequences (each unique by construction): A*
        best-first search; finishing is modeled as a virtual end transition so
        hypotheses pop in exact cost order."""
        cost = (self.arc_graph_cost * lm_scale
                + self.arc_acoustic_cost * acoustic_scale + word_penalty)
        h = _backward_best(self, cost, lm_scale, acoustic_scale)
        if not np.isfinite(h[self.start]):
            return []
        out = []
        ctr = 0  # tie-breaker so heterogeneous payloads never compare
        heap = [(float(h[self.start]), 0, self.start, (), (), False)]
        pops = 0
        while heap and len(out) < n:
            f, _c, s, ws, tids, done = heapq.heappop(heap)
            pops += 1
            if pops > 500_000:
                break
            if done:
                out.append({"words": list(ws), "score": -float(f),
                            "tids": list(tids)})
                continue
            g_here = f - h[s]
            if s in self.finals:
                fg, fa, ft = self.finals[s]
                ctr += 1
                heapq.heappush(
                    heap, (g_here + fg * lm_scale + fa * acoustic_scale,
                           ctr, -1, ws, tids + tuple(ft), True))
            for k in self.arcs_from(s):
                ds = int(self.arc_dst[k])
                g2 = g_here + float(cost[k])
                if not np.isfinite(h[ds]):
                    continue
                ctr += 1
                heapq.heappush(heap, (g2 + float(h[ds]), ctr, ds,
                                      ws + (int(self.arc_word[k]),),
                                      tids + tuple(self.arc_tids[k]), False))
        return out


def _backward_best(clat: CompactLattice, cost: np.ndarray, lm_scale, acwt):
    """Exact best completion cost per state (reverse topological sweep)."""
    n = clat.num_states
    h = np.full(n, np.inf)
    for s, (fg, fa, _t) in clat.finals.items():
        h[s] = fg * lm_scale + fa * acwt
    for s in reversed(clat.topo_order()):
        for k in clat.arcs_from(s):
            c = float(cost[k]) + h[int(clat.arc_dst[k])]
            if c < h[s]:
                h[s] = c
    return h


# ---------------------------------------------------------------------------
# NFA construction from a frame-synchronous Lattice
# ---------------------------------------------------------------------------


class _Nfa:
    """Word-label NFA with (graph, acoustic, tids) weights, single final."""

    __slots__ = ("narcs", "order", "num_states", "final")

    def __init__(self):
        self.narcs: list[list] = [[]]  # per state: (dst, word|-1, gc, ac, tids)
        self.order: list[int] = [0]  # topological rank per state
        self.final = -1

    def add_state(self, rank: int) -> int:
        self.narcs.append([])
        self.order.append(rank)
        return len(self.narcs) - 1

    def add_arc(self, src, dst, word, gc, ac, tids=()):
        self.narcs[src].append((dst, word, float(gc), float(ac), tuple(tids)))

    def add_word_seq(self, src, dst, words, gc, ac, tids, rank):
        """Arc with 0..k words -> chain of single-word arcs (cost/tids on the
        first arc)."""
        if len(words) == 0:
            self.add_arc(src, dst, -1, gc, ac, tids)
            return
        cur = src
        for i, w in enumerate(words):
            nxt = dst if i == len(words) - 1 else self.add_state(rank)
            if i == 0:
                self.add_arc(cur, nxt, int(w), gc, ac, tids)
            else:
                self.add_arc(cur, nxt, int(w), 0.0, 0.0, ())
            cur = nxt


def _build_nfa(lat: Lattice) -> _Nfa:
    g = lat.graph
    nfa = _Nfa()  # state 0 = superstart, rank 0
    state_of: dict[tuple, int] = {}

    def get_state(t: int, s: int) -> int:
        key = (t, s)
        q = state_of.get(key)
        if q is None:
            q = nfa.add_state(2 + 2 * t)
            state_of[key] = q
        return q

    for s0, c0, o0 in zip(*lat.start_entries()):
        q = get_state(0, int(s0))
        nfa.add_word_seq(0, q, g.oseqs[int(o0)], float(c0), 0.0, (), 1)
    bounds = lat._frame_slices()
    for t in range(lat.nf):
        for m in range(bounds[t], bounds[t + 1]):
            sa, da = int(lat.arc_src[m]), int(lat.arc_dst[m])
            qs = get_state(t, sa)
            qd = get_state(t + 1, da)
            nfa.add_word_seq(qs, qd, lat.arc_words(m),
                             float(lat.graph_cost[m]),
                             float(lat.acoustic_cost[m]),
                             (int(lat.arc_tid[m]),), 3 + 2 * t)
    final = nfa.add_state(2 + 2 * lat.nf + 2)
    nfa.final = final
    for (t, s), q in list(state_of.items()):
        if t != lat.nf:
            continue
        fc = lat.final_cost(s)
        if not np.isfinite(fc):
            continue
        fw = tuple(g.oseqs[g.final_oseq[s]]) if lat.use_final else ()
        nfa.add_word_seq(q, final, fw, fc, 0.0, (), 2 + 2 * lat.nf + 1)
    return nfa


def _beta(nfa: _Nfa, lm_scale: float, acwt: float) -> np.ndarray:
    """Exact best completion cost to the final state, per NFA state."""
    n = len(nfa.narcs)
    beta = np.full(n, np.inf)
    beta[nfa.final] = 0.0
    for q in sorted(range(n), key=lambda i: -nfa.order[i]):
        for (d, _w, gc, ac, _t) in nfa.narcs[q]:
            c = gc * lm_scale + ac * acwt + beta[d]
            if c < beta[q]:
                beta[q] = c
    return beta


# ---------------------------------------------------------------------------
# Subset construction
# ---------------------------------------------------------------------------


def determinize_lattice_pruned(lat: Lattice, beam: float = 6.0,
                               lm_scale: float = 1.0,
                               acoustic_scale: float = 1.0,
                               max_states: int = 200_000) -> CompactLattice:
    """Determinize ``lat`` (pruned to ``beam`` around the best path at the
    given scales).  Raises :class:`DetStateLimitError` past ``max_states``."""
    nfa = _build_nfa(lat)
    beta = _beta(nfa, lm_scale, acoustic_scale)
    if not np.isfinite(beta[0]):
        return CompactLattice(1, np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.int32), np.zeros(0, np.float32),
                              np.zeros(0, np.float32), [], {})
    best_total = float(beta[0])
    limit = best_total + beam

    def total(gc, ac):
        return gc * lm_scale + ac * acoustic_scale

    def closure(elems: dict, base_fwd: float) -> dict:
        """Epsilon-close {q: (gc, ac, tids)} keeping the min-total element
        per state; prune elements outside the beam."""
        heap = [(nfa.order[q], q) for q in elems]
        heapq.heapify(heap)
        inq = set(elems)
        while heap:
            _, q = heapq.heappop(heap)
            inq.discard(q)
            gc, ac, tids = elems[q]
            for (d, w, agc, aac, atids) in nfa.narcs[q]:
                if w != -1:
                    continue
                ngc, nac = gc + agc, ac + aac
                if base_fwd + total(ngc, nac) + beta[d] > limit:
                    continue
                old = elems.get(d)
                if old is None or total(ngc, nac) < total(old[0], old[1]) - 1e-9:
                    elems[d] = (ngc, nac, tids + atids)
                    if d not in inq:
                        heapq.heappush(heap, (nfa.order[d], d))
                        inq.add(d)
        return {q: v for q, v in elems.items()
                if base_fwd + total(v[0], v[1]) + beta[q] <= limit}

    def normalize(elems: dict):
        """Divide out (min-total cost pair, longest common tid prefix).
        Returns (base_gc, base_ac, prefix, residual dict, canonical key)."""
        qmin = min(elems, key=lambda q: (total(elems[q][0], elems[q][1]),
                                         elems[q][2]))
        bg, ba, _ = elems[qmin]
        strs = [v[2] for v in elems.values()]
        prefix = strs[0]
        for s in strs[1:]:
            k = 0
            m = min(len(prefix), len(s))
            while k < m and prefix[k] == s[k]:
                k += 1
            prefix = prefix[:k]
            if not prefix:
                break
        p = len(prefix)
        res = {q: (gc - bg, ac - ba, tids[p:])
               for q, (gc, ac, tids) in elems.items()}
        key = frozenset(
            (q, round(total(gc, ac) / _QUANT), tids)
            for q, (gc, ac, tids) in res.items())
        return bg, ba, prefix, res, key

    # det-state bookkeeping
    det_key2id: dict = {}
    det_elems: list[dict] = []
    det_fwd: list[float] = []
    arcs_src, arcs_dst, arcs_word = [], [], []
    arcs_gc, arcs_ac, arcs_tids = [], [], []
    finals: dict = {}

    start_elems = closure({0: (0.0, 0.0, ())}, 0.0)
    # start state: no incoming arc to carry the divisor, so keep it
    # un-normalized (cost divisor 0) — matches the reference's initial subset
    skey = frozenset((q, round(total(gc, ac) / _QUANT), tids)
                     for q, (gc, ac, tids) in start_elems.items())
    det_key2id[skey] = 0
    det_elems.append(start_elems)
    det_fwd.append(0.0)
    queue = [0]
    while queue:
        sid = queue.pop()
        elems = det_elems[sid]
        fwd = det_fwd[sid]
        # final?
        if nfa.final in elems:
            gc, ac, tids = elems[nfa.final]
            finals[sid] = (gc, ac, tids)
        # group word arcs
        by_word: dict[int, dict] = {}
        for q, (gc, ac, tids) in elems.items():
            for (d, w, agc, aac, atids) in nfa.narcs[q]:
                if w == -1:
                    continue
                ngc, nac = gc + agc, ac + aac
                if fwd + total(ngc, nac) + beta[d] > limit:
                    continue
                tgt = by_word.setdefault(w, {})
                old = tgt.get(d)
                if old is None or total(ngc, nac) < total(old[0], old[1]) - 1e-9:
                    tgt[d] = (ngc, nac, tids + atids)
        for w in sorted(by_word):
            elems2 = closure(by_word[w], fwd)
            if not elems2:
                continue
            bg, ba, prefix, res, key = normalize(elems2)
            nid = det_key2id.get(key)
            if nid is None:
                if len(det_elems) >= max_states:
                    raise DetStateLimitError(
                        f"determinization exceeded {max_states} states "
                        f"(beam {beam})")
                nid = len(det_elems)
                det_key2id[key] = nid
                det_elems.append(res)
                det_fwd.append(fwd + total(bg, ba))
                queue.append(nid)
            arcs_src.append(sid)
            arcs_dst.append(nid)
            arcs_word.append(w)
            arcs_gc.append(bg)
            arcs_ac.append(ba)
            arcs_tids.append(prefix)

    return CompactLattice(
        num_states=len(det_elems),
        arc_src=np.asarray(arcs_src, np.int32),
        arc_dst=np.asarray(arcs_dst, np.int32),
        arc_word=np.asarray(arcs_word, np.int32),
        arc_graph_cost=np.asarray(arcs_gc, np.float32),
        arc_acoustic_cost=np.asarray(arcs_ac, np.float32),
        arc_tids=arcs_tids,
        finals=finals)


def determinize_lattice_pruned_safe(lat: Lattice, beam: float = 6.0,
                                    lm_scale: float = 1.0,
                                    acoustic_scale: float = 1.0,
                                    max_states: int = 200_000,
                                    max_retries: int = 3) -> CompactLattice:
    """Retry wrapper: halve the beam on state-limit overflow, like the
    reference's ``DeterminizeLatticePhonePrunedWrapper``
    (``determinize-lattice-pruned.cc``)."""
    b = beam
    for _ in range(max_retries):
        try:
            return determinize_lattice_pruned(
                lat, beam=b, lm_scale=lm_scale,
                acoustic_scale=acoustic_scale, max_states=max_states)
        except DetStateLimitError:
            b *= 0.5
    return determinize_lattice_pruned(
        lat, beam=b, lm_scale=lm_scale, acoustic_scale=acoustic_scale,
        max_states=max_states * 4)
