"""True pruned lattice determinization (CompactLattice construction).

The JAX package's ``voicebridge_tpu/lat/determinize.py`` (``lattice_mbr``
determinizes before it builds the confusion network), its subset
construction in native code (``csrc/lat_determinize.cpp``, built with
``g++`` at first use) that gives the same determinized lattices; the
``CompactLattice`` walks (best path, N best) stay numpy.

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

import ctypes
import heapq
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from ..ops.graph import NEG_INF
from .lattice import Lattice


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
# Subset construction (native, ``csrc/lat_determinize.cpp``)
# ---------------------------------------------------------------------------

_LIB = None


def native_library() -> ctypes.CDLL:
    """The native determinization (``csrc/lat_determinize.cpp``), built at
    first use."""
    global _LIB
    if _LIB is None:
        from .._build import CSRC, build_host_library

        lib = ctypes.CDLL(str(build_host_library(CSRC / "lat_determinize.cpp",
                                                 "libvbt_latdet")))
        i32, i64, f64 = (ctypes.POINTER(t) for t in (ctypes.c_int32, ctypes.c_int64,
                                                      ctypes.c_double))
        lib.vb_det_run.restype = ctypes.c_int
        lib.vb_det_run.argtypes = [ctypes.c_int64, i32, f64, i32, ctypes.c_int32, i64, i32,
                                   i32, f64, f64, i32, i32, i64, i32, ctypes.c_int64, i32,
                                   f64, i32, ctypes.c_double, ctypes.c_double,
                                   ctypes.c_double, ctypes.c_int64,
                                   ctypes.POINTER(ctypes.c_void_p)]
        lib.vb_det_sizes.restype = None
        lib.vb_det_sizes.argtypes = [ctypes.c_void_p, i64]
        lib.vb_det_fetch.restype = None
        lib.vb_det_fetch.argtypes = [ctypes.c_void_p, i32, i32, i32, f64, f64, i64, i32, i32,
                                     f64, f64, i64, i32]
        lib.vb_det_free.restype = None
        lib.vb_det_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _nfa_inputs(lat: Lattice) -> list:
    """The lattice as the native code builds its NFA from it: the start
    entries, the arcs frame by frame, the word sequences they output (those
    used, renumbered) and the graph states at the last frame with their
    final costs and words (-1: none)."""
    g = lat.graph
    s0, c0, o0 = lat.start_entries()
    bounds = lat._frame_slices().astype(np.int64)
    arc_oseq = g.arc_oseq[lat.arc_id]
    last = (s0 if lat.nf == 0
            else np.unique(lat.arc_dst[bounds[lat.nf - 1]:bounds[lat.nf]]))
    if lat.use_final:
        fs = g.final_score[last]
        fcost = np.where(fs > NEG_INF / 2, -fs.astype(np.float64), np.inf)
        fseq = g.final_oseq[last]
    else:
        fcost = np.zeros(len(last))
        fseq = np.zeros(0, np.int64)
    used = np.unique(np.concatenate([np.asarray(o0, np.int64), arc_oseq.astype(np.int64),
                                     np.asarray(fseq, np.int64)]))
    seqs = [g.oseqs[int(o)] for o in used]
    off = np.concatenate([[0], np.cumsum([len(q) for q in seqs])]).astype(np.int64)
    words = np.asarray([w for q in seqs for w in q], np.int32)
    fseq = (np.searchsorted(used, fseq) if lat.use_final
            else np.full(len(last), -1))
    return [np.ascontiguousarray(x, dt) for x, dt in (
        (s0, np.int32), (c0, np.float64), (np.searchsorted(used, o0), np.int32),
        (bounds, np.int64), (lat.arc_src, np.int32), (lat.arc_dst, np.int32),
        (lat.graph_cost, np.float64), (lat.acoustic_cost, np.float64),
        (lat.arc_tid, np.int32), (np.searchsorted(used, arc_oseq), np.int32),
        (off, np.int64), (words, np.int32), (last, np.int32), (fcost, np.float64),
        (fseq, np.int32))]


def _ptr(x: np.ndarray):
    ctype = {np.dtype(np.int32): ctypes.c_int32, np.dtype(np.int64): ctypes.c_int64,
             np.dtype(np.float64): ctypes.c_double}[x.dtype]
    return x.ctypes.data_as(ctypes.POINTER(ctype))


def _run(inputs: list, nf: int, beam: float, lm_scale: float, acoustic_scale: float,
         max_states: int) -> tuple:
    """The native construction over a lattice's ``_nfa_inputs`` -> (its
    return code, the result's handle).  It touches no Python object, so
    that threads may run it side by side (ctypes releases the GIL)."""
    (s0, c0, o0, bounds, src, dst, gc, ac, tid, oseq, off, words, last, fcost,
     fseq) = inputs
    handle = ctypes.c_void_p()
    rc = native_library().vb_det_run(
        len(s0), _ptr(s0), _ptr(c0), _ptr(o0), nf, _ptr(bounds), _ptr(src), _ptr(dst),
        _ptr(gc), _ptr(ac), _ptr(tid), _ptr(oseq), _ptr(off), _ptr(words), len(last),
        _ptr(last), _ptr(fcost), _ptr(fseq), float(beam), float(lm_scale),
        float(acoustic_scale), int(max_states), ctypes.byref(handle))
    return rc, handle


def _collect(rc: int, handle, beam: float, max_states: int) -> CompactLattice:
    """A construction's result as a ``CompactLattice`` (its handle freed);
    raises :class:`DetStateLimitError` for one past ``max_states``."""
    if rc == 1:
        raise DetStateLimitError(f"determinization exceeded {max_states} states "
                                 f"(beam {beam})")
    if rc == 2:
        return CompactLattice(1, np.zeros(0, np.int32), np.zeros(0, np.int32),
                              np.zeros(0, np.int32), np.zeros(0, np.float32),
                              np.zeros(0, np.float32), [], {})
    lib = native_library()
    try:
        sizes = np.zeros(5, np.int64)
        lib.vb_det_sizes(handle, _ptr(sizes))
        n_states, n_arcs, n_tids, n_fin, n_fin_tids = (int(x) for x in sizes)
        out = [np.zeros(n, dt) for n, dt in (
            (n_arcs, np.int32), (n_arcs, np.int32), (n_arcs, np.int32), (n_arcs, np.float64),
            (n_arcs, np.float64), (n_arcs + 1, np.int64), (n_tids, np.int32),
            (n_fin, np.int32), (n_fin, np.float64), (n_fin, np.float64), (n_fin + 1, np.int64),
            (n_fin_tids, np.int32))]
        lib.vb_det_fetch(handle, *[_ptr(x) for x in out])
    finally:
        lib.vb_det_free(handle)
    a_src, a_dst, a_word, a_gc, a_ac, t_off, tids, f_state, f_gc, f_ac, f_off, f_tids = out
    tids, f_tids, t_off, f_off = tids.tolist(), f_tids.tolist(), t_off.tolist(), f_off.tolist()
    return CompactLattice(
        num_states=n_states, arc_src=a_src, arc_dst=a_dst, arc_word=a_word,
        arc_graph_cost=a_gc.astype(np.float32), arc_acoustic_cost=a_ac.astype(np.float32),
        arc_tids=[tuple(tids[t_off[k]:t_off[k + 1]]) for k in range(n_arcs)],
        finals={s: (g, a, tuple(f_tids[f_off[i]:f_off[i + 1]]))
                for i, (s, g, a) in enumerate(zip(f_state.tolist(), f_gc.tolist(),
                                                   f_ac.tolist()))})


def determinize_lattice_pruned(lat: Lattice, beam: float = 6.0,
                               lm_scale: float = 1.0,
                               acoustic_scale: float = 1.0,
                               max_states: int = 200_000) -> CompactLattice:
    """Determinize ``lat`` (pruned to ``beam`` around the best path at the
    given scales).  Raises :class:`DetStateLimitError` past ``max_states``.

    The construction of the module's docstring, in native code: the
    lattice's NFA (a state per (frame, graph state), word arcs chained one
    word an arc), exact best-completion costs on it, and the subsets built
    from the start's closure, the JAX package's ``determinize_lattice_pruned``
    step for step (``tests/test_torch_lat_determinize.py``)."""
    rc, handle = _run(_nfa_inputs(lat), lat.nf, beam, lm_scale, acoustic_scale, max_states)
    return _collect(rc, handle, beam, max_states)


def determinize_lattice_pruned_safe(lat: Lattice, beam: float = 6.0,
                                    lm_scale: float = 1.0,
                                    acoustic_scale: float = 1.0,
                                    max_states: int = 200_000,
                                    max_retries: int = 3) -> CompactLattice:
    """Retry wrapper: halve the beam on state-limit overflow, like the
    reference's ``DeterminizeLatticePhonePrunedWrapper``
    (``determinize-lattice-pruned.cc``)."""
    return determinize_lattices([lat], beam, lm_scale, acoustic_scale, max_states,
                                max_retries)[0][0]


def determinize_lattices(lats: list, beam: float = 6.0, lm_scale: float = 1.0,
                         acoustic_scale: float = 1.0, max_states: int = 200_000,
                         max_retries: int = 3, threads: int = 1) -> list:
    """``determinize_lattice_pruned_safe`` of each lattice -> [(CompactLattice,
    the number of times its beam was halved)]: the inputs and the results
    made in this thread, the native constructions on ``threads`` threads (a
    Python step on each would queue them for the GIL)."""
    inputs = [_nfa_inputs(lat) for lat in lats]
    native_library()  # built (at first use) here, not by racing threads
    out: list = [None] * len(lats)
    todo, b = list(range(len(lats))), beam
    pool = ThreadPoolExecutor(threads) if threads > 1 else None
    try:
        for retry in range(max_retries + 1):
            last = retry == max_retries
            cap = max_states * 4 if last else max_states
            runs = (pool.map if pool else map)(
                lambda i: _run(inputs[i], lats[i].nf, b, lm_scale, acoustic_scale, cap), todo)
            again = []
            for i, (rc, handle) in zip(todo, list(runs)):
                if rc == 1:
                    again.append(i)
                else:
                    out[i] = (_collect(rc, handle, b, cap), retry)
            todo = again
            if not todo:
                break
            if last:  # past four times the states at the least beam
                _collect(1, None, b, cap)
            b *= 0.5
    finally:
        if pool is not None:
            pool.shutdown()
    return out
