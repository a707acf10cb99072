"""Frame-synchronous lattices + lattice algebra on the host.

Copied as numpy from ``voicebridge_tpu/lat/lattice.py``; only the imports
differ (the JAX package's ``lat`` imports jax through ``ops/viterbi.py``).

Counterpart of the reference's lattice stack (``lat/kaldi-lattice.h:69-107``
``Lattice/CompactLattice``; ``lat/lattice-functions.h`` best-path / posterior /
depth / scale; ``latbin/lattice-{scale,add-penalty,best-path,to-post,
mbr-decode}.cpp``; ``gmmbin/gmm-rescore-lattice.cpp``).

Representation: the device forward-backward (``ops/lattice.py``) emits, per
utterance, the set of surviving (frame t, dense-graph arc a) instances.  A
``Lattice`` stores them as flat arrays with Kaldi's ``LatticeWeight``
convention — graph cost and acoustic cost kept SEPARATE so scaling
(``LatticeScale``, the LMWT sweep) is a reweighting, not a re-decode.  States
are implicit (t, graph-state) pairs; the lattice is acyclic and topologically
ordered by t, so every algorithm below is a single vectorized sweep over
frames.

Word labels: dense-graph arcs carry word *sequences* (epsilon-closure
outputs), stored per arc via the graph's oseq table.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..ops.graph import NEG_INF, DenseGraph


@dataclass
class Lattice:
    """A pruned utterance lattice over a shared dense decode graph."""

    graph: DenseGraph
    nf: int                      # number of frames
    arc_t: np.ndarray            # [M] int32 frame index
    arc_id: np.ndarray           # [M] int32 dense-graph arc id
    acoustic_cost: np.ndarray    # [M] f32 = -loglik (unscaled)
    # per-utterance start/final handling
    use_final: bool              # final states were reachable
    # caches
    _states: dict = field(default_factory=dict, repr=False)

    # -- derived views -------------------------------------------------------
    @property
    def num_arcs(self) -> int:
        return len(self.arc_id)

    @property
    def arc_src(self) -> np.ndarray:
        return self.graph.arc_src[self.arc_id]

    @property
    def arc_dst(self) -> np.ndarray:
        return self.graph.arc_dst[self.arc_id]

    @property
    def graph_cost(self) -> np.ndarray:
        return -self.graph.arc_score[self.arc_id]

    @property
    def arc_tid(self) -> np.ndarray:
        return self.graph.arc_tid[self.arc_id]

    @property
    def arc_pdf(self) -> np.ndarray:
        return self.graph.arc_pdf[self.arc_id]

    def arc_words(self, m: int) -> tuple:
        return self.graph.oseqs[self.graph.arc_oseq[self.arc_id[m]]]

    def num_words(self) -> np.ndarray:
        """[M] number of word labels on each arc (for insertion penalties)."""
        lens = np.asarray([len(o) for o in self.graph.oseqs], np.int32)
        return lens[self.graph.arc_oseq[self.arc_id]]

    def final_cost(self, state: int) -> float:
        """Final cost of graph state ``state`` at frame nf."""
        if not self.use_final:
            return 0.0
        fs = self.graph.final_score[state]
        return float(-fs) if fs > NEG_INF / 2 else float("inf")

    def arc_total_cost(self, lm_scale: float = 1.0, acoustic_scale: float = 1.0,
                       word_penalty: float = 0.0) -> np.ndarray:
        """Combined per-arc cost under (LatticeScale + AddPenalty) weights."""
        c = self.graph_cost * lm_scale + self.acoustic_cost * acoustic_scale
        if word_penalty:
            c = c + word_penalty * self.num_words()
        return c

    # -- state indexing ------------------------------------------------------
    def _frame_slices(self):
        """Arc index ranges per frame (arcs are sorted by t at build time)."""
        bounds = np.searchsorted(self.arc_t, np.arange(self.nf + 1))
        return bounds

    def _compact(self):
        """(states [K], src_c [M], dst_c [M]): graph states touched by this
        lattice and per-arc endpoints remapped into [0, K).  Sweeps allocate
        [K]-sized frames instead of dense [num_graph_states] — on a real HCLG
        (~90k states) the touched set is orders of magnitude smaller."""
        cached = self._states.get("compact")
        if cached is None:
            starts = self.start_entries()[0]
            states = np.unique(np.concatenate(
                [self.arc_src, self.arc_dst, starts.astype(np.int64)]))
            src_c = np.searchsorted(states, self.arc_src).astype(np.int64)
            dst_c = np.searchsorted(states, self.arc_dst).astype(np.int64)
            cached = (states, src_c, dst_c)
            self._states["compact"] = cached
        return cached

    def start_entries(self):
        """(states, costs, oseq ids) of lattice entry points at t=0."""
        g = self.graph
        if self.num_arcs == 0:
            srcs = np.asarray([int(np.argmax(g.alpha0))], np.int64)
        else:
            srcs = np.unique(self.arc_src[self.arc_t == 0])
        costs = -g.alpha0[srcs]
        oseqs = g.start_oseq[srcs]
        ok = costs < -NEG_INF / 2
        return srcs[ok], costs[ok], oseqs[ok]


def build_lattices(graph: DenseGraph, mask: np.ndarray, ll: np.ndarray,
                   num_frames, use_final: np.ndarray) -> list[Lattice]:
    """Assemble per-utterance lattices from the device FB survivor mask.

    mask [T, B, A] bool; ll [B, T, P] host loglikes; num_frames [B].
    """
    t_tot, b, a = mask.shape
    out = []
    for i in range(b):
        nf = int(num_frames[i])
        ts, arcs = np.nonzero(mask[:nf, i, :])
        order = np.argsort(ts, kind="stable")
        ts = ts[order].astype(np.int32)
        arcs = arcs[order].astype(np.int32)
        ac = -ll[i, ts, graph.arc_pdf[arcs]].astype(np.float32)
        out.append(Lattice(graph=graph, nf=nf, arc_t=ts, arc_id=arcs,
                           acoustic_cost=ac, use_final=bool(use_final[i])))
    return out


def build_lattices_sparse(graph: DenseGraph, row_arc: np.ndarray,
                          sparse: list, nbytes: int, ll: np.ndarray,
                          num_frames, use_final: np.ndarray,
                          log_warn=None) -> list["Lattice"]:
    """Assemble lattices from the SPARSE survivor-word fetch of
    ``lattice_forward_backward_rows(mask_budget=...)``: per window,
    ``(t0, idx [K, B], val [K, B], count [B])`` where idx are 4-byte WORD
    positions over the flat ``t_local * nbytes + byte`` mask space (-1
    pad) and val the big-endian packed mask words (ops/lattice.py
    ``_sparsify_words``).  Same expansion math as
    :func:`build_lattices_packed`; a window whose nonzero-word count
    exceeded the budget K is clipped (latest frames dropped) and reported
    via ``log_warn(utt_index, window_t0, count, budget)`` — callers that
    pass no handler (external API users) get a log.warning instead of a
    silent clip; the production Decoder passes a collector and refetches
    the whole chunk dense, so its lattices are never clipped."""
    from ..utils.logging import get_logger

    if log_warn is None:
        log_warn = (lambda i, t0, c, k: get_logger().warning(
            "build_lattices_sparse: utt %d window t0=%d overflowed the "
            "sparse mask budget (%d > %d); lattice clipped — refetch dense "
            "for exactness", i, t0, c, k))
    row_arc_flat = row_arc.reshape(-1)
    n_pos = len(row_arc_flat)
    shifts = np.array([24, 16, 8, 0], np.uint32)[None, :]
    b = sparse[0][3].shape[0] if sparse else 0
    out = []
    for i in range(b):
        nf = int(num_frames[i])
        ts_parts, byte_parts, val_parts = [], [], []
        for t0, idx, val, count in sparse:
            budget = idx.shape[0]
            c = int(count[i])
            if c > budget:
                log_warn(i, int(t0), c, budget)
                c = budget
            if c == 0:
                continue
            wpos = idx[:c, i].astype(np.int64)
            wval = val[:c, i].astype(np.uint32)
            bpos = (wpos[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
            bval = ((wval[:, None] >> shifts) & 0xFF).astype(
                np.uint8).reshape(-1)
            nzb = bval != 0
            pos, bv = bpos[nzb], bval[nzb]
            ts_parts.append(t0 + pos // nbytes)
            byte_parts.append(pos % nbytes)
            val_parts.append(bv)
        if not ts_parts:
            out.append(Lattice(graph=graph, nf=nf,
                               arc_t=np.zeros(0, np.int32),
                               arc_id=np.zeros(0, np.int32),
                               acoustic_cost=np.zeros(0, np.float32),
                               use_final=bool(use_final[i])))
            continue
        ts_b = np.concatenate(ts_parts)
        bytes_b = np.concatenate(byte_parts)
        vals = np.concatenate(val_parts)
        inside = ts_b < nf
        ts_b, bytes_b, vals = ts_b[inside], bytes_b[inside], vals[inside]
        bits = np.unpackbits(vals[:, None], axis=1)  # [n, 8]
        pos = bytes_b[:, None] * 8 + np.arange(8)[None, :]
        keep = (bits == 1) & (pos < n_pos)
        ts = np.repeat(ts_b, 8).reshape(-1, 8)[keep].astype(np.int32)
        arcs = row_arc_flat[pos[keep]]
        ok = arcs >= 0
        ts, arcs = ts[ok], arcs[ok].astype(np.int32)
        order = np.argsort(ts, kind="stable")
        ts, arcs = ts[order], arcs[order]
        ac = (np.zeros(len(ts), np.float32) if ll is None
              else -ll[i, ts, graph.arc_pdf[arcs]].astype(np.float32))
        out.append(Lattice(graph=graph, nf=nf, arc_t=ts, arc_id=arcs,
                           acoustic_cost=ac, use_final=bool(use_final[i])))
    return out


def build_lattices_packed(graph: DenseGraph, row_arc: np.ndarray,
                          packed: np.ndarray, ll: np.ndarray, num_frames,
                          use_final: np.ndarray) -> list[Lattice]:
    """Assemble lattices from the row-based FB's packed survivor bits
    WITHOUT unpacking the dense [T, A] mask: survivors are sparse, so only
    nonzero bytes are expanded (~1000x less host work on a real HCLG).

    packed [T, nbytes, B] uint8 (row-major bit positions = row * D + slot);
    row_arc: EmitPlan.row_arc (maps positions to graph arc ids, -1 = pad);
    ll [B, T, P] host loglikes, or None to skip acoustic costs (zeros) —
    the production Decoder fills them afterwards with a device gather of
    exactly the surviving (utt, t, pdf) entries instead of fetching the
    full multi-hundred-MB loglik block to the host (round 5).
    """
    row_arc_flat = row_arc.reshape(-1)
    n_pos = len(row_arc_flat)
    out = []
    for i in range(packed.shape[2]):
        nf = int(num_frames[i])
        pk = packed[:nf, :, i]
        ts_b, bytes_b = np.nonzero(pk)
        if len(ts_b) == 0:
            out.append(Lattice(graph=graph, nf=nf,
                               arc_t=np.zeros(0, np.int32),
                               arc_id=np.zeros(0, np.int32),
                               acoustic_cost=np.zeros(0, np.float32),
                               use_final=bool(use_final[i])))
            continue
        bits = np.unpackbits(pk[ts_b, bytes_b][:, None], axis=1)  # [n, 8]
        pos = bytes_b[:, None] * 8 + np.arange(8)[None, :]
        keep = (bits == 1) & (pos < n_pos)
        ts = np.repeat(ts_b, 8).reshape(-1, 8)[keep].astype(np.int32)
        arcs = row_arc_flat[pos[keep]]
        ok = arcs >= 0
        ts, arcs = ts[ok], arcs[ok].astype(np.int32)
        order = np.argsort(ts, kind="stable")
        ts, arcs = ts[order], arcs[order]
        ac = (np.zeros(len(ts), np.float32) if ll is None
              else -ll[i, ts, graph.arc_pdf[arcs]].astype(np.float32))
        out.append(Lattice(graph=graph, nf=nf, arc_t=ts, arc_id=arcs,
                           acoustic_cost=ac, use_final=bool(use_final[i])))
    return out


# ---------------------------------------------------------------------------
# Forward sweeps over a lattice (all vectorized per frame)
# ---------------------------------------------------------------------------


def _sweep(lat: Lattice, arc_cost: np.ndarray, mode: str,
           lm_scale=1.0):
    """Shared forward sweep over COMPACT lattice states.  mode='min'
    (tropical/Viterbi, returns backpointers) or 'log' (log semiring, alphas
    only).

    ``arc_cost`` is [M] or [G, M] — a whole (LMWT, WIP) grid sweeps in one
    pass (the reference shards its sweep over threads,
    ``score_kaldi_wer.cpp:93-111``; here the grid is a vector axis).
    ``lm_scale`` scales start costs ([G] or scalar).  Returns
    (alphas: list of [G, K] per frame boundary, bps: list of [G, K]).
    """
    states, src_c, dst_c = lat._compact()
    k = len(states)
    cost2 = arc_cost if arc_cost.ndim == 2 else arc_cost[None]
    gdim = cost2.shape[0]
    lms = np.broadcast_to(np.asarray(lm_scale, np.float64), (gdim,))
    inf = np.float64(np.inf)
    alpha = np.full((gdim, k), inf)
    srcs, costs, _ = lat.start_entries()
    start_c = np.searchsorted(states, srcs)
    alpha[:, start_c] = lms[:, None] * costs[None, :]
    alphas = [alpha]
    bps = []
    bounds = lat._frame_slices()
    rows = np.arange(gdim)[:, None]
    for t in range(lat.nf):
        lo, hi = bounds[t], bounds[t + 1]
        sa, da, ca = src_c[lo:hi], dst_c[lo:hi], cost2[:, lo:hi]
        cand = alpha[:, sa] + ca  # [G, H]
        new = np.full((gdim, k), inf)
        if mode == "min":
            order = np.argsort(-cand, axis=1, kind="stable")  # descending
            da_o = da[order]
            new[rows, da_o] = np.take_along_axis(cand, order, axis=1)
            bp = np.full((gdim, k), -1, np.int64)
            bp[rows, da_o] = np.arange(lo, hi)[order]
            bps.append(bp)
        else:
            # stable -logsumexp(-cand) per dst: min as shift, then exp-sum
            rows_b = np.broadcast_to(rows, cand.shape)
            da_b = np.broadcast_to(da[None, :], cand.shape)
            np.minimum.at(new, (rows_b, da_b), cand)
            m = new[:, da]
            acc = np.zeros((gdim, k))
            np.add.at(acc, (rows_b, da_b), np.exp(-(cand - m)))
            new = np.where(np.isfinite(new),
                           new - np.log(np.maximum(acc, 1e-300)), inf)
        alpha = new
        alphas.append(alpha)
    return alphas, bps


def lattice_best_path_grid(lat: Lattice, points: list) -> list[dict]:
    """Viterbi best path per (lm_scale, acoustic_scale, word_penalty) grid
    point, all points swept in ONE vectorized pass (``lattice-scale`` ->
    ``lattice-add-penalty`` -> ``lattice-best-path`` per point,
    ``score_kaldi_wer.cpp:279-356``).  Returns one result dict per point."""
    g = lat.graph
    states, src_c, _dst_c = lat._compact()
    lms = np.asarray([p[0] for p in points], np.float64)
    acs = np.asarray([p[1] for p in points], np.float64)
    wps = np.asarray([p[2] for p in points], np.float64)
    base = lat.graph_cost.astype(np.float64)
    ac = lat.acoustic_cost.astype(np.float64)
    cost = lms[:, None] * base[None, :] + acs[:, None] * ac[None, :]
    if wps.any():
        cost = cost + wps[:, None] * lat.num_words()[None, :].astype(np.float64)
    alphas, bps = _sweep(lat, cost, "min", lms)
    final = alphas[-1].copy()  # [G, K]
    if lat.use_final:
        fs = g.final_score[states]
        fs = np.where(fs > NEG_INF / 2, -fs.astype(np.float64), np.inf)
        final = final + lms[:, None] * fs[None, :]
    out = []
    for gi in range(len(points)):
        if not np.isfinite(final[gi]).any():
            out.append({"words": [], "tids": [], "score": -np.inf, "arcs": []})
            continue
        end_c = int(np.argmin(final[gi]))
        total = float(final[gi][end_c])
        arcs = []
        s_cur = end_c
        for t in range(lat.nf - 1, -1, -1):
            m = int(bps[t][gi][s_cur])
            arcs.append(m)
            s_cur = int(src_c[m])
        arcs.reverse()
        words = list(g.oseqs[g.start_oseq[states[s_cur]]])
        for m in arcs:
            words.extend(lat.arc_words(m))
        if lat.use_final:
            words.extend(g.oseqs[g.final_oseq[states[end_c]]])
        out.append({"words": words,
                    "tids": [int(t) for t in lat.arc_tid[arcs]],
                    "score": -total, "arcs": arcs})
    return out


def lattice_best_path(lat: Lattice, lm_scale: float = 1.0,
                      acoustic_scale: float = 1.0,
                      word_penalty: float = 0.0) -> dict:
    """Viterbi best path through the lattice (``lattice-best-path`` role,
    with ``lattice-scale``/``lattice-add-penalty`` folded into the weights).

    Returns {"words", "tids", "score", "arcs"} like the decoder backtraces
    (score in max-plus domain = -cost).
    """
    return lattice_best_path_grid(
        lat, [(lm_scale, acoustic_scale, word_penalty)])[0]


def lattice_to_post(lat: Lattice, acoustic_scale: float = 1.0,
                    lm_scale: float = 1.0, min_post: float = 1e-4):
    """Arc posteriors by forward-backward in the log semiring
    (``lattice-to-post`` role).  Returns (arc_post [M] f64, per-frame lists of
    (tid, pdf, post) with posts > min_post normalized per frame).
    """
    g = lat.graph
    states, src_c, dst_c = lat._compact()
    k = len(states)
    cost = lat.arc_total_cost(lm_scale, acoustic_scale).astype(np.float64)
    alphas, _ = _sweep(lat, cost, "log", lm_scale)

    # backward (log semiring, compact states); final costs are graph costs
    inf = np.inf
    if lat.use_final:
        fs = g.final_score[states]
        beta = np.where(fs > NEG_INF / 2,
                        -fs.astype(np.float64) * lm_scale, inf)
    else:
        beta = np.zeros(k, np.float64)
    bounds = lat._frame_slices()
    arc_post = np.zeros(lat.num_arcs, np.float64)
    # total log prob (cost domain): combine at the end states
    tot = _log_add_vec(alphas[-1][0] + beta)
    betas_next = beta
    for t in range(lat.nf - 1, -1, -1):
        lo, hi = bounds[t], bounds[t + 1]
        sa, da, ca = src_c[lo:hi], dst_c[lo:hi], cost[lo:hi]
        through = alphas[t][0][sa] + ca + betas_next[da]
        arc_post[lo:hi] = np.exp(-(through - tot))
        # beta at t
        new = np.full(k, inf)
        cand = ca + betas_next[da]
        np.minimum.at(new, sa, cand)
        m = new[sa]
        acc = np.zeros(k)
        # dead arcs (cand = inf, so m = inf too) would make inf - inf = nan
        # inside exp and spray RuntimeWarnings; they contribute 0 regardless
        live = np.isfinite(cand)
        np.add.at(acc, sa[live], np.exp(-(cand[live] - m[live])))
        betas_next = np.where(np.isfinite(new),
                              new - np.log(np.maximum(acc, 1e-300)), inf)

    per_frame = []
    for t in range(lat.nf):
        lo, hi = bounds[t], bounds[t + 1]
        posts = arc_post[lo:hi]
        tids = lat.arc_tid[lo:hi]
        pdfs = lat.arc_pdf[lo:hi]
        keep = posts > min_post
        p = posts[keep]
        z = p.sum()
        if z > 0:
            p = p / z
        per_frame.append(list(zip(tids[keep].tolist(), pdfs[keep].tolist(),
                                  p.tolist())))
    return arc_post, per_frame


def _pairwise_rows(a: np.ndarray) -> np.ndarray:
    """The sum of each row of ``a [G, n]`` (float64) by numpy's pairwise
    summation (8 accumulators up to 128 values, halves past that), every
    row at once."""
    n = a.shape[1]
    if n < 8:
        res = np.zeros(len(a))
        for i in range(n):
            res = res + a[:, i]
        return res
    if n <= 128:
        m = n - n % 8
        r = a[:, :8].copy()
        for i in range(8, m, 8):
            r = r + a[:, i:i + 8]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + ((r[:, 4] + r[:, 5])
                                                             + (r[:, 6] + r[:, 7]))
        for i in range(m, n):
            res = res + a[:, i]
        return res
    h = n // 2
    h -= h % 8
    return _pairwise_rows(a[:, :h]) + _pairwise_rows(a[:, h:])


_ROW_SUMS: list = []


def _row_sums(a: np.ndarray) -> np.ndarray:
    """``[r.sum() for r in a]``: ``_pairwise_rows`` where it gives numpy's
    own bits (checked once on drawn rows), else row by row."""
    if not _ROW_SUMS:
        probe = np.random.default_rng(0).random((4, 300)) * 1e3
        same = all((_pairwise_rows(probe[:, :n]) == probe[:, :n].sum(axis=1)).all()
                   and (_pairwise_rows(probe[:, :n]) == [r[:n].sum() for r in probe]).all()
                   for n in range(1, 300))
        _ROW_SUMS.append(_pairwise_rows if same
                         else (lambda v: np.asarray([r.sum() for r in v], np.float64)))
    return _ROW_SUMS[0](a)


def _segment_sums(x: np.ndarray, starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """``x[s:s + n].sum()`` of every (start, length), to the last bit,
    segments of one length at a time."""
    out = np.zeros(len(starts))
    for n in np.unique(lens):
        rows = np.flatnonzero(lens == n)
        if n:
            out[rows] = _row_sums(x[starts[rows, None] + np.arange(n)[None, :]])
    return out


def lattice_posts_batch(lats: list, acoustic_scale: float = 1.0, lm_scale: float = 1.0,
                        min_post: float = 1e-4) -> tuple:
    """``lattice_to_post``'s per-frame entries of many lattices at once, to
    the last bit: one log-semiring forward and backward over every
    lattice's arcs, frame by frame across the batch.

    A lattice's (frame boundary, graph state) pairs are the sweeps' nodes;
    each keeps its own forward and backward score, so no ``[T, states]``
    table is built.  Returns (lattice index, frame, tid, pdf, posterior
    float64) of every entry above ``min_post``, normalized per frame, in
    ``lattice_to_post``'s order: lattices in order, then frames, then arcs.
    Lattices without arcs give no entry."""
    live = [i for i, lat in enumerate(lats) if lat.num_arcs]
    empty = (np.zeros(0, np.int64),) * 4 + (np.zeros(0),)
    if not live:
        return empty
    inf = np.inf
    sizes = np.asarray([lats[i].num_arcs for i in live], np.int64)
    utt = np.repeat(np.arange(len(live), dtype=np.int64), sizes)
    t = np.concatenate([lats[i].arc_t for i in live]).astype(np.int64)
    src = np.concatenate([lats[i].arc_src for i in live]).astype(np.int64)
    dst = np.concatenate([lats[i].arc_dst for i in live]).astype(np.int64)
    cost = np.concatenate([lats[i].arc_total_cost(lm_scale, acoustic_scale)
                           .astype(np.float64) for i in live])
    nf = np.asarray([lats[i].nf for i in live], np.int64)
    span = int(max(int(nf.max()) + 1, 1))
    width = int(max(src.max(), dst.max())) + 1
    # nodes: (lattice, frame boundary, state), numbered in that order
    key_src = (utt * span + t) * width + src
    key_dst = (utt * span + t + 1) * width + dst
    keys, inv = np.unique(np.concatenate([key_src, key_dst]), return_inverse=True)
    n_arcs = len(t)
    src_n, dst_n = inv[:n_arcs], inv[n_arcs:]
    node_state = keys % width
    alpha = np.full(len(keys), inf)
    lms = np.float64(lm_scale)
    for j, i in enumerate(live):
        s0, c0, _o = lats[i].start_entries()
        at = np.searchsorted(keys, (j * span) * width + s0.astype(np.int64))
        alpha[at] = lms * c0
    # the arcs frame-major (lattices and arcs in order within a frame), so
    # that a frame's arcs are one slice
    order = np.argsort(t, kind="stable")
    bounds = np.searchsorted(t[order], np.arange(span + 1))
    frames = [slice(bounds[f], bounds[f + 1]) for f in range(span - 1)]
    src_o, dst_o, cost_o, utt_o = src_n[order], dst_n[order], cost[order], utt[order]
    dst_sets, src_sets = (_frame_sets(t[order], n, len(keys), span - 1)
                          for n in (dst_o, src_o))
    with np.errstate(invalid="ignore"):  # inf - inf where no path reaches an arc
        alpha_src = np.empty(n_arcs)
        acc = np.zeros(len(keys))
        for a, ud in zip(frames, dst_sets):
            if a.start == a.stop:
                continue
            alpha_src[a] = alpha[src_o[a]]
            cand = alpha_src[a] + cost_o[a]
            d = dst_o[a]
            np.minimum.at(alpha, d, cand)
            m = alpha[d]
            np.add.at(acc, d, np.exp(-(cand - m)))
            alpha[ud] = _log_normalized(alpha[ud], acc[ud])
        # backward from each lattice's last boundary; totals per lattice
        beta = np.full(len(keys), inf)
        tot = np.empty(len(live))
        for j, i in enumerate(live):
            lat = lats[i]
            lo, hi = np.searchsorted(keys, [(j * span + lat.nf) * width,
                                            (j * span + lat.nf + 1) * width])
            if lat.use_final:
                fs = lat.graph.final_score[node_state[lo:hi]]
                beta[lo:hi] = np.where(fs > NEG_INF / 2, -fs.astype(np.float64) * lm_scale, inf)
            else:
                beta[lo:hi] = 0.0
            tot[j] = _log_add_vec(alpha[lo:hi] + beta[lo:hi])
        post_o = np.empty(n_arcs)
        acc = np.zeros(len(keys))
        for a, us in zip(reversed(frames), reversed(src_sets)):
            if a.start == a.stop:
                continue
            s, d, ca = src_o[a], dst_o[a], cost_o[a]
            through = alpha_src[a] + ca + beta[d]
            post_o[a] = np.exp(-(through - tot[utt_o[a]]))
            cand = ca + beta[d]
            np.minimum.at(beta, s, cand)
            m = beta[s]
            ok = np.isfinite(cand)
            np.add.at(acc, s[ok], np.exp(-(cand[ok] - m[ok])))
            beta[us] = _log_normalized(beta[us], acc[us])
    arc_post = np.empty(n_arcs)
    arc_post[order] = post_o
    # entries above min_post, normalized per (lattice, frame)
    keep = np.flatnonzero(arc_post > min_post)  # lattice, then frame, then arc order
    post = arc_post[keep]
    group = utt[keep] * span + t[keep]
    cut = np.flatnonzero(np.diff(group)) + 1
    starts = np.concatenate([[0], cut]).astype(np.int64)
    lens = np.diff(np.concatenate([starts, [len(keep)]]))
    post = post / np.repeat(_segment_sums(post, starts, lens), lens)
    tid = np.concatenate([lats[i].arc_tid for i in live]).astype(np.int64)[keep]
    pdf = np.concatenate([lats[i].arc_pdf for i in live]).astype(np.int64)[keep]
    return np.asarray(live, np.int64)[utt[keep]], t[keep], tid, pdf, post


def _frame_sets(t: np.ndarray, node: np.ndarray, num_nodes: int, num_frames: int) -> list:
    """The distinct nodes (sorted) of each frame's arcs, arcs given by
    frame ``t`` and node, found in one sort."""
    keys = np.unique(t * num_nodes + node)
    cuts = np.searchsorted(keys, np.arange(num_frames + 1) * num_nodes)
    return [keys[cuts[f]:cuts[f + 1]] - f * num_nodes for f in range(num_frames)]


def _log_normalized(best: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """-log-sum-exp of costs from their minimum ``best`` and the sum
    ``acc`` of exp(-(cost - best)); inf stays inf."""
    return np.where(np.isfinite(best), best - np.log(np.maximum(acc, 1e-300)), np.inf)


def _log_add_vec(costs: np.ndarray) -> float:
    finite = costs[np.isfinite(costs)]
    if len(finite) == 0:
        return np.inf
    m = finite.min()
    return float(m - np.log(np.exp(-(finite - m)).sum()))


def lattice_depth_per_frame(lat: Lattice) -> np.ndarray:
    """Arcs crossing each frame (``lattice-depth-per-frame`` role)."""
    depth = np.zeros(lat.nf, np.int64)
    np.add.at(depth, lat.arc_t, 1)
    return depth


def lattice_nbest(lat: Lattice, n: int, lm_scale: float = 1.0,
                  acoustic_scale: float = 1.0, word_penalty: float = 0.0,
                  beam: float = np.inf) -> list[dict]:
    """Word-sequence-unique N-best from the lattice — the role of
    ``lattice-determinize-pruned`` + ``lattice-nbest``: per (frame, state) we
    keep the best-scoring partial path per distinct word sequence, up to the
    top ``n`` of them, pruned to ``beam``.  Exact when the per-state list
    doesn't overflow ``n`` distinct sequences.

    Returns list of {"words", "score", "tids"} sorted best-first.
    """
    g = lat.graph
    cost = lat.arc_total_cost(lm_scale, acoustic_scale, word_penalty)
    bounds = lat._frame_slices()
    # per state: dict wordseq(tuple) -> (cost, arcs tuple)
    cur: dict[int, dict] = {}
    for s0, c0, o0 in zip(*lat.start_entries()):
        cur.setdefault(int(s0), {})[tuple(g.oseqs[o0])] = (float(c0) * lm_scale, ())
    for t in range(lat.nf):
        lo, hi = bounds[t], bounds[t + 1]
        nxt: dict[int, dict] = {}
        for m in range(lo, hi):
            sa = int(lat.arc_src[m])
            if sa not in cur:
                continue
            da = int(lat.arc_dst[m])
            w = lat.arc_words(m)
            ca = float(cost[m])
            d = nxt.setdefault(da, {})
            for ws, (c, arcs) in cur[sa].items():
                nws = ws + w
                nc = c + ca
                old = d.get(nws)
                if old is None or nc < old[0]:
                    d[nws] = (nc, arcs + (m,))
        # cap per-state lists at n (by cost)
        for da, d in nxt.items():
            if len(d) > n:
                best = sorted(d.items(), key=lambda kv: kv[1][0])[:n]
                nxt[da] = dict(best)
        cur = nxt
    # finals
    finals: dict[tuple, tuple] = {}
    for s, d in cur.items():
        fc = lat.final_cost(s) * (lm_scale if lat.use_final else 1.0)
        if not np.isfinite(fc):
            continue
        fw = tuple(g.oseqs[g.final_oseq[s]]) if lat.use_final else ()
        for ws, (c, arcs) in d.items():
            nws = ws + fw
            nc = c + fc
            old = finals.get(nws)
            if old is None or nc < old[0]:
                finals[nws] = (nc, arcs)
    ranked = sorted(finals.items(), key=lambda kv: kv[1][0])
    if ranked and np.isfinite(beam):
        best = ranked[0][1][0]
        ranked = [r for r in ranked if r[1][0] <= best + beam]
    out = []
    for ws, (c, arcs) in ranked[:n]:
        out.append({"words": list(ws), "score": -c,
                    "tids": [int(x) for x in lat.arc_tid[list(arcs)]]})
    return out


def lattice_mbr(lat: Lattice, n: int = 20, lm_scale: float = 1.0,
                acoustic_scale: float = 1.0,
                word_penalty: float = 0.0) -> tuple[list, list]:
    """Minimum-Bayes-risk word sequence via confusion network over the
    TRUE-determinized lattice's N best word sequences (``lattice-mbr-decode``
    / sausages role; ``lat/sausages.h:76`` — the reference also determinizes
    before MBR, ``lattice-mbr-decode.cc``).  Returns (words, confidences)."""
    from ..steps.mbr import mbr_decode
    from .determinize import determinize_lattice_pruned_safe

    clat = determinize_lattice_pruned_safe(
        lat, beam=10.0, lm_scale=lm_scale, acoustic_scale=acoustic_scale)
    hyps = clat.nbest(n, lm_scale, acoustic_scale, word_penalty)
    if not hyps:  # degenerate lattice: fall back to the state-level DP
        hyps = lattice_nbest(lat, n, lm_scale, acoustic_scale, word_penalty)
    return mbr_decode([(h["words"], h["score"]) for h in hyps])


def rescore_lattice_acoustics(lat: Lattice, ll: np.ndarray) -> Lattice:
    """Replace acoustic costs with a new model's loglikes
    (``gmm-rescore-lattice`` role).  ll: [T, P] for this utterance."""
    ac = -ll[lat.arc_t, lat.arc_pdf].astype(np.float32)
    return Lattice(graph=lat.graph, nf=lat.nf, arc_t=lat.arc_t,
                   arc_id=lat.arc_id, acoustic_cost=ac,
                   use_final=lat.use_final)
