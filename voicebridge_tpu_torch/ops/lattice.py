"""Lattice generation on the device: the row-based windowed Viterbi
forward-backward.

Port of ``voicebridge_tpu/ops/lattice.py`` (``build_lattice_plans``,
``lattice_forward_backward_rows`` with ``_fb_win_forward`` and
``_fb_win_backward``).  An arc instance (frame t, graph arc a) survives into
the lattice iff the best complete path through it scores within
``lattice_beam`` of the utterance's best path (the lattice-beam invariant
of Kaldi's ``LatticeFasterDecoder``):

    gamma[t, a] = alpha[t][src] + w(a) + acwt * ll[t, pdf(a)] + beta[t+1][dst]

The host half, ``build_lattice_plans``, is the JAX package's numpy code: the
forward plan (the decoder's own), the plan of the transposed graph, and
``row_dst``, each forward row's destination in backward-plan space.  The two
plans number states independently, so alpha and alpha_at_end live in
forward-plan space and beta and the backward pass's final scores in
backward-plan space.

The device half walks windows of frames, one kernel launch per window and
pass.  Phase 1 runs the forward (K3, ``decode_core.viterbi_scan``, over the
forward plan) and keeps one alpha snapshot per window.  Phase 2 walks the
windows from last to first: K3 over the backward plan (``bwd_window``) relaxes
beta, run on ``beta_eff`` (beta above the frame, with the final scores where
the utterance ends), which it stores per frame in a slab; then K5
(``fb_frames``, ``csrc/lattice_fb.cu``) recomputes alpha from the snapshot and
writes one survivor byte per (row, lane), bit k for slot k.  The survivors
are compacted with torch ops on the device, and only they reach the host.
The forward is exact: no beam or max-active pruning.

The lane-major FB of the JAX package's first round
(``lattice_forward_backward``, at the end of this module; hand kernels in
``csrc/lattice_lane.cu``, one cooperative launch per window and pass) keeps
scores lanes minor ``[S, B]``, relaxes arcs through CSRs by destination and
by source, prunes the forward with the decoder's beam and ``max_active``, and
writes survivors packed ``[T, B, ceil(A/8)]`` on the device.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..device import free_bytes, resolve_device, stream_handle
from ..lat.lattice import Lattice
from ..utils import profiling
from . import decode_core
from .decode_core import (EmitPlan, EmitPlanDev, build_emit_plan, launch_k3, plan_to_device,
                          reduce_rows, require, viterbi_scan, viterbi_step_plain)
from .graph import NEG_INF, DenseGraph

__all__ = ["Survivors", "build_lattice_plans", "bwd_window", "bwd_window_plain", "fb_frame",
           "fb_frame_plain", "fb_frames", "fb_frames_plain", "fb_window",
           "lattice_forward_backward_rows", "lattice_window", "survivor_lattices",
           "LaneCsr", "LanePlanDev", "build_dst_plan", "build_src_plan", "lane_plan_to_device",
           "lane_forward", "lane_forward_plain", "lane_backward", "lane_backward_plain",
           "apply_cut", "lane_bits", "lane_pieces", "packbits_plain",
           "lattice_forward_backward_packed", "lattice_forward_backward"]

WORD_SLOTS = 8  # row slots one survivor byte holds


def build_lattice_plans(graph: DenseGraph, d: Optional[int] = None,
                        fwd_plan: Optional[EmitPlan] = None, *, device):
    """(fwd_plan, fwd_dev, bwd_plan, bwd_dev, row_dst [R]) for the row-based
    FB.  Pass an existing forward ``EmitPlan`` (the decoder's) to reuse it.
    ``row_dst[r]`` is the BWD-PLAN state id of forward row r's destination
    (the pad row maps to the pad state)."""
    if fwd_plan is None:
        fwd_plan = build_emit_plan(graph, d=d)
    bwd_plan = build_emit_plan(graph._replace(arc_src=graph.arc_dst, arc_dst=graph.arc_src),
                               d=d)
    s_pad = graph.num_states + 1
    # forward row -> graph dst -> bwd-plan state
    dst_plan = np.repeat(np.arange(s_pad, dtype=np.int64), np.diff(fwd_plan.row_start))
    dst_graph = fwd_plan.sperm[dst_plan]
    bwd_iperm = np.empty(s_pad, np.int64)
    bwd_iperm[bwd_plan.sperm] = np.arange(s_pad)
    row_dst = bwd_iperm[dst_graph].astype(np.int32)
    return (fwd_plan, plan_to_device(fwd_plan, device), bwd_plan,
            plan_to_device(bwd_plan, device), row_dst)


def fb_frame_plain(alpha, ll_t, dev: EmitPlanDev, row_dst, beta_next, num_frames, t: int,
                   acwt: float, thresh, rspec: tuple):
    """Plain version of K5 (JAX ``fwd_frame``).  alpha [S+1, B] forward-plan
    space; beta_next [S+1, B] backward-plan space; thresh [B].  Returns
    (alpha after frame t, survivor bytes [R, B] uint8, bit k = slot k)."""
    r, d = dev.row_w.shape
    b = alpha.shape[1]
    am = ll_t.index_select(0, dev.row_pdf) * acwt  # [R, B]
    g = alpha.index_select(0, dev.row_src).view(r, d, b) + dev.row_w[:, :, None]
    active = (t < num_frames)[None, :]
    na = torch.where(active, reduce_rows(g.amax(dim=1) + am, rspec, b), alpha)
    tail = am + beta_next.index_select(0, row_dst)  # [R, B]
    keep = (g + tail[:, None, :] >= thresh[None, None, :]) & active[None]
    shift = torch.arange(d, device=alpha.device, dtype=torch.int32)[None, :, None]
    return na, (keep.to(torch.int32) << shift).sum(dim=1).to(torch.uint8)


def fb_frames_plain(alpha, ll_win, dev: EmitPlanDev, row_dst, beta_slab, num_frames, t0: int,
                    acwt: float, thresh, rspec: tuple, words):
    """Plain version of ``fb_frames``: ``fb_frame_plain`` frame by frame."""
    for i in range(ll_win.shape[0]):
        alpha, words_i = fb_frame_plain(alpha, ll_win[i], dev, row_dst, beta_slab[i],
                                        num_frames, t0 + i, acwt, thresh, rspec)
        words[i].copy_(words_i)
    return alpha


def fb_frames(alpha: torch.Tensor, ll_win: torch.Tensor, dev: EmitPlanDev,
              row_dst: torch.Tensor, beta_slab: torch.Tensor, num_frames: torch.Tensor,
              t0: int, acwt: float, thresh: torch.Tensor, rspec: tuple,
              words: torch.Tensor) -> torch.Tensor:
    """The recompute-and-test step (K5) over frames t0 .. t0+W-1 in ONE
    launch: ll_win [W, P, B], beta_slab [W, S+1, B] (beta above each frame,
    backward-plan space).  Fills ``words`` [W, R, B] uint8 with the survivor
    bytes and returns alpha after the window."""
    if alpha.device.type == "cpu":
        return fb_frames_plain(alpha, ll_win, dev, row_dst, beta_slab, num_frames, t0, acwt,
                               thresh, rspec, words)
    if alpha.device.type != "cuda":
        raise ValueError(f"unsupported device {alpha.device}")
    s1, b = alpha.shape
    w = ll_win.shape[0]
    r, d = dev.row_w.shape
    if d > WORD_SLOTS:
        raise ValueError(f"row width {d} exceeds the {WORD_SLOTS} slots of a survivor byte")
    f32, i32 = torch.float32, torch.int32
    require(alpha.device, ("alpha", alpha, f32), ("ll_win", ll_win, f32),
            ("beta_slab", beta_slab, f32), ("thresh", thresh, f32), ("row_w", dev.row_w, f32),
            ("row_src", dev.row_src, i32), ("row_pdf", dev.row_pdf, i32),
            ("row_start", dev.row_start, i32), ("row_real", dev.row_real, torch.uint8),
            ("row_dst", row_dst, i32), ("num_frames", num_frames, i32),
            ("words", words, torch.uint8))
    if (beta_slab.shape != (w, s1, b) or ll_win.dim() != 3 or ll_win.shape[2] != b
            or thresh.shape != (b,) or num_frames.shape != (b,)
            or dev.row_start.shape != (s1 + 1,) or dev.row_src.shape != (r * d,)
            or dev.row_pdf.shape != (r,) or dev.row_real.shape != (r,)
            or row_dst.shape != (r,) or words.shape != (w, r, b)):
        raise ValueError("fb_frames: inconsistent shapes")
    if w == 0:
        return alpha
    bufs = [torch.empty_like(alpha) for _ in range(min(w, 2))]
    _build.launch("lattice_fb", alpha.data_ptr(), bufs[0].data_ptr(),
                  bufs[-1].data_ptr() if w > 1 else None, words.data_ptr(), ll_win.data_ptr(),
                  beta_slab.data_ptr(), thresh.data_ptr(), dev.row_start.data_ptr(),
                  dev.row_src.data_ptr(), dev.row_w.data_ptr(), dev.row_pdf.data_ptr(),
                  dev.row_real.data_ptr(), row_dst.data_ptr(), num_frames.data_ptr(), t0, w,
                  acwt, s1, b, ll_win.shape[1], r, d, decode_core._MAX_GRID_BLOCKS,
                  stream_handle(alpha.device))
    return bufs[(w - 1) % 2]  # frame k of the launch writes bufs[k % 2]


def fb_frame(alpha: torch.Tensor, ll_t: torch.Tensor, dev: EmitPlanDev,
             row_dst: torch.Tensor, beta_next: torch.Tensor, num_frames: torch.Tensor,
             t: int, acwt: float, thresh: torch.Tensor, rspec: tuple,
             words_out: torch.Tensor) -> torch.Tensor:
    """One frame of the recompute-and-test step (K5 with W = 1): fills
    ``words_out`` [R, B] uint8 with the survivor bytes and returns alpha after
    frame t."""
    if ll_t.dim() != 2 or beta_next.dim() != 2 or words_out.dim() != 2:
        raise ValueError("fb_frame: inconsistent shapes")
    return fb_frames(alpha, ll_t[None], dev, row_dst, beta_next[None], num_frames, t, acwt,
                     thresh, rspec, words_out[None])


def bwd_window_plain(beta, ll_win, dev: EmitPlanDev, num_frames, t0: int, acwt: float,
                     rspec: tuple, packed: bool, final_eff, slab):
    """Plain version of ``bwd_window`` (JAX ``bwd_frame``): per frame from
    last to first, the ``beta_eff`` select, its store into ``slab``, and the
    relaxation over the backward plan."""
    for i in range(ll_win.shape[0] - 1, -1, -1):
        t = t0 + i
        # beta_eff == beta wherever t >= nf, so K3's t < nf mask applies as is
        eff = torch.where((t + 1 == num_frames)[None, :], final_eff, beta, out=slab[i])
        beta, _ = viterbi_step_plain(eff, eff, ll_win[i], dev, num_frames, t, acwt, rspec,
                                     packed)
    return beta


def bwd_window(beta: torch.Tensor, ll_win: torch.Tensor, dev: EmitPlanDev,
               num_frames: torch.Tensor, t0: int, acwt: float, rspec: tuple, packed: bool,
               final_eff: torch.Tensor, slab: torch.Tensor) -> torch.Tensor:
    """K3 over the backward plan for frames t0+W-1 down to t0 in ONE launch,
    from ``beta`` (beta at t0 + W, backward-plan space), with the select
    ``beta_eff = (t + 1 == nf ? final_eff : beta)`` and its store into
    ``slab`` [W, S+1, B] fused in.  Returns beta at t0."""
    if beta.device.type == "cpu":
        return bwd_window_plain(beta, ll_win, dev, num_frames, t0, acwt, rspec, packed,
                                final_eff, slab)
    if beta.device.type != "cuda":
        raise ValueError(f"unsupported device {beta.device}")
    return launch_k3(beta, ll_win, dev, num_frames, t0, acwt, final_eff=final_eff, slab=slab,
                     count="viterbi_step_backward")


class Survivors(NamedTuple):
    """Surviving arc instances of a batch, on the device, ordered by
    (lane, t, forward-plan position r * D + slot): the arc order of the JAX
    package's lattices."""

    utt: torch.Tensor  # [M] int64 lane
    t: torch.Tensor  # [M] int64 frame
    arc: torch.Tensor  # [M] int64 graph arc id
    counts: np.ndarray  # [B] int64 survivors per lane (host)


def fb_window(plans: tuple, snap: torch.Tensor, beta: torch.Tensor, ll_win: torch.Tensor,
              t0: int, num_frames: torch.Tensor, final_eff: torch.Tensor,
              thresh: torch.Tensor, acwt: float, words: torch.Tensor) -> torch.Tensor:
    """One window of phase 2 (JAX ``_fb_win_backward``), frames t0 .. t0+W-1
    with ll_win [W, P, B], in two launches.  K3 over the backward plan
    (``bwd_window``) relaxes beta from ``beta`` (beta at t0 + W) down to t0,
    storing beta_eff per frame; K5 (``fb_frames``) then recomputes alpha from
    ``snap`` (alpha at t0) and fills words[:W] with the survivor bytes.
    ``plans`` is ``build_lattice_plans``'s tuple with row_dst on the device.
    Returns beta at t0."""
    fwd_plan, fwd_dev, bwd_plan, bwd_dev, row_dst = plans
    w = ll_win.shape[0]
    slab = torch.empty((w,) + tuple(beta.shape), device=beta.device)
    beta = bwd_window(beta, ll_win, bwd_dev, num_frames, t0, acwt, bwd_plan.rspec,
                      bwd_plan.packed, final_eff, slab)
    fb_frames(snap, ll_win, fwd_dev, row_dst, slab, num_frames, t0, acwt, thresh,
              fwd_plan.rspec, words[:w])
    return beta


def _window_survivors(words: torch.Tensor, lo: int, row_arc: torch.Tensor):
    """Survivor bytes [W, R, B] of frames lo.. -> (lane, t, arc) in
    (t, position, lane) order; pad slots (arc -1) are dropped.  A stable
    sort by lane then gives the lattices' (t, position) order per lane
    without transposing the bytes."""
    d = row_arc.shape[1]
    # torch.nonzero and the three masked selects each read a count back
    with profiling.host_wait("compaction", 4 * 8):
        tl, row, lane = torch.nonzero(words).unbind(1)
        shift = torch.arange(d, device=words.device, dtype=torch.int32)
        bits = (words[tl, row, lane].to(torch.int32)[:, None] >> shift) & 1  # [K, D]
        arc = row_arc[row]  # [K, D]
        keep = (bits != 0) & (arc >= 0)
        return (lane[:, None].expand(-1, d)[keep], (tl + lo)[:, None].expand(-1, d)[keep],
                arc[keep].long())


def lattice_window(t: int, s1: int, rows: int, b: int) -> tuple[int, int]:
    """(frames per window, device bytes the FB keeps).  The window's beta
    slab and survivor bytes take (4 * (S+1) + R) * B bytes per frame, the
    snapshots 4 * (S+1) * B per window, so residency is least near
    W = sqrt(T * snapshot / frame)."""
    per_frame = (4 * s1 + rows) * b
    per_window = 4 * s1 * b
    w = max(1, min(max(t, 1), round(math.sqrt(max(t, 1) * per_window / max(per_frame, 1)))))
    return w, w * per_frame + -(-t // w) * per_window


def lattice_forward_backward_rows(graph: DenseGraph, fwd_plan: EmitPlan, fwd_dev: EmitPlanDev,
                                  bwd_plan: EmitPlan, bwd_dev: EmitPlanDev, row_dst,
                                  loglikes: torch.Tensor, num_frames, acoustic_scale: float,
                                  lattice_beam: float, window: Optional[int] = None):
    """Row-based windowed lattice FB over a shared graph.  loglikes [B, T, P]
    on the decode device; num_frames [B].  The window defaults to
    ``lattice_window``'s, which must fit in half the free device memory;
    the result does not depend on it.

    Returns (Survivors, total_best [B], alpha_at_end [S+1, B] forward-plan
    space, use_final [B]), all on the device but the survivor counts."""
    with profiling.span("lattice.forward"):
        device = loglikes.device
        b, t_total, p = loglikes.shape
        if fwd_plan.num_rows and int(fwd_plan.row_pdf.max()) >= p:
            raise ValueError(f"the graph uses pdf {int(fwd_plan.row_pdf.max())}, "
                             f"loglikes have only {p}")
        nf_np = np.asarray(num_frames).astype(np.int32)
        # frames at or past every utterance's end change nothing: not run
        t_run = int(nf_np.max()) if b else 0
        if t_run > t_total:
            raise ValueError(f"num_frames up to {t_run}, loglikes have {t_total} frames")
        profiling.count("lattice.frames", int(nf_np.sum()))
        nf = torch.from_numpy(nf_np).to(device)
        acwt = float(np.float32(acoustic_scale))
        s1 = fwd_plan.num_states + 1
        r, d = fwd_plan.row_w.shape
        if window is None:
            window, need = lattice_window(t_run, s1, r, b)
            if need > free_bytes(device) // 2:
                raise ValueError(f"the lattice FB needs {need} bytes for B = {b}, T = {t_run}: "
                                 "decode fewer utterances at once")
        ll = loglikes.permute(1, 2, 0)[:t_run].contiguous()  # [T, P, B]

        def column(v, plan):
            return torch.from_numpy(np.concatenate([v[plan.sperm[:-1]], [NEG_INF]])
                                    .astype(np.float32)).to(device)

        # phase 1: forward per window, keeping one alpha snapshot per window
        alpha = column(graph.alpha0, fwd_plan)[:, None].expand(s1, b).contiguous()
        at_end = torch.where((nf == 0)[None, :], alpha, torch.full_like(alpha, NEG_INF))
        snaps = []
        for lo in range(0, t_run, window):
            snaps.append(alpha)
            (alpha, at_end), _ = viterbi_scan(fwd_dev, alpha, at_end, ll[lo:lo + window], nf, lo,
                                              acwt, fwd_plan.rspec, fwd_plan.packed, with_bp=False)

        with_final = (at_end + column(graph.final_score, fwd_plan)[:, None]).amax(dim=0)
        use_final = with_final > NEG_INF / 2
        total_best = torch.where(use_final, with_final, at_end.amax(dim=0))
        # partial-path fallback: when no final state is reachable, every state
        # is final with cost 0 (Kaldi's DecodeUtteranceLatticeFaster)
        final_eff = torch.where(use_final[None, :], column(graph.final_score, bwd_plan)[:, None],
                                torch.zeros((s1, b), device=device))
        thresh = (total_best - float(np.float32(lattice_beam))).contiguous()

    # phase 2: windows from last to first, then the survivors in lane order
    with profiling.span("lattice.backward"):
        plans = (fwd_plan, fwd_dev, bwd_plan, bwd_dev,
                 torch.as_tensor(row_dst, dtype=torch.int32, device=device))
        row_arc = torch.from_numpy(fwd_plan.row_arc).to(device)
        beta = torch.full((s1, b), NEG_INF, device=device)
        words = torch.empty((min(window, t_run), r, b), dtype=torch.uint8, device=device)
        parts = []
        for w in range(len(snaps) - 1, -1, -1):
            lo = w * window
            hi = min(lo + window, t_run)
            beta = fb_window(plans, snaps[w], beta, ll[lo:hi], lo, nf, final_eff, thresh, acwt,
                             words)
            snaps[w] = None
            parts.append(_window_survivors(words[:hi - lo], lo, row_arc))
        profiling.count("lattice.windows", len(parts))
    with profiling.span("lattice.order"):
        if parts:
            lane, tt, arc = (torch.cat(x[::-1]) for x in zip(*parts))
            order = torch.sort(lane, stable=True).indices
            lane, tt, arc = lane[order], tt[order], arc[order]
        else:
            lane = tt = arc = torch.zeros(0, dtype=torch.int64, device=device)
        # bincount on the card reads its input's largest value back first
        with profiling.host_wait("survivor_counts", 8 * b):
            counts = torch.bincount(lane, minlength=b).cpu().numpy()
        profiling.count("lattice.survivor_arcs", int(counts.sum()))
    return Survivors(lane, tt, arc, counts), total_best, at_end, use_final


def survivor_lattices(graph: DenseGraph, surv: Survivors, num_frames, use_final,
                      loglikes: Optional[torch.Tensor] = None) -> list[Lattice]:
    """One ``Lattice`` per lane from the device survivors.  Acoustic costs
    come from ONE device gather of exactly the surviving (lane, t, pdf)
    entries of loglikes [B, T, P]; without loglikes they are zeros."""
    nf_np = np.asarray(num_frames)
    uf = np.asarray(profiling.to_host(torch.as_tensor(use_final), "use_final"))
    if loglikes is not None and len(surv.arc):
        _b, t_total, p = loglikes.shape
        pdf = torch.from_numpy(graph.arc_pdf).to(loglikes.device)[surv.arc]
        ac = profiling.to_host(-loglikes.reshape(-1)[(surv.utt * t_total + surv.t) * p + pdf],
                               "costs").numpy()
    else:
        ac = np.zeros(len(surv.arc), np.float32)
    ts = profiling.to_host(surv.t.to(torch.int32), "frames").numpy()
    arcs = profiling.to_host(surv.arc.to(torch.int32), "arcs").numpy()
    bounds = np.concatenate([[0], np.cumsum(surv.counts)])
    return [Lattice(graph=graph, nf=int(nf_np[i]), arc_t=ts[lo:hi], arc_id=arcs[lo:hi],
                    acoustic_cost=ac[lo:hi], use_final=bool(uf[i]))
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]


# ---------------------------------------------------------------------------
# Lane-major windowed forward-backward (``lattice_lane.cu``)
# ---------------------------------------------------------------------------
# The JAX package's first lattice FB (``lattice_forward_backward`` with
# ``_window_fb``): arc-parallel max-plus over the arcs of a shared graph, with
# the decoder's beam and max-active prune in the forward pass.  It is on no
# decode path of either package; it is the reference its tests hold lattices
# to.  The JAX package keeps scores [B, S] and reduces arcs through reduction
# trees (``levels``, ``rev_levels``); here scores are lanes minor, [S, B],
# log-likelihoods [T, P, B], and the arcs are grouped into CSRs by
# destination and by source, built once per graph.


class LaneCsr(NamedTuple):
    """Arcs of a graph grouped by one of their end states."""

    start: np.ndarray  # [S+1] int32 row starts
    arc: np.ndarray  # [A] int32 arc ids, a state's arcs in arc order


def _lane_csr(key: np.ndarray, num_states: int) -> LaneCsr:
    start = np.zeros(num_states + 1, np.int32)
    start[1:] = np.cumsum(np.bincount(key, minlength=num_states))
    return LaneCsr(start, np.argsort(key, kind="stable").astype(np.int32))


def build_dst_plan(graph: DenseGraph) -> LaneCsr:
    """The CSR by destination the forward pass reads (in place of the JAX
    package's reduction ``levels``)."""
    return _lane_csr(graph.arc_dst, graph.num_states)


def build_src_plan(graph: DenseGraph) -> LaneCsr:
    """The CSR by source the backward pass reads (the JAX package's
    ``build_src_plan`` returns reduction-tree levels grouping arcs by
    source)."""
    return _lane_csr(graph.arc_src, graph.num_states)


PIECE_ARCS = 64  # a state of more arcs than this is a hub, walked in pieces


class LanePlanDev(NamedTuple):
    """A graph and its two CSRs on a device, int32 and f32.  Within a state's
    row of the CSR by destination the arcs are ordered by pdf (then arc id),
    so that the forward gathers a log-likelihood row once per run of equal
    pdfs (a max does not depend on the order); the CSR by source keeps arc
    order, so that the backward sets a survivor byte's bits together.  Each
    CSR is walked in pieces (state, lo, hi, hub slot): a state's whole row,
    or for a hub (more than ``PIECE_ARCS`` arcs) runs of ``PIECE_ARCS``, with
    the hub's slot in ``in_hub`` / ``out_hub``."""

    arc_src: torch.Tensor  # [A], arc order
    arc_dst: torch.Tensor
    arc_pdf: torch.Tensor
    arc_score: torch.Tensor
    in_piece: torch.Tensor  # [pieces, 4] over the CSR by destination
    in_hub: torch.Tensor  # [hubs] the hubs' states
    in_src: torch.Tensor  # [A]
    in_score: torch.Tensor
    in_pdf: torch.Tensor
    out_piece: torch.Tensor  # [pieces, 4] over the CSR by source
    out_hub: torch.Tensor
    out_dst: torch.Tensor  # [A]
    out_score: torch.Tensor
    out_pdf: torch.Tensor
    out_arc: torch.Tensor  # [A] each entry's arc id (its survivor bit)
    alpha0: torch.Tensor  # [S]
    final: torch.Tensor  # [S]
    num_pdfs_used: int  # 1 + the largest pdf of an arc (0 without arcs)

    @property
    def num_states(self) -> int:
        return self.alpha0.shape[0]

    @property
    def num_arcs(self) -> int:
        return self.arc_src.shape[0]


def _by_pdf(plan: LaneCsr, key: np.ndarray, pdf: np.ndarray) -> np.ndarray:
    """``plan.arc`` with each state's arcs ordered by pdf, then arc id."""
    arc = plan.arc.astype(np.int64)
    return arc[np.lexsort((arc, pdf[arc], key[arc]))].astype(np.int32)


def lane_pieces(start: np.ndarray, size: int = PIECE_ARCS):
    """The pieces of a CSR with row starts ``start`` [S+1]: ``[pieces, 4]``
    int32 rows (state, lo, hi, hub slot or -1), a state's pieces in order,
    every state at least one (a state of no arcs: an empty one), and the
    hubs' states ``[hubs]`` int32 (the states of more than ``size`` arcs)."""
    start = np.asarray(start, np.int64)
    n = np.maximum(1, -(-np.diff(start) // size))
    state = np.repeat(np.arange(len(n)), n)
    lo = start[state] + size * (np.arange(len(state)) - np.repeat(np.cumsum(n) - n, n))
    hubs = np.flatnonzero(n > 1)
    slot = np.full(len(n), -1, np.int64)
    slot[hubs] = np.arange(len(hubs))
    piece = np.stack([state, lo, np.minimum(lo + size, start[state + 1]), slot[state]], axis=1)
    return piece.astype(np.int32), hubs.astype(np.int32)


def lane_plan_to_device(graph: DenseGraph, dst_plan: LaneCsr, src_plan: LaneCsr,
                        device) -> LanePlanDev:
    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    i = _by_pdf(dst_plan, graph.arc_dst, graph.arc_pdf)
    o = src_plan.arc
    in_piece, in_hub = lane_pieces(dst_plan.start)
    out_piece, out_hub = lane_pieces(src_plan.start)
    return LanePlanDev(
        arc_src=dev(graph.arc_src, np.int32), arc_dst=dev(graph.arc_dst, np.int32),
        arc_pdf=dev(graph.arc_pdf, np.int32), arc_score=dev(graph.arc_score, np.float32),
        in_piece=dev(in_piece, np.int32), in_hub=dev(in_hub, np.int32),
        in_src=dev(graph.arc_src[i], np.int32), in_score=dev(graph.arc_score[i], np.float32),
        in_pdf=dev(graph.arc_pdf[i], np.int32),
        out_piece=dev(out_piece, np.int32), out_hub=dev(out_hub, np.int32),
        out_dst=dev(graph.arc_dst[o], np.int32), out_score=dev(graph.arc_score[o], np.float32),
        out_pdf=dev(graph.arc_pdf[o], np.int32), out_arc=dev(o, np.int32),
        alpha0=dev(graph.alpha0, np.float32), final=dev(graph.final_score, np.float32),
        num_pdfs_used=int(graph.arc_pdf.max()) + 1 if graph.num_arcs else 0)


def packbits_plain(keep: torch.Tensor) -> torch.Tensor:
    """``[..., A]`` bool -> ``[..., ceil(A/8)]`` uint8 in ``np.packbits``
    order (arc 8j + k is bit 7 - k of byte j)."""
    a = keep.shape[-1]
    pad = -a % 8
    if pad:
        keep = torch.nn.functional.pad(keep, (0, pad))
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                           device=keep.device)
    groups = keep.reshape(*keep.shape[:-1], -1, 8).to(torch.int32)
    return (groups * weights).sum(dim=-1).to(torch.uint8)


def apply_cut(seq: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """Alpha from a stored frame: ``seq`` [S, B] where it reaches the lane's
    ``cut`` [B], else NEG_INF (the forward's prune, applied on read)."""
    return torch.where(seq >= cut[None, :], seq, NEG_INF)


def lane_forward_plain(plan: LanePlanDev, seq: torch.Tensor, cut: torch.Tensor,
                       at_end: Optional[torch.Tensor], ll: torch.Tensor,
                       num_frames: torch.Tensor, t0: int, w: int, acwt: float, beam: float,
                       max_active: int) -> None:
    """Plain version of ``lane_forward``: per frame a gather of the arcs'
    scores, a scatter-max by destination, ``decode_core.prune``.  It stores
    the pruned alphas, so every cut is -inf."""
    s, b = seq.shape[1:]
    src, pdf = plan.arc_src.long(), plan.arc_pdf.long()
    dst = plan.arc_dst.long()[:, None].expand(-1, b)
    alpha = seq[0]
    for i in range(w):
        t = t0 + i
        am = ll[t].index_select(0, pdf) * acwt
        score = (alpha.index_select(0, src) + plan.arc_score[:, None]) + am
        na = torch.full_like(alpha, NEG_INF).scatter_reduce_(0, dst, score, reduce="amax",
                                                             include_self=True)
        na = decode_core.prune(na, beam, max_active, dim=0)
        alpha = torch.where((t < num_frames)[None, :], na, alpha)
        seq[i + 1] = alpha
        if at_end is not None:
            at_end.copy_(torch.where((t + 1 == num_frames)[None, :], alpha, at_end))
    cut[: w + 1] = -math.inf


def lane_backward_plain(plan: LanePlanDev, seq: torch.Tensor, cut: torch.Tensor,
                        beta: torch.Tensor, ll: torch.Tensor, num_frames: torch.Tensor,
                        t0: int, w: int, final_eff: torch.Tensor, thresh: torch.Tensor,
                        acwt: float, bits: torch.Tensor, beta_tmp=None) -> None:
    """Plain version of ``lane_backward`` (``beta_tmp``, the kernel's
    scratch, is not used): per frame, last first, the arcs' tails and
    survivor test, ``packbits_plain``, a scatter-max by source."""
    s, b = beta.shape
    src, dst = plan.arc_src.long(), plan.arc_dst.long()
    pdf = plan.arc_pdf.long()
    for i in range(w - 1, -1, -1):
        t = t0 + i
        active = (t < num_frames)[None, :]
        beta_eff = torch.where((t + 1 == num_frames)[None, :], final_eff, beta)
        am = ll[t].index_select(0, pdf) * acwt
        tail = (am + plan.arc_score[:, None]) + beta_eff.index_select(0, dst)  # [A, B]
        gamma = apply_cut(seq[i], cut[i]).index_select(0, src) + tail
        bits[i] = packbits_plain(((gamma >= thresh[None, :]) & active).t())
        bt = torch.full_like(beta, NEG_INF).scatter_reduce_(0, src[:, None].expand(-1, b), tail,
                                                            reduce="amax", include_self=True)
        beta.copy_(torch.where(active, bt, beta))


def _lane_check(plan: LanePlanDev, ll: torch.Tensor, num_frames: torch.Tensor, *tensors):
    dev = ll.device
    f32, i32 = torch.float32, torch.int32
    require(dev, ("ll", ll, f32), ("num_frames", num_frames, i32),
            *((name, getattr(plan, name), f32 if "score" in name else i32)
              for name in ("in_piece", "in_hub", "in_src", "in_score", "in_pdf", "out_piece",
                           "out_hub", "out_dst", "out_score", "out_pdf", "out_arc")), *tensors)
    if plan.num_pdfs_used > ll.shape[1]:
        raise ValueError(f"the graph uses pdfs up to {plan.num_pdfs_used - 1}, "
                         f"loglikes have only {ll.shape[1]}")


def lane_forward(plan: LanePlanDev, seq: torch.Tensor, cut: torch.Tensor,
                 at_end: Optional[torch.Tensor], ll: torch.Tensor, num_frames: torch.Tensor,
                 t0: int, w: int, acwt: float, beam: float, max_active: int) -> None:
    """Frames t0 .. t0+w-1 of the forward pass.  ``seq`` [w+1, S, B] holds
    alpha before frame t0 in ``seq[0]`` (pruned) and receives the frames
    after it; the alpha before frame t0 + i is ``apply_cut(seq[i],
    cut[i])``, ``cut`` [w+1, B] (``seq[w]`` is stored pruned, cut -inf).
    ``at_end`` [S, B] (or None) receives alpha after frame nf - 1 of the
    lanes that end in the window.  ``ll`` [T, P, B], num_frames [B] int32.
    On CUDA one cooperative launch of ``lattice_lane_forward``; a CPU tensor
    goes to ``lane_forward_plain``."""
    if ll.device.type == "cpu":
        return lane_forward_plain(plan, seq, cut, at_end, ll, num_frames, t0, w, acwt, beam,
                                  max_active)
    if ll.device.type != "cuda":
        raise ValueError(f"unsupported device {ll.device}")
    t_total, p, b = ll.shape
    s = plan.num_states
    f32 = torch.float32
    ends = () if at_end is None else (("at_end", at_end, f32),)
    _lane_check(plan, ll, num_frames, ("seq", seq, f32), ("cut", cut, f32), *ends)
    if seq.shape[0] < w + 1 or seq.shape[1:] != (s, b) or cut.shape[0] < w + 1 \
            or cut.shape[1:] != (b,) or (at_end is not None and at_end.shape != (s, b)) \
            or num_frames.shape != (b,) or not 0 <= t0 <= t0 + w <= t_total:
        raise ValueError("lane_forward: inconsistent shapes")
    hubs = plan.in_hub.shape[0]
    scratch = torch.empty(b * (2 * w + 260 + hubs), dtype=torch.int32, device=ll.device)
    _build.launch("lattice_lane_forward", seq.data_ptr(), cut.data_ptr(),
                  0 if at_end is None else at_end.data_ptr(), scratch.data_ptr(),
                  ll.data_ptr(), t_total, p, plan.in_piece.data_ptr(), plan.in_piece.shape[0],
                  plan.in_hub.data_ptr(), hubs, plan.in_src.data_ptr(), plan.in_score.data_ptr(),
                  plan.in_pdf.data_ptr(), num_frames.data_ptr(), t0, w,
                  float(np.float32(acwt)), float(np.float32(beam)), int(max_active), b, s,
                  stream_handle(ll.device), count="lattice_lane")


def lane_backward(plan: LanePlanDev, seq: torch.Tensor, cut: torch.Tensor, beta: torch.Tensor,
                  ll: torch.Tensor, num_frames: torch.Tensor, t0: int, w: int,
                  final_eff: torch.Tensor, thresh: torch.Tensor, acwt: float,
                  bits: torch.Tensor, beta_tmp: Optional[torch.Tensor] = None) -> None:
    """Frames t0+w-1 .. t0 of the backward pass: alpha before frame t0 + i is
    ``apply_cut(seq[i], cut[i])``; ``beta`` [S, B] holds beta above the
    window and receives beta at t0; ``final_eff`` [S, B]; ``thresh`` [B] =
    total_best - lattice_beam; ``bits`` [w, B, ceil(A/8)] uint8 receives the
    window's packed survivors.  On CUDA one cooperative launch of
    ``lattice_lane_backward`` (``beta_tmp`` [S, B] is its scratch); its rows
    of ``bits`` must lie a multiple of 4 bytes apart, the frames one row
    count apart (``lane_bits`` allocates them so), since the kernel zeroes
    whole rows and sets bits by 32-bit atomics.  A CPU tensor goes to
    ``lane_backward_plain``."""
    if ll.device.type == "cpu":
        return lane_backward_plain(plan, seq, cut, beta, ll, num_frames, t0, w, final_eff,
                                   thresh, acwt, bits)
    if ll.device.type != "cuda":
        raise ValueError(f"unsupported device {ll.device}")
    t_total, p, b = ll.shape
    s, a = plan.num_states, plan.num_arcs
    beta_tmp = torch.empty_like(beta) if beta_tmp is None else beta_tmp
    f32 = torch.float32
    _lane_check(plan, ll, num_frames, ("seq", seq, f32), ("cut", cut, f32), ("beta", beta, f32),
                ("beta_tmp", beta_tmp, f32), ("final_eff", final_eff, f32),
                ("thresh", thresh, f32))
    if bits.dtype != torch.uint8 or bits.device != ll.device:
        raise ValueError("lane_backward: bits must be uint8 on the loglikes' device")
    row = bits.stride(1)
    if seq.shape[0] < w or seq.shape[1:] != (s, b) or cut.shape[0] < w or cut.shape[1:] != (b,) \
            or beta.shape != (s, b) or beta_tmp.shape != (s, b) or final_eff.shape != (s, b) \
            or thresh.shape != (b,) or num_frames.shape != (b,) \
            or bits.shape != (w, b, (a + 7) // 8) or not 0 <= t0 <= t0 + w <= t_total:
        raise ValueError("lane_backward: inconsistent shapes")
    if bits.stride(2) != 1 or row % 4 or row < (a + 7) // 8 or bits.stride(0) != b * row \
            or bits.data_ptr() % 4:
        raise ValueError("lane_backward: bits rows must be whole 32-bit words apart "
                         "(allocate them with lane_bits)")
    hubs = plan.out_hub.shape[0]
    scratch = torch.empty(b * hubs, dtype=torch.int32, device=ll.device)
    _build.launch("lattice_lane_backward", seq.data_ptr(), cut.data_ptr(), beta.data_ptr(),
                  beta_tmp.data_ptr(), scratch.data_ptr(), ll.data_ptr(), t_total, p,
                  final_eff.data_ptr(), thresh.data_ptr(), plan.out_piece.data_ptr(),
                  plan.out_piece.shape[0], plan.out_hub.data_ptr(), hubs,
                  plan.out_dst.data_ptr(), plan.out_score.data_ptr(), plan.out_pdf.data_ptr(),
                  plan.out_arc.data_ptr(), num_frames.data_ptr(), t0, w,
                  float(np.float32(acwt)), b, s, a, bits.data_ptr(), row,
                  stream_handle(ll.device), count="lattice_lane")


def lane_bits(frames: int, lanes: int, arcs: int, device) -> torch.Tensor:
    """An uninitialized packed survivor mask ``[frames, lanes, ceil(arcs/8)]``
    uint8 whose rows start on 32-bit words (a view into rows padded to a
    multiple of 4 bytes)."""
    nbytes = (arcs + 7) // 8
    row = -(-nbytes // 4) * 4
    return torch.empty((frames, lanes, row), dtype=torch.uint8, device=device)[..., :nbytes]


def lattice_forward_backward_packed(plan: LanePlanDev, loglikes: torch.Tensor, num_frames,
                                    acoustic_scale: float, beam: float, lattice_beam: float,
                                    max_active: int = 0, window: int = 64, steps=None):
    """The lane-major windowed FB on the device of ``loglikes`` [B, T, P].

    The log-likelihoods are laid out once as [T, P, B].  Phase 1 runs the
    forward window by window (``lane_forward``), keeping one alpha snapshot
    per window and ``alpha_at_end``; the best complete score prefers final
    states (``use_final``), else the best partial path with every state
    final at cost 0.  Phase 2 walks the windows from last to first,
    recomputing the window's alphas from its snapshot and running the
    backward pass (``lane_backward``).  Returns (packed survivors [T, B,
    ceil(A/8)] uint8, rows 32-bit aligned, total_best [B], alpha_at_end
    [B, S], use_final [B]), tensors on the device.  ``steps`` replaces the
    (forward, backward) pair ``(lane_forward, lane_backward)``:
    ``(lane_forward_plain, lane_backward_plain)`` runs the plain versions on
    any device, which is how the card's kernels are held to them."""
    fwd_step, bwd_step = steps or (lane_forward, lane_backward)
    device = loglikes.device
    b, t_total, _p = loglikes.shape
    s, a = plan.num_states, plan.num_arcs
    nf = torch.as_tensor(num_frames).to(device=device, dtype=torch.int32)
    if b and int(nf.max()) > t_total:
        raise ValueError(f"num_frames up to {int(nf.max())}, loglikes have {t_total} frames")
    acwt, beam = float(np.float32(acoustic_scale)), float(np.float32(beam))
    nw = max(1, -(-t_total // window))
    t_pad = nw * window
    ll = loglikes.to(torch.float32)
    if t_pad != t_total:
        ll = torch.nn.functional.pad(ll, (0, 0, 0, t_pad - t_total))
    ll = ll.permute(1, 2, 0).contiguous()  # [T, P, B]
    seq = torch.empty((window + 1, s, b), device=device)
    cut = torch.empty((window + 1, b), device=device)
    seq[0] = plan.alpha0[:, None]
    at_end = torch.where((nf == 0)[None, :], seq[0], torch.full((s, b), NEG_INF, device=device))
    snaps = []
    for w in range(nw):  # phase 1
        snaps.append(seq[0].clone())
        fwd_step(plan, seq, cut, at_end, ll, nf, w * window, window, acwt, beam, max_active)
        seq[0] = seq[window]
    with_final = (at_end + plan.final[:, None]).amax(dim=0)
    use_final = with_final > NEG_INF / 2
    total_best = torch.where(use_final, with_final, at_end.amax(dim=0))
    final_eff = torch.where(use_final[None, :], plan.final[:, None],
                            torch.zeros((s, b), device=device)).contiguous()
    thresh = (total_best - float(np.float32(lattice_beam))).contiguous()
    bits = lane_bits(t_pad, b, a, device)
    beta = torch.full((s, b), NEG_INF, device=device)
    beta_tmp = torch.empty_like(beta)
    for w in range(nw - 1, -1, -1):  # phase 2
        lo = w * window
        seq[0] = snaps[w]
        snaps[w] = None
        fwd_step(plan, seq, cut, None, ll, nf, lo, window, acwt, beam, max_active)
        bwd_step(plan, seq, cut, beta, ll, nf, lo, window, final_eff, thresh, acwt,
                 bits[lo:lo + window], beta_tmp)
    return bits[:t_total], total_best, at_end.t().contiguous(), use_final


def lattice_forward_backward(graph: DenseGraph, dst_plan: LaneCsr, src_plan: LaneCsr,
                             loglikes, num_frames, acoustic_scale: float, beam: float,
                             lattice_beam: float, max_active: int = 0, window: int = 64, *,
                             device=None):
    """Full windowed lattice FB over a shared graph, as the JAX package's
    ``lattice_forward_backward`` (which takes reduction ``levels`` and
    ``rev_levels`` where this takes ``build_dst_plan`` and
    ``build_src_plan``).  ``loglikes`` [B, T, P]: a tensor runs on its
    device, an array on ``device`` (``None``: the card).  Returns (survivor
    mask [T, B, A] bool, total_best [B], alpha_at_end [B, S], use_final
    [B]), numpy."""
    if isinstance(loglikes, torch.Tensor):
        dev = loglikes.device
    else:
        dev = resolve_device(device)
        loglikes = torch.as_tensor(np.asarray(loglikes, np.float32)).to(dev)
    plan = lane_plan_to_device(graph, dst_plan, src_plan, dev)
    bits, total_best, at_end, use_final = lattice_forward_backward_packed(
        plan, loglikes, num_frames, acoustic_scale, beam, lattice_beam, max_active, window)
    mask = np.unpackbits(bits.cpu().numpy(), axis=-1, count=graph.num_arcs).astype(bool)
    return (mask, total_best.cpu().numpy(), at_end.cpu().numpy(), use_final.cpu().numpy())
