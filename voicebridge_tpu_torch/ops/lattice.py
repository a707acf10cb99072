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
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..device import free_bytes, stream_handle
from ..lat.lattice import Lattice
from . import decode_core
from .decode_core import (EmitPlan, EmitPlanDev, build_emit_plan, launch_k3, plan_to_device,
                          reduce_rows, require, viterbi_scan, viterbi_step_plain)
from .graph import NEG_INF, DenseGraph

__all__ = ["Survivors", "build_lattice_plans", "bwd_window", "bwd_window_plain", "fb_frame",
           "fb_frame_plain", "fb_frames", "fb_frames_plain", "fb_window",
           "lattice_forward_backward_rows", "lattice_window", "survivor_lattices"]

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

    # phase 2: windows from last to first
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
    if parts:
        lane, tt, arc = (torch.cat(x[::-1]) for x in zip(*parts))
        order = torch.sort(lane, stable=True).indices
        lane, tt, arc = lane[order], tt[order], arc[order]
    else:
        lane = tt = arc = torch.zeros(0, dtype=torch.int64, device=device)
    counts = torch.bincount(lane, minlength=b).cpu().numpy()
    return Survivors(lane, tt, arc, counts), total_best, at_end, use_final


def survivor_lattices(graph: DenseGraph, surv: Survivors, num_frames, use_final,
                      loglikes: Optional[torch.Tensor] = None) -> list[Lattice]:
    """One ``Lattice`` per lane from the device survivors.  Acoustic costs
    come from ONE device gather of exactly the surviving (lane, t, pdf)
    entries of loglikes [B, T, P]; without loglikes they are zeros."""
    nf_np = np.asarray(num_frames)
    uf = np.asarray(torch.as_tensor(use_final).cpu())
    if loglikes is not None and len(surv.arc):
        _b, t_total, p = loglikes.shape
        pdf = torch.from_numpy(graph.arc_pdf).to(loglikes.device)[surv.arc]
        ac = (-loglikes.reshape(-1)[(surv.utt * t_total + surv.t) * p + pdf]).cpu().numpy()
    else:
        ac = np.zeros(len(surv.arc), np.float32)
    ts = surv.t.to(torch.int32).cpu().numpy()
    arcs = surv.arc.to(torch.int32).cpu().numpy()
    bounds = np.concatenate([[0], np.cumsum(surv.counts)])
    return [Lattice(graph=graph, nf=int(nf_np[i]), arc_t=ts[lo:hi], arc_id=arcs[lo:hi],
                    acoustic_cost=ac[lo:hi], use_final=bool(uf[i]))
            for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:]))]
