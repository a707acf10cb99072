"""Banded Viterbi for training-graph alignment, with a hand-written CUDA
kernel (K4, ``csrc/align_band.cu``).

Port of ``voicebridge_tpu/ops/align_band.py``.  Training graphs (the output
of ``TrainingGraphCompiler``) are nearly linear, so under a BFS state order
every arc's displacement ``dst - src`` lies in a small band of K offsets, and
all arcs entering a state share that state's pdf.  The relaxation is then K
shifted adds and a max per state, the emission one gathered loglik per
state, and the backpointer one uint8 band slot per state per frame.

The host half (``BandPlan``, ``_bfs_order``, ``build_band_plan``) is the JAX
package's numpy code, copied so both packages build identical plans.  The
device half has a plain PyTorch version (``viterbi_forward_banded_plain``,
``backtrace_banded_plain``: a Python loop over frames) and wrappers that send
a CPU tensor to it and a CUDA tensor to K4:

* ``viterbi_forward_banded``: ONE launch for the whole sub-batch, one CTA
  per utterance looping over all frames, the emissions of the next frames
  in flight; the plan's pdf range is checked on the host
  (``BandPlanDev.pdf_range``), so the wrapper does not synchronise;
* ``backtrace_banded``: one launch, one CTA per utterance walking its
  backpointer rows staged in shared memory, with an exact replay from the
  first empty band slot on the path; it writes the arc ids ``arc_of`` names,
  or the transition ids ``BandPlanDev.tid_of`` names.

Rounding follows the JAX package: the candidate is ``(shift + W)``, then the
max, then ``+ fl(ll[pdf] * acwt)``; ties go to the first maximal slot in
ascending offset order.  Scores are max-plus (higher is better).
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..device import stream_handle
from .graph import NEG_INF, DenseGraph

__all__ = ["BandPlan", "BandPlanDev", "build_band_plan", "plan_to_device",
           "viterbi_forward_banded", "viterbi_forward_banded_plain", "backtrace_banded",
           "backtrace_banded_plain"]


class BandPlan(NamedTuple):
    """Host-built banded batch plan (states renumbered by per-graph BFS)."""

    W: np.ndarray  # [B, S, K] f32 graph score of the arc entering state s
    #                with displacement offsets[k] (NEG_INF where no arc)
    pdf: np.ndarray  # [B, S] int32 pdf shared by arcs entering s (0 default)
    arc_of: np.ndarray  # [B, S, K] int32 original arc id (-1 where no arc)
    offsets: tuple  # K sorted ints: arc displacement dst_pos - src_pos
    alpha0: np.ndarray  # [B, S] f32 initial scores (banded numbering)
    final: np.ndarray  # [B, S] f32 final scores (banded numbering)
    n2o: np.ndarray  # [B, S] int32 banded index -> original state (-1 pad)

    @property
    def num_padded_states(self) -> int:
        return self.W.shape[1]


def _bfs_order(g: DenseGraph) -> Optional[np.ndarray]:
    """BFS state order from the start states; None only if the graph has no
    start state.  States unreachable from the starts are parked at the END
    of the order: their alpha stays NEG_INF so arcs out of them can never
    win, but their arcs still receive band offsets and may widen the band
    (possibly past ``max_band``, in which case build_band_plan refuses)."""
    adj: dict[int, list[int]] = collections.defaultdict(list)
    for s, d in zip(g.arc_src, g.arc_dst):
        adj[int(s)].append(int(d))
    starts = np.where(g.alpha0 > NEG_INF / 2)[0]
    if len(starts) == 0:
        return None
    seen = set(int(s) for s in starts)
    order = list(starts)
    dq = collections.deque(order)
    while dq:
        s = dq.popleft()
        for d in adj[s]:
            if d not in seen:
                seen.add(d)
                order.append(d)
                dq.append(d)
    if len(order) < g.num_states:
        order.extend(s for s in range(g.num_states) if s not in seen)
    return np.asarray(order, np.int64)


def build_band_plan(graphs: list[DenseGraph], pad_states: int | None = None,
                    max_band: int = 48,
                    reason: list | None = None) -> Optional[BandPlan]:
    """Build the banded batch plan, or None if the set isn't banded-friendly
    (band wider than ``max_band`` offsets, or a graph whose incoming arcs
    disagree on the destination pdf).  Pass a list as ``reason`` to receive
    a one-string diagnostic on failure (which constraint, which graph)."""
    b = len(graphs)
    s_pad = pad_states or max(g.num_states for g in graphs)
    orders, poss, offs_all = [], [], set()
    for gi, g in enumerate(graphs):
        order = _bfs_order(g)
        if order is None:
            if reason is not None:
                reason.append(f"graph {gi} has no start state")
            return None
        pos = np.empty(g.num_states, np.int64)
        pos[order] = np.arange(g.num_states)
        orders.append(order)
        poss.append(pos)
        if g.num_arcs:
            offs = pos[g.arc_dst] - pos[g.arc_src]
            offs_all.update(int(o) for o in np.unique(offs))
    offsets = tuple(sorted(offs_all))
    if len(offsets) == 0 or len(offsets) > max_band:
        if reason is not None:
            reason.append(f"band width {len(offsets)} exceeds max_band "
                          f"{max_band} (offset span "
                          f"[{min(offs_all, default=0)}, "
                          f"{max(offs_all, default=0)}])")
        return None
    koff = {o: k for k, o in enumerate(offsets)}
    k = len(offsets)

    W = np.full((b, s_pad, k), NEG_INF, np.float32)
    arc_of = np.full((b, s_pad, k), -1, np.int32)
    pdf = np.zeros((b, s_pad), np.int32)
    alpha0 = np.full((b, s_pad), NEG_INF, np.float32)
    final = np.full((b, s_pad), NEG_INF, np.float32)
    n2o = np.full((b, s_pad), -1, np.int32)
    for i, g in enumerate(graphs):
        pos, order = poss[i], orders[i]
        n2o[i, : g.num_states] = order
        alpha0[i, pos] = g.alpha0
        final[i, pos] = g.final_score
        dst_n = pos[g.arc_dst]
        src_n = pos[g.arc_src]
        # dst-purity check: all arcs entering a state must share its pdf
        seen_pdf = np.full(s_pad, -1, np.int64)
        for a in range(g.num_arcs):
            d = int(dst_n[a])
            p = int(g.arc_pdf[a])
            if seen_pdf[d] >= 0 and seen_pdf[d] != p:
                if reason is not None:
                    reason.append(
                        f"graph {i} not dst-pure: state {d} entered with "
                        f"pdfs {seen_pdf[d]} and {p}")
                return None
            seen_pdf[d] = p
            kk = koff[int(dst_n[a] - src_n[a])]
            # parallel arcs (same src/dst/pdf): keep the best-scoring one,
            # exactly what the max-plus recursion would pick
            if g.arc_score[a] > W[i, d, kk]:
                W[i, d, kk] = g.arc_score[a]
                arc_of[i, d, kk] = a
        pdf[i, seen_pdf >= 0] = seen_pdf[seen_pdf >= 0]
    return BandPlan(W=W, pdf=pdf, arc_of=arc_of, offsets=offsets,
                    alpha0=alpha0, final=final, n2o=n2o)


class BandPlanDev(NamedTuple):
    """A ``BandPlan`` on a device (``n2o`` and ``pdf_range`` stay on the
    host).  ``tid_of`` is ``arc_of`` with each arc's transition id in its
    place (-1 where no arc), when the plan was moved with its graphs' ids:
    given to ``backtrace_banded`` for ``arc_of``, it writes the frames'
    transition ids."""

    W: torch.Tensor  # [B, S, K] f32
    pdf: torch.Tensor  # [B, S] int32
    arc_of: torch.Tensor  # [B, S, K] int32
    offsets: torch.Tensor  # [K] int32
    alpha0: torch.Tensor  # [B, S] f32
    final: torch.Tensor  # [B, S] f32
    n2o: np.ndarray  # [B, S] int32, host
    pdf_range: tuple  # (smallest, largest) pdf of the plan, host ints
    tid_of: Optional[torch.Tensor] = None  # [B, S, K] int32

    def take(self, idx: np.ndarray) -> "BandPlanDev":
        """The plan of the utterances ``idx`` (a batch subset), gathered on
        the device; ``pdf_range`` stays the whole plan's, which bounds the
        subset's."""
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.W.device)
        return BandPlanDev(self.W[i], self.pdf[i], self.arc_of[i], self.offsets,
                           self.alpha0[i], self.final[i], self.n2o[idx], self.pdf_range,
                           None if self.tid_of is None else self.tid_of[i])


def _tid_table(arc_of: torch.Tensor, arc_tid: np.ndarray) -> torch.Tensor:
    """[B, S, K] int32 on ``arc_of``'s device: the transition id of the arc
    ``arc_of`` names, -1 where it names none.  ``arc_tid`` [B, A] holds each
    graph's arc transition ids, padded (``pad_graphs``'s ``arc_tid``); a
    negative one would read as a missing arc, and is refused."""
    if arc_tid.size and int(arc_tid.min()) < 0:
        raise ValueError("a graph has an arc with a negative transition id")
    if arc_tid.shape[1] == 0:
        return torch.full_like(arc_of, -1)
    tid = torch.from_numpy(np.ascontiguousarray(arc_tid, np.int32)).to(arc_of.device)
    got = torch.gather(tid, 1, arc_of.reshape(arc_of.shape[0], -1).clamp(min=0).long())
    return torch.where(arc_of >= 0, got.view(arc_of.shape), -1)


def plan_to_device(plan: BandPlan, device, arc_tid: np.ndarray | None = None) -> BandPlanDev:
    """``plan`` on ``device``; with its graphs' padded transition ids
    ``arc_tid`` [B, A], also ``tid_of`` (``_tid_table``)."""
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    lo, hi = (int(plan.pdf.min()), int(plan.pdf.max())) if plan.pdf.size else (0, 0)
    arc_of = dev(plan.arc_of, np.int32)
    return BandPlanDev(W=dev(plan.W, np.float32), pdf=dev(plan.pdf, np.int32), arc_of=arc_of,
                       offsets=dev(np.asarray(plan.offsets), np.int32),
                       alpha0=dev(plan.alpha0, np.float32),
                       final=dev(plan.final, np.float32), n2o=plan.n2o, pdf_range=(lo, hi),
                       tid_of=None if arc_tid is None else _tid_table(arc_of, arc_tid))


def _initial_end(alpha0: torch.Tensor, num_frames: torch.Tensor) -> torch.Tensor:
    """alpha_end before frame 0: alpha0 for empty utterances, else NEG_INF."""
    return torch.where((num_frames == 0)[:, None], alpha0, torch.full_like(alpha0, NEG_INF))


def viterbi_forward_banded_plain(W, pdf, alpha0, loglikes, num_frames,
                                 acoustic_scale: float, offsets):
    """Plain version of K4's forward.  W [B,S,K] f32, pdf [B,S] int32,
    alpha0 [B,S] f32, loglikes [B,T,P] f32, num_frames [B] int32; ``offsets``
    the K band offsets (tuple or tensor).  Returns (alpha_end [B,S],
    bps [T,B,S] uint8 band-slot winners)."""
    b, t_total, _ = loglikes.shape
    s = W.shape[1]
    offs = [int(o) for o in offsets]
    lo, hi = max(0, max(offs)), max(0, -min(offs))
    acwt = float(np.float32(acoustic_scale))
    pdf_l = pdf.long()
    alpha = alpha0
    alpha_end = _initial_end(alpha0, num_frames)
    pad_lo = torch.full((b, lo), NEG_INF, dtype=alpha0.dtype, device=alpha0.device)
    pad_hi = torch.full((b, hi), NEG_INF, dtype=alpha0.dtype, device=alpha0.device)
    bps = torch.empty((t_total, b, s), dtype=torch.uint8, device=alpha0.device)
    for t in range(t_total):
        padded = torch.cat([pad_lo, alpha, pad_hi], dim=1)  # alpha[s] at lo + s
        # out[:, s] = alpha[:, s - off] (NEG_INF outside), then + W: [B, S, K]
        cand = torch.stack([padded[:, lo - o: lo - o + s] for o in offs], dim=2) + W
        best, slot = torch.max(cand, dim=2)
        bps[t] = slot.to(torch.uint8)
        e = torch.gather(loglikes[:, t], 1, pdf_l) * acwt
        active = (t < num_frames)[:, None]
        alpha = torch.where(active, best + e, alpha)
        alpha_end = torch.where((t + 1 == num_frames)[:, None], alpha, alpha_end)
    return alpha_end, bps


def backtrace_banded_plain(alpha_end, final, bps, num_frames, offsets, arc_of):
    """Plain version of K4's backtrace.  Returns (arcs [T,B] int32 original
    arc ids, -1 at inactive frames; end_state [B] int32 banded index;
    ok [B] bool; score [B] f32).  A path that meets an empty band slot at an
    active frame clears ``ok``."""
    b = alpha_end.shape[0]
    t_total = bps.shape[0]
    total = alpha_end + final
    score, end_state = torch.max(total, dim=1)
    ok = score > NEG_INF / 2
    bidx = torch.arange(b, device=bps.device)
    offs = torch.tensor([int(o) for o in offsets], device=bps.device)
    st = end_state
    arcs = torch.empty((t_total, b), dtype=torch.int32, device=bps.device)
    for t in range(t_total - 1, -1, -1):
        active = t < num_frames
        k = bps[t, bidx, st].long()
        a = arc_of[bidx, st, k]
        ok = torch.where(active, ok & (a >= 0), ok)
        st = torch.where(active & (a >= 0), st - offs[k], st)
        arcs[t] = torch.where(active, a, -1)
    return arcs, end_state.to(torch.int32), ok, score


def _check(tensors, device) -> None:
    for name, x, dtype in tensors:
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {device}, "
                             f"got {x.dtype} on {x.device}")


def viterbi_forward_banded(W, pdf, alpha0, loglikes, num_frames,
                           acoustic_scale: float, offsets: torch.Tensor,
                           pdf_range: tuple | None = None):
    """Banded forward (K4) over a sub-batch in ONE launch.  Shapes as
    ``viterbi_forward_banded_plain``; ``offsets`` a [K] int32 tensor on the
    device.  ``pdf_range`` is (smallest, largest) pdf of ``pdf`` as the host
    knows it (``BandPlanDev.pdf_range``): it is checked against P on either
    device before anything runs, without reading the card.  Without it the
    wrapper reads the range from ``pdf`` (one host synchronisation).  A CPU
    tensor goes to the plain version."""
    if loglikes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {loglikes.device}")
    p = loglikes.shape[-1]
    if pdf_range is None:
        pdf_range = tuple(int(v) for v in pdf.aminmax()) if pdf.numel() else (0, 0)
    lo, hi = pdf_range
    if lo < 0 or hi >= p:
        raise ValueError(f"the band plan uses pdfs [{lo}, {hi}], loglikes have {p}")
    if loglikes.device.type == "cpu":
        return viterbi_forward_banded_plain(W, pdf, alpha0, loglikes, num_frames,
                                            acoustic_scale, offsets)
    b, t_total, p = loglikes.shape
    s, k = W.shape[1], W.shape[2]
    f32, i32 = torch.float32, torch.int32
    _check((("W", W, f32), ("pdf", pdf, i32), ("alpha0", alpha0, f32),
            ("loglikes", loglikes, f32), ("num_frames", num_frames, i32),
            ("offsets", offsets, i32)), loglikes.device)
    if (W.shape[0] != b or pdf.shape != (b, s) or alpha0.shape != (b, s)
            or num_frames.shape != (b,) or offsets.shape != (k,) or not 0 < k <= 255):
        raise ValueError("viterbi_forward_banded: inconsistent shapes")
    alpha_end = torch.empty((b, s), dtype=f32, device=loglikes.device)
    bps = torch.empty((t_total, b, s), dtype=torch.uint8, device=loglikes.device)
    if b * s == 0:
        return alpha_end, bps
    _build.launch("align_forward", W.data_ptr(), pdf.data_ptr(), alpha0.data_ptr(),
                  loglikes.data_ptr(), num_frames.data_ptr(), offsets.data_ptr(),
                  float(np.float32(acoustic_scale)), b, s, k, t_total, p,
                  alpha_end.data_ptr(), bps.data_ptr(), stream_handle(loglikes.device))
    return alpha_end, bps


def backtrace_banded(alpha_end, final, bps, num_frames, offsets: torch.Tensor, arc_of):
    """Backtrace over band-slot winners (K4's second entry point), resolving
    original arc ids on the device.  Returns as ``backtrace_banded_plain``.
    Given a plan's ``tid_of`` for ``arc_of``, it writes transition ids where
    it would write arc ids: the walk reads only the table's sign."""
    if bps.device.type == "cpu":
        return backtrace_banded_plain(alpha_end, final, bps, num_frames, offsets, arc_of)
    if bps.device.type != "cuda":
        raise ValueError(f"unsupported device {bps.device}")
    t_total, b, s = bps.shape
    k = offsets.shape[0]
    f32, i32 = torch.float32, torch.int32
    _check((("alpha_end", alpha_end, f32), ("final", final, f32),
            ("bps", bps, torch.uint8), ("num_frames", num_frames, i32),
            ("offsets", offsets, i32), ("arc_of", arc_of, i32)), bps.device)
    if (alpha_end.shape != (b, s) or final.shape != (b, s) or num_frames.shape != (b,)
            or arc_of.shape != (b, s, k)):
        raise ValueError("backtrace_banded: inconsistent shapes")
    arcs = torch.empty((t_total, b), dtype=i32, device=bps.device)
    end_state = torch.empty(b, dtype=i32, device=bps.device)
    ok = torch.empty(b, dtype=torch.bool, device=bps.device)  # the kernel writes 0 or 1
    score = torch.empty(b, dtype=f32, device=bps.device)
    if b * s == 0:
        return arcs, end_state, ok, score
    _build.launch("align_backtrace", alpha_end.data_ptr(), final.data_ptr(),
                  bps.data_ptr(), num_frames.data_ptr(), offsets.data_ptr(),
                  arc_of.data_ptr(), b, s, k, t_total, arcs.data_ptr(),
                  end_state.data_ptr(), ok.data_ptr(), score.data_ptr(),
                  stream_handle(bps.device))
    return arcs, end_state, ok, score
