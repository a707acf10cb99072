"""The frame-synchronous searches of ``ops/viterbi.py``: generic per-utterance
alignment, N-best decoding and the windowed best-path decode.

Port of ``voicebridge_tpu/ops/viterbi.py``.  The JAX package takes the
per-destination max (or top K) through a fixed-depth gather reduction tree,
because the TPU wants static gathers.  Here the arcs are grouped by
destination instead (CSR from a stable sort by ``arc_dst``) and a thread walks
a state's in-arcs; the results are the same, ties included: the tree's
``argmax``/``top_k`` take the lowest position in the destination-sorted arc
list, which is the lowest arc id among equals.

* **Generic aligner** (``generic_forward``, ``generic_backtrace`` over a
  ``GenericPlanDev`` built once per graph set; ``viterbi_forward_batched``,
  ``backtrace_batched_device`` keep the JAX package's signatures;
  ``csrc/viterbi_generic.cu``): per-utterance graphs ``arc_* [B, A]``, used
  when a set of training graphs does not fit the banded form of
  ``ops/align_band.py``.  One CTA per utterance runs all frames with alpha
  in shared memory and the emissions of the next frames in flight, and
  writes a byte code per (frame, state) beside the arc ids; the backtrace,
  one launch, walks the codes staged in shared memory.
* **N-best** (``viterbi_nbest_forward``, K7, ``csrc/viterbi_nbest.cu``): every
  state of a shared graph carries its K best partial-path scores with (arc,
  slot) provenance, in a lane-minor layout ``[S, B, K]``; one cooperative
  launch runs a window of frames (``nbest_window``; ``nbest_step`` is W = 1).
  ``backtrace_nbest`` is the JAX package's numpy code;
  ``backtrace_nbest_device`` walks the same backpointers where they lie, in
  one launch of ``backtrace_nbest`` (``csrc/backtrace.cu``, a warp a walk)
  through ``nbest_walk``, over the walk's tables of the ``NbestPlan`` built
  once per graph.
* **Windowed decode** (``viterbi_decode_windowed``): alpha snapshots per
  window, then each window re-run with backpointers in reverse, over the emit
  plan and K3 (``ops/decode_core.py``).

Every wrapper sends a CPU tensor to the plain version beside it and a CUDA
tensor to its kernel.  Scores are max-plus (higher is better).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..device import stream_handle
from . import decode_core as DC
from .graph import NEG_INF, DenseGraph, compile_dense_graph

__all__ = ["NEG_INF", "DenseGraph", "compile_dense_graph", "pad_graphs", "GenericPlanDev",
           "generic_plan_to_device", "plan_arcs", "generic_forward", "generic_backtrace",
           "generic_codes_plain", "generic_backtrace_codes_plain",
           "viterbi_forward_batched", "backtrace_batched_device",
           "assemble_batched_results", "NbestPlan", "build_nbest_plan", "nbest_step",
           "nbest_window", "viterbi_nbest_forward", "nbest_walk", "backtrace_nbest",
           "backtrace_nbest_device", "viterbi_decode_windowed", "NBEST_MAX"]

NBEST_MAX = 16  # K7 keeps a state's list in registers
ARC_ID_LIMIT = 1 << 27  # K7 packs (arc id, slot) into one int: arc << 4 | slot
WALK_GROUP = 64  # states per 32-bit base of the N-best walk's compact row starts


def pad_graphs(graphs: list[DenseGraph], pad_states: Optional[int] = None,
               pad_arcs: Optional[int] = None) -> dict:
    """Stack per-utterance graphs into padded batch arrays.  Padding arcs
    point from/to a dead padding state with NEG_INF score."""
    s_max = pad_states or max(g.num_states for g in graphs)
    a_max = pad_arcs or max(g.num_arcs for g in graphs)
    s_pad = s_max + 1  # last state = dead state
    b = len(graphs)

    def pad_arc(field, fill, dtype):
        out = np.full((b, a_max), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_arcs] = getattr(g, field)
        return out

    def pad_state(field, fill, dtype):
        out = np.full((b, s_pad), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_states] = getattr(g, field)
        return out

    return dict(
        arc_src=pad_arc("arc_src", s_max, np.int32),
        arc_dst=pad_arc("arc_dst", s_max, np.int32),
        arc_tid=pad_arc("arc_tid", 0, np.int32),
        arc_pdf=pad_arc("arc_pdf", 0, np.int32),
        arc_score=pad_arc("arc_score", NEG_INF, np.float32),
        arc_oseq=pad_arc("arc_oseq", 0, np.int32),
        alpha0=pad_state("alpha0", NEG_INF, np.float32),
        final_score=pad_state("final_score", NEG_INF, np.float32),
        num_states=s_pad,
    )


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, device, shape=None) -> None:
    if x.device != device or x.dtype != dtype or not x.is_contiguous():
        raise ValueError(f"{name}: need contiguous {dtype} on {device}, "
                         f"got {x.dtype} on {x.device}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got {tuple(x.shape)}")


# ---------------------------------------------------------------------------
# Generic aligner (per-utterance graphs)
# ---------------------------------------------------------------------------


def viterbi_forward_batched_plain(arc_src, arc_dst, arc_pdf, arc_score, alpha0, loglikes,
                                  num_frames, acwt: float, beam: float, max_active: int = 0):
    """Plain version of the generic aligner's forward pass (tensors on one
    device): per frame a scatter-max of the arc scores by destination, the
    winner being the lowest arc id among a state's maximal arcs."""
    b, t_total, _ = loglikes.shape
    a = arc_src.shape[1]
    arc_ids = torch.arange(a, device=loglikes.device).expand(b, a)
    alpha = alpha0
    alpha_end = torch.where((num_frames == 0)[:, None], alpha, torch.full_like(alpha, NEG_INF))
    bps = torch.empty((t_total,) + tuple(alpha.shape), dtype=torch.int32,
                      device=loglikes.device)
    for t in range(t_total):
        active = (t < num_frames)[:, None]
        am = torch.gather(loglikes[:, t], 1, arc_pdf) * acwt
        score = torch.gather(alpha, 1, arc_src) + arc_score + am
        new_alpha = torch.full_like(alpha, NEG_INF).scatter_reduce_(
            1, arc_dst, score, reduce="amax", include_self=True)
        wins = score == torch.gather(new_alpha, 1, arc_dst)
        winner = torch.full(alpha.shape, a, dtype=torch.int64, device=alpha.device)
        winner.scatter_reduce_(1, arc_dst, torch.where(wins, arc_ids, a), reduce="amin",
                               include_self=True)
        winner = torch.where((new_alpha > NEG_INF / 2) & (winner < a), winner, -1)
        bps[t] = torch.where(active, winner, -1).to(torch.int32)
        new_alpha = DC.prune(new_alpha, beam, max_active)
        alpha = torch.where(active, new_alpha, alpha)
        alpha_end = torch.where((t + 1 == num_frames)[:, None], alpha, alpha_end)
    return alpha_end, bps


class GenericPlanDev(NamedTuple):
    """Per-utterance padded graphs (``pad_graphs``) on one device, as the
    generic aligner's kernels read them, built once per graph set
    (``generic_plan_to_device``).  The arcs entering state s of utterance b
    are the CSR positions ``in_start[b, s] : in_start[b, s + 1]``, in
    ascending arc id (the grouping of a stable sort by destination); the
    ``in_*`` rows hold them in that order (``plan_arcs`` gives them back in
    arc order).  ``max_in_degree`` and ``pdf_range`` stay on the host."""

    in_start: torch.Tensor  # [B, S+1] int32
    in_arc: torch.Tensor  # [B, A] int32 arc id at each CSR position
    in_src: torch.Tensor  # [B, A] int32 source state, CSR order
    in_score: torch.Tensor  # [B, A] f32, CSR order
    in_lpdf: torch.Tensor  # [B, A] int32 the arc's index into pdf_list[b], CSR order
    in_len: torch.Tensor  # [B, S] int32 arcs of a row the forward reads: 1 where
    #                       every arc of the row has one (source, score, pdf), else
    #                       the in-degree (equal arcs give equal candidates, and the
    #                       first wins)
    pdf_list: torch.Tensor  # [B, U] int32 each graph's distinct pdfs, ascending, 0 after
    n_pdf: torch.Tensor  # [B] int32 distinct pdfs of each graph
    alpha0: torch.Tensor  # [B, S] f32
    final: torch.Tensor  # [B, S] f32
    arc_src: torch.Tensor  # [B, A] int32 source state, arc order (the walk of bps)
    max_in_degree: int  # the largest in_len: picks the forward's compiled row bound
    pdf_range: tuple  # (smallest, largest) pdf of the arcs, host ints

    @property
    def num_states(self) -> int:
        return self.in_len.shape[1]

    def take(self, idx: np.ndarray) -> "GenericPlanDev":
        """The plan of the utterances ``idx`` (a batch subset), gathered on
        the device; the host fields stay the whole plan's, which bound the
        subset's."""
        i = torch.from_numpy(np.asarray(idx, np.int64)).to(self.in_len.device)
        return GenericPlanDev(*(x[i] for x in self[:-2]), self.max_in_degree, self.pdf_range)


CODE_MAX_DEGREE = 255  # a byte code names the rank of a row's arc; 0xFF names none
NO_ARC = 0xFF


def generic_plan_to_device(graphs, device) -> GenericPlanDev:
    """The generic aligner's plan of ``graphs`` (a list of ``DenseGraph``, or
    the dict ``pad_graphs`` returns) on ``device``: the numpy work (padding,
    the CSR by destination, the pdf lists) is done here once."""
    padded = graphs if isinstance(graphs, dict) else pad_graphs(graphs)
    src, dst, pdf = (np.asarray(padded[k], np.int32) for k in ("arc_src", "arc_dst", "arc_pdf"))
    score = np.asarray(padded["arc_score"], np.float32)
    b, a = src.shape
    s = int(padded["num_states"])
    rows = np.arange(b)[:, None]
    order = np.argsort(dst, axis=1, kind="stable")
    key = (dst.astype(np.int64) + s * rows).ravel()
    counts = np.bincount(key, minlength=b * s).reshape(b, s)
    in_start = np.concatenate([np.zeros((b, 1), np.int64), np.cumsum(counts, axis=1)], axis=1)
    in_src, in_dst, in_pdf, in_score = (np.take_along_axis(x, order, axis=1)
                                        for x in (src, dst, pdf, score))
    # a row reads one arc when all its arcs equal its first (scores bit for bit)
    first = np.take_along_axis(in_start[:, :-1], in_dst.astype(np.int64), axis=1)
    differ = ((np.take_along_axis(in_src, first, axis=1) != in_src)
              | (np.take_along_axis(in_pdf, first, axis=1) != in_pdf)
              | (np.take_along_axis(in_score, first, axis=1).view(np.int32)
                 != in_score.view(np.int32)))
    mixed = np.bincount((in_dst.astype(np.int64) + s * rows)[differ], minlength=b * s)
    in_len = np.where((counts > 0) & (mixed.reshape(b, s) == 0), 1, counts)
    lists = [np.unique(pdf[i]) for i in range(b)]
    n_pdf = np.asarray([len(x) for x in lists], np.int32)
    pdf_list = np.zeros((b, int(n_pdf.max()) if b else 0), np.int32)
    in_lpdf = np.empty_like(in_pdf)
    for i, x in enumerate(lists):
        pdf_list[i, : len(x)] = x
        in_lpdf[i] = np.searchsorted(x, in_pdf[i])

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return GenericPlanDev(
        in_start=dev(in_start, np.int32), in_arc=dev(order, np.int32),
        in_src=dev(in_src, np.int32), in_score=dev(in_score, np.float32),
        in_lpdf=dev(in_lpdf, np.int32), in_len=dev(in_len, np.int32),
        pdf_list=dev(pdf_list, np.int32), n_pdf=dev(n_pdf, np.int32),
        alpha0=dev(padded["alpha0"], np.float32), final=dev(padded["final_score"], np.float32),
        arc_src=dev(src, np.int32), max_in_degree=int(in_len.max()) if in_len.size else 0,
        pdf_range=(int(pdf.min()), int(pdf.max())) if pdf.size else (0, 0))


def _csr_dst(plan: GenericPlanDev) -> torch.Tensor:
    """[B, A] int64: the destination of the arc at each CSR position."""
    b, a = plan.in_arc.shape
    pos = torch.arange(a, device=plan.in_arc.device).expand(b, a).contiguous()
    return torch.searchsorted(plan.in_start[:, 1:].long().contiguous(), pos, right=True)


def plan_arcs(plan: GenericPlanDev):
    """The plan's arcs in arc order, as the plain versions take them:
    (arc_src, arc_dst, arc_pdf int64, arc_score f32), each [B, A], equal to
    ``pad_graphs``'s arrays."""
    arc = plan.in_arc.long()

    def by_arc(x):
        return torch.empty_like(x).scatter_(1, arc, x)

    pdf = torch.gather(plan.pdf_list.long(), 1, plan.in_lpdf.long())
    return (plan.arc_src.long(), by_arc(_csr_dst(plan)), by_arc(pdf), by_arc(plan.in_score))


def generic_codes_plain(bps: torch.Tensor, plan: GenericPlanDev) -> Optional[torch.Tensor]:
    """Plain version of the forward's byte codes: [B, T, S] uint8, the rank
    of the arc ``bps`` names in its destination's CSR row, 0xFF where it is
    -1; None when a row reads more than 255 arcs (``max_in_degree``)."""
    if plan.max_in_degree > CODE_MAX_DEGREE:
        return None
    b, a = plan.in_arc.shape
    rank = torch.empty((b, a), dtype=torch.int64, device=bps.device)
    rank.scatter_(1, plan.in_arc.long(), torch.arange(a, device=bps.device)[None, :]
                  - torch.gather(plan.in_start.long(), 1, _csr_dst(plan)))
    by_utt = bps.permute(1, 0, 2).long()  # [B, T, S]
    t_total, s = by_utt.shape[1], by_utt.shape[2]
    if a == 0:
        return torch.full((b, t_total, s), NO_ARC, dtype=torch.uint8, device=bps.device)
    got = torch.gather(rank, 1, by_utt.clamp(min=0).reshape(b, -1)).view(b, t_total, s)
    return torch.where(by_utt >= 0, got, NO_ARC).to(torch.uint8)


def generic_backtrace_codes_plain(plan: GenericPlanDev, alpha_end, final, codes, num_frames):
    """Plain version of the code-driven backtrace: the end state as
    ``backtrace_batched_plain`` takes it, then per active frame, from the
    last, the code of the state: st <- in_src[in_start[st] + code]; a 0xFF
    clears ok and holds the state.  Returns as ``backtrace_batched_plain``."""
    b, t_total, _ = codes.shape
    dev = codes.device
    score, end_state = torch.max(alpha_end + final, dim=1)
    ok = score > NEG_INF / 2
    bidx = torch.arange(b, device=dev)
    zero = torch.zeros((b, 1), dtype=torch.int64, device=dev)  # a target when A is 0
    src = torch.cat([plan.in_src.long(), zero], dim=1)
    arc_of = torch.cat([plan.in_arc.long(), zero], dim=1)
    start = plan.in_start.long()
    st = end_state
    arcs = torch.empty((t_total, b), dtype=torch.int32, device=dev)
    for t in range(t_total - 1, -1, -1):
        active = t < num_frames
        code = codes[bidx, t, st].long()
        hit = code != NO_ARC
        j = torch.where(hit, start[bidx, st] + code, src.shape[1] - 1)
        ok = torch.where(active, ok & hit, ok)
        st = torch.where(active & hit, src[bidx, j], st)
        arcs[t] = torch.where(active & hit, arc_of[bidx, j], -1).to(torch.int32)
    return arcs, ok, end_state.to(torch.int32), score


def generic_forward(plan: GenericPlanDev, loglikes: torch.Tensor, num_frames: torch.Tensor,
                    acoustic_scale: float, beam: float):
    """The generic aligner's forward over ``plan``: loglikes [B, T, P] f32
    and num_frames [B] int32 on the plan's device.  Returns (alpha_end [B, S]
    f32, bps [T, B, S] int32 arc ids, codes [B, T, S] uint8 or None when a
    row reads more than 255 arcs).  The pdf range is checked against P on
    the host (``plan.pdf_range``).  On CUDA it is ONE launch of
    ``generic_forward`` with no host synchronisation and no copy; a CPU
    tensor goes to ``viterbi_forward_batched_plain`` and
    ``generic_codes_plain``."""
    dev = loglikes.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    b, t_total, p = loglikes.shape
    lo, hi = plan.pdf_range
    if lo < 0 or hi >= p:
        raise ValueError(f"the graphs use pdfs [{lo}, {hi}], loglikes have only {p}")
    acwt = float(np.float32(acoustic_scale))
    beam = float(np.float32(beam))
    if dev.type == "cpu":
        alpha_end, bps = viterbi_forward_batched_plain(*plan_arcs(plan), plan.alpha0, loglikes,
                                                       num_frames, acwt, beam)
        return alpha_end, bps, generic_codes_plain(bps, plan)
    s = plan.num_states
    a, u = plan.in_arc.shape[1], plan.pdf_list.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("loglikes", loglikes, f32, dev)
    _check("num_frames", num_frames, i32, dev, (b,))
    _check("in_start", plan.in_start, i32, dev, (b, s + 1))
    for name in ("in_arc", "in_src", "in_score", "in_lpdf"):
        x = getattr(plan, name)
        _check(name, x, f32 if name == "in_score" else i32, dev, (b, a))
    _check("in_len", plan.in_len, i32, dev, (b, s))
    _check("pdf_list", plan.pdf_list, i32, dev, (b, u))
    _check("n_pdf", plan.n_pdf, i32, dev, (b,))
    _check("alpha0", plan.alpha0, f32, dev, (b, s))
    alpha_end = torch.empty((b, s), dtype=f32, device=dev)
    bps = torch.empty((t_total, b, s), dtype=i32, device=dev)
    codes = (torch.empty((b, t_total, s), dtype=torch.uint8, device=dev)
             if plan.max_in_degree <= CODE_MAX_DEGREE else None)
    if b * s == 0:
        return alpha_end, bps, codes
    _build.launch("generic_forward", plan.in_start.data_ptr(), plan.in_len.data_ptr(),
                  plan.in_src.data_ptr(), plan.in_score.data_ptr(), plan.in_lpdf.data_ptr(),
                  plan.in_arc.data_ptr(), plan.pdf_list.data_ptr(), plan.n_pdf.data_ptr(),
                  plan.alpha0.data_ptr(), loglikes.data_ptr(), num_frames.data_ptr(), acwt,
                  beam, b, s, a, u, t_total, p, plan.max_in_degree, alpha_end.data_ptr(),
                  bps.data_ptr(), None if codes is None else codes.data_ptr(),
                  stream_handle(dev))
    return alpha_end, bps, codes


def generic_backtrace(plan: GenericPlanDev, alpha_end: torch.Tensor, bps: torch.Tensor,
                      codes: Optional[torch.Tensor], num_frames: torch.Tensor,
                      final: Optional[torch.Tensor] = None):
    """Backtrace of ``generic_forward``'s result on its device (``final``
    defaults to the plan's).  Returns (arcs [T, B] int32, -1 at inactive
    frames and where the path found no arc; ok [B] bool; end_state [B]
    int32, the first state with the best final-weighted score; score [B]
    f32).  On CUDA it is ONE launch of ``generic_backtrace``: a CTA per
    utterance walking its code rows staged in shared memory, or, without
    codes, ``bps`` in global memory.  A CPU tensor goes to
    ``generic_backtrace_codes_plain`` (with codes) or
    ``backtrace_batched_plain``."""
    dev = bps.device
    final = plan.final if final is None else final
    if dev.type == "cpu":
        if codes is not None:
            return generic_backtrace_codes_plain(plan, alpha_end, final, codes, num_frames)
        return backtrace_batched_plain(plan.arc_src.long(), alpha_end, final, bps, num_frames)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    t_total, b, s = bps.shape
    a = plan.in_arc.shape[1]
    f32, i32 = torch.float32, torch.int32
    _check("bps", bps, i32, dev)
    _check("alpha_end", alpha_end, f32, dev, (b, s))
    _check("final", final, f32, dev, (b, s))
    _check("num_frames", num_frames, i32, dev, (b,))
    _check("in_start", plan.in_start, i32, dev, (b, s + 1))
    for name in ("arc_src", "in_src", "in_arc"):
        _check(name, getattr(plan, name), i32, dev, (b, a))
    if codes is not None:
        _check("codes", codes, torch.uint8, dev, (b, t_total, s))
    arcs = torch.empty((t_total, b), dtype=i32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)  # the kernel writes 0 or 1
    end_state = torch.empty(b, dtype=i32, device=dev)
    score = torch.empty(b, dtype=f32, device=dev)
    if b * s == 0:
        return arcs, ok, end_state, score
    _build.launch("generic_backtrace", alpha_end.data_ptr(), final.data_ptr(),
                  None if codes is None else codes.data_ptr(), bps.data_ptr(),
                  num_frames.data_ptr(), plan.in_start.data_ptr(), plan.in_src.data_ptr(),
                  plan.in_arc.data_ptr(), plan.arc_src.data_ptr(), b, s, a, t_total,
                  arcs.data_ptr(), ok.data_ptr(), end_state.data_ptr(), score.data_ptr(),
                  stream_handle(dev))
    return arcs, ok, end_state, score


def viterbi_forward_batched(arc_src, arc_dst, arc_pdf, arc_score, alpha0, loglikes,
                            num_frames, acoustic_scale: float, beam: float,
                            num_states: int, max_active: int = 0):
    """Per-utterance graphs: arc_* [B, A], alpha0 [B, S], loglikes [B, T, P]
    (a tensor; the other operands may be arrays and go to its device).
    Returns (alpha_end [B, S] f32, bps [T, B, S] int32 per-utterance arc ids,
    -1 where no arc won and at frames past an utterance's end).

    On CUDA the forward pass is one launch of ``generic_forward``, over a
    plan built here from the arrays (``AlignmentSet`` builds its plan once
    and calls ``generic_forward``).  ``max_active`` is supported by the plain
    version only; no caller of the aligner sets it."""
    dev = loglikes.device

    def tensor(x, dtype):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    nf = tensor(num_frames, torch.int32)
    alpha0 = tensor(alpha0, torch.float32).contiguous()
    if alpha0.shape[1] != num_states:
        raise ValueError(f"alpha0 has {alpha0.shape[1]} states, expected {num_states}")
    if dev.type == "cpu":
        return viterbi_forward_batched_plain(
            tensor(arc_src, torch.int64), tensor(arc_dst, torch.int64),
            tensor(arc_pdf, torch.int64), tensor(arc_score, torch.float32), alpha0,
            loglikes, nf, float(np.float32(acoustic_scale)), float(np.float32(beam)),
            max_active)
    if max_active:
        raise NotImplementedError("the generic aligner's kernel has no max_active pruning")

    def host(x):
        return torch.as_tensor(x).cpu().numpy()

    b = alpha0.shape[0]
    arcs = {k: host(x) for k, x in (("arc_src", arc_src), ("arc_dst", arc_dst),
                                    ("arc_pdf", arc_pdf), ("arc_score", arc_score))}
    for name, x in arcs.items():
        if x.shape != arcs["arc_src"].shape or x.shape[0] != b:
            raise ValueError(f"{name}: need shape {arcs['arc_src'].shape}, got {x.shape}")
    plan = generic_plan_to_device(dict(arcs, alpha0=host(alpha0),
                                       final_score=np.full((b, num_states), NEG_INF,
                                                           np.float32),  # not read here
                                       num_states=num_states), dev)
    return generic_forward(plan, loglikes.contiguous(), nf, acoustic_scale, beam)[:2]


def backtrace_batched_plain(arc_src, alpha_end, final_score, bps, num_frames):
    """Plain version of the generic aligner's backtrace over ``bps``."""
    b = arc_src.shape[0]
    t_total = bps.shape[0]
    score, end_state = torch.max(alpha_end + final_score, dim=1)
    ok = score > NEG_INF / 2
    bidx = torch.arange(b, device=bps.device)
    s = end_state
    arcs = torch.empty((t_total, b), dtype=torch.int32, device=bps.device)
    for t in range(t_total - 1, -1, -1):
        active = t < num_frames
        a = bps[t, bidx, s].long()
        valid = a >= 0
        ok = torch.where(active, ok & valid, ok)
        s = torch.where(active & valid, arc_src[bidx, a.clamp(min=0)], s)
        arcs[t] = torch.where(active, a, -1).to(torch.int32)
    return arcs, ok, end_state.to(torch.int32), score


def backtrace_batched_device(arc_src, alpha_end, final_score, bps, num_frames):
    """Backtrace for per-utterance padded graphs on the device of ``bps``.

    arc_src [B, A]; alpha_end/final_score [B, S]; bps [T, B, S] int32 arc
    ids.  Returns (arcs [T, B] int32, -1 at inactive frames; ok [B] bool;
    end_state [B] int32, the first state with the best final-weighted score;
    score [B] f32).  On CUDA it is one launch of ``generic_backtrace``
    walking ``bps`` in global memory (``generic_backtrace`` walks the
    forward's byte codes staged in shared memory)."""
    dev = bps.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    final_score = torch.as_tensor(final_score, dtype=torch.float32).to(dev).contiguous()
    nf = torch.as_tensor(num_frames, dtype=torch.int32).to(dev)
    if dev.type == "cpu":
        return backtrace_batched_plain(torch.as_tensor(arc_src, dtype=torch.int64),
                                       alpha_end, final_score, bps, nf)
    arc_src = torch.as_tensor(arc_src, dtype=torch.int32).to(dev).contiguous()
    t_total, b, s = bps.shape
    _check("bps", bps, torch.int32, dev)
    _check("alpha_end", alpha_end, torch.float32, dev, (b, s))
    _check("final_score", final_score, torch.float32, dev, (b, s))
    if arc_src.shape[0] != b or nf.shape != (b,):
        raise ValueError("backtrace_batched_device: inconsistent shapes")
    arcs = torch.empty((t_total, b), dtype=torch.int32, device=dev)
    ok = torch.empty(b, dtype=torch.bool, device=dev)
    end_state = torch.empty(b, dtype=torch.int32, device=dev)
    score = torch.empty(b, dtype=torch.float32, device=dev)
    _build.launch("generic_backtrace", alpha_end.data_ptr(), final_score.data_ptr(), None,
                  bps.data_ptr(), nf.data_ptr(), None, None, None, arc_src.data_ptr(), b, s,
                  arc_src.shape[1], t_total, arcs.data_ptr(), ok.data_ptr(),
                  end_state.data_ptr(), score.data_ptr(), stream_handle(dev))
    return arcs, ok, end_state, score


def assemble_batched_results(graphs: list[DenseGraph], arcs: np.ndarray,
                             ok: np.ndarray, end_state: np.ndarray,
                             score: np.ndarray, num_frames: np.ndarray):
    """Host assembly of per-utterance results from a device backtrace:
    [{"tids", "words", "score", "arcs"}] per utterance."""
    out = []
    for i, g in enumerate(graphs):
        n = int(num_frames[i])
        if not ok[i]:
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        a_i = arcs[:n, i].astype(np.int64)
        s = int(g.arc_src[a_i[0]]) if n else int(end_state[i])
        words: list[int] = list(g.oseqs[g.start_oseq[s]])
        o_ids = g.arc_oseq[a_i]
        for o in o_ids[o_ids != 0]:  # oseqs[0] is (); skip wordless arcs
            words.extend(g.oseqs[o])
        words.extend(g.oseqs[g.final_oseq[int(end_state[i])]])
        out.append({
            "tids": g.arc_tid[a_i].tolist(),
            "words": words,
            "score": float(score[i]),
            "arcs": a_i.tolist(),
        })
    return out


# ---------------------------------------------------------------------------
# N-best Viterbi (per-state K-hypothesis lists), K7
# ---------------------------------------------------------------------------


class NbestPlan(NamedTuple):
    """A shared graph's arcs grouped by destination, on one device: the arcs
    entering state s are ``in_start[s] : in_start[s + 1]`` of the other
    arrays, in ascending arc id.  K7 reads the first five; the N-best walk
    reads ``in_start`` (as ``in_base`` + ``in_off`` where that compact form
    exists), ``arc``, ``src``, ``arc_src`` and ``final``."""

    in_start: torch.Tensor  # [S+1] int32
    src: torch.Tensor  # [A] int32 source state
    pdf: torch.Tensor  # [A] int32
    score: torch.Tensor  # [A] f32 graph score
    arc: torch.Tensor  # [A] int32 original arc id
    dst: torch.Tensor  # [A] int64 destination (plain version only)
    arc_src: torch.Tensor  # [A] int32 source state by original arc id
    final: torch.Tensor  # [S] f32 final scores
    # the row starts compact: in_start of every WALK_GROUP-th state (padded
    # to a multiple of 4) and in_start[x] - in_base[x // WALK_GROUP] as
    # uint16 bits (padded to a multiple of 8); in_off is empty where a group
    # of states has 65536 in-arcs or more
    in_base: torch.Tensor  # [4 * ceil(ceil((S+1) / WALK_GROUP) / 4)] int32
    in_off: torch.Tensor  # [8 * ceil((S+1) / 8)] int16, or [0]

    @property
    def num_states(self) -> int:
        return self.in_start.shape[0] - 1


def compact_row_starts(in_start: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``in_start`` [S+1] as (in_base, in_off): the start of every
    ``WALK_GROUP``-th row, padded to a multiple of 4, and each row's start
    less its group's base as uint16 bits in int16, padded to a multiple of
    8 (empty where an offset needs more than 16 bits)."""
    n = in_start.shape[0]
    n_base = -(-n // WALK_GROUP)
    base = np.zeros(-(-n_base // 4) * 4, np.int32)
    base[:n_base] = in_start[::WALK_GROUP]
    off = in_start.astype(np.int64) - np.repeat(base[:n_base], WALK_GROUP)[:n]
    if off.max(initial=0) >= 1 << 16:
        return base, np.zeros(0, np.int16)
    padded = np.zeros(-(-n // 8) * 8, np.uint16)
    padded[:n] = off
    return base, padded.view(np.int16)


def build_nbest_plan(graph: DenseGraph, device) -> NbestPlan:
    order = np.argsort(graph.arc_dst, kind="stable")
    counts = np.bincount(graph.arc_dst, minlength=graph.num_states)
    in_start = np.concatenate([[0], np.cumsum(counts)])
    in_base, in_off = compact_row_starts(in_start)

    def dev(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype)).to(device)

    return NbestPlan(in_start=dev(in_start, np.int32), src=dev(graph.arc_src[order], np.int32),
                     pdf=dev(graph.arc_pdf[order], np.int32),
                     score=dev(graph.arc_score[order], np.float32),
                     arc=dev(order, np.int32), dst=dev(graph.arc_dst[order], np.int64),
                     arc_src=dev(graph.arc_src, np.int32),
                     final=dev(graph.final_score, np.float32), in_base=dev(in_base, np.int32),
                     in_off=dev(in_off, np.int16))


def nbest_step_plain(plan: NbestPlan, alpha, alpha_end, ll_t, num_frames, t: int,
                     acwt: float, beam: float, bp_arc, bp_slot):
    """Plain version of K7's frame, in K7's layout (see ``nbest_step``).
    The per-destination top K comes from two stable sorts of the
    ``[B, A * K]`` candidates: by value, descending, then by destination, so
    that a state's candidates stand together, best first, equals in (arc
    position, source slot) order.  Returns (alpha, alpha_end) [S, B, K]
    (views of new lane-major tensors)."""
    s, b, k = alpha.shape
    alpha = alpha.permute(1, 0, 2)  # [B, S, K] views
    a = plan.src.shape[0]
    w = plan.score[None, :] + ll_t.t()[:, plan.pdf.long()] * acwt  # [B, A]
    cand = alpha[:, plan.src.long(), :] + w[:, :, None]  # [B, A, K]
    vals, i1 = cand.reshape(b, a * k).sort(dim=1, descending=True, stable=True)
    group = plan.dst.repeat_interleave(k)[i1]
    _, i2 = group.sort(dim=1, stable=True)
    vals = vals.gather(1, i2)
    flat = i1.gather(1, i2)  # candidate index (arc position * K + slot)
    start = plan.in_start.long()
    pos = start[:-1, None] * k + torch.arange(k, device=alpha.device)[None, :]  # [S, K]
    valid = (pos < start[1:, None] * k).reshape(-1)
    pos = pos.clamp(max=max(a * k - 1, 0)).reshape(-1)
    if a == 0:
        scores = torch.full_like(alpha, NEG_INF)
        flat_top = torch.zeros((b, s * k), dtype=torch.int64, device=alpha.device)
    else:
        scores = torch.where(valid, vals[:, pos], NEG_INF).view(b, s, k)
        flat_top = flat[:, pos]
    best = scores.amax(dim=(1, 2), keepdim=True)
    scores = torch.where(scores >= best - beam, scores, NEG_INF)
    active = (t < num_frames)[:, None, None]
    live = active & (scores > NEG_INF)
    if a:
        arc = plan.arc.long()[flat_top // k].view(b, s, k)
        slot = (flat_top % k).view(b, s, k)
    else:
        arc = slot = flat_top.view(b, s, k)
    bp_arc.permute(1, 0, 2).copy_(torch.where(live, arc, -1))
    bp_slot.permute(1, 0, 2).copy_(torch.where(live, slot, 0))
    alpha = torch.where(active, scores, alpha)
    alpha_end = torch.where((t + 1 == num_frames)[:, None, None], alpha,
                            alpha_end.permute(1, 0, 2))
    return alpha.permute(1, 0, 2), alpha_end.permute(1, 0, 2)


def nbest_window_plain(plan: NbestPlan, alpha, alpha_end, ll, num_frames, t0: int, acwt: float,
                       beam: float, bp_arc, bp_slot):
    """Plain version of ``nbest_window``: ``nbest_step_plain`` frame by
    frame."""
    for i in range(ll.shape[0]):
        alpha, alpha_end = nbest_step_plain(plan, alpha, alpha_end, ll[i], num_frames, t0 + i,
                                            acwt, beam, bp_arc[i], bp_slot[i])
    return alpha, alpha_end


def nbest_window(plan: NbestPlan, alpha: torch.Tensor, alpha_end: torch.Tensor,
                 ll: torch.Tensor, num_frames: torch.Tensor, t0: int, acwt: float, beam: float,
                 bp_arc: torch.Tensor, bp_slot: torch.Tensor):
    """K7 over the frames t0 .. t0+W-1 of ``ll`` [W, P, B] f32 in ONE
    cooperative launch.  Lane-minor layout: alpha, alpha_end [S, B, K] f32;
    num_frames [B] int32; bp_arc [W, S, B, K] int32 and bp_slot [W, S, B, K]
    int8 are filled: the arc and the source slot each hypothesis came from,
    -1 and 0 where the slot holds NEG_INF (none, or pruned by the beam) or
    the utterance has ended.

    Returns (alpha, alpha_end) after the window.  On CUDA ``alpha_end`` is
    updated in place and returned; it must not share memory with
    ``alpha``.  A refused cooperative launch raises."""
    dev = alpha.device
    if dev.type == "cpu":
        return nbest_window_plain(plan, alpha, alpha_end, ll, num_frames, t0, acwt, beam,
                                  bp_arc, bp_slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    s, b, k = alpha.shape
    if not 1 <= k <= NBEST_MAX:
        raise ValueError(f"nbest must be in 1..{NBEST_MAX}, got {k}")
    if ll.dim() != 3 or ll.shape[2] != b:
        raise ValueError(f"ll: need [W, P, {b}], got {tuple(ll.shape)}")
    w, p = ll.shape[0], ll.shape[1]
    a = plan.src.shape[0]
    _check("alpha", alpha, torch.float32, dev)
    _check("alpha_end", alpha_end, torch.float32, dev, alpha.shape)
    _check("ll", ll, torch.float32, dev)
    _check("bp_arc", bp_arc, torch.int32, dev, (w, s, b, k))
    _check("bp_slot", bp_slot, torch.int8, dev, (w, s, b, k))
    _check("num_frames", num_frames, torch.int32, dev, (b,))
    _check("in_start", plan.in_start, torch.int32, dev, (s + 1,))
    for name, x, dtype in (("src", plan.src, torch.int32), ("pdf", plan.pdf, torch.int32),
                           ("score", plan.score, torch.float32), ("arc", plan.arc, torch.int32)):
        _check(name, x, dtype, dev, (a,))
    if alpha_end.data_ptr() == alpha.data_ptr():
        raise ValueError("alpha_end must not share memory with alpha")
    if a > ARC_ID_LIMIT:
        raise ValueError(f"K7 packs arc ids in 27 bits: {a} arcs")
    if w == 0:
        return alpha, alpha_end
    bufs = [torch.empty_like(alpha) for _ in range(min(w, 2))]
    best = torch.full((3, b), NEG_INF, dtype=torch.float32, device=dev)  # lane best, 3 frames
    _build.launch("viterbi_nbest", alpha.data_ptr(), bufs[0].data_ptr(),
                  bufs[-1].data_ptr() if w > 1 else None, alpha_end.data_ptr(),
                  bp_arc.data_ptr(), bp_slot.data_ptr(), best.data_ptr(), ll.data_ptr(),
                  plan.in_start.data_ptr(), plan.src.data_ptr(), plan.pdf.data_ptr(),
                  plan.score.data_ptr(), plan.arc.data_ptr(), num_frames.data_ptr(), t0, w, acwt,
                  beam, b, s, k, p, DC._MAX_GRID_BLOCKS, stream_handle(dev))
    return bufs[(w - 1) % 2], alpha_end  # frame i of the launch writes bufs[i % 2]


def nbest_step(plan: NbestPlan, alpha: torch.Tensor, alpha_end: torch.Tensor,
               ll_t: torch.Tensor, num_frames: torch.Tensor, t: int, acwt: float,
               beam: float, bp_arc: torch.Tensor, bp_slot: torch.Tensor):
    """One frame of the N-best relaxation (K7 with W = 1).  alpha, alpha_end
    [S, B, K] f32; ll_t [P, B] f32; num_frames [B] int32; bp_arc [S, B, K]
    int32 and bp_slot [S, B, K] int8 are filled as in ``nbest_window``.

    Returns (alpha, alpha_end) after frame ``t``.  On CUDA ``alpha_end`` is
    updated in place and returned."""
    dev = alpha.device
    if dev.type == "cpu":
        return nbest_step_plain(plan, alpha, alpha_end, ll_t, num_frames, t, acwt, beam,
                                bp_arc, bp_slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if ll_t.dim() != 2:
        raise ValueError("ll_t: need [P, B]")
    return nbest_window(plan, alpha, alpha_end, ll_t[None], num_frames, t, acwt, beam,
                        bp_arc[None], bp_slot[None])


def viterbi_nbest_forward(plan: NbestPlan, alpha0, loglikes: torch.Tensor, num_frames,
                          acoustic_scale: float, beam: float, nbest: int):
    """Exact N-best Viterbi over a shared graph: every state carries its K
    best partial-path scores (the role of lattice N-best,
    ``lattice-nbest``/``nshortest``).

    loglikes [B, T, P] on the plan's device; alpha0 [S].  Returns
    (alpha_end [B, S, K] f32, bp_arc [T, B, S, K] int32, bp_slot [T, B, S, K]
    int8): full backpointer storage, 5 bytes per (frame, state, slot), so a
    caller splits its batch by the memory it has.  The three are views of
    K7's lane-minor tables (``[S, B, K]`` and ``[T, S, B, K]``), which all T
    frames fill in one ``nbest_window``."""
    dev = loglikes.device
    b, t_total, p = loglikes.shape
    s = plan.num_states
    if plan.pdf.numel() and int(plan.pdf.max()) >= p:
        raise ValueError(f"the graph uses pdf {int(plan.pdf.max())}, loglikes have only {p}")
    nf = torch.as_tensor(np.asarray(num_frames), dtype=torch.int32).to(dev)
    acwt = float(np.float32(acoustic_scale))
    beam = float(np.float32(beam))
    alpha = torch.full((s, b, nbest), NEG_INF, dtype=torch.float32, device=dev)
    alpha[:, :, 0] = torch.as_tensor(alpha0, dtype=torch.float32).to(dev)[:, None]
    alpha_end = torch.where((nf == 0)[None, :, None], alpha, torch.full_like(alpha, NEG_INF))
    bp_arc = torch.empty((t_total, s, b, nbest), dtype=torch.int32, device=dev)
    bp_slot = torch.empty((t_total, s, b, nbest), dtype=torch.int8, device=dev)
    ll = loglikes.permute(1, 2, 0).contiguous()  # [T, P, B]: lanes fastest, as K7 reads them
    _, alpha_end = nbest_window(plan, alpha, alpha_end, ll, nf, 0, acwt, beam, bp_arc, bp_slot)
    return alpha_end.permute(1, 0, 2), bp_arc.permute(0, 2, 1, 3), bp_slot.permute(0, 2, 1, 3)


def _assemble_hyp(graph: DenseGraph, arcs: np.ndarray, start_state: int, end_state: int,
                  score: float, nonempty: np.ndarray) -> dict:
    words = list(graph.oseqs[graph.start_oseq[start_state]])
    words.extend(DC.arc_words(graph, arcs, nonempty))
    words.extend(graph.oseqs[graph.final_oseq[end_state]])
    return {"words": words, "score": score, "tids": graph.arc_tid[arcs].tolist(),
            "arcs": arcs.tolist()}


def backtrace_nbest(graph: DenseGraph, alpha_end, bp_arc, bp_slot, num_frames,
                    nbest: int):
    """-> per utterance: list of up to ``nbest`` dicts (words, tids, score,
    arcs), from host copies of the whole backpointer tables."""
    alpha_end = np.asarray(alpha_end)
    bp_arc = np.asarray(bp_arc)
    bp_slot = np.asarray(bp_slot)
    b = alpha_end.shape[0]
    nonempty = DC.oseq_nonempty(graph)
    out = []
    for i in range(b):
        t_end = int(num_frames[i])
        total = alpha_end[i] + graph.final_score[:, None]  # [S, K]
        flat = total.reshape(-1)
        order = np.argsort(-flat, kind="stable")[: nbest * 4]
        hyps = []
        seen = set()
        for fidx in order:
            if flat[fidx] <= NEG_INF / 2 or len(hyps) >= nbest:
                break
            s, k = divmod(int(fidx), alpha_end.shape[2])
            score = float(flat[fidx])
            arcs = []
            si, ki = s, k
            ok = True
            for t in range(t_end - 1, -1, -1):
                a = int(bp_arc[t, i, si, ki])
                if a < 0:
                    ok = False
                    break
                ki = int(bp_slot[t, i, si, ki])
                arcs.append(a)
                si = int(graph.arc_src[a])
            if not ok:
                continue
            arcs.reverse()
            key = tuple(arcs)
            if key in seen:
                continue
            seen.add(key)
            hyps.append(_assemble_hyp(graph, np.asarray(arcs, np.int64), si, s, score, nonempty))
        out.append(hyps)
    return out


def nbest_walk_plain(bp_arc, bp_slot, arc_src, num_frames, state, slot):
    """Plain version of ``nbest_walk``: every (lane, candidate) walked back
    together, one gather per frame."""
    t_total, b = bp_arc.shape[:2]
    c = state.shape[1]
    dev = bp_arc.device
    si, ki = state.long(), slot.long()
    nf = num_frames.long()
    ok = torch.ones((b, c), dtype=torch.bool, device=dev)
    arcs = torch.full((t_total, b, c), -1, dtype=torch.int32, device=dev)
    bidx = torch.arange(b, device=dev)[:, None]
    arc_src = arc_src.long()
    for t in range(min(t_total, int(nf.max()) if b else 0) - 1, -1, -1):
        active = (t < nf)[:, None] & ok
        a = bp_arc[t][bidx, si, ki].long()
        ok = ok & ((a >= 0) | ~active)
        step = active & (a >= 0)
        ki = torch.where(step, bp_slot[t][bidx, si, ki].long(), ki)
        si = torch.where(step, arc_src[a.clamp(min=0)], si)
        arcs[t] = torch.where(step, a, -1)
    return arcs, si.to(torch.int32), ok


def nbest_walk(plan: NbestPlan, bp_arc: torch.Tensor, bp_slot: torch.Tensor,
               num_frames: torch.Tensor, state: torch.Tensor, slot: torch.Tensor):
    """Walk every (lane, candidate) back from its end entry (``state``,
    ``slot``) [B, C] int32 through the N-best backpointers bp_arc [T, B, S,
    K] int32 / bp_slot [T, B, S, K] int8 (any strides, the same for both),
    from frame ``num_frames[b] - 1`` down to 0, over the graph of ``plan``
    (on the tables' device).  num_frames [B] int32.

    Returns (arcs [T, B, C] int32 in forward frame order, -1 at frames past
    the lane's end and below a failure; the start state [B, C] int32; ok [B,
    C] bool, False where a walk met arc -1).  On CUDA it is one launch of
    ``backtrace_nbest`` (``csrc/backtrace.cu``), a warp per (lane,
    candidate) reading each frame's in-arcs beside its backpointer."""
    dev = bp_arc.device
    if dev.type == "cpu":
        return nbest_walk_plain(bp_arc, bp_slot, plan.arc_src, num_frames, state, slot)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    t_total, b, s, k = bp_arc.shape
    c = state.shape[1] if state.dim() == 2 else -1
    a = plan.arc.shape[0]
    if (bp_arc.dtype != torch.int32 or bp_slot.dtype != torch.int8 or bp_slot.device != dev
            or bp_slot.shape != bp_arc.shape or bp_slot.stride() != bp_arc.stride()):
        raise ValueError("nbest_walk: need int32 bp_arc and int8 bp_slot of one shape and "
                         "one layout on " + str(dev))
    _check("num_frames", num_frames, torch.int32, dev, (b,))
    _check("state", state, torch.int32, dev, (b, c))
    _check("slot", slot, torch.int32, dev, (b, c))
    _check("in_start", plan.in_start, torch.int32, dev, (s + 1,))
    for name in ("arc", "src", "arc_src"):
        _check(name, getattr(plan, name), torch.int32, dev, (a,))
    n_base = -(-(s + 1) // WALK_GROUP)
    _check("in_base", plan.in_base, torch.int32, dev, (-(-n_base // 4) * 4,))
    if plan.in_off.numel():
        _check("in_off", plan.in_off, torch.int16, dev, (-(-(s + 1) // 8) * 8,))
    arcs = torch.empty((t_total, b, c), dtype=torch.int32, device=dev)
    start = torch.empty((b, c), dtype=torch.int32, device=dev)
    ok = torch.empty((b, c), dtype=torch.uint8, device=dev)
    _build.launch("backtrace_nbest", bp_arc.data_ptr(), bp_slot.data_ptr(), *bp_arc.stride(),
                  plan.in_start.data_ptr(), plan.in_off.data_ptr() if plan.in_off.numel() else None,
                  plan.in_base.data_ptr(), plan.arc.data_ptr(), plan.src.data_ptr(),
                  plan.arc_src.data_ptr(), s, a, num_frames.data_ptr(), state.data_ptr(),
                  slot.data_ptr(), b, c, t_total, arcs.data_ptr(), start.data_ptr(),
                  ok.data_ptr(), stream_handle(dev))
    return arcs, start, ok.bool()


def backtrace_nbest_device(graph: DenseGraph, alpha_end: torch.Tensor, bp_arc: torch.Tensor,
                           bp_slot: torch.Tensor, num_frames, nbest: int,
                           plan: Optional[NbestPlan] = None):
    """``backtrace_nbest`` without a host copy of the tables: the ``4 * nbest``
    best end entries of every utterance are walked back together on the
    tables' device (``nbest_walk``), and only their arcs ``[T, B, C]``, end
    and start states, flags and scores come to the host, in one transfer,
    where hypotheses are assembled and duplicate arc sequences dropped as
    ``backtrace_nbest`` does.  ``plan`` is ``graph``'s ``NbestPlan`` on the
    tables' device (its final scores and walk tables; the call then copies
    no graph array to the device); without it one is built for the call."""
    dev = alpha_end.device
    if plan is None:
        plan = build_nbest_plan(graph, dev)
    b, s, k = alpha_end.shape
    t_total = bp_arc.shape[0]
    nf_np = np.asarray(num_frames).astype(np.int32)
    nf = torch.from_numpy(nf_np).to(dev)
    total = (alpha_end + plan.final[None, :, None]).reshape(b, s * k)
    c = min(nbest * 4, s * k)
    score, fidx = total.sort(dim=1, descending=True, stable=True)
    score, fidx = score[:, :c], fidx[:, :c]
    end_state = (fidx // k).to(torch.int32)
    arcs, start, ok = nbest_walk(plan, bp_arc, bp_slot, nf, end_state,
                                 (fidx % k).to(torch.int32))
    host = torch.cat([arcs.view(t_total * b, c), start, end_state, ok.to(torch.int32),
                      score.view(torch.int32)]).cpu().numpy()
    arcs_np = host[: t_total * b].reshape(t_total, b, c)
    start_np, end_np, ok_np, score_np = host[t_total * b:].reshape(4, b, c)
    score_np = score_np.view(np.float32)
    nonempty = DC.oseq_nonempty(graph)
    out = []
    for i in range(b):
        hyps, seen = [], set()
        for j in range(c):
            if score_np[i, j] <= NEG_INF / 2 or len(hyps) >= nbest:
                break
            if not ok_np[i, j]:
                continue
            path = arcs_np[: int(nf_np[i]), i, j]
            key = path.tobytes()
            if key in seen:
                continue
            seen.add(key)
            hyps.append(_assemble_hyp(graph, path, int(start_np[i, j]), int(end_np[i, j]),
                                      float(score_np[i, j]), nonempty))
        out.append(hyps)
    return out


# ---------------------------------------------------------------------------
# Windowed best-path decode
# ---------------------------------------------------------------------------


def viterbi_decode_windowed(graph: DenseGraph, plan: DC.EmitPlan, plan_dev: DC.EmitPlanDev,
                            loglikes: torch.Tensor, num_frames, acoustic_scale: float,
                            beam: float, window: int = 64, max_active: int = 0):
    """Memory-bounded Viterbi decode over a shared graph (long audio).

    Phase 1: forward pass storing an alpha snapshot at each window start
    (memory [NW, S+1, B] instead of backpointers [T, S+1, B]).  Phase 2: per
    window, in reverse order, re-run the window recording backpointers and
    backtrace through it on the device.  The frame step is K3's relaxation
    over the emit plan followed by the beam / max-active prune; a beam of
    1e8 or more prunes nothing and is not applied.

    loglikes [B, T, P] on the plan's device.  Returns one
    {"tids", "words", "score", "arcs"} per utterance, as
    ``decode_core.decode_best_path``."""
    pruned = beam < 1e8 or max_active > 0
    return DC.decode_best_path(
        graph, plan, plan_dev, loglikes, num_frames, acoustic_scale, window=window,
        beam=float(np.float32(beam)) if pruned else None, max_active=max_active)
