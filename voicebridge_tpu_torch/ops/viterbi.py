"""Generic per-utterance Viterbi alignment (plain PyTorch).

Port of the training-alignment half of ``voicebridge_tpu/ops/viterbi.py``,
used only when a set of training graphs does not fit the banded form of
``ops/align_band.py`` (band too wide, or pdfs not dst-pure).  Each frame
gathers the source scores of every arc, adds the graph and acoustic scores,
and takes the per-destination max through a fixed-depth gather reduction
tree (``ReductionPlan``), with optional beam pruning.

The host half (``pad_graphs``, ``ReductionPlan``, ``build_reduction_plan``,
``batched_plan_spec``, ``build_batched_plans``, ``assemble_batched_results``)
is the JAX package's numpy code, copied so both packages build identical
arrays.  The device half (``viterbi_forward_batched``,
``backtrace_batched_device``) is plain torch on any device; it has no kernel
yet.  Scores are max-plus (higher is better).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .graph import NEG_INF, DenseGraph, compile_dense_graph

__all__ = ["NEG_INF", "DenseGraph", "compile_dense_graph", "pad_graphs",
           "ReductionPlan", "build_reduction_plan", "batched_plan_spec",
           "build_batched_plans", "viterbi_forward_batched",
           "backtrace_batched_device", "assemble_batched_results"]


def pad_graphs(graphs: list[DenseGraph], pad_states: Optional[int] = None,
               pad_arcs: Optional[int] = None, plans: list | None = None,
               plan_depth: int | None = None,
               plan_rows: list[int] | None = None):
    """Stack per-utterance graphs into padded batch arrays.  Padding arcs
    point from/to a dead padding state with NEG_INF score.  ``plans`` (+
    optional ``plan_depth``/``plan_rows`` global targets from
    :func:`batched_plan_spec`) reuse precomputed reduction plans."""
    s_max = pad_states or max(g.num_states for g in graphs)
    a_max = pad_arcs or max(g.num_arcs for g in graphs)
    s_pad = s_max + 1  # last state = dead state
    b = len(graphs)

    def pad_arc(field, fill, dtype):
        out = np.full((b, a_max), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_arcs] = getattr(g, field)
        return out

    arc_src = pad_arc("arc_src", s_max, np.int32)
    arc_dst = pad_arc("arc_dst", s_max, np.int32)
    arc_tid = pad_arc("arc_tid", 0, np.int32)
    arc_pdf = pad_arc("arc_pdf", 0, np.int32)
    arc_score = pad_arc("arc_score", NEG_INF, np.float32)
    arc_oseq = pad_arc("arc_oseq", 0, np.int32)

    def pad_state(field, fill, dtype):
        out = np.full((b, s_pad), fill, dtype=dtype)
        for i, g in enumerate(graphs):
            out[i, : g.num_states] = getattr(g, field)
        return out

    alpha0 = pad_state("alpha0", NEG_INF, np.float32)
    final_score = pad_state("final_score", NEG_INF, np.float32)
    levels = build_batched_plans([g.arc_dst for g in graphs],
                                 [g.num_arcs for g in graphs], s_pad,
                                 plans=plans, depth=plan_depth,
                                 rows_per_level=plan_rows)
    return dict(
        arc_src=arc_src, arc_dst=arc_dst, arc_tid=arc_tid, arc_pdf=arc_pdf,
        arc_score=arc_score, arc_oseq=arc_oseq, alpha0=alpha0,
        final_score=final_score, num_states=s_pad, levels=levels,
    )


class ReductionPlan(NamedTuple):
    """Host-built plan for per-destination max over arc scores.

    ``levels[0]`` indexes arcs; each subsequent level indexes the previous
    level's row outputs; the last level has exactly ``num_states`` rows (row s
    = state s).  Entries are -1 where padded.
    """

    levels: tuple  # tuple[np.ndarray [R_i, K] int32]
    num_states: int


def build_reduction_plan(arc_dst: np.ndarray, num_states: int, k: int = 16) -> ReductionPlan:
    order = np.argsort(arc_dst, kind="stable").astype(np.int32)
    groups = np.asarray(arc_dst, np.int32)[order]  # sorted dst per element
    elems = order  # element ids at current level = arc indices
    levels = []
    while True:
        n = len(elems)
        if n == 0:
            levels.append(np.full((num_states, k), -1, np.int32))
            return ReductionPlan(tuple(levels), num_states)
        # runs of equal group
        boundaries = np.flatnonzero(np.diff(groups)) + 1
        run_starts = np.concatenate([[0], boundaries]).astype(np.int64)
        run_ends = np.concatenate([boundaries, [n]]).astype(np.int64)
        run_lens = run_ends - run_starts
        chunks_per_run = -(-run_lens // k)
        r = int(chunks_per_run.sum())
        first_chunk = np.concatenate([[0], np.cumsum(chunks_per_run[:-1])])
        chunk_run = np.repeat(np.arange(len(run_starts)), chunks_per_run)
        chunk_rank = np.arange(r) - first_chunk[chunk_run]
        chunk_start = run_starts[chunk_run] + k * chunk_rank
        pos = chunk_start[:, None] + np.arange(k)[None, :]
        valid = pos < run_ends[chunk_run][:, None]
        idx = np.where(valid, elems[np.minimum(pos, n - 1)], -1).astype(np.int32)
        row_groups = groups[run_starts][chunk_run]
        if int(chunks_per_run.max()) <= 1:
            final = np.full((num_states, k), -1, np.int32)
            final[row_groups] = idx
            levels.append(final)
            return ReductionPlan(tuple(levels), num_states)
        levels.append(idx)
        elems = np.arange(r, dtype=np.int32)
        groups = row_groups.astype(np.int32)


def _aligned_levels(plan_levels: tuple, num_arcs: int, depth: int, k: int):
    """Pad a per-graph plan to ``depth`` levels by inserting identity
    passthrough levels before the final state-level."""
    levels = list(plan_levels)
    while len(levels) < depth:
        dom = levels[-2].shape[0] if len(levels) >= 2 else num_arcs
        ident = np.full((dom, k), -1, np.int32)
        ident[:, 0] = np.arange(dom, dtype=np.int32)
        levels.insert(len(levels) - 1, ident)
    return levels


def batched_plan_spec(plans: list, num_arcs_each: list[int], k: int = 16):
    """Global (depth, rows-per-level) targets over a set of per-graph plans,
    so that any subset stacked with these targets shares one padded shape."""
    depth = max(len(p.levels) for p in plans)
    rows = [0] * depth
    for p, na in zip(plans, num_arcs_each):
        lv = _aligned_levels(p.levels, na, depth, k)
        for d in range(depth):
            rows[d] = max(rows[d], lv[d].shape[0])
    return depth, rows


def build_batched_plans(graphs_arc_dst: list[np.ndarray], num_arcs_each: list[int],
                        num_states: int, k: int = 16, plans: list | None = None,
                        depth: int | None = None,
                        rows_per_level: list[int] | None = None) -> tuple:
    """Per-graph reduction plans padded to a common (depth, rows) shape and
    stacked on the batch axis: tuple of [B, R_i, K] int32 arrays (graphs with
    shallower trees get identity passthrough levels)."""
    if plans is None:
        plans = [build_reduction_plan(np.asarray(dst[:na]), num_states, k)
                 for dst, na in zip(graphs_arc_dst, num_arcs_each)]
    depth = depth or max(len(p.levels) for p in plans)
    fixed = [_aligned_levels(p.levels, na, depth, k)
             for p, na in zip(plans, num_arcs_each)]
    out = []
    for d in range(depth):
        r_max = max(f[d].shape[0] for f in fixed)
        if rows_per_level is not None:
            r_max = max(r_max, rows_per_level[d])
        stack = np.full((len(fixed), r_max, k), -1, np.int32)
        for i, f in enumerate(fixed):
            stack[i, : f[d].shape[0]] = f[d]
        out.append(stack)
    return tuple(out)


def _tree_reduce_max(values: torch.Tensor, levels: list[torch.Tensor]):
    """values [B, A] -> (state max [B, S], winner arc [B, S], -1 where no
    finite candidate); ``levels`` [B, R_i, K] index tensors."""
    b = values.shape[0]
    v, widx = values, None
    for idx in levels:
        r, k = idx.shape[1], idx.shape[2]
        safe = idx.clamp(min=0).long()
        g = torch.gather(v, 1, safe.view(b, r * k)).view(b, r, k)
        g = torch.where(idx >= 0, g, NEG_INF)
        arg = torch.argmax(g, dim=2, keepdim=True)  # first maximal slot
        v = torch.gather(g, 2, arg)[..., 0]
        chosen = torch.gather(idx, 2, arg)[..., 0].long()
        if widx is None:
            widx = chosen  # arc ids
        else:
            widx = torch.where(chosen >= 0, torch.gather(widx, 1, chosen.clamp(min=0)), -1)
        widx = torch.where(v > NEG_INF / 2, widx, -1)
    return v, widx


def _prune(new_alpha: torch.Tensor, beam: float, max_active: int) -> torch.Tensor:
    """Keep states within ``beam`` of each utterance's best, and at most
    ``max_active`` of them."""
    best = new_alpha.amax(dim=1, keepdim=True)
    out = torch.where(new_alpha >= best - beam, new_alpha, NEG_INF)
    if max_active and max_active < out.shape[1]:
        kth = torch.topk(out, max_active, dim=1).values[:, -1:]
        out = torch.where(out >= kth, out, NEG_INF)
    return out


def viterbi_forward_batched(arc_src, levels, arc_pdf, arc_score, alpha0, loglikes,
                            num_frames, acoustic_scale: float, beam: float,
                            num_states: int, max_active: int = 0):
    """Per-utterance graphs: arc_* [B, A], alpha0 [B, S], loglikes [B, T, P]
    (a tensor; the other operands may be arrays and go to its device),
    ``levels`` from :func:`build_batched_plans`.  Returns (alpha_end [B, S],
    bps [T, B, S] int64 per-utterance arc ids, -1 where no arc won)."""
    dev = loglikes.device

    def tensor(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    arc_src = tensor(arc_src, torch.int64)
    arc_pdf = tensor(arc_pdf, torch.int64)
    arc_score = tensor(arc_score, torch.float32)
    alpha = tensor(alpha0, torch.float32)
    levels = [tensor(lv, torch.int32) for lv in levels]
    nf = tensor(np.asarray(num_frames), torch.int32)
    acwt = float(np.float32(acoustic_scale))
    b, t_total, _ = loglikes.shape
    alpha_end = torch.where((nf == 0)[:, None], alpha, torch.full_like(alpha, NEG_INF))
    bps = torch.empty((t_total, b, num_states), dtype=torch.int64, device=dev)
    for t in range(t_total):
        am = torch.gather(loglikes[:, t], 1, arc_pdf) * acwt
        score = torch.gather(alpha, 1, arc_src) + arc_score + am
        new_alpha, bps[t] = _tree_reduce_max(score, levels)
        new_alpha = _prune(new_alpha, float(np.float32(beam)), max_active)
        alpha = torch.where((t < nf)[:, None], new_alpha, alpha)
        alpha_end = torch.where((t + 1 == nf)[:, None], alpha, alpha_end)
    return alpha_end, bps


def backtrace_batched_device(arc_src, alpha_end, final_score, bps, num_frames):
    """Backtrace for per-utterance padded graphs on the device of ``bps``.

    arc_src [B, A]; alpha_end/final_score [B, S]; bps [T, B, S] arc ids.
    Returns (arcs [T, B] int64, -1 at inactive frames; ok [B] bool;
    end_state [B] int64; score [B] f32)."""
    dev = bps.device
    arc_src = torch.as_tensor(arc_src, dtype=torch.int64).to(dev)
    final_score = torch.as_tensor(final_score, dtype=torch.float32).to(dev)
    nf = torch.as_tensor(np.asarray(num_frames), dtype=torch.int32).to(dev)
    b = arc_src.shape[0]
    t_total = bps.shape[0]
    score, end_state = torch.max(alpha_end + final_score, dim=1)
    ok = score > NEG_INF / 2
    bidx = torch.arange(b, device=dev)
    s = end_state
    arcs = torch.empty((t_total, b), dtype=torch.int64, device=dev)
    for t in range(t_total - 1, -1, -1):
        active = t < nf
        a = bps[t, bidx, s]
        valid = a >= 0
        ok = torch.where(active, ok & valid, ok)
        s = torch.where(active & valid, arc_src[bidx, a.clamp(min=0)], s)
        arcs[t] = torch.where(active, a, -1)
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
