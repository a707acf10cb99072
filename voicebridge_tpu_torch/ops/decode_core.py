"""Exact Viterbi best-path decode core: batch-minor state scores and
in-degree rows, in PyTorch with a hand-written per-frame CUDA kernel.

Port of ``voicebridge_tpu/ops/decode_core.py``.  The host half (``EmitPlan``
.. ``build_emit_plan``) is the JAX package's numpy code, copied so that both
packages build identical plans array for array:

* **Batch-minor layout** ``alpha[S+1, B]``: a gather of a source state's
  scores reads ``B`` contiguous floats.
* **In-degree rows**: the incoming arcs of each state are grouped by
  ``(dst, pdf)`` into rows of width ``D``, so a row's acoustic score is one
  gathered value.  States are renumbered by bucketed row count (plan space);
  each plan state owns the contiguous rows ``row_start[s]:row_start[s+1]``.
* **Backpointers** are one integer per state per frame: the winner code
  ``local_row * D + slot`` (uint8 when ``max_bucket * D <= 256``, else int16).

The device half is K3 (``csrc/viterbi_step.cu``): ``viterbi_window`` runs a
window of frames in one cooperative launch (``viterbi_scan`` without a
beam), ``viterbi_step`` one frame (the beam path, which prunes between
frames).  Their plain versions loop over ``_emit_step``, which keeps the TPU
design's bucketed reshape-max (``reduce_rows``).  ``backtrace_scan`` walks a
block's backpointers in one launch of ``backtrace_best``
(``csrc/backtrace.cu``) and maps the codes to arc ids on the device, so only
arc ids reach the host; ``select_end_state`` is plain torch on the device.
Scores are max-plus (higher is better).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build
from ..device import free_bytes, stream_handle
from .graph import NEG_INF, DenseGraph

__all__ = [
    "EmitPlan", "build_emit_plan", "plan_to_device", "row_real_slots", "viterbi_step",
    "viterbi_window", "viterbi_scan", "backtrace_scan", "decode_best_path", "reduce_rows",
    "prune",
]

# Test hook: when positive, caps the blocks of a K3, K5 or K7 launch, so that
# one block's stride loop covers every state.
_MAX_GRID_BLOCKS = 0


class EmitPlan(NamedTuple):
    """Host-built decode plan for a shared graph (see module docstring).

    States are renumbered into PLAN space: ``sperm[i]`` is the graph state
    of plan state ``i`` (the pad state ``S`` maps to itself).  All row
    arrays, ``row_start``, backtrace states and alpha tables live in plan
    space; ``row_arc`` stores ORIGINAL arc ids so host-side lattice/path
    assembly never needs the permutation.

    ``rspec`` is a static tuple of ``(bucket, n_states)`` runs in plan-state
    order (last entry is the pad state's ``(1, 1)``): plan state block
    ``i0:i0+n`` owns rows ``r0 + k*bucket : r0 + (k+1)*bucket``, so the
    row->state reduction is one reshape-max per run.
    """

    row_src: np.ndarray  # [R, D] int32 source PLAN state per slot (pad: S)
    row_w: np.ndarray  # [R, D] f32 graph score (pad: NEG_INF)
    row_pdf: np.ndarray  # [R] int32 pdf shared by the row's arcs
    row_arc: np.ndarray  # [R, D] int32 original arc id (pad: -1; host only)
    row_start: np.ndarray  # [S+2] int32 CSR of rows per plan state
    sperm: np.ndarray  # [S+1] int32 plan state -> graph state (pad: S)
    rspec: tuple  # ((bucket, n_states), ...) static reduction spec
    num_states: int  # S (real states, excluding the pad state)
    packed: bool  # True: bp code fits uint8 (else int16)

    @property
    def num_rows(self) -> int:
        return len(self.row_pdf)

    @property
    def d(self) -> int:
        return self.row_w.shape[1]


def _chunk_runs(run_starts, run_ends, elems, width):
    """Chunk [start, end) runs over ``elems`` into [n_chunk, width] index rows
    (-1 padded).  Returns (rows, chunk_run)."""
    n = len(elems)
    run_lens = run_ends - run_starts
    cpr = -(-run_lens // width)
    n_chunk = int(cpr.sum())
    if n_chunk == 0:
        return (np.zeros((0, width), np.int64),
                np.zeros(0, np.int64))
    first = np.concatenate([[0], np.cumsum(cpr[:-1])])
    chunk_run = np.repeat(np.arange(len(run_starts)), cpr)
    rank = np.arange(n_chunk) - first[chunk_run]
    start = run_starts[chunk_run] + width * rank
    pos = start[:, None] + np.arange(width)[None, :]
    valid = pos < run_ends[chunk_run][:, None]
    rows = np.where(valid, elems[np.minimum(pos, max(n - 1, 0))], -1)
    return rows, chunk_run


def _runs(key: np.ndarray):
    n = len(key)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    b = np.flatnonzero(np.diff(key)) + 1
    return (np.concatenate([[0], b]).astype(np.int64),
            np.concatenate([b, [n]]).astype(np.int64))


def _buckets_upto(n: int) -> np.ndarray:
    """Bucket ladder 1, 2, 3, 4, 6, 9, 13, ... (~1.5x steps) covering n."""
    out = [1]
    while out[-1] < n:
        out.append(max(out[-1] + 1, out[-1] * 3 // 2))
    return np.asarray(out, np.int64)


def build_emit_plan(graph: DenseGraph, d: Optional[int] = None) -> EmitPlan:
    """Group ``graph``'s arcs by (dst, pdf) into rows of width ``d``
    (defaulting to a value adapted to the run-length distribution), then
    renumber states by bucketed row count so the row->state reduction is
    gather-free (see EmitPlan docstring)."""
    s_real = graph.num_states
    s_pad = s_real + 1
    a = graph.num_arcs
    dst = graph.arc_dst.astype(np.int64)
    pdf = graph.arc_pdf.astype(np.int64)
    num_pdfs = int(pdf.max()) + 1 if a else 1

    order = np.argsort(dst * num_pdfs + pdf, kind="stable")
    dst_s, pdf_s = dst[order], pdf[order]
    run_starts, run_ends = _runs(dst_s * num_pdfs + pdf_s)

    if d is None:
        lens = run_ends - run_starts
        if len(lens) == 0:
            d = 2
        else:
            p90 = float(np.quantile(lens, 0.9))
            d = int(min(8, max(2, 2 ** int(np.ceil(np.log2(max(p90, 2)))))))

    arc_rows, chunk_run = _chunk_runs(run_starts, run_ends, order, d)
    n_chunk = len(chunk_run)
    chunk_dst = (dst_s[run_starts][chunk_run] if n_chunk else
                 np.zeros(0, np.int64))
    chunk_pdf = (pdf_s[run_starts][chunk_run] if n_chunk else
                 np.zeros(0, np.int64))

    # rows per graph state (row-less states get one dead row -> bucket 1)
    nrows = np.zeros(s_real, np.int64)
    np.add.at(nrows, chunk_dst, 1)
    nrows1 = np.maximum(nrows, 1)

    buckets = _buckets_upto(int(nrows1.max()))
    bidx = np.searchsorted(buckets, nrows1)
    cap = buckets[bidx]  # [S_real] row slots owned by each graph state

    # plan numbering: stable sort by bucket; the pad state stays at index S
    sperm = np.argsort(bidx, kind="stable")  # plan i -> graph state
    iperm = np.empty(s_real, np.int64)
    iperm[sperm] = np.arange(s_real)
    cap_plan = cap[sperm]
    row_start_plan = np.concatenate([[0], np.cumsum(cap_plan)])
    r = int(row_start_plan[-1]) + 1  # + one dead row for the pad state
    row_start = np.concatenate([row_start_plan, [r]]).astype(np.int32)

    # static reduction spec: runs of equal bucket in plan order + pad entry
    rs, re = _runs(cap_plan)
    rspec = tuple((int(cap_plan[s]), int(e - s)) for s, e in zip(rs, re))
    rspec = rspec + ((1, 1),)

    # scatter chunk rows into their plan slots (rank-within-state preserved:
    # chunks are (dst, pdf)-sorted, so per-dst chunks are consecutive)
    row_arc = np.full((r, d), -1, np.int64)
    row_pdf_all = np.zeros(r, np.int64)
    if n_chunk:
        first_chunk_of_dst = np.searchsorted(chunk_dst, chunk_dst)
        rank = np.arange(n_chunk) - first_chunk_of_dst
        tgt = row_start_plan[iperm[chunk_dst]] + rank
        row_arc[tgt] = arc_rows
        row_pdf_all[tgt] = chunk_pdf
    row_pdf_all = row_pdf_all.astype(np.int32)
    row_arc = row_arc.astype(np.int32)

    rvalid = row_arc >= 0
    safe = np.maximum(row_arc, 0)
    iperm_pad = np.concatenate([iperm, [s_real]])
    row_src = np.where(rvalid, iperm_pad[graph.arc_src[safe]],
                       s_real).astype(np.int32)
    row_w = np.where(rvalid, graph.arc_score[safe], NEG_INF).astype(np.float32)

    max_bucket = int(cap.max()) if s_real else 1
    # bp code = local_row * d + slot, stored as uint8 when it fits, else int16
    assert max_bucket * d <= 2 ** 15, \
        f"state with {max_bucket} row slots exceeds the int16 bp code range"
    packed = max_bucket * d <= 256

    sperm_full = np.concatenate([sperm, [s_real]]).astype(np.int32)
    return EmitPlan(row_src=row_src, row_w=row_w, row_pdf=row_pdf_all,
                    row_arc=row_arc, row_start=row_start, sperm=sperm_full,
                    rspec=rspec, num_states=s_real, packed=packed)


class EmitPlanDev(NamedTuple):
    """Device half of an EmitPlan."""

    row_src: torch.Tensor  # [R*D] int32 flattened
    row_w: torch.Tensor  # [R, D] f32
    row_pdf: torch.Tensor  # [R] int32
    row_start: torch.Tensor  # [S+2] int32
    row_real: torch.Tensor  # [R] uint8 real slots per row (``row_real_slots``)
    row_arc: torch.Tensor  # [R*D] int32 original arc id (pad: -1), for the backtrace


def row_real_slots(plan: EmitPlan) -> np.ndarray:
    """Per row, the count of real slots (``row_arc >= 0``), uint8.  K3 and K5
    evaluate a row's pad slots once, as one value: that needs the pads to
    trail the real slots (``_chunk_runs`` fills rows from the left) and to
    read the pad state with weight NEG_INF, which this checks."""
    real = plan.row_arc >= 0
    n = real.sum(axis=1)
    pad = ~real
    if not (plan.d < 256 and np.array_equal(real, np.arange(plan.d)[None, :] < n[:, None])
            and (plan.row_src[pad] == plan.num_states).all()
            and (plan.row_w[pad] == np.float32(NEG_INF)).all()):
        raise ValueError("plan rows must hold their real slots first and pad with the pad "
                         "state at NEG_INF")
    return n.astype(np.uint8)


def plan_to_device(plan: EmitPlan, device) -> EmitPlanDev:
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return EmitPlanDev(row_src=dev(plan.row_src.reshape(-1), np.int32),
                       row_w=dev(plan.row_w, np.float32),
                       row_pdf=dev(plan.row_pdf, np.int32),
                       row_start=dev(plan.row_start, np.int32),
                       row_real=dev(row_real_slots(plan), np.uint8),
                       row_arc=dev(plan.row_arc.reshape(-1), np.int32))


def _bp_dtype(plan_packed: bool) -> torch.dtype:
    return torch.uint8 if plan_packed else torch.int16


def reduce_rows(v: torch.Tensor, rspec: tuple, b: int) -> torch.Tensor:
    """Row values [R, B] -> plan-state values [S+1, B]: one reshape-max per
    bucket run (rows of a state are contiguous and every state in a run owns
    exactly ``bucket`` rows)."""
    parts = []
    lo = 0
    for c, n in rspec:
        blk = v[lo:lo + n * c]
        parts.append(blk if c == 1 else blk.view(n, c, b).amax(dim=1))
        lo += n * c
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _emit_step(alpha: torch.Tensor, ll_t: torch.Tensor, dev: EmitPlanDev,
               acwt: float, rspec: tuple, packed: bool):
    """Plain version of K3's relaxation.  alpha [S+1, B], ll_t [P, B].

    Returns (new_alpha [S+1, B], bp [S+1, B]) where bp is the winner code
    ``local_row * D + slot`` relative to the state's first row: the first
    maximal slot of a row, the largest code among maximal rows."""
    r, d_w = dev.row_w.shape
    b = alpha.shape[1]
    am = ll_t.index_select(0, dev.row_pdf) * acwt  # [R, B]
    g = alpha.index_select(0, dev.row_src).view(r, d_w, b) + dev.row_w[:, :, None]
    # [R, B], first maximal slot (over a contiguous last axis: on the CPU
    # many times faster than over the middle one)
    slot = torch.argmax(g.transpose(1, 2).contiguous(), dim=2)
    v = torch.amax(g, dim=1) + am  # [R, B]

    parts_v, parts_c = [], []
    lo = 0
    for c, n in rspec:
        bv = v[lo:lo + n * c]
        bs = slot[lo:lo + n * c]
        if c == 1:
            parts_v.append(bv)
            parts_c.append(bs)  # local row 0 -> code == slot
        else:
            bvr = bv.view(n, c, b)
            codes = (torch.arange(c, device=v.device)[None, :, None] * d_w
                     + bs.view(n, c, b))
            vm = bvr.amax(dim=1)
            # any maximal row's code is a valid backpointer; take the largest
            # so (value, code) stay consistent
            parts_c.append(torch.where(bvr == vm[:, None, :], codes, -1).amax(dim=1))
            parts_v.append(vm)
        lo += n * c
    v_out = parts_v[0] if len(parts_v) == 1 else torch.cat(parts_v, dim=0)
    code = parts_c[0] if len(parts_c) == 1 else torch.cat(parts_c, dim=0)
    return v_out, code.to(_bp_dtype(packed))


def viterbi_step_plain(alpha, alpha_end, ll_t, dev: EmitPlanDev, num_frames, t: int,
                       acwt: float, rspec: tuple, packed: bool, bp_out=None):
    """Plain version of ``viterbi_step``: ``_emit_step`` plus the
    ``t < num_frames`` mask and the ``alpha_at_end`` capture."""
    new_alpha, code = _emit_step(alpha, ll_t, dev, acwt, rspec, packed)
    if bp_out is not None:
        bp_out.copy_(code)
    a = torch.where((t < num_frames)[None, :], new_alpha, alpha)
    return a, torch.where((t + 1 == num_frames)[None, :], a, alpha_end)


def viterbi_window_plain(alpha, alpha_end, ll, dev: EmitPlanDev, num_frames, t0: int,
                         acwt: float, rspec: tuple, packed: bool, bps=None):
    """Plain version of ``viterbi_window``: ``viterbi_step_plain`` frame by
    frame."""
    for i in range(ll.shape[0]):
        alpha, alpha_end = viterbi_step_plain(alpha, alpha_end, ll[i], dev, num_frames, t0 + i,
                                              acwt, rspec, packed,
                                              None if bps is None else bps[i])
    return alpha, alpha_end


def require(device: torch.device, *checks) -> None:
    """Raise unless every ``(name, tensor, dtype)`` is a contiguous tensor of
    that dtype on ``device``."""
    for name, x, dtype in checks:
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name}: need contiguous {dtype} on {device}, "
                             f"got {x.dtype} on {x.device}")


def launch_k3(alpha: torch.Tensor, ll: torch.Tensor, dev: EmitPlanDev,
              num_frames: torch.Tensor, t0: int, acwt: float, *, alpha_end=None, bps=None,
              final_eff=None, slab=None, count: str = "viterbi_step") -> torch.Tensor:
    """K3 over the W = ``ll.shape[0]`` frames of ``ll`` [W, P, B] from
    ``alpha`` [S+1, B] in one launch (cooperative when W > 1).  Returns
    alpha after the window (a new tensor).  ``alpha_end`` [S+1, B] is
    updated in place; ``bps`` [W, S+1, B] gets the frames' backpointers.
    With ``final_eff`` [S+1, B] and ``slab`` [W, S+1, B] the window runs in
    reverse as the lattice's backward pass: each frame relaxes beta_eff =
    (t + 1 == nf ? final_eff : beta) and stores it in ``slab``."""
    s1, b = alpha.shape
    w = ll.shape[0]
    r, d = dev.row_w.shape
    f32, i32 = torch.float32, torch.int32
    device = alpha.device
    require(device, ("alpha", alpha, f32), ("ll", ll, f32), ("row_w", dev.row_w, f32),
            ("row_src", dev.row_src, i32), ("row_pdf", dev.row_pdf, i32),
            ("row_start", dev.row_start, i32), ("row_real", dev.row_real, torch.uint8),
            ("num_frames", num_frames, i32))
    if (ll.dim() != 3 or ll.shape[2] != b or num_frames.shape != (b,)
            or dev.row_start.shape != (s1 + 1,) or dev.row_src.shape != (r * d,)
            or dev.row_pdf.shape != (r,) or dev.row_real.shape != (r,)):
        raise ValueError("viterbi_step: inconsistent shapes")
    ptrs = []
    for name, x, dtype, shape in (("alpha_end", alpha_end, f32, (s1, b)),
                                  ("final_eff", final_eff, f32, (s1, b)),
                                  ("slab", slab, f32, (w, s1, b))):
        if x is not None:
            require(device, (name, x, dtype))
            if x.shape != shape:
                raise ValueError(f"{name}: need shape {shape}, got {tuple(x.shape)}")
        ptrs.append(None if x is None else x.data_ptr())
    if alpha_end is not None and alpha_end.data_ptr() == alpha.data_ptr():
        raise ValueError("alpha_end must not share memory with alpha")
    bp_bytes, bp_ptr = 0, None
    if bps is not None:
        if (bps.shape != (w, s1, b) or bps.dtype not in (torch.uint8, torch.int16)
                or bps.device != device or not bps.is_contiguous()):
            raise ValueError(f"bps: need contiguous uint8 or int16 {(w, s1, b)} on {device}")
        bp_bytes, bp_ptr = bps.element_size(), bps.data_ptr()
    if w == 0:
        return alpha
    bufs = [torch.empty_like(alpha) for _ in range(min(w, 2))]
    _build.launch("viterbi_step", alpha.data_ptr(), bufs[0].data_ptr(),
                  bufs[-1].data_ptr() if w > 1 else None, ptrs[0], bp_ptr, bp_bytes,
                  ll.data_ptr(), dev.row_start.data_ptr(), dev.row_src.data_ptr(),
                  dev.row_w.data_ptr(), dev.row_pdf.data_ptr(), dev.row_real.data_ptr(),
                  num_frames.data_ptr(), ptrs[1], ptrs[2], t0, w, acwt, s1, b, ll.shape[1], d,
                  int(slab is not None), _MAX_GRID_BLOCKS, stream_handle(device), count=count)
    return bufs[(w - 1) % 2]  # frame k of the launch writes bufs[k % 2]


def viterbi_window(alpha: torch.Tensor, alpha_end: torch.Tensor, ll: torch.Tensor,
                   dev: EmitPlanDev, num_frames: torch.Tensor, t0: int, acwt: float,
                   rspec: tuple, packed: bool, bps: Optional[torch.Tensor] = None):
    """K3 over a window: frames t0 .. t0+W-1 of ``ll`` [W, P, B] in ONE
    launch.  alpha, alpha_end [S+1, B] f32; num_frames [B] int32; ``bps`` an
    optional [W, S+1, B] backpointer table to fill.

    Returns (alpha, alpha_end) after the window.  On CUDA ``alpha_end`` is
    updated in place and returned; it must not share memory with ``alpha``."""
    if alpha.device.type == "cpu":
        return viterbi_window_plain(alpha, alpha_end, ll, dev, num_frames, t0, acwt, rspec,
                                    packed, bps)
    if alpha.device.type != "cuda":
        raise ValueError(f"unsupported device {alpha.device}")
    if bps is not None and bps.dtype != _bp_dtype(packed):
        raise ValueError(f"bps: need {_bp_dtype(packed)} codes for this plan")
    return launch_k3(alpha, ll, dev, num_frames, t0, acwt, alpha_end=alpha_end,
                     bps=bps), alpha_end


def viterbi_step(alpha: torch.Tensor, alpha_end: torch.Tensor, ll_t: torch.Tensor,
                 dev: EmitPlanDev, num_frames: torch.Tensor, t: int, acwt: float,
                 rspec: tuple, packed: bool, bp_out: Optional[torch.Tensor] = None):
    """One frame of the Viterbi relaxation (K3 with W = 1).  alpha,
    alpha_end [S+1, B] f32; ll_t [P, B] f32; num_frames [B] int32; ``bp_out``
    an optional [S+1, B] slice of the backpointer table to fill.

    Returns (alpha, alpha_end) after frame ``t``.  On CUDA ``alpha_end`` is
    updated in place and returned; it must not share memory with ``alpha``."""
    if alpha.device.type == "cpu":
        return viterbi_step_plain(alpha, alpha_end, ll_t, dev, num_frames, t, acwt,
                                  rspec, packed, bp_out)
    if alpha.device.type != "cuda":
        raise ValueError(f"unsupported device {alpha.device}")
    if ll_t.dim() != 2:
        raise ValueError("viterbi_step: inconsistent shapes")
    return viterbi_window(alpha, alpha_end, ll_t[None], dev, num_frames, t, acwt, rspec,
                          packed, None if bp_out is None else bp_out[None])


def prune(alpha: torch.Tensor, beam: float, max_active: int = 0, dim: int = 1) -> torch.Tensor:
    """Keep the states (along ``dim``) within ``beam`` of each utterance's
    best, and at most ``max_active`` of them; the rest become NEG_INF."""
    best = alpha.amax(dim=dim, keepdim=True)
    out = torch.where(alpha >= best - beam, alpha, NEG_INF)
    if max_active and max_active < out.shape[dim]:
        kth = torch.topk(out, max_active, dim=dim).values.narrow(dim, max_active - 1, 1)
        out = torch.where(out >= kth, out, NEG_INF)
    return out


def viterbi_scan(dev: EmitPlanDev, alpha, alpha_end, ll: torch.Tensor,
                 num_frames: torch.Tensor, t0: int, acwt: float, rspec: tuple,
                 packed: bool, with_bp: bool = True, beam: Optional[float] = None,
                 max_active: int = 0):
    """Forward Viterbi over a block of frames, resuming from
    (alpha, alpha_end) at absolute frame ``t0``.

    ll [W, P, B] frame-major, batch-minor; num_frames [B] int32.  Without a
    ``beam`` the search is exact and the block is one ``viterbi_window``;
    with one, every frame's scores are pruned (``prune``) after its
    ``viterbi_step``.  Returns
    ((alpha, alpha_end), bps [W, S+1, B] or None when ``with_bp`` is
    False)."""
    w = ll.shape[0]
    bps = (torch.empty((w,) + tuple(alpha.shape), dtype=_bp_dtype(packed),
                       device=alpha.device) if with_bp else None)
    if beam is None:
        return viterbi_window(alpha, alpha_end, ll, dev, num_frames, t0, acwt, rspec, packed,
                              bps), bps
    for i in range(w):
        alpha, alpha_end = viterbi_step(alpha, alpha_end, ll[i], dev, num_frames,
                                        t0 + i, acwt, rspec, packed,
                                        None if bps is None else bps[i])
        if beam is not None:
            # lanes past their end kept their (already pruned) scores
            alpha = torch.where((t0 + i < num_frames)[None, :],
                                prune(alpha, beam, max_active, dim=0), alpha)
            alpha_end = torch.where((t0 + i + 1 == num_frames)[None, :], alpha, alpha_end)
    return (alpha, alpha_end), bps


def backtrace_scan_plain(row_start, row_src_flat, row_arc_flat, d: int, bps: torch.Tensor,
                         end_state: torch.Tensor, num_frames: torch.Tensor, t0: int):
    """Plain version of ``backtrace_scan``: the JAX package's scan as a loop
    over the block's frames, last first.

    bps [W, S+1, B] winner codes.  Returns the global codes ``row * D +
    slot`` [W, B] int32 in forward frame order (-1 where inactive), their arc
    ids ``row_arc[code]`` [W, B] int32 (-1 where inactive, and at a pad slot)
    and the state [B] int32 at the block start."""
    w, _, b = bps.shape
    bidx = torch.arange(b, device=bps.device)
    active = (t0 + torch.arange(w, device=bps.device))[:, None] < num_frames[None, :]
    codes = torch.empty((w, b), dtype=torch.int32, device=bps.device)
    arcs = torch.empty_like(codes)
    s = end_state.long()
    for i in range(w - 1, -1, -1):
        gcode = row_start[s].long() * d + bps[i, s, bidx].long()
        codes[i] = torch.where(active[i], gcode, -1)
        arcs[i] = torch.where(active[i], row_arc_flat[gcode].long(), -1)
        s = torch.where(active[i], row_src_flat[gcode].long(), s)
    return codes, arcs, s.to(torch.int32)


def backtrace_scan(dev: EmitPlanDev, bps: torch.Tensor, end_state: torch.Tensor,
                   num_frames: torch.Tensor, t0: int):
    """Backtrace over one block's backpointers (frames [t0, t0+W)), from
    ``end_state`` [B] (plan space) at frame t0+W-1.  bps [W, S+1, B] uint8
    or int16 codes; num_frames [B] int32.  Returns (codes [W, B] int32,
    arcs [W, B] int32, state [B] int32 at the block start), as
    ``backtrace_scan_plain``.

    On CUDA it is one launch of ``backtrace_best`` (``csrc/backtrace.cu``), a
    warp per lane, its threads reading the state's row slots beside its
    code."""
    d = dev.row_w.shape[1]
    if bps.device.type == "cpu":
        return backtrace_scan_plain(dev.row_start, dev.row_src, dev.row_arc, d, bps, end_state,
                                    num_frames, t0)
    if bps.device.type != "cuda":
        raise ValueError(f"unsupported device {bps.device}")
    w, s1, b = bps.shape
    i32 = torch.int32
    require(bps.device, ("end_state", end_state, i32), ("num_frames", num_frames, i32),
            ("row_start", dev.row_start, i32), ("row_src", dev.row_src, i32),
            ("row_arc", dev.row_arc, i32))
    if (bps.dtype not in (torch.uint8, torch.int16) or not bps.is_contiguous()
            or end_state.shape != (b,) or num_frames.shape != (b,)
            or dev.row_start.shape != (s1 + 1,) or dev.row_arc.shape != dev.row_src.shape):
        raise ValueError("backtrace_scan: inconsistent shapes or dtypes")
    codes = torch.empty((w, b), dtype=i32, device=bps.device)
    arcs = torch.empty_like(codes)
    state = torch.empty(b, dtype=i32, device=bps.device)
    _build.launch("backtrace_best", bps.data_ptr(), bps.element_size(), dev.row_start.data_ptr(),
                  dev.row_src.data_ptr(), dev.row_arc.data_ptr(), end_state.data_ptr(),
                  num_frames.data_ptr(), t0, w, s1, b, d, codes.data_ptr(), arcs.data_ptr(),
                  state.data_ptr(), stream_handle(bps.device))
    return codes, arcs, state


def oseq_nonempty(graph: DenseGraph) -> np.ndarray:
    """[len(oseqs)] bool: the output sequence holds a word."""
    return np.fromiter((len(o) > 0 for o in graph.oseqs), dtype=bool, count=len(graph.oseqs))


def arc_words(graph: DenseGraph, arcs: np.ndarray, nonempty: np.ndarray) -> list:
    """The words along ``arcs``, looked up only for arcs whose output
    sequence holds one (``nonempty``: ``oseq_nonempty(graph)``)."""
    words: list = []
    oseq = graph.arc_oseq[arcs]
    for o in oseq[nonempty[oseq]]:
        words.extend(graph.oseqs[o])
    return words


def select_end_state(alpha_end: torch.Tensor, final_score: torch.Tensor):
    """End-state choice as the reference's ``FindBestPath``: final-weighted
    scores when any final state is reachable, else the best non-final score.
    ``final_score`` must be in PLAN space.  Returns (end_state [B] plan
    space, score [B], use_final [B], has_path [B])."""
    s_real = final_score.shape[0]
    ae = alpha_end[:s_real]
    total = ae + final_score[:, None]
    best_final = total.amax(dim=0)
    best_any = ae.amax(dim=0)
    use_final = best_final > NEG_INF / 2
    has_path = best_any > NEG_INF / 2
    end_state = torch.where(use_final, total.argmax(dim=0), ae.argmax(dim=0))
    score = torch.where(use_final, best_final, best_any)
    return end_state, score, use_final, has_path


def decode_best_path(graph: DenseGraph, plan: EmitPlan, dev: EmitPlanDev,
                     loglikes: torch.Tensor, num_frames, acoustic_scale: float,
                     bp_bytes_budget: Optional[int] = None, window: Optional[int] = None,
                     beam: Optional[float] = None, max_active: int = 0) -> list[dict]:
    """Full 1-best decode: forward + device backtrace + host assembly.

    loglikes [B, T, P] on the decode device; returns
    [{"tids", "words", "score", "arcs"}] per utterance.

    When the backpointer table ``T * (S+1) * B`` would exceed
    ``bp_bytes_budget`` (default: half the memory free on the device), the
    decode switches to checkpoint/recompute: pass 1 runs the forward without
    backpointers, keeping one [S+1, B] alpha snapshot per block; pass 2 walks
    the blocks in reverse, recomputing each block's forward with
    backpointers from its snapshot and backtracing it at once, so at most one
    block's table is resident.  Blocks carry ``alpha`` forward and the
    backtrace walks them in reverse.  ``window`` forces that mode with blocks
    of ``window`` frames; ``beam``/``max_active`` prune every frame's scores
    (the search is exact without them)."""
    device = loglikes.device
    b, t_total, p = loglikes.shape
    if plan.num_rows and int(plan.row_pdf.max()) >= p:
        raise ValueError(f"the graph uses pdf {int(plan.row_pdf.max())}, "
                         f"loglikes have only {p}")
    nf_np = np.asarray(num_frames).astype(np.int32)
    nf = torch.from_numpy(nf_np).to(device)
    alpha0 = torch.from_numpy(np.concatenate(
        [graph.alpha0[plan.sperm[:-1]], [NEG_INF]]).astype(np.float32)).to(device)
    acwt = float(np.float32(acoustic_scale))
    s1 = plan.num_states + 1
    rspec = plan.rspec

    alpha = alpha0[:, None].expand(s1, b).contiguous()
    alpha_end = torch.where((nf == 0)[None, :], alpha, torch.full_like(alpha, NEG_INF))
    bp_width = 1 if plan.packed else 2
    if bp_bytes_budget is None:
        bp_bytes_budget = free_bytes(device) // 2
    recompute = t_total * s1 * b * bp_width > bp_bytes_budget
    step_t = max(t_total, 1)
    if window is not None:
        recompute, step_t = True, max(1, int(window))
    elif recompute:
        # a block length that keeps one resident [W, S+1, B] table in budget
        step_t = max(16, min(t_total, bp_bytes_budget // (s1 * b * bp_width)))
    ll = loglikes.permute(1, 2, 0).contiguous()  # [T, P, B]: coalesced per frame

    chunks = []  # (lo, bps) in keep mode; (lo, alpha_snap) in recompute mode
    for lo in range(0, t_total, step_t):
        if recompute:
            # alpha_at_end never feeds back into the recursion, so pass 2
            # runs with a scratch one: only alpha is snapshotted
            chunks.append((lo, alpha))
            (alpha, alpha_end), _ = viterbi_scan(
                dev, alpha, alpha_end, ll[lo:lo + step_t], nf, lo, acwt, rspec,
                plan.packed, with_bp=False, beam=beam, max_active=max_active)
        else:
            (alpha, alpha_end), bps = viterbi_scan(
                dev, alpha, alpha_end, ll[lo:lo + step_t], nf, lo, acwt, rspec,
                plan.packed, beam=beam, max_active=max_active)
            chunks.append((lo, bps))

    final_plan = torch.from_numpy(graph.final_score[plan.sperm[:-1]]).to(device)
    end_dev, score_dev, use_final_dev, has_path_dev = select_end_state(alpha_end, final_plan)
    end_state = end_dev.cpu().numpy()  # plan space
    scores = score_dev.cpu().numpy().astype(np.float64)
    use_final = use_final_dev.cpu().numpy()
    has_path = has_path_dev.cpu().numpy()
    end_orig = plan.sperm[end_state]  # graph space, for oseq lookups

    state = end_dev.to(torch.int32)
    arc_parts = []
    for lo, item in reversed(chunks):
        if recompute:
            _, bps = viterbi_scan(dev, item, torch.full_like(item, NEG_INF),
                                  ll[lo:lo + step_t], nf, lo, acwt, rspec, plan.packed,
                                  beam=beam, max_active=max_active)
        else:
            bps = item
        _codes, arcs_c, state = backtrace_scan(dev, bps, state, nf, lo)
        del bps  # recompute mode: at most one block's table resident
        arc_parts.append(arcs_c.cpu().numpy())
    arcs_all = (np.concatenate(arc_parts[::-1], axis=0) if arc_parts
                else np.zeros((0, b), np.int32))

    nonempty = oseq_nonempty(graph)
    out = []
    for i in range(b):
        n = int(nf_np[i])
        arcs = arcs_all[:n, i]
        if not has_path[i] or (arcs < 0).any():
            out.append({"tids": [], "words": [], "score": -np.inf, "arcs": []})
            continue
        start_s = int(graph.arc_src[arcs[0]]) if n else int(end_orig[i])
        words = list(graph.oseqs[graph.start_oseq[start_s]])
        words.extend(arc_words(graph, arcs, nonempty))
        if use_final[i]:
            words.extend(graph.oseqs[graph.final_oseq[end_orig[i]]])
        out.append({
            "tids": graph.arc_tid[arcs].tolist(),
            "words": words,
            "score": float(scores[i]),
            "arcs": arcs.tolist(),
        })
    return out
