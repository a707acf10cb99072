"""Alignment engine: batched Viterbi alignment over training graphs.

Port of ``voicebridge_tpu/steps/align.py`` (counterparts:
``gmm-align-compiled`` / ``align-equal-compiled``).  All utterances of a
sub-batch advance together through their own graphs.  Exact alignment over
banded training graphs goes through K4 (``ops/align_band.py``): one forward
launch and one backtrace launch per sub-batch, with emissions from K2
(``ops/gmm_kernel.py``).  Graph sets that are not banded, or a finite beam,
go to the generic aligner (``ops/viterbi.py``, ``csrc/viterbi_generic.cu``):
one forward launch and one backtrace launch per sub-batch too.

Sub-batches are sized from the memory free on the device; the band plan and
the generic aligner's plan are each built and moved to the device once per
``AlignmentSet``, and a sub-batch takes its rows of them on the device.

Two entry points share the sub-batch loop and the search, and differ in
what reaches the host: ``align_feats`` assembles a dict per utterance
(transition ids, words, score, arcs); ``align_feats_to_tids``, what training
reads, has the frames' transition ids written on the device (K4 through the
band plan's ``tid_of``, the generic aligner's arcs through a gather) and
reads back one ``[B, T]`` block and the ok flags a sub-batch, which numpy
scatters into the caller's ``tids`` and ``weights``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fst.core import Fst
from ..models.transition import TransitionModel
from ..utils.logging import get_logger

from ..device import free_bytes, ieee_fp32_entry, resolve_device
from ..ops import align_band as AB
from ..ops import gmm_kernel
from ..ops import viterbi as V
from ..ops.gmm_kernels import GmmParams, pack_gmm
from ..utils import profiling

log = get_logger()

_UNSET = object()

# Beams at or above this are treated as "no pruning": alignment routes to the
# exact banded kernel when the graph set fits the banded form; below it the
# pruned generic aligner is used.
_NO_PRUNE_BEAM = 1e8


def _banded_search(plan: AB.BandPlanDev, loglikes: torch.Tensor, nf_np: np.ndarray,
                   acoustic_scale: float, by_tid: bool = False) -> tuple:
    """K4's forward and backtrace: (arcs [T, B], end state in band space,
    ok, score), on the device; ``by_tid``: transition ids (``plan.tid_of``)
    in place of the arcs."""
    nf = torch.from_numpy(nf_np).to(loglikes.device)
    alpha_end, bps = AB.viterbi_forward_banded(
        plan.W, plan.pdf, plan.alpha0, loglikes.contiguous(), nf, acoustic_scale,
        plan.offsets, plan.pdf_range)
    arcs, end_b, ok, score = AB.backtrace_banded(alpha_end, plan.final, bps, nf, plan.offsets,
                                                 plan.tid_of if by_tid else plan.arc_of)
    return arcs, end_b, ok, score


def _generic_search(plan: V.GenericPlanDev, loglikes: torch.Tensor, nf_np: np.ndarray,
                    acoustic_scale: float, beam: float) -> tuple:
    """The generic aligner's forward and backtrace (one launch each on
    CUDA): (arcs [T, B], end state, ok, score), on the device."""
    nf = torch.from_numpy(nf_np).to(loglikes.device)
    alpha_end, bps, codes = V.generic_forward(plan, loglikes.contiguous(), nf, acoustic_scale,
                                              beam)
    arcs, ok, end_state, score = V.generic_backtrace(plan, alpha_end, bps, codes, nf)
    return arcs, end_state, ok, score


def _read_back(found: tuple) -> tuple:
    """A search's four results on the host, as numpy: the host waits here
    for the sub-batch's device work."""
    return tuple(profiling.to_host(x, name).numpy()
                 for x, name in zip(found, ("align_arcs", "align_end", "align_ok",
                                            "align_score")))


def _read_pinned(x: torch.Tensor, name: str) -> np.ndarray:
    """``x`` on the host as numpy, a recorded read (``sync.<name>``); from
    CUDA through page-locked memory, in one copy."""
    if x.device.type != "cuda":
        return profiling.to_host(x, name).numpy()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    with profiling.host_wait(name, x.numel() * x.element_size()):
        out.copy_(x)
    return out.numpy()


def padded_tids(graphs: list) -> np.ndarray:
    """[B, A] int32: each graph's arc transition ids, 0 past its arcs
    (``pad_graphs``'s ``arc_tid``)."""
    n = np.asarray([g.num_arcs for g in graphs], np.int64)
    out = np.zeros((len(graphs), int(n.max(initial=0))), np.int32)
    out[np.arange(out.shape[1]) < n[:, None]] = np.concatenate(
        [np.asarray(g.arc_tid, np.int32) for g in graphs] or [np.zeros(0, np.int32)])
    return out


def _assemble(graphs: list, host: tuple, nf_np: np.ndarray,
              n2o: np.ndarray | None = None) -> list:
    """Per-utterance results from a search's host copies; ``n2o`` maps a
    band plan's end states to the graphs' own."""
    arcs, end, ok, score = host
    if n2o is not None:
        end = np.maximum(n2o[np.arange(len(graphs)), end], 0)
    return V.assemble_batched_results(graphs, arcs, ok, end, score, nf_np)


def align_banded(plan: AB.BandPlan | AB.BandPlanDev, graphs: list, loglikes: torch.Tensor,
                 num_frames, acoustic_scale: float):
    """Exact banded alignment (K4) of ``graphs`` under ``plan``, assembled
    per utterance.  loglikes [B, T, P] on the alignment device."""
    if isinstance(plan, AB.BandPlan):
        plan = AB.plan_to_device(plan, loglikes.device)
    nf_np = np.asarray(num_frames, np.int32)
    host = _read_back(_banded_search(plan, loglikes, nf_np, acoustic_scale))
    return _assemble(graphs, host, nf_np, plan.n2o)


def _align_generic(plan: V.GenericPlanDev, graphs: list, loglikes: torch.Tensor, num_frames,
                   acoustic_scale: float, beam: float):
    """Generic alignment (one forward and one backtrace launch on CUDA) of
    ``graphs`` under ``plan`` (their rows of the set's plan), assembled per
    utterance.  loglikes [B, T, P] on the plan's device."""
    nf_np = np.asarray(num_frames, np.int32)
    host = _read_back(_generic_search(plan, loglikes, nf_np, acoustic_scale, beam))
    return _assemble(graphs, host, nf_np)


class AlignmentSet:
    """Per-utterance dense training graphs aligned in sub-batches on one
    device."""

    def __init__(self, graphs: list[V.DenseGraph], *, device=None):
        self.graphs = graphs
        self.device = resolve_device(device)
        self._generic_dev = None
        self._tid_dev = None
        self._band = _UNSET
        self._band_dev = None
        self.band_refusal: str | None = None  # why build_band_plan refused the set

    @property
    def band(self) -> AB.BandPlan | None:
        """Banded plan, or None when the graph set doesn't fit the banded
        form (wide band / non-dst-pure pdfs)."""
        if self._band is _UNSET:
            why: list = []
            self._band = (AB.build_band_plan(self.graphs, reason=why)
                          if self.graphs else None)
            if self._band is None and self.graphs:
                self.band_refusal = why[0] if why else "unknown"
                log.info("alignment: graphs not banded-friendly (%s), using "
                         "the generic aligner for the whole batch", self.band_refusal)
        return self._band

    @property
    def aligner(self) -> str:
        """Which aligner exact alignment of this set takes, and why."""
        if self.band is not None:
            return "banded (K4)"
        return f"generic (build_band_plan refused the set: {self.band_refusal})"

    @property
    def band_dev(self) -> AB.BandPlanDev | None:
        """The band plan on the device, moved there once, with its
        transition-id table (``tid_of``)."""
        if self._band_dev is None and self.band is not None:
            self._band_dev = AB.plan_to_device(self.band, self.device,
                                               arc_tid=padded_tids(self.graphs))
        return self._band_dev

    @property
    def generic_dev(self) -> V.GenericPlanDev:
        """The generic aligner's plan of the whole set on the device, built
        once."""
        if self._generic_dev is None:
            self._generic_dev = V.generic_plan_to_device(self.graphs, self.device)
        return self._generic_dev

    @property
    def tid_dev(self) -> torch.Tensor:
        """[B, A] int32: the graphs' arc transition ids on the device
        (``padded_tids``), moved there once; the generic aligner's arcs
        are mapped through it."""
        if self._tid_dev is None:
            self._tid_dev = torch.from_numpy(padded_tids(self.graphs)).to(self.device)
        return self._tid_dev

    @classmethod
    def from_fsts(cls, fsts: list[Fst], trans_model: TransitionModel, *,
                  device=None) -> "AlignmentSet":
        tid2pdf = trans_model.tid2pdf
        return cls([V.compile_dense_graph(f, tid2pdf) for f in fsts], device=device)

    def align(self, loglikes, num_frames, acoustic_scale: float = 1.0,
              beam: float = 1e9):
        """loglikes [B, T, P]; returns one alignment dict per utterance
        (``tids``, ``words``, ``score``, ``arcs``).  beam >= 1e8 routes to the
        exact banded kernel when the graphs fit the banded form."""
        loglikes = torch.as_tensor(loglikes, dtype=torch.float32).to(self.device)
        num_frames = np.asarray(num_frames, np.int32)
        if beam >= _NO_PRUNE_BEAM and self.band is not None:
            return align_banded(self.band_dev, self.graphs, loglikes, num_frames,
                                acoustic_scale)
        return _align_generic(self.generic_dev, self.graphs, loglikes, num_frames,
                              acoustic_scale, beam)

    def _batch_chunk(self, t: int, num_pdfs: int, dim: int, s_pad: int) -> int:
        """Utterances per sub-batch so that its loglikes, features,
        backpointers and byte codes take at most a quarter of the free device
        memory."""
        per_utt = t * (4 * (num_pdfs + dim) + 9 * s_pad)
        return max(1, free_bytes(self.device) // (4 * max(per_utt, 1)))

    def _searches(self, params: GmmParams, feats, num_frames, acoustic_scale: float,
                  beam: float, by_tid: bool):
        """The sub-batch loop of ``align_feats`` and ``align_feats_to_tids``:
        loglikes through K2, then the banded (K4) or generic aligner, the
        utterances in order of decreasing length.  Yields, a sub-batch,
        (idx, frame counts, (ids [T, B_c], end state, ok, score) on the
        device, the band plan's ``n2o`` or None); the ids are arc ids, or
        with ``by_tid`` transition ids (-1 where none in both)."""
        with profiling.span("align.prepare"):
            feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
            num_frames = np.asarray(num_frames, np.int32)
            s_max = max(g.num_states for g in self.graphs)
            band = self.band if beam >= _NO_PRUNE_BEAM else None
            plan = self.generic_dev if band is None else None  # on the device before sizing
            b_chunk = self._batch_chunk(int(num_frames.max()), params.num_pdfs,
                                        feats.shape[2], s_max + 1)
            order = np.argsort(-num_frames, kind="stable")
        for lo in range(0, len(self.graphs), b_chunk):
            idx = order[lo: lo + b_chunk]
            nf_c = num_frames[idx]
            profiling.count("align.sub_batches")
            profiling.count("align.utterances", len(idx))
            with profiling.span("align.loglikes"):
                t_c = max(1, int(nf_c.max()))
                i_dev = torch.from_numpy(idx).to(self.device)
                ll = gmm_kernel.loglikes_batch(feats[i_dev, :t_c].contiguous(), params)
            with profiling.span("align.search"):
                if band is not None:
                    sub = self.band_dev.take(idx)
                    found = _banded_search(sub, ll, nf_c, acoustic_scale, by_tid)
                else:
                    sub = None
                    found = _generic_search(plan.take(idx), ll, nf_c, acoustic_scale, beam)
                    if by_tid:
                        arcs = found[0]
                        tid = torch.gather(self.tid_dev[i_dev], 1, arcs.t().clamp(min=0).long())
                        found = (torch.where(arcs >= 0, tid.t(), -1),) + found[1:]
            yield idx, nf_c, found, None if sub is None else sub.n2o

    def align_feats(self, params: GmmParams, feats, num_frames,
                    acoustic_scale: float = 1.0, beam: float = 1e9):
        """Alignment from features: loglikes per sub-batch through K2, then
        the banded (K4) or generic aligner, assembled per utterance (as
        ``align``).  ``params`` is a packed GMM (``ops/gmm_kernels.pack_gmm``)
        on the alignment device; feats [B, T, D] (tensor or array).
        Sub-batches take the utterances in order of decreasing length."""
        results: list = [None] * len(self.graphs)
        if not self.graphs:
            return results
        for idx, nf_c, found, n2o in self._searches(params, feats, num_frames, acoustic_scale,
                                                    beam, by_tid=False):
            with profiling.span("align.to_host"):
                host = _read_back(found)
            with profiling.span("align.assemble"):
                chunk_res = _assemble([self.graphs[i] for i in idx], host, nf_c, n2o)
                for j, i in enumerate(idx):
                    results[int(i)] = chunk_res[j]
        return results

    def align_feats_to_tids(self, params: GmmParams, feats, num_frames, tids: np.ndarray,
                            weights: np.ndarray, stage: str, names: list | None = None,
                            acoustic_scale: float = 1.0, beam: float = 1e9,
                            max_fail_frac: float = 0.5) -> int:
        """``align_feats`` followed by ``apply_alignments``, with the
        transition ids written on the device: ``tids`` and ``weights``
        [B, T] are filled in place with the values those two give (each
        aligned utterance's ids and weight 1 on its frames, zeros elsewhere
        and for a failed utterance), from one ``[B_c, T_c]`` block and the
        ok flags read back a sub-batch.  Failures are accounted as
        ``apply_alignments`` accounts them; returns their number."""
        failed: list = []
        frame = np.arange(weights.shape[1])
        searches = (self._searches(params, feats, num_frames, acoustic_scale, beam, by_tid=True)
                    if self.graphs else ())
        for idx, nf_c, (ids, _end, ok, _score), _n2o in searches:
            profiling.count("align.tid_blocks")
            with profiling.span("align.to_host"):
                # the device turns the [T, B_c] ids into rows, zeros where no id
                block = _read_pinned(torch.where(ok[:, None], ids.t(), 0).clamp_(min=0),
                                     "align_tids")
                good = _read_pinned(ok, "align_ok") & (nf_c > 0)
            with profiling.span("align.assemble"):
                t_c = block.shape[1]
                tids[idx, :t_c] = block
                tids[idx, t_c:] = 0
                weights[idx] = (frame < nf_c[:, None]) & good[:, None]
            failed.append(idx[~good])
        with profiling.span("align.apply"):
            return _account_failures(np.sort(np.concatenate(failed or [np.zeros(0, int)])),
                                     len(self.graphs), stage, names, max_fail_frac)


def _account_failures(failed, total: int, stage: str, names: list | None,
                      max_fail_frac: float) -> int:
    """Each failed utterance (indices ascending) logged by name, a systemic
    failure (> max_fail_frac) aborted (``utils/health.py``), the counter
    ``align.failed``; returns the number of failures."""
    from ..utils.health import FailureTracker

    tracker = FailureTracker(stage, total=total)
    for i in failed:
        tracker.record(names[i] if names else f"utt[{i}]", "no path through training graph")
    tracker.finish(max_fail_frac)
    profiling.count("align.failed", tracker.num_failed)
    return tracker.num_failed


def apply_alignments(results: list, tids: np.ndarray, weights: np.ndarray,
                     num_frames, stage: str, names: list | None = None,
                     max_fail_frac: float = 0.5) -> int:
    """Fill (tids, weights) in place from batched align results, zeroing
    failed utterances; failures are logged per utterance and a systemic
    failure (> max_fail_frac) aborts (``utils/health.py``).  Returns the
    number of failures."""
    tids[:] = 0
    weights[:] = 0.0
    failed = []
    for i, r in enumerate(results):
        if r["tids"]:
            tids[i, : num_frames[i]] = r["tids"]
            weights[i, : num_frames[i]] = 1.0
        else:
            failed.append(i)
    return _account_failures(failed, len(results), stage, names, max_fail_frac)


def equal_align(graph: V.DenseGraph, num_frames: int, seed: int = 0):
    """Evenly-spread initial alignment (align-equal-compiled): a RANDOM
    successful path through the graph, padded with self-loops distributed
    evenly.  Returns the arc index of every frame, or None if impossible.
    Host numpy, identical to the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    by_src: dict[int, list[int]] = {}
    for i, s in enumerate(graph.arc_src):
        by_src.setdefault(int(s), []).append(i)
    # self-loop arc per state (prefer the max-score one)
    self_loop: dict[int, int] = {}
    for i in range(graph.num_arcs):
        s, d = int(graph.arc_src[i]), int(graph.arc_dst[i])
        if s == d and (s not in self_loop or
                       graph.arc_score[i] > graph.arc_score[self_loop[s]]):
            self_loop[s] = i

    init = int(np.argmax(graph.alpha0))
    if graph.alpha0[init] <= V.NEG_INF / 2:
        return None
    # reverse BFS: min #arcs from each state to a final state (self-loops
    # excluded) so the random walk never overshoots the frame budget
    radj: dict[int, list[int]] = {}
    for i in range(graph.num_arcs):
        s, d = int(graph.arc_src[i]), int(graph.arc_dst[i])
        if s != d:
            radj.setdefault(d, []).append(s)
    inf = 10 ** 9
    dist_final = np.full(graph.num_states, inf, np.int64)
    frontier = [s for s in range(graph.num_states)
                if graph.final_score[s] > V.NEG_INF / 2]
    for s in frontier:
        dist_final[s] = 0
    while frontier:
        nxt = []
        for d in frontier:
            for s in radj.get(d, ()):  # predecessors
                if dist_final[s] > dist_final[d] + 1:
                    dist_final[s] = dist_final[d] + 1
                    nxt.append(s)
        frontier = nxt
    if dist_final[init] > num_frames:
        return None

    # random walk with feasibility constraint
    path: list[int] = []
    s = init
    budget = num_frames
    while True:
        if graph.final_score[s] > V.NEG_INF / 2 and (
                dist_final[s] == 0 and (budget == 0 or rng.random() < 0.3)):
            break
        choices = [i for i in by_src.get(s, ())
                   if int(graph.arc_dst[i]) != s
                   and dist_final[int(graph.arc_dst[i])] <= budget - 1]
        if not choices:
            if graph.final_score[s] > V.NEG_INF / 2:
                break
            return None
        i = int(choices[rng.integers(len(choices))])
        path.append(i)
        s = int(graph.arc_dst[i])
        budget -= 1

    k = len(path)
    if k > num_frames:
        return None
    extra = num_frames - k
    loop_positions = [i for i, a in enumerate(path)
                      if int(graph.arc_dst[a]) in self_loop]
    if extra > 0 and not loop_positions:
        return None
    frames: list[int] = []
    m = len(loop_positions)
    base, rem = (extra // m, extra % m) if m else (0, 0)
    extras = {}
    for j, pos in enumerate(loop_positions):
        extras[pos] = base + (1 if j < rem else 0)
    for i, a in enumerate(path):
        frames.append(a)
        n_extra = extras.get(i, 0)
        if n_extra:
            frames.extend([self_loop[int(graph.arc_dst[a])]] * n_extra)
    assert len(frames) == num_frames
    return frames


def alignment_to_tids(graph: V.DenseGraph, arc_frames: list[int]) -> list[int]:
    return [int(graph.arc_tid[a]) for a in arc_frames]


@ieee_fp32_entry
def align_utterances(am, trans_model, lang, feats_by_utt: dict, transcripts: dict,
                     acoustic_scale: float = 1.0, boost_silence: float = 1.0,
                     transition_scale: float = 1.0, self_loop_scale: float = 0.1,
                     silence_pdfs: list | None = None, *, device=None) -> dict:
    """AlignSi: align every utterance to its transcript with an existing
    model on ``device``; returns utt -> list[tid]."""
    from ..fst.hclg import TrainingGraphCompiler

    from .train_mono import _batchify

    device = resolve_device(device)
    utts = sorted(feats_by_utt)
    compiler = TrainingGraphCompiler(lang, trans_model.tree, trans_model,
                                     transition_scale, self_loop_scale)
    fsts = compiler.compile_batch([transcripts[u] for u in utts])
    aset = AlignmentSet.from_fsts(fsts, trans_model, device=device)
    feats, nf = _batchify([feats_by_utt[u] for u in utts], device)
    align_am = am
    if boost_silence != 1.0 and silence_pdfs:
        align_am = am.boost_silence(silence_pdfs, boost_silence)
    results = aset.align_feats(pack_gmm(align_am, device), feats, nf,
                               acoustic_scale=acoustic_scale)
    return {u: r["tids"] for u, r in zip(utts, results)}
