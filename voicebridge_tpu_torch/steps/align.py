"""Alignment engine: batched Viterbi alignment over training graphs.

Port of ``voicebridge_tpu/steps/align.py`` (counterparts:
``gmm-align-compiled`` / ``align-equal-compiled``).  All utterances of a
sub-batch advance together through their own graphs.  Exact alignment over
banded training graphs goes through K4 (``ops/align_band.py``): one forward
launch and one backtrace launch per sub-batch, with emissions from K2
(``ops/gmm_kernel.py``).  Graph sets that are not banded, or a finite beam,
go to the plain-torch generic aligner (``ops/viterbi.py``).

Sub-batches are sized from the memory free on the device; the band plan is
moved to the device once per ``AlignmentSet``.
"""

from __future__ import annotations

import numpy as np
import torch

from voicebridge_tpu.fst.core import Fst
from voicebridge_tpu.models.transition import TransitionModel
from voicebridge_tpu.utils.logging import get_logger

from .. import convert
from ..device import free_bytes, resolve_device
from ..ops import align_band as AB
from ..ops import gmm_kernel
from ..ops import viterbi as V
from ..ops.gmm_kernels import GmmParams, pack_gmm

log = get_logger()

_UNSET = object()

# Beams at or above this are treated as "no pruning": alignment routes to the
# exact banded kernel when the graph set fits the banded form; below it the
# pruned generic aligner is used.
_NO_PRUNE_BEAM = 1e8


def align_banded(plan: AB.BandPlan | AB.BandPlanDev, graphs: list, loglikes: torch.Tensor,
                 num_frames, acoustic_scale: float):
    """Exact banded alignment (K4) of ``graphs`` under ``plan``, assembled
    per utterance.  loglikes [B, T, P] on the alignment device."""
    if isinstance(plan, AB.BandPlan):
        plan = AB.plan_to_device(plan, loglikes.device)
    nf_np = np.asarray(num_frames, np.int32)
    nf = torch.from_numpy(nf_np).to(loglikes.device)
    alpha_end, bps = AB.viterbi_forward_banded(
        plan.W, plan.pdf, plan.alpha0, loglikes.contiguous(), nf, acoustic_scale,
        plan.offsets)
    arcs, end_b, ok, score = AB.backtrace_banded(alpha_end, plan.final, bps, nf,
                                                 plan.offsets, plan.arc_of)
    end_b = end_b.cpu().numpy()
    end_orig = plan.n2o[np.arange(len(graphs)), end_b]
    return V.assemble_batched_results(graphs, arcs.cpu().numpy(), ok.cpu().numpy(),
                                      np.maximum(end_orig, 0), score.cpu().numpy(), nf_np)


def _align_generic(padded: dict, graphs: list, loglikes: torch.Tensor, num_frames,
                   acoustic_scale: float, beam: float):
    alpha_end, bps = V.viterbi_forward_batched(
        padded["arc_src"], padded["levels"], padded["arc_pdf"], padded["arc_score"],
        padded["alpha0"], loglikes, num_frames, acoustic_scale, beam,
        padded["num_states"])
    arcs, ok, end_state, score = V.backtrace_batched_device(
        padded["arc_src"], alpha_end, padded["final_score"], bps, num_frames)
    return V.assemble_batched_results(graphs, arcs.cpu().numpy(), ok.cpu().numpy(),
                                      end_state.cpu().numpy(), score.cpu().numpy(),
                                      np.asarray(num_frames))


class AlignmentSet:
    """Per-utterance dense training graphs aligned in sub-batches on one
    device."""

    def __init__(self, graphs: list[V.DenseGraph], *, device):
        self.graphs = graphs
        self.device = resolve_device(device)
        self._padded = None
        self._plans = None
        self._plan_spec = None
        self._band = _UNSET
        self._band_dev = None

    @property
    def band(self) -> AB.BandPlan | None:
        """Banded plan, or None when the graph set doesn't fit the banded
        form (wide band / non-dst-pure pdfs)."""
        if self._band is _UNSET:
            why: list = []
            self._band = (AB.build_band_plan(self.graphs, reason=why)
                          if self.graphs else None)
            if self._band is None and self.graphs:
                log.info("alignment: graphs not banded-friendly (%s), using "
                         "the generic aligner for the whole batch",
                         why[0] if why else "unknown")
        return self._band

    @property
    def band_dev(self) -> AB.BandPlanDev | None:
        """The band plan on the device, moved there once."""
        if self._band_dev is None and self.band is not None:
            self._band_dev = AB.plan_to_device(self.band, self.device)
        return self._band_dev

    @property
    def padded(self) -> dict:
        """Monolithic padded batch for the generic aligner."""
        if self._padded is None:
            self._padded = V.pad_graphs(self.graphs)
        return self._padded

    def _graph_plans(self, s_pad: int):
        if self._plans is None:
            self._plans = [V.build_reduction_plan(g.arc_dst, s_pad) for g in self.graphs]
            self._plan_spec = V.batched_plan_spec(
                self._plans, [g.num_arcs for g in self.graphs])
        return self._plans, self._plan_spec

    @classmethod
    def from_fsts(cls, fsts: list[Fst], trans_model: TransitionModel, *,
                  device) -> "AlignmentSet":
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
        return _align_generic(self.padded, self.graphs, loglikes, num_frames,
                              acoustic_scale, beam)

    def _batch_chunk(self, t: int, num_pdfs: int, dim: int, s_pad: int) -> int:
        """Utterances per sub-batch so that its loglikes, features and
        backpointers take at most a quarter of the free device memory."""
        per_utt = t * (4 * (num_pdfs + dim) + 8 * s_pad)
        return max(1, free_bytes(self.device) // (4 * max(per_utt, 1)))

    def align_feats(self, params: GmmParams, feats, num_frames,
                    acoustic_scale: float = 1.0, beam: float = 1e9):
        """Alignment from features: loglikes per sub-batch through K2, then
        the banded (K4) or generic aligner.  ``params`` is a packed GMM
        (``ops/gmm_kernels.pack_gmm``) on the alignment device; feats
        [B, T, D] (tensor or array).  Sub-batches take the utterances in
        order of decreasing length."""
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        num_frames = np.asarray(num_frames, np.int32)
        b_total = len(self.graphs)
        if b_total == 0:
            return []
        w = convert.kernel_params_from_twin(params)
        s_max = max(g.num_states for g in self.graphs)
        a_max = max(g.num_arcs for g in self.graphs)
        band = self.band if beam >= _NO_PRUNE_BEAM else None
        plans = depth = rows = None
        if band is None:
            plans, (depth, rows) = self._graph_plans(s_max + 1)
        b_chunk = self._batch_chunk(int(num_frames.max()), params.num_pdfs,
                                    feats.shape[2], s_max + 1)
        order = np.argsort(-num_frames, kind="stable")
        results: list = [None] * b_total
        for lo in range(0, b_total, b_chunk):
            idx = order[lo: lo + b_chunk]
            nf_c = num_frames[idx]
            t_c = max(1, int(nf_c.max()))
            ll = gmm_kernel.loglikes_batch(
                feats[torch.from_numpy(idx).to(self.device), :t_c].contiguous(), w)
            graphs_c = [self.graphs[i] for i in idx]
            if band is not None:
                chunk_res = align_banded(self.band_dev.take(idx), graphs_c, ll, nf_c,
                                         acoustic_scale)
            else:
                padded = V.pad_graphs(graphs_c, pad_states=s_max, pad_arcs=a_max,
                                      plans=[plans[i] for i in idx], plan_depth=depth,
                                      plan_rows=rows)
                chunk_res = _align_generic(padded, graphs_c, ll, nf_c, acoustic_scale, beam)
            for j, i in enumerate(idx):
                results[int(i)] = chunk_res[j]
        return results


def apply_alignments(results: list, tids: np.ndarray, weights: np.ndarray,
                     num_frames, stage: str, names: list | None = None,
                     max_fail_frac: float = 0.5) -> int:
    """Fill (tids, weights) in place from batched align results, zeroing
    failed utterances; failures are logged per utterance and a systemic
    failure (> max_fail_frac) aborts (``utils/health.py``).  Returns the
    number of failures."""
    from voicebridge_tpu.utils.health import FailureTracker

    tracker = FailureTracker(stage, total=len(results))
    tids[:] = 0
    weights[:] = 0.0
    for i, r in enumerate(results):
        if r["tids"]:
            tids[i, : num_frames[i]] = r["tids"]
            weights[i, : num_frames[i]] = 1.0
        else:
            tracker.record(names[i] if names else f"utt[{i}]",
                           "no path through training graph")
    tracker.finish(max_fail_frac)
    return tracker.num_failed


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


def align_utterances(am, trans_model, lang, feats_by_utt: dict, transcripts: dict,
                     acoustic_scale: float = 1.0, boost_silence: float = 1.0,
                     transition_scale: float = 1.0, self_loop_scale: float = 0.1,
                     silence_pdfs: list | None = None, *, device) -> dict:
    """AlignSi: align every utterance to its transcript with an existing
    model on ``device``; returns utt -> list[tid]."""
    from voicebridge_tpu.fst.hclg import TrainingGraphCompiler

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
