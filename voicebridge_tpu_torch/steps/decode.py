"""Decoding over a shared HCLG graph: exact batched Viterbi best paths and
lattices.

Port of ``voicebridge_tpu/steps/decode.py`` (``DecodeResult``, and from
``Decoder``: ``_loglikes``, ``decode_batch``, ``decode_sweep``,
``decode_lattice``, ``decode_sweep_lattice``, ``decode_nbest``,
``decode_mbr``).  GMM log-likelihoods come from the K2 wrapper, the forward
relaxation from the K3 wrapper, the lattice survivor test from the K5 wrapper,
the N-best relaxation from the K7 wrapper and both backtraces from the
``backtrace_best`` / ``backtrace_nbest`` wrappers; the tensor's device decides
between kernel and plain version.  ``decode_sweep`` re-runs
the exact search per acoustic scale; ``decode_sweep_lattice`` decodes once
into lattices and rescales them on the host per (LMWT, WIP) grid point, as
the reference's ``score_kaldi_wer.cpp`` does.  ``DecodeOptions.beam`` and
``max_active`` are ignored by the best-path and lattice searches, which are
exact; ``decode_nbest`` prunes with ``beam`` as the JAX package's does.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import DecodeOptions
from ..fst.core import Fst
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel

from ..device import free_bytes, resolve_device
from ..lat import lattice_best_path, lattice_best_path_grid, lattice_mbr
from ..ops import decode_core as DC
from ..ops import gmm_kernel
from ..ops import lattice as LAT
from ..ops import viterbi as V
from ..ops.gmm_kernels import pack_gmm
from ..ops.graph import DenseGraph, compile_dense_graph
from ..utils import profiling


@dataclass
class DecodeResult:
    utt: str
    words: list  # word ids
    score: float
    tids: list = field(default_factory=list)


class Decoder:
    def __init__(self, hclg: Fst, trans_model: TransitionModel, am: AmDiagGmm,
                 opts: DecodeOptions = DecodeOptions(), *, device=None):
        graph = compile_dense_graph(hclg, trans_model.tid2pdf)
        self._setup(graph, DC.build_emit_plan(graph), am, opts, device)

    @classmethod
    def from_dense_graph(cls, graph: DenseGraph, am: AmDiagGmm,
                         opts: DecodeOptions = DecodeOptions(), *, device=None,
                         row_width: int | None = None) -> "Decoder":
        """A decoder over an already epsilon-free graph (``row_width`` fixes
        the plan's row width D instead of deriving it from the graph)."""
        dec = cls.__new__(cls)
        dec._setup(graph, DC.build_emit_plan(graph, d=row_width), am, opts, device)
        return dec

    def _setup(self, graph: DenseGraph, plan: DC.EmitPlan, am: AmDiagGmm,
               opts: DecodeOptions, device) -> None:
        self.device = resolve_device(device)
        self.graph = graph
        self.plan = plan
        self.plan_dev = DC.plan_to_device(plan, self.device)
        self.opts = opts
        self.gmm = pack_gmm(am, self.device)
        self._lat_plans = None  # (bwd_plan, bwd_dev, row_dst), built at first use
        self._nbest_plan = None  # arcs grouped by destination, built at first use

    def with_model(self, am: AmDiagGmm, opts: DecodeOptions) -> "Decoder":
        """A decoder over this one's graph and plans (the lattice plans
        built here first) with another model and options."""
        self.lattice_plans()
        dec = copy.copy(self)
        dec.opts = opts
        dec.gmm = pack_gmm(am, self.device)
        return dec

    def lattice_plans(self) -> tuple:
        """(backward plan, its device copy, each row's destination on the
        device) of the lattice forward-backward, built at first use."""
        if self._lat_plans is None:
            _plan, _fwd_dev, bwd_plan, bwd_dev, row_dst = LAT.build_lattice_plans(
                self.graph, fwd_plan=self.plan, device=self.device)
            self._lat_plans = (bwd_plan, bwd_dev, torch.from_numpy(row_dst).to(self.device))
        return self._lat_plans

    def _loglikes(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> [B, T, P] acoustic log-likelihoods."""
        return gmm_kernel.loglikes_batch(feats, self.gmm)

    def _batch_chunk(self, t: int, d: int) -> int:
        """Utterances per sub-batch so its features and the two [B, T, P]
        loglik layouts take at most a quarter of the free device memory (the
        backpointer table has its own budget in ``decode_best_path``)."""
        per_utt = 4 * t * (2 * self.gmm.num_pdfs + d)
        return max(1, free_bytes(self.device) // (4 * max(per_utt, 1)))

    def decode_batch(self, utts: list[str], feats, num_frames,
                     acoustic_scale: float | None = None,
                     keep_tids: bool = False) -> list[DecodeResult]:
        """feats [B, T, D] padded (tensor or array); per-utterance best paths.

        Search is exact (infinite beam): the dense relaxation touches every
        state each frame regardless, so pruning would save nothing."""
        acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        num_frames = np.asarray(torch.as_tensor(num_frames).cpu())
        b_chunk = self._batch_chunk(feats.shape[1], feats.shape[2])
        out = []
        for lo in range(0, len(utts), b_chunk):
            hi = min(len(utts), lo + b_chunk)
            ll = self._loglikes(feats[lo:hi].contiguous())
            paths = DC.decode_best_path(self.graph, self.plan, self.plan_dev, ll,
                                        num_frames[lo:hi], acoustic_scale=acwt)
            for u, r in zip(utts[lo:hi], paths):
                out.append(DecodeResult(u, r["words"], r["score"],
                                        r["tids"] if keep_tids else []))
        return out

    def decode_sweep(self, utts: list[str], feats, num_frames,
                     lmwts: list[int]) -> dict:
        """Exact best path per LM weight: {lmwt: [DecodeResult]}."""
        return {w: self.decode_batch(utts, feats, num_frames, acoustic_scale=1.0 / w)
                for w in lmwts}

    def _lattice_chunk(self, t: int, d: int) -> int:
        """Utterances per lattice sub-batch so its features, the two [B, T, P]
        loglik layouts and the FB's window residency take at most a quarter
        of the free device memory; the survivors take from the rest."""
        _w, fb_bytes = LAT.lattice_window(t, self.plan.num_states + 1, self.plan.num_rows, 1)
        per_utt = 4 * t * (2 * self.gmm.num_pdfs + d) + fb_bytes
        return max(1, free_bytes(self.device) // (4 * per_utt))

    def decode_lattice(self, utts: list[str], feats, num_frames,
                       acoustic_scale: float | None = None) -> dict:
        """Lattice-generating decode (``gmm-latgen-faster``'s lattice output):
        the row-based forward-backward (``ops/lattice.py``); arcs whose best
        complete path is within ``lattice_beam`` of the best survive.
        Returns {utt: Lattice} with graph and acoustic costs kept apart."""
        with profiling.span("decode_lattice"):
            acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
            feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
            num_frames = np.asarray(profiling.to_host(torch.as_tensor(num_frames),
                                                      "frame_counts"))
            bwd_plan, bwd_dev, row_dst = self.lattice_plans()
            b_chunk = self._lattice_chunk(feats.shape[1], feats.shape[2])
            out = {}
            for lo in range(0, len(utts), b_chunk):
                hi = min(len(utts), lo + b_chunk)
                profiling.count("lattice.sub_batches")
                with profiling.span("lattice.loglikes"):
                    ll = self._loglikes(feats[lo:hi].contiguous())
                surv, _best, _end, use_final = LAT.lattice_forward_backward_rows(
                    self.graph, self.plan, self.plan_dev, bwd_plan, bwd_dev, row_dst, ll,
                    num_frames[lo:hi], acoustic_scale=acwt,
                    lattice_beam=self.opts.lattice_beam)
                with profiling.span("lattice.survivors"):
                    out.update(zip(utts[lo:hi], LAT.survivor_lattices(
                        self.graph, surv, num_frames[lo:hi], use_final, ll)))
            return out

    def decode_sweep_lattice(self, utts: list[str], feats, num_frames, lmwts: list[int],
                             word_ins_penalties: tuple = (0.0,)) -> tuple[dict, dict]:
        """Decode once into lattices at the decoder's acoustic scale, then per
        (LMWT, WIP) grid point rescale, add the word-insertion penalty and
        take the best path on the host (``lattice-scale`` ->
        ``lattice-add-penalty`` -> ``lattice-best-path``,
        ``score_kaldi_wer.cpp:279-356``), the whole grid in one vectorized
        pass per utterance.  Returns ({(lmwt, wip): [DecodeResult]},
        {utt: Lattice})."""
        lats = self.decode_lattice(utts, feats, num_frames)
        grid = [(w, wip) for w in lmwts for wip in word_ins_penalties]
        points = [(1.0, 1.0 / w, wip) for (w, wip) in grid]
        sweep = {gp: [] for gp in grid}
        for u in utts:
            for gp, p in zip(grid, lattice_best_path_grid(lats[u], points)):
                sweep[gp].append(DecodeResult(u, p["words"], p["score"], p["tids"]))
        return sweep, lats

    def _nbest_chunk(self, t: int, d: int, nbest: int) -> int:
        """Utterances per N-best sub-batch so its features, its logliks in
        both layouts ([B, T, P] and K7's [T, P, B]), the [T, S, B, K]
        backpointer tables (5 bytes per entry), four [S, B, K] score tables
        and the walk's [T, B, 4K] arcs, twice (the walk's output and the
        copy gathered for the host), take at most half of the free device
        memory."""
        s = self.graph.num_states
        per_utt = (4 * t * (2 * self.gmm.num_pdfs + d) + 5 * t * s * nbest + 16 * s * nbest
                   + 32 * t * nbest)
        return max(1, free_bytes(self.device) // (2 * per_utt))

    def decode_nbest(self, utts: list[str], feats, num_frames, nbest: int = 4,
                     acoustic_scale: float | None = None,
                     batch_chunk: int | None = None, keep_arcs: bool = False) -> dict:
        """Exact N-best decoding (``lattice-nbest`` role): utt -> list of up
        to ``nbest`` (words, score) hypotheses with distinct arc sequences,
        best first ((words, score, arcs) with ``keep_arcs``).  Every state
        keeps its ``nbest`` best partial paths
        (``ops/viterbi.viterbi_nbest_forward``, K7) with full backpointers,
        so the batch is split by the device's free memory (or into
        sub-batches of ``batch_chunk``); the result does not depend on the
        split."""
        acwt = self.opts.acoustic_scale if acoustic_scale is None else acoustic_scale
        feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
        num_frames = np.asarray(torch.as_tensor(num_frames).cpu())
        if self._nbest_plan is None:
            self._nbest_plan = V.build_nbest_plan(self.graph, self.device)
        b_chunk = batch_chunk or self._nbest_chunk(feats.shape[1], feats.shape[2], nbest)
        out = {}
        for lo in range(0, len(utts), b_chunk):
            hi = min(len(utts), lo + b_chunk)
            ll = self._loglikes(feats[lo:hi].contiguous())
            alpha_end, bp_arc, bp_slot = V.viterbi_nbest_forward(
                self._nbest_plan, self.graph.alpha0, ll, num_frames[lo:hi], acwt,
                self.opts.beam, nbest)
            hyps = V.backtrace_nbest_device(self.graph, alpha_end, bp_arc, bp_slot,
                                            num_frames[lo:hi], nbest, plan=self._nbest_plan)
            del bp_arc, bp_slot  # before the next sub-batch allocates its own
            for u, hs in zip(utts[lo:hi], hyps):
                out[u] = [(h["words"], h["score"]) + ((h["arcs"],) if keep_arcs else ())
                          for h in hs]
        return out

    def decode_mbr(self, utts: list[str], feats, num_frames, nbest: int = 8) -> list[DecodeResult]:
        """MBR consensus decoding over lattices (``lattice-mbr-decode`` role):
        one lattice decode, then a confusion network from each lattice's
        word-unique N best paths."""
        lats = self.decode_lattice(utts, feats, num_frames)
        acwt = self.opts.acoustic_scale
        out = []
        for u in utts:
            words, _conf = lattice_mbr(lats[u], n=nbest, lm_scale=1.0, acoustic_scale=acwt)
            out.append(DecodeResult(u, words, lattice_best_path(lats[u], 1.0, acwt)["score"]))
        return out
