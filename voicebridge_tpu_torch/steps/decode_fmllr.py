"""Two-pass speaker-adapted decoding (fMLLR) from lattice posteriors.

Port of ``voicebridge_tpu/steps/decode_fmllr.py`` (the reference's
``DecodeFmllr``, ``scr/steps/decode_fmllr.cpp``):

  (0) speaker-independent lattice pass with ``final.alimdl``;
  (1) per-speaker fMLLR from the SI-lattice posteriors (``LatticeToPost ->
      WeightSilencePost -> GmmPostToGpost -> GmmEstFmllrGpost``);
  (2) adapted lattice pass with ``final.mdl``;
  (3) second fMLLR estimate from the adapted lattices, as the total
      transform on the base features;
  (4) rescoring of the adapted lattices with the final features
      (``GmmRescoreLattice``), pruned determinization and the best path.

``FmllrDecoder`` holds what every request shares, built once: the graph,
the speaker-independent and the adapted ``Decoder`` (one set of plans) and
the adapted model packed for the statistics.  ``decode_fmllr`` builds one
for a single call.

The lattice passes are ``Decoder.decode_lattice`` (K2, K3, K5), exact as the
JAX package's: the beams of ``FmllrDecodeOptions`` (``beam``,
``first_beam``, ``max_active``, ``first_max_active``) change nothing in
either package; ``lattice_beam`` prunes the lattices.  The fMLLR statistics
and the feature transforms are torch on the card (``transforms/fmllr.py``),
the repeated base features are built there, and stage 4 gathers the
survivors' costs there with int64 ``(utterance, frame, pdf)`` index tensors
in sub-batches sized from the card's free memory.  The posteriors are host
numpy, one forward-backward over all the lattices (``lat.lattice_posts_batch``);
the row solves (``transforms/fmllr.estimate_fmllr_rows``) and the
determinizations (``lat/determinize.py``) native host code, the latter on a
thread per host core (the native calls release the GIL), as
``steps/decode_fmllr.sh`` spreads its ``nj`` jobs.
"""

from __future__ import annotations

import os
import time
from dataclasses import replace

import numpy as np
import torch

from ..config import DecodeOptions, FmllrDecodeOptions
from ..data.lang import Lang
from ..fst.core import Fst
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..utils.logging import get_logger

from ..device import ieee_fp32_entry, resolve_device
from ..lat.determinize import determinize_lattices
from ..lat.lattice import lattice_posts_batch
from ..ops.graph import DenseGraph, compile_dense_graph
from ..transforms.fmllr import acc_fmllr_stats, apply_fmllr_batch, estimate_fmllr_rows
from ..utils import profiling
from .decode import Decoder, DecodeResult

log = get_logger()

K_POST = 4  # posterior entries kept per frame (lattice posteriors are peaky)


def host_threads() -> int:
    """Threads for the determinizations: the host's cores (those this
    process may run on)."""
    return (len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity")
            else os.cpu_count() or 1)


def lattice_posteriors(lats: dict, utts: list, tid2phone: np.ndarray, silence_phones: set,
                       t_max: int, acoustic_scale: float, silence_weight: float):
    """Per-frame top-``K_POST`` (pdf, weight) of each lattice's posteriors
    (``lattice_to_post`` with min_post 0.01, all lattices in one sweep),
    silence down-weighted (WeightSilencePost) -> (pdf ``[B*T*K_POST]``
    int32, weight float32).  Entries are ranked by falling posterior, ties
    in ``lattice_to_post``'s order (a stable sort), as the JAX package's
    per-frame loop ranks them."""
    pdf = np.zeros((len(utts), t_max, K_POST), np.int32)
    w = np.zeros((len(utts), t_max, K_POST), np.float32)
    utt, t, tid, pdf_e, post = lattice_posts_batch([lats[u] for u in utts],
                                                   acoustic_scale=acoustic_scale, min_post=0.01)
    if not len(utt):
        return pdf.reshape(-1), w.reshape(-1)
    order = np.lexsort((-post, t, utt))
    group = (utt * t_max + t)[order]
    first = np.concatenate([[0], np.flatnonzero(np.diff(group)) + 1])
    sizes = np.diff(np.concatenate([first, [len(order)]]))
    rank = np.arange(len(order)) - np.repeat(first, sizes)
    top = rank < K_POST
    sel = order[top]
    sil = np.asarray(sorted(silence_phones), np.int64)
    on_sil = np.isin(tid2phone[tid[sel]], sil)
    pdf[utt[sel], t[sel], rank[top]] = pdf_e[sel]
    w[utt[sel], t[sel], rank[top]] = post[sel] * np.where(on_sil, silence_weight, 1.0)
    return pdf.reshape(-1), w.reshape(-1)


def survivor_index(lats: list, arc_pdf: np.ndarray):
    """(utterance within ``lats``, frame, pdf) of every arc of the lattices,
    in order, as three int64 arrays: no flat index, so nothing wraps however
    large ``len(lats) * T * num_pdfs`` grows."""
    sizes = [lat.num_arcs for lat in lats]
    j = np.repeat(np.arange(len(lats), dtype=np.int64), sizes)
    t = np.concatenate([np.zeros(0, np.int64)] + [lat.arc_t for lat in lats]).astype(np.int64)
    arcs = np.concatenate([np.zeros(0, np.int64)] + [lat.arc_id for lat in lats])
    return j, t, arc_pdf[arcs].astype(np.int64)


def gather_costs(ll: torch.Tensor, j: np.ndarray, t: np.ndarray, pdf: np.ndarray) -> np.ndarray:
    """Acoustic costs ``-ll[j, t, pdf]`` of the listed entries of a loglik
    block ``[B, T, P]``, gathered on its device -> float32 host array."""
    idx = [torch.from_numpy(a).to(ll.device) for a in (j, t, pdf)]
    return profiling.to_host(-ll[idx[0], idx[1], idx[2]], "rescore_costs").numpy()


def rescore_lattices(dec: Decoder, feats: torch.Tensor, utts: list, lats: dict) -> dict:
    """gmm-rescore-lattice: each lattice's acoustic costs from ``dec``'s
    model on ``feats [B, T, D]`` (K2 per sub-batch, the survivors gathered
    on the card) -> {utt: Lattice}."""
    b_chunk = dec._batch_chunk(feats.shape[1], feats.shape[2])
    out = {}
    for lo in range(0, len(utts), b_chunk):
        names = utts[lo:lo + b_chunk]
        ll = dec._loglikes(feats[lo:lo + len(names)].contiguous())
        chunk = [lats[u] for u in names]
        ac = gather_costs(ll, *survivor_index(chunk, dec.graph.arc_pdf))
        del ll
        o = 0
        for u, lat in zip(names, chunk):
            out[u] = replace(lat, acoustic_cost=ac[o:o + lat.num_arcs].copy(), _states={})
            o += lat.num_arcs
    return out


class FmllrDecoder:
    """Two-pass fMLLR decoding over one graph, built once and called per
    batch (``steps/decode_fmllr.sh``'s job over a speaker-complete batch).

    ``hclg`` is an HCLG over ``trans_model``'s transition ids or a graph
    already compiled (``ops/graph.compile_dense_graph``); ``trans_model``
    gives the phones of transition ids (silence down-weighting) and
    ``lang`` the silence phones.  ``mesh`` (``parallel/mesh.make_mesh``)
    routes both fMLLR statistics passes through the data-axis-sharded
    reduction."""

    def __init__(self, hclg: Fst | DenseGraph, trans_model: TransitionModel, am: AmDiagGmm,
                 alimdl: AmDiagGmm, lang: Lang,
                 opts: FmllrDecodeOptions = FmllrDecodeOptions(), mesh=None, *, device=None):
        self.device = resolve_device(device)
        self.opts, self.mesh = opts, mesh
        self.tid2phone = trans_model.tid2phone
        self.silence = set(lang.silence_phone_ids)
        self.graph = (hclg if isinstance(hclg, DenseGraph)
                      else compile_dense_graph(hclg, trans_model.tid2pdf))
        self.si = Decoder.from_dense_graph(self.graph, alimdl, _decode_opts(opts, first=True),
                                           device=self.device)
        self.adapted = self.si.with_model(am, _decode_opts(opts, first=False))
        means, inv_vars = am.means(), am.inv_vars
        if mesh is None:  # on the card once, not per estimate
            means = torch.from_numpy(np.ascontiguousarray(means)).to(self.device)
            inv_vars = torch.from_numpy(np.ascontiguousarray(inv_vars)).to(self.device)
        self.means, self.inv_vars = means, inv_vars

    @ieee_fp32_entry
    def decode(self, utts: list, feats, num_frames, utt2spk: dict, *,
               stage_s: dict | None = None, keep: dict | None = None):
        """feats [B, T, D] padded base features (array or tensor) of ``utts``
        -> (results list[DecodeResult], final transforms ``[S, D, D+1]`` of
        the speakers in sorted order).  ``stage_s``, when given, receives
        each stage's wall seconds; ``keep`` each stage's output
        (``si_lattices``, ``transforms1``, ``adapted1`` (the features of the
        adapted pass), ``adapted_lattices``, ``transforms2``, ``adapted2``,
        ``rescored``)."""
        times = {} if stage_s is None else stage_s
        out = {} if keep is None else keep
        clock = [time.perf_counter()]

        def lap(stage: str) -> None:
            now = time.perf_counter()
            times[stage] = now - clock[0]
            clock[0] = now

        with profiling.span("decode_fmllr"):
            feats = torch.as_tensor(feats, dtype=torch.float32).to(self.device)
            num_frames = np.asarray(profiling.to_host(torch.as_tensor(num_frames),
                                                      "frame_counts"))
            speakers = sorted({utt2spk[u] for u in utts})
            spk_idx = {s: i for i, s in enumerate(speakers)}
            spk_of_utt = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
            profiling.count("fmllr.speakers", len(speakers))
            # ---- stage 0: SI lattice pass with alimdl ---------------------------
            with profiling.span("fmllr.si_lattices"):
                out["si_lattices"] = self.si.decode_lattice(utts, feats, num_frames)
            lap("si_lattices")
            # ---- stage 1: first transforms from SI-lattice posteriors -----------
            out["transforms1"] = self._estimate(out["si_lattices"], utts, feats, spk_of_utt,
                                                len(speakers))
            lap("first_transforms")
            log.info("decode_fmllr: pass-1 transforms for %d speakers", len(speakers))
            # ---- stage 2: adapted lattice decode --------------------------------
            with profiling.span("fmllr.apply"):
                out["adapted1"] = apply_fmllr_batch(feats, out["transforms1"], spk_of_utt,
                                                    device=self.device)
            with profiling.span("fmllr.adapted_lattices"):
                out["adapted_lattices"] = self.adapted.decode_lattice(utts, out["adapted1"],
                                                                      num_frames)
            lap("adapted_lattices")
            # ---- stage 3: second estimate from adapted lattices -----------------
            out["transforms2"] = self._estimate(out["adapted_lattices"], utts, feats,
                                                spk_of_utt, len(speakers))
            with profiling.span("fmllr.apply"):
                out["adapted2"] = apply_fmllr_batch(feats, out["transforms2"], spk_of_utt,
                                                    device=self.device)
            lap("second_transforms")
            # ---- stage 4: rescore + pruned determinization ----------------------
            with profiling.span("fmllr.rescore"):
                out["rescored"] = rescore_lattices(self.adapted, out["adapted2"], utts,
                                                   out["adapted_lattices"])
            lap("rescore")
            with profiling.span("fmllr.determinize"):
                results = self._determinize(utts, out["rescored"])
            lap("determinize")
        return results, out["transforms2"]

    def _estimate(self, lats: dict, utts: list, feats: torch.Tensor, spk_of_utt: np.ndarray,
                  num_speakers: int) -> np.ndarray:
        """Per-speaker transforms ``[S, D, D+1]`` from the lattices'
        posteriors: statistics on the card, row solves on the host."""
        opts = self.opts
        b, t_max, dim = feats.shape
        with profiling.span("fmllr.posteriors"):
            pdf, w = lattice_posteriors(lats, utts, self.tid2phone, self.silence, t_max,
                                        opts.acoustic_scale, opts.silence_weight)
            profiling.count("fmllr.post_entries", int(np.count_nonzero(w)))
        with profiling.span("fmllr.stats"):
            spk_rep = torch.from_numpy(spk_of_utt).to(self.device).repeat_interleave(
                t_max * K_POST)
            base_rep = feats.reshape(b * t_max, dim).repeat_interleave(K_POST, dim=0)
            stats = acc_fmllr_stats(self.adapted.gmm, self.means, self.inv_vars, base_rep, pdf, w,
                                    spk_rep, num_speakers, mesh=self.mesh, device=self.device)
            beta, k, g = (profiling.to_host(x, "fmllr_stats").numpy() for x in stats)
        with profiling.span("fmllr.solve"):
            trans, _imprs = estimate_fmllr_rows(beta, k, g, min_count=opts.fmllr_min_count)
        return trans

    def _determinize(self, utts: list, lats: dict) -> list:
        """Each lattice determinized (the native constructions a thread a
        host core) and its best path."""
        beam, acwt = self.opts.lattice_beam, self.opts.acoustic_scale
        dets = determinize_lattices([lats[u] for u in utts], beam=beam, lm_scale=1.0,
                                    acoustic_scale=acwt, threads=host_threads())
        paths = [clat.best_path(lm_scale=1.0, acoustic_scale=acwt) for clat, _h in dets]
        profiling.count("fmllr.det_states", sum(clat.num_states for clat, _h in dets))
        profiling.count("fmllr.det_retries", sum(h for _c, h in dets))
        return [DecodeResult(u, p["words"], p["score"], p["tids"]) for u, p in zip(utts, paths)]


@ieee_fp32_entry
def decode_fmllr(hclg: Fst | DenseGraph, trans_model: TransitionModel, am: AmDiagGmm,
                 alimdl: AmDiagGmm, lang: Lang, utts: list, feats, num_frames, utt2spk: dict,
                 opts: FmllrDecodeOptions = FmllrDecodeOptions(), mesh=None, *,
                 device=None, stage_s: dict | None = None):
    """One call of ``FmllrDecoder(hclg, trans_model, am, alimdl, lang, opts,
    mesh, device=device).decode(utts, feats, num_frames, utt2spk,
    stage_s=stage_s)``: (results list[DecodeResult], final transforms
    ``[S, D, D+1]`` of the speakers in sorted order)."""
    dec = FmllrDecoder(hclg, trans_model, am, alimdl, lang, opts, mesh, device=device)
    return dec.decode(utts, feats, num_frames, utt2spk, stage_s=stage_s)


def _decode_opts(opts: FmllrDecodeOptions, first: bool) -> DecodeOptions:
    return DecodeOptions(
        beam=opts.first_beam if first else opts.beam,
        max_active=opts.first_max_active if first else opts.max_active,
        acoustic_scale=opts.acoustic_scale,
        lattice_beam=opts.lattice_beam,
    )
