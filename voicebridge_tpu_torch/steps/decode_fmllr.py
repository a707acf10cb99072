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

The lattice passes are ``Decoder.decode_lattice`` (K2, K3, K5), exact as the
JAX package's: the beams of ``FmllrDecodeOptions`` (``beam``,
``first_beam``, ``max_active``, ``first_max_active``) change nothing in
either package; ``lattice_beam`` prunes the lattices.  The fMLLR statistics
and the feature transforms are torch on the card
(``transforms/fmllr.py``), the repeated base features are built there, and
stage 4 gathers the survivors' costs there with int64 ``(utterance, frame,
pdf)`` index tensors in sub-batches sized from the card's free memory.  The
posteriors, the row solves and the determinization are host numpy.
"""

from __future__ import annotations

import time
from dataclasses import replace
from itertools import chain

import numpy as np
import torch

from ..config import DecodeOptions, FmllrDecodeOptions
from ..data.lang import Lang
from ..fst.core import Fst
from ..models.gmm import AmDiagGmm
from ..models.transition import TransitionModel
from ..utils.logging import get_logger

from ..device import ieee_fp32_entry, resolve_device
from ..lat import determinize_lattice_pruned_safe, lattice_to_post
from ..ops import gmm_kernels as K
from ..ops.graph import DenseGraph, compile_dense_graph
from ..transforms.fmllr import acc_fmllr_stats, apply_fmllr_batch, estimate_fmllr_batch
from .decode import Decoder, DecodeResult

log = get_logger()

K_POST = 4  # posterior entries kept per frame (lattice posteriors are peaky)


def lattice_posteriors(lats: dict, utts: list, tid2phone: np.ndarray, silence_phones: set,
                       t_max: int, acoustic_scale: float, silence_weight: float):
    """Per-frame top-``K_POST`` (pdf, weight) of each lattice's posteriors
    (``lattice_to_post`` with min_post 0.01), silence down-weighted
    (WeightSilencePost) -> (pdf ``[B*T*K_POST]`` int32, weight float32).
    Entries are ranked by falling posterior, ties in ``lattice_to_post``'s
    order (a stable sort), as the JAX package's per-frame loop ranks them."""
    pdf = np.zeros((len(utts), t_max, K_POST), np.int32)
    w = np.zeros((len(utts), t_max, K_POST), np.float32)
    sil = np.asarray(sorted(silence_phones), np.int64)
    for i, u in enumerate(utts):
        lat = lats[u]
        if lat.num_arcs == 0:
            continue
        _ap, per_frame = lattice_to_post(lat, acoustic_scale=acoustic_scale, min_post=0.01)
        counts = np.fromiter(map(len, per_frame), np.int64, len(per_frame))
        if not counts.sum():
            continue
        ent = np.asarray(list(chain.from_iterable(per_frame)), np.float64)  # (tid, pdf, post)
        t = np.repeat(np.arange(len(per_frame)), counts)
        order = np.lexsort((-ent[:, 2], t))
        rank = np.arange(len(t)) - np.repeat(np.cumsum(counts) - counts, counts)
        top = rank < K_POST
        sel = ent[order[top]]
        on_sil = np.isin(tid2phone[sel[:, 0].astype(np.int64)], sil)
        pdf[i, t[top], rank[top]] = sel[:, 1]
        w[i, t[top], rank[top]] = sel[:, 2] * np.where(on_sil, silence_weight, 1.0)
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
    return (-ll[idx[0], idx[1], idx[2]]).cpu().numpy()


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


@ieee_fp32_entry
def decode_fmllr(hclg: Fst | DenseGraph, trans_model: TransitionModel, am: AmDiagGmm,
                 alimdl: AmDiagGmm, lang: Lang, utts: list, feats, num_frames, utt2spk: dict,
                 opts: FmllrDecodeOptions = FmllrDecodeOptions(), mesh=None, *,
                 device=None, stage_s: dict | None = None):
    """feats [B, T, D] padded base features (array or tensor) of ``utts``
    -> (results list[DecodeResult], final transforms ``[S, D, D+1]`` of the
    speakers in sorted order).

    ``hclg`` is an HCLG over ``trans_model``'s transition ids or a graph
    already compiled (``ops/graph.compile_dense_graph``); ``trans_model``
    gives the phones of transition ids (silence down-weighting) and
    ``lang`` the silence phones.  ``stage_s``, when given, receives each
    stage's wall seconds.  ``mesh`` (``parallel/mesh.make_mesh``) routes
    both fMLLR statistics passes through the data-axis-sharded reduction."""
    device = resolve_device(device)
    feats = torch.as_tensor(feats, dtype=torch.float32).to(device)
    num_frames = np.asarray(torch.as_tensor(num_frames).cpu())
    b, t_max, dim = feats.shape
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    spk_of_utt = np.asarray([spk_idx[utt2spk[u]] for u in utts], np.int32)
    spk_rep = torch.from_numpy(spk_of_utt).to(device).repeat_interleave(t_max * K_POST)
    base_rep = feats.reshape(b * t_max, dim).repeat_interleave(K_POST, dim=0)  # [N*K, D]
    sil_set = set(lang.silence_phone_ids)
    times = {} if stage_s is None else stage_s
    clock = [time.perf_counter()]

    def lap(stage: str) -> None:
        now = time.perf_counter()
        times[stage] = now - clock[0]
        clock[0] = now

    def posteriors(lats):
        return lattice_posteriors(lats, utts, trans_model.tid2phone, sil_set, t_max,
                                  opts.acoustic_scale, opts.silence_weight)

    def estimate(pdf_flat, wflat):
        beta, k, g = acc_fmllr_stats(K.pack_gmm(am, device), am.means(), am.inv_vars,
                                     base_rep, pdf_flat, wflat, spk_rep, len(speakers),
                                     mesh=mesh, device=device)
        trans, _imprs = estimate_fmllr_batch(beta.cpu().numpy(), k.cpu().numpy(),
                                             g.cpu().numpy(), min_count=opts.fmllr_min_count)
        return trans

    graph = (hclg if isinstance(hclg, DenseGraph)
             else compile_dense_graph(hclg, trans_model.tid2pdf))
    # ---- stage 0: SI lattice pass with alimdl -------------------------------
    si_dec = Decoder.from_dense_graph(graph, alimdl, _decode_opts(opts, first=True),
                                      device=device)
    si_lats = si_dec.decode_lattice(utts, feats, num_frames)
    lap("si_lattices")
    # ---- stage 1: first transforms from SI-lattice posteriors ---------------
    trans = estimate(*posteriors(si_lats))
    lap("first_transforms")
    log.info("decode_fmllr: pass-1 transforms for %d speakers", len(speakers))
    # ---- stage 2: adapted lattice decode ------------------------------------
    ad_dec = Decoder.from_dense_graph(graph, am, _decode_opts(opts, first=False),
                                      device=device)
    ad_lats = ad_dec.decode_lattice(
        utts, apply_fmllr_batch(feats, trans, spk_of_utt, device=device), num_frames)
    lap("adapted_lattices")
    # ---- stage 3: second estimate from adapted lattices ---------------------
    trans2 = estimate(*posteriors(ad_lats))
    adapted2 = apply_fmllr_batch(feats, trans2, spk_of_utt, device=device)
    lap("second_transforms")
    # ---- stage 4: rescore + pruned determinization ---------------------------
    rescored = rescore_lattices(ad_dec, adapted2, utts, ad_lats)
    lap("rescore")
    results = []
    for u in utts:
        clat = determinize_lattice_pruned_safe(rescored[u], beam=opts.lattice_beam,
                                               lm_scale=1.0, acoustic_scale=opts.acoustic_scale)
        p = clat.best_path(lm_scale=1.0, acoustic_scale=opts.acoustic_scale)
        results.append(DecodeResult(u, p["words"], p["score"], p["tids"]))
    lap("determinize")
    return results, trans2


def _decode_opts(opts: FmllrDecodeOptions, first: bool) -> DecodeOptions:
    return DecodeOptions(
        beam=opts.first_beam if first else opts.beam,
        max_active=opts.first_max_active if first else opts.max_active,
        acoustic_scale=opts.acoustic_scale,
        lattice_beam=opts.lattice_beam,
    )
