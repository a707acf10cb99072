"""Training/decoding diagnostics.

Counterparts: ``scr/steps/diagnostic/{analyze_alignments.cpp,
analyze_phone_length_stats.cpp, analyze_lats.cpp,
analyze_lattice_depth_stats.cpp}`` — post-training QA on phone durations and
per-frame search-space depth (SURVEY.md §2.1 Diagnostics).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from ..utils.logging import get_logger

log = get_logger()


def phone_length_stats(alignments: dict, trans_model, lang=None) -> dict:
    """Per-phone duration statistics from alignments (AnalyzeAlignments /
    analyze_phone_length_stats): phone -> dict(count, mean frames, p50, p95,
    frequency at utterance boundaries)."""
    durations: dict[int, list] = defaultdict(list)
    begins: dict[int, int] = defaultdict(int)
    ends: dict[int, int] = defaultdict(int)
    for utt, tids in alignments.items():
        if not tids:
            continue
        seg_phones, seg_of_frame = trans_model.split_to_phones(tids)
        counts = np.bincount(seg_of_frame, minlength=len(seg_phones))
        for i, ph in enumerate(seg_phones):
            durations[ph].append(int(counts[i]))
        begins[seg_phones[0]] += 1
        ends[seg_phones[-1]] += 1
    out = {}
    for ph, ds in durations.items():
        arr = np.asarray(ds)
        name = lang.phones.sym(ph) if lang is not None else str(ph)
        out[ph] = {
            "phone": name,
            "count": len(ds),
            "mean_frames": float(arr.mean()),
            "median_frames": float(np.percentile(arr, 50)),
            "p95_frames": float(np.percentile(arr, 95)),
            "begins_utt": begins.get(ph, 0),
            "ends_utt": ends.get(ph, 0),
        }
    return out


def report_alignment_diagnostics(alignments: dict, trans_model, lang=None,
                                 top: int = 10) -> str:
    """Human-readable summary like the reference's analyze_alignments log."""
    stats = phone_length_stats(alignments, trans_model, lang)
    n_empty = sum(1 for a in alignments.values() if not a)
    lines = [f"alignments: {len(alignments)} utts ({n_empty} failed)"]
    by_count = sorted(stats.values(), key=lambda s: -s["count"])[:top]
    for s in by_count:
        lines.append(
            f"  {s['phone']:>10s}: n={s['count']:5d} mean={s['mean_frames']:6.1f} "
            f"median={s['median_frames']:5.0f} p95={s['p95_frames']:5.0f} "
            f"begin={s['begins_utt']} end={s['ends_utt']}")
    text = "\n".join(lines)
    log.info("%s", text)
    return text


def lattice_depth_stats(lats: dict) -> dict:
    """``analyze_lats.cpp`` / ``lattice-depth-per-frame`` role: distribution
    of lattice depth (arcs crossing each frame) over a decode set."""
    from ..lat import lattice_depth_per_frame

    depths = []
    for lat in lats.values():
        if lat.nf:
            depths.append(lattice_depth_per_frame(lat))
    if not depths:
        return {"mean_depth": 0.0, "median_depth": 0.0, "p95_depth": 0.0,
                "max_depth": 0}
    d = np.concatenate(depths)
    return {
        "mean_depth": float(d.mean()),
        "median_depth": float(np.median(d)),
        "p95_depth": float(np.percentile(d, 95)),
        "max_depth": int(d.max()),
    }


def state_occupancy_report(alpha_end: np.ndarray, threshold: float = -1e29) -> dict:
    """Decode-time analogue of lattice-depth stats: distribution of surviving
    (un-pruned) states per utterance at the final frame."""
    active = (alpha_end > threshold).sum(axis=1)
    return {
        "mean_active_states": float(active.mean()),
        "max_active_states": int(active.max()),
        "min_active_states": int(active.min()),
    }
