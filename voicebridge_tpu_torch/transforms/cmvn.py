"""Cepstral mean/variance normalization (per speaker), batched in PyTorch.

Port of ``voicebridge_tpu/transforms/cmvn.py``: per-speaker stats of shape
``[2, D+1]`` (row 0 = [sum x, count], row 1 = [sum x^2, 0]) for all speakers
at once, and application as a gather plus an elementwise op.  The JAX
package's ``segment_sum`` over the speaker ids becomes a float64 one-hot
product ``[S, B] @ [B, 2D+1]`` of the per-utterance sums: no float atomics,
so the statistics are the same bits in every run on the card.

The per-utterance host helpers (``acc_cmvn_stats``, ``fake_cmvn_stats``, the
two-channel statistics, ``utterance_pairs``, ``modify_cmvn_stats``) are numpy
copies of the JAX package's; ``apply_cmvn`` runs on the tensor's device.
"""

from __future__ import annotations

import numpy as np
import torch


def acc_cmvn_stats_batch(feats: torch.Tensor, num_frames: torch.Tensor,
                         spk_ids: torch.Tensor, num_speakers: int) -> torch.Tensor:
    """``[B, T, D]`` padded features + ``[B]`` frame counts + ``[B]`` speaker
    ids -> ``[num_speakers, 2, D+1]`` CMVN stats."""
    b, t, d = feats.shape
    dev = feats.device
    num_frames = num_frames.to(dev)
    spk_ids = spk_ids.to(dev, torch.int64)
    mask = (torch.arange(t, device=dev)[None, :] < num_frames[:, None]).to(feats.dtype)
    x = feats * mask[:, :, None]
    per_utt = torch.cat([x.sum(dim=1), num_frames.to(feats.dtype)[:, None],
                         (x * x).sum(dim=1)], dim=1).double()  # [B, 2D+1]
    onehot = (spk_ids[None, :] == torch.arange(num_speakers, device=dev)[:, None]).double()
    sums = (onehot @ per_utt).to(feats.dtype)  # [S, 2D+1]
    stats = torch.zeros((num_speakers, 2, d + 1), dtype=feats.dtype, device=dev)
    stats[:, 0] = sums[:, : d + 1]
    stats[:, 1, :d] = sums[:, d + 1:]
    return stats


def apply_cmvn_batch(feats: torch.Tensor, spk_stats: torch.Tensor, spk_ids: torch.Tensor,
                     norm_vars: bool = False) -> torch.Tensor:
    """``[B, T, D]`` normalized by per-speaker stats gathered by ``spk_ids``
    (reference: ``ApplyCmvn``, transform/cmvn.cc)."""
    stats = spk_stats[spk_ids.to(spk_stats.device, torch.int64)]  # [B, 2, D+1]
    d = feats.shape[-1]
    count = stats[:, 0, d]
    mean = stats[:, 0, :d] / count[:, None]
    out = feats - mean[:, None, :]
    if norm_vars:
        var = stats[:, 1, :d] / count[:, None] - mean * mean
        scale = 1.0 / torch.sqrt(torch.clamp_min(var, 1e-20))
        out = out * scale[:, None, :]
    return out


def apply_cmvn(feats: torch.Tensor, stats, norm_vars: bool = False) -> torch.Tensor:
    """Normalize ``[T, D]`` by one speaker's ``[2, D+1]`` stats on the
    features' device (reference: ``ApplyCmvn``, transform/cmvn.cc)."""
    stats = torch.as_tensor(stats).to(feats.device, feats.dtype)
    d = feats.shape[-1]
    count = stats[0, d]
    mean = stats[0, :d] / count
    out = feats - mean[None, :]
    if norm_vars:
        var = stats[1, :d] / count - mean * mean
        out = out * (1.0 / torch.sqrt(torch.clamp_min(var, 1e-20)))[None, :]
    return out


# ---------------------------------------------------------------------------
# Host helpers (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def acc_cmvn_stats(feats: np.ndarray) -> np.ndarray:
    """Single-matrix stats ``[2, D+1]`` (host-side convenience)."""
    t, d = feats.shape
    stats = np.zeros((2, d + 1), dtype=np.float64)
    stats[0, :d] = feats.sum(axis=0)
    stats[0, d] = t
    stats[1, :d] = (feats.astype(np.float64) ** 2).sum(axis=0)
    return stats.astype(np.float32)


def fake_cmvn_stats(dim: int) -> np.ndarray:
    """'Fake' no-op stats (reference: compute-cmvn-stats --fake / kaldi_scr.h:87-94):
    count 1, zero mean, unit variance."""
    stats = np.zeros((2, dim + 1), dtype=np.float32)
    stats[0, dim] = 1.0
    stats[1, :dim] = 1.0
    return stats



def acc_cmvn_stats_two_channel(feats_a: np.ndarray, feats_b: np.ndarray,
                               quieter_channel_weight: float = 0.01
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Two-sided telephone CMVN: at each frame the louder channel (by C0,
    i.e. energy) gets weight 1.0 and the quieter one a small weight
    (reference: ``AccCmvnStatsForPair``,
    featbin/compute-cmvn-stats-two-channel.cpp:79-106). Returns per-channel
    ``[2, D+1]`` stats. If the channels differ in length they are
    accumulated independently (reference :86-92)."""
    d = feats_a.shape[1]
    assert feats_b.shape[1] == d
    if feats_a.shape[0] != feats_b.shape[0]:
        return acc_cmvn_stats(feats_a), acc_cmvn_stats(feats_b)
    a_louder = feats_a[:, 0] > feats_b[:, 0]
    w_a = np.where(a_louder, 1.0, quieter_channel_weight)[:, None]
    w_b = np.where(a_louder, quieter_channel_weight, 1.0)[:, None]

    def weighted(feats, w):
        stats = np.zeros((2, d + 1), np.float64)
        stats[0, :d] = (w * feats).sum(axis=0)
        stats[0, d] = w.sum()
        stats[1, :d] = (w * feats.astype(np.float64) ** 2).sum(axis=0)
        return stats.astype(np.float32)

    return weighted(feats_a, w_a), weighted(feats_b, w_b)


def utterance_pairs(reco2file_and_channel: list[tuple[str, str, str]]
                    ) -> list[list[str]]:
    """Group utterances into A/B-side pairs by call id (reference:
    ``GetUtterancePairs``, compute-cmvn-stats-two-channel.cpp:33-71).
    Input rows are ``(utt_id, call_id, side)``; calls without exactly two
    sides fall back to singletons."""
    by_call: dict[str, list[str]] = {}
    for utt, call, _side in reco2file_and_channel:
        by_call.setdefault(call, []).append(utt)
    pairs = []
    for call in sorted(by_call):
        utts = by_call[call]
        if len(utts) == 2:
            pairs.append(utts)
        else:
            pairs.extend([u] for u in utts)
    return pairs


def modify_cmvn_stats(stats: np.ndarray, skip_dims: list[int] = (),
                      convert_to_mean_and_var: bool = False) -> np.ndarray:
    """``modify-cmvn-stats`` role (featbin/modify-cmvn-stats.cpp): fake out
    the listed dims (zero mean, unit variance — ``FakeStatsForSomeDims``,
    transform/cmvn.cc) and optionally convert sums to [mean; variance]."""
    stats = np.array(stats, np.float64)
    if stats.shape[0] != 2:
        raise ValueError("CMVN stats must have two rows")
    d = stats.shape[1] - 1
    count = stats[0, d]
    for i in skip_dims:
        stats[0, i] = 0.0
        stats[1, i] = count
    if not convert_to_mean_and_var:
        return stats.astype(np.float32)
    if count <= 0.0:
        raise ValueError("zero or negative count in CMVN stats")
    mean = stats[0, :d] / count
    var = stats[1, :d] / count - mean * mean
    return np.stack([mean, var]).astype(np.float32)
