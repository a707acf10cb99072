"""Cepstral mean/variance normalization (per speaker), batched in PyTorch.

Port of ``voicebridge_tpu/transforms/cmvn.py``: per-speaker stats of shape
``[2, D+1]`` (row 0 = [sum x, count], row 1 = [sum x^2, 0]) for all speakers
at once, and application as a gather plus an elementwise op.  The JAX
package's ``segment_sum`` over the speaker ids becomes a float64 one-hot
product ``[S, B] @ [B, 2D+1]`` of the per-utterance sums: no float atomics,
so the statistics are the same bits in every run on the card.
"""

from __future__ import annotations

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
