"""Traffic kind ``decode_batches``: a closed loop of requests, each a batch
of equal-length utterances of speech-band tones drifting in pitch plus white
noise, a few speakers a batch.  Parameters: ``batch_utts``, ``speakers``,
``frames``, ``tones``, ``tone_hz``, ``tone_amp``, ``drift``, ``noise``,
``pool_batches`` (distinct requests the loop cycles through).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vbbench.traffic import uniform


def wave_samples(spec: dict, feat: dict) -> int:
    """Samples of an utterance of ``spec["frames"]`` snip-edge frames."""
    sr = float(feat["samp_freq"])
    ws = int(sr * 0.001 * feat["frame_length_ms"])
    shift = int(sr * 0.001 * feat["frame_shift_ms"])
    return ws + (int(spec["frames"]) - 1) * shift


def decode_batch(spec: dict, feat: dict, gen: torch.Generator, device, index: int):
    """One request: ``spec["batch_utts"]`` waves of speech-band tones drifting
    in pitch plus white noise, ``spec["speakers"]`` speakers a batch.
    Returns (utt -> float32 numpy wave, utt -> speaker, speaker ids in utt
    order)."""
    b, n = int(spec["batch_utts"]), wave_samples(spec, feat)
    k = int(spec["tones"])
    sr = float(feat["samp_freq"])
    f = uniform(gen, (b, k, 1), spec["tone_hz"][0], spec["tone_hz"][1], device)
    a = uniform(gen, (b, k, 1), spec["tone_amp"][0], spec["tone_amp"][1], device)
    ph = uniform(gen, (b, k, 1), 0.0, 2 * math.pi, device)
    t = torch.arange(n, device=device, dtype=torch.float64) / sr
    drift = 1.0 + float(spec["drift"]) * torch.sin(t)
    sig = (a * torch.sin(2 * math.pi * f * t * drift + ph)).sum(dim=1)
    sig = sig + float(spec["noise"]) * torch.randn((b, n), generator=gen, device=device,
                                                  dtype=torch.float64)
    host = sig.float().cpu().numpy()
    per = b // int(spec["speakers"])
    utts = [f"r{index:03d}_s{i // per:02d}_u{i % per:03d}" for i in range(b)]
    waves = {u: host[i] for i, u in enumerate(utts)}
    utt2spk = {u: u[:8] for u in utts}
    return waves, utt2spk, np.arange(b) // per


def requests(spec: dict, feat: dict, gen: torch.Generator, device) -> list:
    """The pool of ``spec["pool_batches"]`` requests, as ``decode_batch``
    gives them."""
    return [decode_batch(spec, feat, gen, device, i) for i in range(int(spec["pool_batches"]))]
