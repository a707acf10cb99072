"""Plain MFCC, per-speaker CMVN and deltas (Kaldi's ``compute-mfcc-feats``,
``apply-cmvn`` with means only, ``add-deltas``), written from Kaldi's
definitions in plain torch.  Imports nothing of the program.

The configuration's ``features`` block gives the options: 25 ms / 10 ms
frames with snipped edges, DC removal, raw log energy, preemphasis 0.97, the
Povey window, an FFT of the window rounded up to a power of two, a
triangular mel bank from 20 Hz to Nyquist, log, an orthonormal DCT-II,
cepstral liftering, and with ``use_energy`` the log energy in place of C0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .precision import EXACT, Precision

FLT_EPS = float(np.finfo(np.float32).eps)  # Kaldi's log floor


def _mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def frame_geometry(feat: dict) -> tuple[int, int, int]:
    """(window size, shift, FFT size) in samples."""
    sr = float(feat["samp_freq"])
    ws = int(sr * 0.001 * feat["frame_length_ms"])
    shift = int(sr * 0.001 * feat["frame_shift_ms"])
    n_fft = 1 << (ws - 1).bit_length()
    return ws, shift, n_fft


def num_frames(num_samples: int, feat: dict) -> int:
    ws, shift, _ = frame_geometry(feat)
    return 0 if num_samples < ws else 1 + (num_samples - ws) // shift


def tables(feat: dict) -> dict:
    """Window, mel bank ``[K/2, bins]``, DCT ``[bins, ceps]`` and lifter, in
    float64 numpy."""
    ws, _shift, n_fft = frame_geometry(feat)
    sr = float(feat["samp_freq"])
    i = np.arange(ws, dtype=np.float64)
    window = (0.5 - 0.5 * np.cos(2.0 * math.pi * i / (ws - 1))) ** 0.85
    bins, ceps = int(feat["num_mel_bins"]), int(feat["num_ceps"])
    lo, hi = _mel(feat["low_freq"]), _mel(0.5 * sr)
    delta = (hi - lo) / (bins + 1)
    mels = _mel(np.arange(n_fft // 2) * sr / n_fft)
    bank = np.zeros((n_fft // 2, bins))
    for b in range(bins):
        left, center, right = lo + b * delta, lo + (b + 1) * delta, lo + (b + 2) * delta
        w = np.where(mels <= center, (mels - left) / (center - left),
                     (right - mels) / (right - center))
        bank[:, b] = np.where((mels > left) & (mels < right), w, 0.0)
    j = np.arange(bins, dtype=np.float64)
    dct = np.stack([np.full(bins, math.sqrt(1.0 / bins))]
                   + [math.sqrt(2.0 / bins) * np.cos(math.pi / bins * (j + 0.5) * k)
                      for k in range(1, ceps)], axis=1)
    q = float(feat["cepstral_lifter"])
    lifter = 1.0 + 0.5 * q * np.sin(math.pi * np.arange(ceps) / q)
    return {"window": window, "bank": bank, "dct": dct, "lifter": lifter}


def mfcc(waves: torch.Tensor, feat: dict, prec: Precision = EXACT) -> torch.Tensor:
    """``[B, N]`` samples (every wave N long) -> ``[B, T, ceps]``."""
    ws, shift, n_fft = frame_geometry(feat)
    tab = tables(feat)
    dev = waves.device
    x = prec.t(waves)
    t = num_frames(x.shape[1], feat)
    frames = x.unfold(1, ws, shift)[:, :t]  # [B, T, ws]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    energy = torch.log(torch.clamp_min((frames * frames).sum(dim=-1), FLT_EPS))
    first = frames[..., :1]
    frames = frames - float(feat["preemph_coeff"]) * torch.cat([first, frames[..., :-1]], -1)
    frames = frames * prec.t(tab["window"]).to(dev)
    spec = torch.fft.rfft(frames, n=n_fft, dim=-1)[..., : n_fft // 2]
    power = spec.real ** 2 + spec.imag ** 2
    b = power.shape[0]
    mel = prec.mm(power.reshape(b * t, -1), prec.t(tab["bank"]).to(dev))
    logmel = torch.log(torch.clamp_min(mel, FLT_EPS))
    ceps = prec.mm(logmel, prec.t(tab["dct"]).to(dev)) * prec.t(tab["lifter"]).to(dev)
    ceps = ceps.reshape(b, t, -1)
    if not feat["use_energy"]:
        return ceps
    return torch.cat([energy[..., None], ceps[..., 1:]], dim=-1)


def cmvn(feats: torch.Tensor, speaker: np.ndarray) -> torch.Tensor:
    """Subtract each speaker's mean over all its frames (``[B, T, D]``,
    every utterance T frames long; ``speaker [B]`` ids)."""
    spk = torch.as_tensor(np.asarray(speaker)).to(feats.device, torch.int64)
    out = feats.clone()
    for s in torch.unique(spk).tolist():
        rows = spk == s
        out[rows] = feats[rows] - feats[rows].reshape(-1, feats.shape[2]).mean(dim=0)
    return out


def delta_taps(order: int, window: int) -> list[np.ndarray]:
    """Kaldi's delta filters: each order the previous one convolved with
    ``j / sum(j^2)`` over ``j = -window..window``."""
    taps = [np.ones(1)]
    ramp = np.arange(-window, window + 1, dtype=np.float64)
    ramp = ramp / (ramp * ramp).sum()
    for _ in range(order):
        taps.append(np.convolve(taps[-1], ramp))
    return taps


def deltas(feats: torch.Tensor, order: int, window: int) -> torch.Tensor:
    """``[B, T, D] -> [B, T, D (order + 1)]``, frame indices clamped to the
    utterance."""
    t = feats.shape[1]
    outs = []
    for taps in delta_taps(order, window):
        half = (len(taps) - 1) // 2
        acc = torch.zeros_like(feats)
        for k, c in enumerate(taps):
            idx = (torch.arange(t, device=feats.device) + k - half).clamp(0, t - 1)
            acc = acc + float(c) * feats[:, idx]
        outs.append(acc)
    return torch.cat(outs, dim=-1)


def features(waves: torch.Tensor, speaker: np.ndarray, feat: dict,
             prec: Precision = EXACT) -> torch.Tensor:
    """The decode features: MFCC -> CMVN per speaker -> deltas."""
    x = cmvn(mfcc(waves, feat, prec), speaker)
    return deltas(x, int(feat["delta_order"]), int(feat["delta_window"]))
