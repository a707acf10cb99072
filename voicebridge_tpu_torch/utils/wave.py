"""RIFF WAV reading/writing with Kaldi sample semantics.

The reference reads 16-bit PCM into floats in the raw integer range
[-32768, 32767] *without* normalizing (``feat/wave-reader.h:106``); all MFCC
defaults (dither=1.0 etc.) assume that scale.  scipy handles the container.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import wavfile


def read_wave(path: str | Path) -> tuple[float, np.ndarray]:
    """Return ``(sample_rate, samples[float32, int16 scale])``; mono uses
    channel 0 like the reference's default."""
    rate, data = wavfile.read(str(path))
    if data.ndim == 2:
        data = data[:, 0]
    if data.dtype == np.int16:
        samples = data.astype(np.float32)
    elif data.dtype == np.int32:
        samples = (data / 65536.0).astype(np.float32)
    elif data.dtype in (np.float32, np.float64):
        samples = (data * 32768.0).astype(np.float32)
    elif data.dtype == np.uint8:
        samples = ((data.astype(np.float32) - 128.0) * 256.0)
    else:
        raise ValueError(f"unsupported wav dtype {data.dtype}")
    return float(rate), samples


def write_wave(path: str | Path, rate: float, samples: np.ndarray) -> None:
    """Write float samples in int16 scale as 16-bit PCM."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    clipped = np.clip(np.round(samples), -32768, 32767).astype(np.int16)
    wavfile.write(str(path), int(rate), clipped)


def resample(samples: np.ndarray, in_rate: float, out_rate: float,
             num_zeros: int = 10) -> np.ndarray:
    """Bandlimited windowed-sinc resampling (role of the reference's
    ``LinearResample``, feat/resample.h:147)."""
    if in_rate == out_rate:
        return samples.astype(np.float32)
    import math

    ratio = out_rate / in_rate
    cutoff = 0.95 * 0.5 * min(in_rate, out_rate)
    n_out = int(math.floor(len(samples) * ratio))
    t_out = np.arange(n_out) / out_rate  # output sample times
    center = t_out * in_rate  # position in input samples
    width = num_zeros * in_rate / (2.0 * cutoff)
    lo = np.maximum(np.ceil(center - width).astype(np.int64), 0)
    k = int(np.ceil(2 * width)) + 2
    idx = lo[:, None] + np.arange(k)[None, :]  # [n_out, k]
    valid = idx < len(samples)
    x = np.where(valid, samples[np.minimum(idx, len(samples) - 1)], 0.0)
    delta = (idx - center[:, None]) / in_rate  # seconds
    # Hann-windowed sinc at the cutoff frequency
    window = np.where(np.abs(delta) < width / in_rate,
                      0.5 + 0.5 * np.cos(np.pi * delta * in_rate / width), 0.0)
    sinc = 2 * cutoff * np.sinc(2 * cutoff * delta)
    taps = window * sinc / in_rate
    return (x * taps).sum(axis=1).astype(np.float32)


def extract_segment(samples: np.ndarray, rate: float, start: float,
                    end: float) -> np.ndarray:
    """extract-segments: slice [start, end) seconds from a recording."""
    lo = max(int(round(start * rate)), 0)
    hi = min(int(round(end * rate)), len(samples))
    return samples[lo:hi]
