"""MFCC / delta feature frontend in PyTorch.

Port of ``voicebridge_tpu/ops/features.py``.  The constant tables are the JAX
package's numpy code, copied so both packages build bit-identical tables:

    frame -> [dither] -> [remove DC] -> raw log-energy -> preemphasis ->
    window -> zero-pad to power of two -> |rFFT|^2 -> mel filterbank ->
    log -> DCT-II -> liftering -> [c0 := log-energy]

``mfcc_from_frames`` is the plain version of the fused MFCC kernel
(``ops/mfcc_kernel.py``, K1) and uses ``torch.fft.rfft``.
``MfccExtractor.batched`` frames a padded batch of waves and sends every
frame through the kernel wrapper, which picks the kernel or the plain version
from the tensor's device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DeltaOptions, FrameOptions, MfccOptions, SpliceOptions

from ..device import resolve_device
from . import mfcc_kernel

FLT_EPS = float(np.finfo(np.float32).eps)


# ---------------------------------------------------------------------------
# Constant tables (host numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def feature_window(opts: FrameOptions) -> np.ndarray:
    """Window function (reference: ``FeatureWindowFunction``, feature-window.cc:90)."""
    n = opts.window_size
    a = 2.0 * math.pi / (n - 1)
    i = np.arange(n, dtype=np.float64)
    wt = opts.window_type
    if wt == "hanning":
        w = 0.5 - 0.5 * np.cos(a * i)
    elif wt == "hamming":
        w = 0.54 - 0.46 * np.cos(a * i)
    elif wt == "povey":  # like hanning but goes to zero at edges
        w = (0.5 - 0.5 * np.cos(a * i)) ** 0.85
    elif wt == "rectangular":
        w = np.ones(n)
    elif wt == "blackman":
        bc = opts.blackman_coeff
        w = bc - 0.5 * np.cos(a * i) + (0.5 - bc) * np.cos(2 * a * i)
    else:
        raise ValueError(f"invalid window type {wt!r}")
    return w.astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def mel_bank_matrix(num_bins: int, frame_opts: FrameOptions, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """Triangular mel filterbank as a dense ``[num_bins, num_fft_bins]`` matrix
    (reference: ``MelBanks`` ctor, mel-computations.cc:46-120); no VTLN."""
    padded = frame_opts.padded_window_size
    num_fft_bins = padded // 2
    nyquist = 0.5 * frame_opts.samp_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not (0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist):
        raise ValueError(f"bad frequency range [{low_freq}, {high_freq}]")
    fft_bin_width = frame_opts.samp_freq / padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)
    for b in range(num_bins):
        left = mel_low + b * mel_delta
        center = mel_low + (b + 1) * mel_delta
        right = mel_low + (b + 2) * mel_delta
        up = (mels - left) / (center - left)
        down = (right - mels) / (right - center)
        w = np.where(mels <= center, up, down)
        bins[b] = np.where((mels > left) & (mels < right), w, 0.0)
    return bins.astype(np.float32)


def dct_matrix(num_ceps: int, num_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix rows 0..num_ceps-1
    (reference: ``ComputeDctMatrix``, matrix/matrix-functions.cc)."""
    m = np.zeros((num_ceps, num_bins), dtype=np.float64)
    m[0, :] = math.sqrt(1.0 / num_bins)
    for k in range(1, num_ceps):
        m[k, :] = math.sqrt(2.0 / num_bins) * np.cos(
            math.pi / num_bins * (np.arange(num_bins) + 0.5) * k
        )
    return m.astype(np.float32)


def lifter_coeffs(num_ceps: int, q: float) -> np.ndarray:
    """Cepstral liftering coefficients (reference: ``ComputeLifterCoeffs``)."""
    i = np.arange(num_ceps, dtype=np.float64)
    return (1.0 + 0.5 * q * np.sin(math.pi * i / q)).astype(np.float32)


def delta_scales(order: int, window: int) -> list[np.ndarray]:
    """Kaldi delta filter taps per order (reference: DeltaFeatures ctor,
    feature-functions.cc:54-86)."""
    scales = [np.array([1.0], dtype=np.float64)]
    for _ in range(order):
        prev = scales[-1]
        prev_offset = (len(prev) - 1) // 2
        cur = np.zeros(len(prev) + 2 * window, dtype=np.float64)
        cur_offset = prev_offset + window
        normalizer = 0.0
        for j in range(-window, window + 1):
            normalizer += j * j
            for k in range(-prev_offset, prev_offset + 1):
                cur[j + k + cur_offset] += j * prev[k + prev_offset]
        scales.append(cur / normalizer)
    return [s.astype(np.float32) for s in scales]


def mel_bands(mel: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A ``[num_bins, K]`` filterbank -> each bin's triangle: ``lo [num_bins]``,
    ``length [num_bins]`` (int32; from the first to the last nonzero weight)
    and ``band [max length, num_bins]`` with ``band[i, b] = mel[b, lo[b] +
    i]`` (zero past a bin's length).  Only zeros outside the triangles are
    left out, so a sum over ``band`` in order equals the dense one."""
    nb = mel.shape[0]
    lo = np.zeros(nb, np.int32)
    length = np.zeros(nb, np.int32)
    for b in range(nb):
        nz = np.flatnonzero(mel[b])
        if len(nz):
            lo[b], length[b] = nz[0], nz[-1] + 1 - nz[0]
    band = np.zeros((max(int(length.max()), 1), nb), np.float32)
    for b in range(nb):
        band[: length[b], b] = mel[b, lo[b]: lo[b] + length[b]]
    return lo, length, band


@dataclass(frozen=True)
class MfccTables:
    """Per-option constants on one device, shared by the kernel and its
    plain version.  ``fbank=True`` gives log-mel rows instead of cepstra."""

    opts: MfccOptions
    fbank: bool
    window: torch.Tensor  # [ws]
    mel_t: torch.Tensor  # [N/2, num_bins] (plain version)
    dct_t: torch.Tensor  # [num_bins, num_ceps]
    lifter: torch.Tensor  # [num_ceps]
    twiddle: torch.Tensor  # [N, 2]: cos, sin of -2*pi*k/N (kernel only)
    mel_lo: torch.Tensor  # [num_bins] int32: first FFT bin of each triangle (kernel only)
    mel_len: torch.Tensor  # [num_bins] int32: its width (kernel only)
    mel_band: torch.Tensor  # [max width, num_bins]: its weights (kernel only)

    @classmethod
    def build(cls, opts: MfccOptions, fbank: bool, device) -> "MfccTables":
        fo, mo = opts.frame_opts, opts.mel_opts
        n = fo.padded_window_size
        ang = -2.0 * math.pi * np.arange(n) / n
        twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
        mel = mel_bank_matrix(mo.num_bins, fo, mo.low_freq, mo.high_freq)
        lo, length, band = mel_bands(mel)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(opts=opts, fbank=fbank, window=dev(feature_window(fo)),
                   mel_t=dev(mel.T), dct_t=dev(dct_matrix(opts.num_ceps, mo.num_bins).T),
                   lifter=dev(lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)),
                   twiddle=dev(twiddle), mel_lo=dev(lo), mel_len=dev(length),
                   mel_band=dev(band))

    @property
    def mel_floor(self) -> float:
        # htk_mode floors mel energies at 1.0 like HTK (mel-computations.cc:238)
        return 1.0 if self.opts.mel_opts.htk_mode else FLT_EPS

    @property
    def out_cols(self) -> int:
        """Kernel output width: cepstra (or mel bins) plus the energy column."""
        return (self.opts.mel_opts.num_bins if self.fbank else self.opts.num_ceps) + 1


# ---------------------------------------------------------------------------
# MFCC computation
# ---------------------------------------------------------------------------


def extract_frames(waves: torch.Tensor, num_frames: int, opts: FrameOptions) -> torch.Tensor:
    """``[..., S] -> [..., num_frames, window_size]`` (snip-edges framing).
    Frames past the true end of an utterance read padded samples and are
    masked by callers."""
    shift, size = opts.window_shift, opts.window_size
    idx = (torch.arange(num_frames, device=waves.device)[:, None] * shift
           + torch.arange(size, device=waves.device)[None, :])
    return waves[..., idx.clamp_max(waves.shape[-1] - 1)]


def _process_window(frames: torch.Tensor, opts: MfccOptions,
                    window: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """DC offset / raw energy / preemphasis / window on ``[N, ws]`` frames
    (reference: ``ProcessWindow``, feature-window.cc:90-185).  Dither is
    added to the frames by the caller."""
    fo = opts.frame_opts
    if fo.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    # raw log energy: after dither/DC, before preemphasis/window
    energy = torch.log(torch.clamp_min((frames * frames).sum(dim=-1), FLT_EPS))
    if fo.preemph_coeff != 0.0:
        shifted = torch.cat([frames[:, :1], frames[:, :-1]], dim=1)
        frames = frames - fo.preemph_coeff * shifted
    frames = frames * window[None, :]
    if not opts.raw_energy:
        energy = torch.log(torch.clamp_min((frames * frames).sum(dim=-1), FLT_EPS))
    return frames, energy


def mfcc_from_frames(frames: torch.Tensor, tables: MfccTables) -> torch.Tensor:
    """Plain version of K1: ``[N, ws]`` dithered frames ->
    ``[N, tables.out_cols]``: cepstra (log-mel bins with ``tables.fbank``),
    then the log energy.  ``assemble`` turns this into features."""
    opts = tables.opts
    padded = opts.frame_opts.padded_window_size
    frames, energy = _process_window(frames, opts, tables.window)
    frames = F.pad(frames, (0, padded - frames.shape[1]))
    spec = torch.fft.rfft(frames, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : padded // 2]
    logmel = torch.log(torch.clamp_min(power @ tables.mel_t, tables.mel_floor))
    if tables.fbank:
        return torch.cat([logmel, energy[:, None]], dim=1)
    ceps = (logmel @ tables.dct_t) * tables.lifter[None, :]
    return torch.cat([ceps, energy[:, None]], dim=1)


def assemble(raw: torch.Tensor, tables: MfccTables) -> torch.Tensor:
    """use_energy / htk_compat assembly of ``[N, out_cols]`` kernel rows
    (``MfccPallas._assemble``)."""
    opts = tables.opts
    nc = tables.out_cols - 1
    feats, energy = raw[:, :nc], raw[:, nc]
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            energy = torch.clamp_min(energy, math.log(opts.energy_floor))
        if tables.fbank:
            # fbank prepends energy (FbankExtractor: dim = num_bins + 1)
            feats = torch.cat([energy[:, None], feats], dim=1)
        else:
            feats = torch.cat([energy[:, None], feats[:, 1:]], dim=1)
    if opts.htk_compat and not tables.fbank:
        # energy/C0 moves last; C0 regains the sqrt(2) DCT scale when it is a
        # true cepstral coefficient (feature-mfcc.cc:70-80)
        first = feats[:, 0] * (1.0 if opts.use_energy else math.sqrt(2.0))
        feats = torch.cat([feats[:, 1:], first[:, None]], dim=1)
    return feats


class MfccExtractor:
    """MFCC (or, with ``fbank=True``, log-mel fbank) features of padded wave
    batches on one device, through the K1 kernel wrapper."""

    def __init__(self, opts: MfccOptions = MfccOptions(), *, device=None,
                 fbank: bool = False):
        self.opts = opts
        self.device = resolve_device(device)
        self.tables = MfccTables.build(opts, fbank, self.device)

    def batched(self, waves: torch.Tensor, num_samples: torch.Tensor, max_frames: int,
                generator: torch.Generator | None = None):
        """``[B, S], [B] -> ([B, max_frames, dim], [B] frame counts)``.

        With ``opts.frame_opts.dither`` set and a ``generator`` given, each
        frame gets ``dither * N(0, 1)`` noise drawn from it.  Frames beyond an
        utterance's frame count are garbage from padding; callers mask by the
        returned counts."""
        fo = self.opts.frame_opts
        waves = waves.to(self.device, torch.float32)
        b = waves.shape[0]
        frames = extract_frames(waves, max_frames, fo).reshape(b * max_frames, -1)
        if fo.dither != 0.0 and generator is not None:
            frames = frames + fo.dither * torch.randn(
                frames.shape, generator=generator, device=frames.device)
        raw = mfcc_kernel.mfcc_frames(frames.contiguous(), self.tables)
        feats = assemble(raw, self.tables).reshape(b, max_frames, -1)
        num_samples = num_samples.to(self.device)
        counts = torch.where(num_samples >= fo.window_size,
                             1 + (num_samples - fo.window_size) // fo.window_shift, 0)
        return feats, counts


# ---------------------------------------------------------------------------
# Deltas and splicing (batched, length-aware edge clamping)
# ---------------------------------------------------------------------------


def add_deltas_batch(feats: torch.Tensor, num_frames: torch.Tensor,
                     opts: DeltaOptions = DeltaOptions()) -> torch.Tensor:
    """``[B, T, D] -> [B, T, D*(order+1)]`` (reference: add-deltas /
    DeltaFeatures), clamping frame indices to ``[0, num_frames-1]`` per
    utterance like the reference does at utterance edges."""
    b, t, d = feats.shape
    last = torch.clamp_min(num_frames.to(feats.device, torch.int64) - 1, 0)
    outs = []
    for s in delta_scales(opts.order, opts.window):
        off = (len(s) - 1) // 2
        offsets = torch.arange(-off, off + 1, device=feats.device)
        idx = torch.arange(t, device=feats.device)[None, None, :] + offsets[None, :, None]
        idx = torch.minimum(idx.clamp_min(0), last[:, None, None])  # [B, K, T]
        shifted = torch.gather(feats[:, None].expand(b, len(s), t, d), 2,
                               idx[..., None].expand(b, len(s), t, d))
        taps = torch.from_numpy(s).to(feats.device)
        outs.append(torch.einsum("k,bktd->btd", taps, shifted))
    return torch.cat(outs, dim=-1)


def splice_frames_batch(feats: torch.Tensor, num_frames: torch.Tensor,
                        opts: SpliceOptions = SpliceOptions()) -> torch.Tensor:
    """``[B, T, D] -> [B, T, D*(left+right+1)]`` (reference: splice-feats):
    output frame t is frames ``t-left .. t+right`` side by side, each index
    clamped to ``[0, num_frames-1]`` of its utterance.  One index gather on
    the features' device."""
    b, t, d = feats.shape
    dev = feats.device
    k = opts.left_context + opts.right_context + 1
    last = torch.clamp_min(torch.as_tensor(num_frames).to(dev, torch.int64) - 1, 0)
    offsets = torch.arange(-opts.left_context, opts.right_context + 1, device=dev)
    idx = torch.arange(t, device=dev)[:, None] + offsets[None, :]  # [T, K]
    idx = torch.minimum(idx.clamp_min(0)[None], last[:, None, None])  # [B, T, K]
    out = torch.gather(feats, 1, idx.reshape(b, t * k, 1).expand(b, t * k, d))
    return out.reshape(b, t, k * d)


def splice_frames(feats: torch.Tensor, num_frames,
                  opts: SpliceOptions = SpliceOptions()) -> torch.Tensor:
    """``[T, D] -> [T, D*(left+right+1)]``."""
    return splice_frames_batch(feats[None], torch.tensor([int(num_frames)]), opts)[0]
