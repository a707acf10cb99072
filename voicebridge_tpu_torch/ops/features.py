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
from the tensor's device.  The other extractors: ``FbankExtractor`` (K1's
log-mel rows), ``PlpExtractor`` (K1's mel energies, then the PLP tail in
torch, ``plp_tail``) and ``SpectrogramExtractor`` (``torch.fft.rfft``, as the
JAX package's XLA one); ``mel_bank_matrix`` takes a VTLN warp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DeltaOptions, FrameOptions, MfccOptions, PlpOptions, SpliceOptions

from ..device import ieee_fp32_entry, resolve_device
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


def inverse_mel_scale(mel):
    return 700.0 * (np.exp(mel / 1127.0) - 1.0)


def vtln_warp_freq(vtln_low: float, vtln_high: float, low_freq: float,
                   high_freq: float, warp: float, freq):
    """Kaldi's piecewise-linear VTLN warp (mel-computations.cc VtlnWarpFreq):
    slope 1/warp in the middle, linear interpolation to the edges."""
    freq = np.asarray(freq, np.float64)
    if warp == 1.0:
        return freq
    scale = 1.0 / warp
    f_low = vtln_low * max(1.0, warp)
    f_high = vtln_high * min(1.0, warp)
    scale_left = (scale * f_low - low_freq) / (f_low - low_freq)
    scale_right = (high_freq - scale * f_high) / (high_freq - f_high)
    out = np.where(
        freq < f_low, low_freq + scale_left * (freq - low_freq),
        np.where(freq <= f_high, scale * freq,
                 high_freq + scale_right * (freq - high_freq)))
    return np.where((freq < low_freq) | (freq > high_freq), freq, out)


def mel_bank_matrix(num_bins: int, frame_opts: FrameOptions, low_freq: float = 20.0,
                    high_freq: float = 0.0, vtln_warp: float = 1.0,
                    vtln_low: float = 100.0, vtln_high: float = -500.0) -> np.ndarray:
    """Triangular mel filterbank as a dense ``[num_bins, num_fft_bins]`` matrix
    (reference: ``MelBanks`` ctor, mel-computations.cc:46-120), with optional
    VTLN warping of the bin edges.  Warped triangles stay contiguous, so
    ``mel_bands`` and K1's tables take them as they are."""
    padded = frame_opts.padded_window_size
    num_fft_bins = padded // 2
    nyquist = 0.5 * frame_opts.samp_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    if not (0.0 <= low_freq < nyquist and low_freq < high_freq <= nyquist):
        raise ValueError(f"bad frequency range [{low_freq}, {high_freq}]")
    if vtln_high < 0.0:
        vtln_high += nyquist
    fft_bin_width = frame_opts.samp_freq / padded
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    def warp_mel(mel):
        if vtln_warp == 1.0:
            return mel
        f = inverse_mel_scale(mel)
        return mel_scale(vtln_warp_freq(vtln_low, vtln_high, low_freq,
                                        high_freq, vtln_warp, f))

    bins = np.zeros((num_bins, num_fft_bins), dtype=np.float64)
    freqs = fft_bin_width * np.arange(num_fft_bins)
    mels = mel_scale(freqs)
    for b in range(num_bins):
        left = warp_mel(mel_low + b * mel_delta)
        center = warp_mel(mel_low + (b + 1) * mel_delta)
        right = warp_mel(mel_low + (b + 2) * mel_delta)
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


# K1's output modes: cepstra, log-mel bins, or the mel energies themselves
# (PLP's input; no log, no DCT).  The kernel takes their index.
MODES = ("mfcc", "fbank", "mel_power")


@dataclass(frozen=True)
class MfccTables:
    """Per-option constants on one device, shared by the kernel and its
    plain version.  ``mode`` (one of ``MODES``) picks the rows: cepstra,
    log-mel bins (``fbank``) or mel energies (``mel_power``)."""

    opts: MfccOptions
    mode: str
    window: torch.Tensor  # [ws]
    mel_t: torch.Tensor  # [N/2, num_bins] (plain version)
    dct_t: torch.Tensor  # [num_bins, num_ceps]
    lifter: torch.Tensor  # [num_ceps]
    twiddle: torch.Tensor  # [N, 2]: cos, sin of -2*pi*k/N (kernel only)
    mel_lo: torch.Tensor  # [num_bins] int32: first FFT bin of each triangle (kernel only)
    mel_len: torch.Tensor  # [num_bins] int32: its width (kernel only)
    mel_band: torch.Tensor  # [max width, num_bins]: its weights (kernel only)

    @classmethod
    def build(cls, opts: MfccOptions, mode, device) -> "MfccTables":
        """``mode``: one of ``MODES``, or a bool (True: ``fbank``, False:
        ``mfcc``)."""
        if isinstance(mode, bool):
            mode = "fbank" if mode else "mfcc"
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        fo, mo = opts.frame_opts, opts.mel_opts
        n = fo.padded_window_size
        ang = -2.0 * math.pi * np.arange(n) / n
        twiddle = np.stack([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)
        mel = mel_bank_matrix(mo.num_bins, fo, mo.low_freq, mo.high_freq)
        lo, length, band = mel_bands(mel)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(opts=opts, mode=mode, window=dev(feature_window(fo)),
                   mel_t=dev(mel.T), dct_t=dev(dct_matrix(opts.num_ceps, mo.num_bins).T),
                   lifter=dev(lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)),
                   twiddle=dev(twiddle), mel_lo=dev(lo), mel_len=dev(length),
                   mel_band=dev(band))

    @property
    def mel_floor(self) -> float:
        # htk_mode floors mel energies at 1.0 like HTK (mel-computations.cc:238);
        # otherwise the log's floor, and none for the mel energies (PLP takes
        # them unfloored before its equal-loudness weights)
        if self.opts.mel_opts.htk_mode:
            return 1.0
        return -math.inf if self.mode == "mel_power" else FLT_EPS

    @property
    def out_cols(self) -> int:
        """Kernel output width: cepstra (or mel bins) plus the energy column."""
        return (self.opts.num_ceps if self.mode == "mfcc" else self.opts.mel_opts.num_bins) + 1


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


@ieee_fp32_entry
def mfcc_from_frames(frames: torch.Tensor, tables: MfccTables) -> torch.Tensor:
    """Plain version of K1: ``[N, ws]`` dithered frames ->
    ``[N, tables.out_cols]``: cepstra (log-mel bins with ``fbank``, mel
    energies with ``mel_power``), then the log energy.  ``assemble`` turns
    MFCC and fbank rows into features, ``plp_tail`` mel energies into PLP."""
    opts = tables.opts
    padded = opts.frame_opts.padded_window_size
    frames, energy = _process_window(frames, opts, tables.window)
    frames = F.pad(frames, (0, padded - frames.shape[1]))
    spec = torch.fft.rfft(frames, dim=-1)
    power = (spec.real ** 2 + spec.imag ** 2)[:, : padded // 2]
    mel = torch.clamp_min(power @ tables.mel_t, tables.mel_floor)
    if tables.mode == "mel_power":
        return torch.cat([mel, energy[:, None]], dim=1)
    logmel = torch.log(mel)
    if tables.mode == "fbank":
        return torch.cat([logmel, energy[:, None]], dim=1)
    ceps = (logmel @ tables.dct_t) * tables.lifter[None, :]
    return torch.cat([ceps, energy[:, None]], dim=1)


@ieee_fp32_entry
def assemble(raw: torch.Tensor, tables: MfccTables) -> torch.Tensor:
    """use_energy / htk_compat assembly of ``[N, out_cols]`` kernel rows
    (``MfccPallas._assemble``)."""
    opts = tables.opts
    fbank = tables.mode == "fbank"
    nc = tables.out_cols - 1
    feats, energy = raw[:, :nc], raw[:, nc]
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            energy = torch.clamp_min(energy, math.log(opts.energy_floor))
        if fbank:
            # fbank prepends energy (FbankExtractor: dim = num_bins + 1)
            feats = torch.cat([energy[:, None], feats], dim=1)
        else:
            feats = torch.cat([energy[:, None], feats[:, 1:]], dim=1)
    if opts.htk_compat and not fbank:
        # energy/C0 moves last; C0 regains the sqrt(2) DCT scale when it is a
        # true cepstral coefficient (feature-mfcc.cc:70-80)
        first = feats[:, 0] * (1.0 if opts.use_energy else math.sqrt(2.0))
        feats = torch.cat([feats[:, 1:], first[:, None]], dim=1)
    return feats


def frame_batch(waves, num_samples, max_frames: int, fo: FrameOptions, device,
                generator: torch.Generator | None = None):
    """``[B, S]`` waves (array or tensor) and ``[B]`` sample counts ->
    (``[B * max_frames, ws]`` contiguous frames on ``device``, ``[B]`` frame
    counts).  With ``fo.dither`` set and a ``generator`` given, each frame
    gets ``dither * N(0, 1)`` noise drawn from it."""
    waves = torch.as_tensor(waves).to(device, torch.float32)
    b = waves.shape[0]
    frames = extract_frames(waves, max_frames, fo).reshape(b * max_frames, -1)
    if fo.dither != 0.0 and generator is not None:
        frames = frames + fo.dither * torch.randn(
            frames.shape, generator=generator, device=frames.device)
    num_samples = torch.as_tensor(num_samples).to(device)
    counts = torch.where(num_samples >= fo.window_size,
                         1 + (num_samples - fo.window_size) // fo.window_shift, 0)
    return frames.contiguous(), counts


def _single(extractor, wave, generator=None) -> torch.Tensor:
    """One utterance ``[S] -> [num_frames, dim]`` through ``batched``."""
    wave = torch.as_tensor(wave, dtype=torch.float32)
    nf = extractor.opts.frame_opts.num_frames(wave.shape[0])
    if nf == 0:
        return torch.zeros((0, extractor.dim), device=extractor.device)
    feats, _ = extractor.batched(wave[None], torch.tensor([wave.shape[0]]), nf, generator)
    return feats[0]


class MfccExtractor:
    """MFCC (or, with ``fbank=True``, log-mel fbank) features of padded wave
    batches on one device, through the K1 kernel wrapper."""

    def __init__(self, opts: MfccOptions = MfccOptions(), *, device=None,
                 fbank: bool = False):
        self.opts = opts
        self.device = resolve_device(device)
        self.tables = MfccTables.build(opts, fbank, self.device)

    @ieee_fp32_entry
    def batched(self, waves: torch.Tensor, num_samples: torch.Tensor, max_frames: int,
                generator: torch.Generator | None = None):
        """``[B, S], [B] -> ([B, max_frames, dim], [B] frame counts)``.

        With ``opts.frame_opts.dither`` set and a ``generator`` given, each
        frame gets ``dither * N(0, 1)`` noise drawn from it.  Frames beyond an
        utterance's frame count are garbage from padding; callers mask by the
        returned counts."""
        frames, counts = frame_batch(waves, num_samples, max_frames, self.opts.frame_opts,
                                     self.device, generator)
        raw = mfcc_kernel.mfcc_frames(frames, self.tables)
        return assemble(raw, self.tables).reshape(counts.shape[0], max_frames, -1), counts


class FbankExtractor:
    """Log-mel filterbank features (reference: ``FbankComputer``,
    feat/feature-fbank.h), K1 in ``fbank`` mode.  As the JAX package's
    ``FbankExtractor``: its own ``use_energy`` flag (the raw log energy
    first, no ``energy_floor``), not ``MfccOptions.use_energy``."""

    def __init__(self, opts: MfccOptions = MfccOptions(), use_energy: bool = False, *,
                 device=None):
        self.opts = opts
        self.use_energy = use_energy
        self.device = resolve_device(device)
        self.tables = MfccTables.build(opts, "fbank", self.device)

    @property
    def dim(self) -> int:
        return self.opts.mel_opts.num_bins + (1 if self.use_energy else 0)

    def __call__(self, wave) -> torch.Tensor:
        """``[S] -> [num_frames, dim]`` on the extractor's device (no dither)."""
        return _single(self, wave)

    @ieee_fp32_entry
    def batched(self, waves, num_samples, max_frames: int,
                generator: torch.Generator | None = None):
        """``[B, S], [B] -> ([B, max_frames, dim], [B] frame counts)``."""
        frames, counts = frame_batch(waves, num_samples, max_frames, self.opts.frame_opts,
                                     self.device, generator)
        raw = mfcc_kernel.mfcc_frames(frames, self.tables)
        nb = self.opts.mel_opts.num_bins
        feats = torch.cat([raw[:, nb:], raw[:, :nb]], dim=1) if self.use_energy else raw[:, :nb]
        return feats.reshape(counts.shape[0], max_frames, -1), counts


class SpectrogramExtractor:
    """Log power-spectrogram features (feat/feature-spectrogram.h):
    ``padded // 2 + 1`` bins, Nyquist included, floored at ``FLT_EPS``.
    ``torch.fft.rfft``, as the JAX package's is an XLA ``jnp.fft.rfft``
    with no Pallas counterpart."""

    def __init__(self, opts: MfccOptions = MfccOptions(), *, device=None):
        self.opts = opts
        self.device = resolve_device(device)
        self.window = torch.from_numpy(feature_window(opts.frame_opts)).to(self.device)

    @property
    def dim(self) -> int:
        return self.opts.frame_opts.padded_window_size // 2 + 1

    def __call__(self, wave) -> torch.Tensor:
        return _single(self, wave)

    @ieee_fp32_entry
    def batched(self, waves, num_samples, max_frames: int,
                generator: torch.Generator | None = None):
        frames, counts = frame_batch(waves, num_samples, max_frames, self.opts.frame_opts,
                                     self.device, generator)
        feats = spectrogram_from_frames(frames, self.opts, self.window)
        return feats.reshape(counts.shape[0], max_frames, -1), counts


@ieee_fp32_entry
def spectrogram_from_frames(frames: torch.Tensor, opts: MfccOptions,
                            window: torch.Tensor) -> torch.Tensor:
    """``[N, ws]`` frames -> ``[N, padded // 2 + 1]`` log power spectra, in
    the frames' dtype."""
    frames, _ = _process_window(frames, opts, window)
    frames = F.pad(frames, (0, opts.frame_opts.padded_window_size - frames.shape[1]))
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.log(torch.clamp_min(spec.real ** 2 + spec.imag ** 2, FLT_EPS))


# ---------------------------------------------------------------------------
# PLP (perceptual linear prediction)
# ---------------------------------------------------------------------------


def mel_center_freqs(num_bins: int, frame_opts: FrameOptions,
                     low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Center frequency (Hz) of each mel bin (reference: MelBanks ctor
    center_freqs_, mel-computations.cc:89-104)."""
    nyquist = 0.5 * frame_opts.samp_freq
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    centers = inverse_mel_scale(mel_low + (np.arange(num_bins) + 1) * mel_delta)
    return centers.astype(np.float64)


def equal_loudness_vector(center_freqs: np.ndarray) -> np.ndarray:
    """Equal-loudness preemphasis curve per mel bin
    (reference: ``GetEqualLoudnessVector``, mel-computations.cc:313-324)."""
    fsq = center_freqs * center_freqs
    fsub = fsq / (fsq + 1.6e5)
    return (fsub * fsub * ((fsq + 1.44e6) / (fsq + 9.61e6))).astype(np.float32)


def idft_bases(n_bases: int, dimension: int) -> np.ndarray:
    """Inverse-DFT basis matrix ``[n_bases, dimension]`` mapping the
    (end-duplicated) compressed mel spectrum to autocorrelations
    (reference: ``InitIdftBases``, feat/feature-functions.cc:188-203)."""
    angle = math.pi / (dimension - 1)
    scale = 1.0 / (2.0 * (dimension - 1))
    i = np.arange(n_bases, dtype=np.float64)[:, None]
    j = np.arange(dimension, dtype=np.float64)[None, :]
    m = 2.0 * scale * np.cos(angle * i * j)
    m[:, 0] = scale
    m[:, -1] = scale * np.cos(angle * i[:, 0] * (dimension - 1))
    return m.astype(np.float32)


def durbin_lpc(autocorr: torch.Tensor, order: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Levinson-Durbin recursion, vectorized over frames:
    ``autocorr [N, order+1] -> (lpc [N, order], residual energy [N])``
    (reference: ``Durbin``, mel-computations.cc:269-299), in the JAX
    package's order of operations."""
    e = autocorr[:, 0]
    lp: list = []  # the coefficients' columns
    for i in range(order):
        ki = autocorr[:, i + 1]
        for j in range(i):
            ki = ki + lp[j] * autocorr[:, i - j]
        ki = ki / e
        e = e * torch.clamp_min(1.0 - ki * ki, 1.0e-5)
        lp = [lp[j] - ki * lp[i - j - 1] for j in range(i)] + [-ki]
    return torch.stack(lp, dim=1), e


def lpc_to_cepstrum(lpc: torch.Tensor, order: int) -> torch.Tensor:
    """LPC -> cepstrum recursion, vectorized over frames
    (reference: ``Lpc2Cepstrum``, mel-computations.cc:302-311)."""
    ceps: list = []
    for i in range(order):
        s = torch.zeros_like(lpc[:, 0])
        for j in range(i):
            s = s + float(i - j) * lpc[:, j] * ceps[i - j - 1]
        ceps.append(-lpc[:, i] - s / float(i + 1))
    return torch.stack(ceps, dim=1)


@dataclass(frozen=True)
class PlpTables:
    """K1's ``mel_power`` tables and the PLP tail's constants on one device."""

    opts: PlpOptions
    k1: MfccTables
    eql: torch.Tensor  # [num_bins] equal-loudness weights
    idft: torch.Tensor  # [lpc_order + 1, num_bins + 2]
    lifter: torch.Tensor  # [num_ceps]

    @classmethod
    def build(cls, opts: PlpOptions, device) -> "PlpTables":
        if opts.num_ceps > opts.lpc_order + 1:
            raise ValueError("num_ceps must be <= lpc_order + 1")
        mo = opts.mel_opts
        centers = mel_center_freqs(mo.num_bins, opts.frame_opts, mo.low_freq, mo.high_freq)
        lifter = (lifter_coeffs(opts.num_ceps, opts.cepstral_lifter)
                  if opts.cepstral_lifter != 0.0 else np.ones(opts.num_ceps, np.float32))

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        # K1's front half: the frame chain of ``opts`` and PLP's own mel bank,
        # ``opts.mel_opts`` (not a default ``MelOptions``)
        k1_opts = MfccOptions(frame_opts=opts.frame_opts, mel_opts=mo,
                              use_energy=opts.use_energy, energy_floor=opts.energy_floor,
                              raw_energy=opts.raw_energy)
        return cls(opts=opts, k1=MfccTables.build(k1_opts, "mel_power", device),
                   eql=dev(equal_loudness_vector(centers)),
                   idft=dev(idft_bases(opts.lpc_order + 1, mo.num_bins + 2)),
                   lifter=dev(lifter))


@ieee_fp32_entry
def plp_tail(raw: torch.Tensor, tables: PlpTables) -> torch.Tensor:
    """K1's ``mel_power`` rows ``[N, num_bins + 1]`` (mel energies, then the
    log energy) -> ``[N, num_ceps]`` PLP features (reference:
    ``PlpComputer::Compute``, feat/feature-plp.cc:112-188): equal loudness,
    compression, the end-duplicated IDFT product, Levinson-Durbin, the
    cepstrum, lifter, ``cepstral_scale``, ``use_energy`` and
    ``htk_compat``.  In the rows' dtype."""
    opts = tables.opts
    nb = opts.mel_opts.num_bins
    dt = raw.dtype
    mel, log_energy = raw[:, :nb] * tables.eql.to(dt)[None, :], raw[:, nb]
    mel = torch.pow(torch.clamp_min(mel, FLT_EPS), opts.compress_factor)
    dup = torch.cat([mel[:, :1], mel, mel[:, -1:]], dim=1)  # feature-plp.cc:152-154
    autocorr = dup @ tables.idft.to(dt).T
    lpc, resid_e = durbin_lpc(autocorr, opts.lpc_order)
    # residual_log_energy = log(E), floored like the reference (flt-min clamp)
    tiny = float(np.finfo(np.float32).tiny)
    resid_log_e = torch.clamp_min(torch.log(torch.clamp_min(resid_e, tiny)), tiny)
    raw_ceps = lpc_to_cepstrum(lpc, opts.lpc_order)
    feat = torch.cat([resid_log_e[:, None], raw_ceps[:, : opts.num_ceps - 1]], dim=1)
    feat = feat * tables.lifter.to(dt)[None, :]
    if opts.cepstral_scale != 1.0:
        feat = feat * opts.cepstral_scale
    if opts.use_energy:
        if opts.energy_floor > 0.0:
            log_energy = torch.clamp_min(log_energy, math.log(opts.energy_floor))
        feat = torch.cat([log_energy[:, None], feat[:, 1:]], dim=1)
    if opts.htk_compat:  # reorder only: energy/C0 last (feature-plp.cc:182-187)
        feat = torch.cat([feat[:, 1:], feat[:, :1]], dim=1)
    return feat


def plp_from_frames(frames: torch.Tensor, tables: PlpTables) -> torch.Tensor:
    """Plain version of the PLP chain: ``[N, ws]`` dithered frames ->
    ``[N, num_ceps]``, K1's plain version in ``mel_power`` mode, then the
    tail."""
    return plp_tail(mfcc_from_frames(frames, tables.k1), tables)


class PlpExtractor:
    """PLP features (reference: ``PlpComputer``/``Plp``,
    feat/feature-plp.h:99-167).  The front half (DC, preemphasis, window,
    FFT, power, mel) is K1 in ``mel_power`` mode; the tail runs in torch on
    its rows."""

    def __init__(self, opts: PlpOptions = PlpOptions(), *, device=None):
        self.opts = opts
        self.device = resolve_device(device)
        self.tables = PlpTables.build(opts, self.device)

    @property
    def dim(self) -> int:
        return self.opts.num_ceps

    def __call__(self, wave, generator: torch.Generator | None = None) -> torch.Tensor:
        """``[S] -> [num_frames, num_ceps]`` on the extractor's device."""
        return _single(self, wave, generator)

    @ieee_fp32_entry
    def batched(self, waves, num_samples, max_frames: int,
                generator: torch.Generator | None = None):
        """``[B, S], [B] -> ([B, max_frames, num_ceps], [B] frame counts)``."""
        frames, counts = frame_batch(waves, num_samples, max_frames, self.opts.frame_opts,
                                     self.device, generator)
        raw = mfcc_kernel.mfcc_frames(frames, self.tables.k1)
        return plp_tail(raw, self.tables).reshape(counts.shape[0], max_frames, -1), counts


# ---------------------------------------------------------------------------
# Deltas and splicing (batched, length-aware edge clamping)
# ---------------------------------------------------------------------------


@ieee_fp32_entry
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
