"""Kaldi-fidelity pitch features: NCCF + Viterbi tracking + POV processing.

Port of ``voicebridge_tpu/ops/pitch.py`` (numpy on the host, as there), the
counterpart of the reference's ``compute-kaldi-pitch-feats`` /
``process-kaldi-pitch-feats`` (``kaldi-master/src/feat/pitch-functions.{h,cc}``,
the Ghahremani et al. 2014 tracker; pipeline ``scr/steps/make_mfcc_pitch.cpp``).
The Viterbi recursion runs in ``csrc/pitch.cpp``, built with ``g++`` at first
use into ``_build/`` (a failed build raises; no binary is committed); with a
zero transition penalty (``ifactor <= 0``), where its lower envelope divides
by zero, the numpy recursion ``viterbi_pitch_plain`` runs instead.  The full
algorithm, with the reference's formulas and defaults:

extraction (``OnlinePitchFeatureImpl``, offline batch form):
  1. resample the wave to ``resample_freq`` (4 kHz) with a bandlimited
     windowed-sinc low-pass at ``lowpass_cutoff`` (1 kHz)
     (pitch-functions.cc:719-721);
  2. NCCF over integer lags spanning [1/max_f0, 1/min_f0] (plus upsample
     filter margin), in TWO variants: with the energy-derived ballast term
     ``(mean_square * window)^2 * nccf_ballast`` for the pitch search, and
     ballast-free for POV (pitch-functions.cc:1140-1151);
  3. windowed-sinc interpolation of both NCCFs onto geometrically spaced
     lags with ratio ``1 + delta_pitch`` (SelectLags; ArbitraryResample with
     cutoff ``resample_freq/2`` and ``upsample_filter_width`` zeros);
  4. Viterbi over lag indices minimizing
     ``local_cost + (j - i)^2 * penalty_factor * log(1+delta_pitch)^2`` with
     ``local_cost = 1 - nccf * (1 - soft_min_f0 * lag)`` (eq. 5 of the
     paper; ComputeLocalCost, ComputeBacktraces:316-371);
  5. per frame output (nccf_pov at the chosen lag, pitch = 1/lag).

processing (``OnlineProcessPitch``):
  * pov_feature = pov_scale * NccfToPovFeature(nccf)
    with NccfToPovFeature(n) = (1.0001 - n)^0.15 - 1 (cc:44-53);
  * normalized_log_pitch = pitch_scale * (log pitch - POV-weighted mean of
    log pitch over [t-75, t+75]), weights NccfToPov(n): the calibrated
    voicing probability p = sigmoid(-5.2 + 5.4 e^{7.5(n'-1)} + 4.8 n'
    - 2 e^{-10 n'} + 4.2 e^{20(n'-1)}) (cc:78-90);
  * delta_pitch = delta_pitch_scale * (delta(log pitch) + N(0,
    delta_pitch_noise_stddev)) with the standard Kaldi delta window
    (ComputeDeltas, window 2, edge-replicated);
  * optional raw log pitch.

Default output is the reference's 3-dim (pov, normalized-log-pitch,
delta-pitch) contract pasted onto MFCCs by MakeMfccPitch.

Offline simplification vs the online class: the ballast term uses the
WHOLE utterance's mean-square energy.  The reference converges to exactly
this for utterances shorter than ``recompute_frame`` (500 frames = 5 s,
the RecomputeBacktraces path); beyond that its frames use a running
estimate that differs negligibly.  Host-side numpy like the rest of the
frontend glue (the per-frame lag search is 208 states; MFCC carries the
FLOPs).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.wave import resample as _resample_wave


@dataclass(frozen=True)
class PitchOptions:
    """PitchExtractionOptions (pitch-functions.h:42-142) defaults."""

    samp_freq: float = 16000.0
    frame_shift_ms: float = 10.0
    frame_length_ms: float = 25.0
    min_f0: float = 50.0
    max_f0: float = 400.0
    soft_min_f0: float = 10.0
    penalty_factor: float = 0.1
    lowpass_cutoff: float = 1000.0
    resample_freq: float = 4000.0
    delta_pitch: float = 0.005
    nccf_ballast: float = 7000.0
    lowpass_filter_width: int = 1
    upsample_filter_width: int = 5


@dataclass(frozen=True)
class ProcessPitchOptions:
    """ProcessPitchOptions (pitch-functions.h:213-249) defaults."""

    pitch_scale: float = 2.0
    pov_scale: float = 2.0
    pov_offset: float = 0.0
    delta_pitch_scale: float = 10.0
    delta_pitch_noise_stddev: float = 0.005
    normalization_left_context: int = 75
    normalization_right_context: int = 75
    delta_window: int = 2
    add_pov_feature: bool = True
    add_normalized_log_pitch: bool = True
    add_delta_pitch: bool = True
    add_raw_log_pitch: bool = False


def nccf_to_pov_feature(n: np.ndarray) -> np.ndarray:
    """NccfToPovFeature (cc:44-53): Gaussianizing warp of the NCCF."""
    n = np.clip(n, -1.0, 1.0)
    return np.power(1.0001 - n, 0.15) - 1.0


def nccf_to_pov(n: np.ndarray) -> np.ndarray:
    """NccfToPov (cc:78-90): calibrated probability of voicing."""
    nd = np.minimum(np.abs(n), 1.0)
    r = (-5.2 + 5.4 * np.exp(7.5 * (nd - 1.0)) + 4.8 * nd
         - 2.0 * np.exp(-10.0 * nd) + 4.2 * np.exp(20.0 * (nd - 1.0)))
    return 1.0 / (1.0 + np.exp(-r))


def select_lags(opts: PitchOptions) -> np.ndarray:
    """SelectLags (cc:157-168): geometric lags (seconds), ratio 1+delta."""
    lags = []
    lag = 1.0 / opts.max_f0
    while lag <= 1.0 / opts.min_f0:
        lags.append(lag)
        lag *= 1.0 + opts.delta_pitch
    return np.asarray(lags)


def _sinc_interp_matrix(measured_pos: np.ndarray, target_pos: np.ndarray,
                        samp_rate: float, cutoff: float,
                        num_zeros: int) -> np.ndarray:
    """ArbitraryResample weights [targets, measured]: Hann-windowed sinc at
    ``cutoff`` for input samples at ``measured_pos`` (seconds) evaluated at
    ``target_pos`` (feat/resample.h:95)."""
    delta = target_pos[:, None] - measured_pos[None, :]
    support = num_zeros / (2.0 * cutoff)
    window = np.where(np.abs(delta) < support,
                      0.5 + 0.5 * np.cos(np.pi * delta / support), 0.0)
    taps = window * 2.0 * cutoff * np.sinc(2.0 * cutoff * delta) / samp_rate
    return taps


def compute_nccf(wave: np.ndarray, opts: PitchOptions):
    """Extraction steps 1-3 -> (nccf_pitch [T, L], nccf_pov [T, L],
    lags [L] seconds), both NCCFs already interpolated onto the geometric
    lag grid (pitch-functions.cc:1102-1161)."""
    rf = opts.resample_freq
    ds = _resample_wave(np.asarray(wave, np.float64), opts.samp_freq, rf,
                        num_zeros=max(2 * opts.lowpass_filter_width, 2)) \
        if opts.samp_freq != rf else np.asarray(wave, np.float64)
    ds = ds.astype(np.float64)

    lags = select_lags(opts)
    outer_min = 1.0 / opts.max_f0 - opts.upsample_filter_width / (2.0 * rf)
    outer_max = 1.0 / opts.min_f0 + opts.upsample_filter_width / (2.0 * rf)
    first_lag = int(np.ceil(rf * outer_min))
    last_lag = int(np.floor(rf * outer_max))
    ilags = np.arange(first_lag, last_lag + 1)

    wlen = int(rf * opts.frame_length_ms / 1000.0)  # 100 @ 4 kHz / 25 ms
    shift = int(rf * opts.frame_shift_ms / 1000.0)  # 40
    full = wlen + last_lag
    t = max((len(ds) - full) // shift + 1, 0)
    if t == 0:
        return (np.zeros((0, len(lags))), np.zeros((0, len(lags))), lags)

    n = len(ds)
    mean_square = float((ds * ds).sum() / n - (ds.sum() / n) ** 2)
    ballast_pitch = (mean_square * wlen) ** 2 * opts.nccf_ballast

    frames = np.lib.stride_tricks.sliding_window_view(ds, full)[::shift][:t]
    # zero-mean by the mean of the BASIC window (ComputeCorrelation:102-112)
    frames = frames - frames[:, :wlen].mean(axis=1, keepdims=True)
    base = frames[:, :wlen]
    e1 = np.einsum("td,td->t", base, base)
    inner = np.empty((t, len(ilags)))
    norm = np.empty((t, len(ilags)))
    for j, lag in enumerate(ilags):
        shifted = frames[:, lag: lag + wlen]
        inner[:, j] = np.einsum("td,td->t", base, shifted)
        norm[:, j] = e1 * np.einsum("td,td->t", shifted, shifted)
    with np.errstate(invalid="ignore", divide="ignore"):
        nccf_pitch_i = inner / np.sqrt(norm + ballast_pitch)
        nccf_pov_i = np.where(norm > 0, inner / np.sqrt(norm), 0.0)
    nccf_pitch_i = np.nan_to_num(nccf_pitch_i)

    # interpolate both NCCFs onto the geometric lags (upsample cutoff =
    # resample_freq / 2, filter width upsample_filter_width; cc:1155-1161)
    taps = _sinc_interp_matrix(ilags / rf, lags, rf, rf * 0.5,
                               opts.upsample_filter_width)
    return nccf_pitch_i @ taps.T, nccf_pov_i @ taps.T, lags


_PITCH_LIB = None


def _native_lib():
    """The pitch Viterbi library (``csrc/pitch.cpp``), built at first use."""
    global _PITCH_LIB
    if _PITCH_LIB is None:
        import ctypes

        from .._build import CSRC, build_host_library

        lib = ctypes.CDLL(str(build_host_library(CSRC / "pitch.cpp", "libvbt_pitch")))
        fn = lib.vb_pitch_viterbi
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int32, ctypes.c_int32,
                       ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                       ctypes.POINTER(ctypes.c_int32)]
        _PITCH_LIB = lib
    return _PITCH_LIB


def _local_costs(nccf_pitch: np.ndarray, lags: np.ndarray, opts: PitchOptions):
    """(local_cost [T, L], ifactor) of the recursion (ComputeLocalCost)."""
    local = 1.0 - nccf_pitch * (1.0 - opts.soft_min_f0 * lags[None, :])
    return local, np.log(1.0 + opts.delta_pitch) ** 2 * opts.penalty_factor


def viterbi_pitch_plain(nccf_pitch: np.ndarray, lags: np.ndarray,
                        opts: PitchOptions) -> np.ndarray:
    """The recursion of ``viterbi_pitch`` in numpy, one ``[L, L]`` candidate
    matrix a frame (first-minimum ties, as numpy's argmin)."""
    t, l = nccf_pitch.shape
    if t == 0:
        return np.zeros(0, np.int64)
    local, ifactor = _local_costs(nccf_pitch, lags, opts)
    idx = np.arange(l)
    trans = (idx[:, None] - idx[None, :]).astype(np.float64) ** 2 * ifactor
    cost = local[0].copy()
    bp = np.zeros((t, l), np.int64)
    for i in range(1, t):
        cand = cost[:, None] + trans  # [prev j, cur i]
        bp[i] = np.argmin(cand, axis=0)
        cost = cand[bp[i], idx] + local[i]
    track = np.zeros(t, np.int64)
    track[-1] = int(np.argmin(cost))
    for i in range(t - 1, 0, -1):
        track[i - 1] = bp[i, track[i]]
    return track


def viterbi_pitch(nccf_pitch: np.ndarray, lags: np.ndarray,
                  opts: PitchOptions) -> np.ndarray:
    """Steps 4-5: minimum-cost lag track [T] (ComputeBacktraces:306-371).

    cost(t, i) = local_cost(t, i) + min_j [ (j-i)^2 * ifactor + cost(t-1, j) ]
    with local_cost = 1 - nccf * (1 - soft_min_f0 * lag) and
    ifactor = log(1 + delta_pitch)^2 * penalty_factor.

    The recursion's inner minimum is a 1-D squared-distance transform; the
    native library (``csrc/pitch.cpp``) computes it with the O(L)
    lower-envelope algorithm.  Its parabolas' intersections divide by
    ``ifactor``, so ``ifactor <= 0`` (no transition penalty) takes
    ``viterbi_pitch_plain``.  Both give identical tracks except at
    exact-tie boundaries of measure zero."""
    t, l = nccf_pitch.shape
    if t == 0:
        return np.zeros(0, np.int64)
    local, ifactor = _local_costs(nccf_pitch, lags, opts)
    if ifactor <= 0.0:
        return viterbi_pitch_plain(nccf_pitch, lags, opts)
    import ctypes

    local_c = np.ascontiguousarray(local, np.float64)
    track32 = np.zeros(t, np.int32)
    rc = _native_lib().vb_pitch_viterbi(
        np.int32(t), np.int32(l), local_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        float(ifactor), track32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if rc != 0:
        raise RuntimeError(f"vb_pitch_viterbi failed ({rc})")
    return track32.astype(np.int64)


def compute_kaldi_pitch(wave: np.ndarray,
                        opts: PitchOptions = PitchOptions()) -> np.ndarray:
    """compute-kaldi-pitch-feats role: -> [T, 2] = (nccf_pov, pitch_hz)."""
    nccf_pitch, nccf_pov, lags = compute_nccf(wave, opts)
    t = nccf_pitch.shape[0]
    if t == 0:
        return np.zeros((0, 2), np.float32)
    track = viterbi_pitch(nccf_pitch, lags, opts)
    ti = np.arange(t)
    return np.stack([nccf_pov[ti, track], 1.0 / lags[track]],
                    axis=1).astype(np.float32)


def _kaldi_delta(x: np.ndarray, window: int) -> np.ndarray:
    """ComputeDeltas order-1 row (feature-functions.h:48-56): edge-replicated
    weighted slope sum_k k*(x[t+k]-x[t-k]) / (2*sum k^2)."""
    t = len(x)
    denom = 2.0 * sum(k * k for k in range(1, window + 1))
    out = np.zeros(t)
    for k in range(1, window + 1):
        plus = x[np.minimum(np.arange(t) + k, t - 1)]
        minus = x[np.maximum(np.arange(t) - k, 0)]
        out += k * (plus - minus)
    return out / denom


def process_pitch(raw: np.ndarray,
                  opts: ProcessPitchOptions = ProcessPitchOptions(),
                  seed: int = 0) -> np.ndarray:
    """process-kaldi-pitch-feats role: raw [T, 2] (nccf_pov, pitch_hz) ->
    [T, D] with the selected columns (default 3: pov, normalized-log-pitch,
    delta-pitch; OnlineProcessPitch cc:1432-1484)."""
    t = raw.shape[0]
    cols = []
    if t == 0:
        d = sum([opts.add_pov_feature, opts.add_normalized_log_pitch,
                 opts.add_delta_pitch, opts.add_raw_log_pitch])
        return np.zeros((0, d), np.float32)
    nccf = raw[:, 0].astype(np.float64)
    log_pitch = np.log(np.maximum(raw[:, 1].astype(np.float64), 1e-10))
    if opts.add_pov_feature:
        cols.append(opts.pov_scale * nccf_to_pov_feature(nccf)
                    + opts.pov_offset)
    if opts.add_normalized_log_pitch:
        pov = nccf_to_pov(nccf)
        wpitch = pov * log_pitch
        cp = np.concatenate([[0.0], np.cumsum(pov)])
        cwp = np.concatenate([[0.0], np.cumsum(wpitch)])
        ti = np.arange(t)
        lo = np.maximum(ti - opts.normalization_left_context, 0)
        hi = np.minimum(ti + opts.normalization_right_context + 1, t)
        avg = (cwp[hi] - cwp[lo]) / np.maximum(cp[hi] - cp[lo], 1e-20)
        cols.append(opts.pitch_scale * (log_pitch - avg))
    if opts.add_delta_pitch:
        rng = np.random.default_rng(seed)
        noise = rng.normal(0.0, opts.delta_pitch_noise_stddev, size=t)
        cols.append(opts.delta_pitch_scale
                    * (_kaldi_delta(log_pitch, opts.delta_window) + noise))
    if opts.add_raw_log_pitch:
        cols.append(log_pitch)
    return np.stack(cols, axis=1).astype(np.float32)


def compute_pitch_feats(wave: np.ndarray,
                        opts: PitchOptions = PitchOptions(),
                        process_opts: ProcessPitchOptions =
                        ProcessPitchOptions(),
                        seed: int = 0) -> np.ndarray:
    """Full MakeMfccPitch side-chain: wave -> processed pitch features
    (default [T, 3] = pov, normalized-log-pitch, delta-pitch)."""
    return process_pitch(compute_kaldi_pitch(wave, opts), process_opts,
                         seed=seed)


def paste_feats(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """paste-feats: column-concatenate, truncating to the shorter length."""
    t = min(a.shape[0], b.shape[0])
    return np.concatenate([a[:t], b[:t]], axis=1)
