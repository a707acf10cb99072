"""Frame-parametric formant speech synthesizer (Klatt-style, spectral domain).

The reference's integration oracles are real corpora (Yes-No ~2% WER,
LibriSpeech 5.92% WER — ``TestDll/TestDll/YesNo.cpp:32``,
``LibriSpeech.cpp:40``) whose audio ships in a separate data repository that
is not available offline.  This module synthesizes a LibriSpeech-*shaped*
stand-in: real phonetic structure (vowel formants, diphthong glides, stop
closures + bursts, shaped fricative noise, nasal murmurs), per-speaker
vocal-tract-length warp / pitch / speaking-rate / breathiness, coarticulated
formant tracks, pitch declination and jitter — enough acoustic realism that a
GMM-HMM pipeline must genuinely model context, speakers, and duration to win.

Synthesis model per 10 ms frame: a harmonic source (pulse-train spectrum with
-6 dB/oct tilt) and a white-noise source are both shaped by a Lorentzian
formant envelope / Gaussian frication band and mixed per the phone's voicing.
Harmonics are rendered as an oscillator bank on the exact running phase of a
declinating, jittered f0 track; noise is rendered by windowed overlap-add
filtering.  Everything is vectorized numpy; ~1 h of 16 kHz audio synthesizes
in well under a minute.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SR = 16000.0
FRAME_S = 0.01  # parameter frame hop (matches the MFCC frame shift)

# --------------------------------------------------------------------- phones
# (F1, F2, F3) formant targets in Hz, male-reference vocal tract.
_VOWELS = {
    "IY": (270, 2290, 3010), "IH": (390, 1990, 2550), "EH": (530, 1840, 2480),
    "AE": (660, 1720, 2410), "AA": (730, 1090, 2440), "AO": (570, 840, 2410),
    "UH": (440, 1020, 2240), "UW": (300, 870, 2240), "AH": (640, 1190, 2390),
    "ER": (490, 1350, 1690),
}
# diphthongs: (start, end) formant targets
_DIPHS = {
    "EY": ((480, 2000, 2600), (310, 2200, 2900)),
    "AY": ((730, 1120, 2440), (390, 2000, 2650)),
    "AW": ((720, 1100, 2440), (430, 1000, 2300)),
    "OW": ((560, 920, 2400), (420, 900, 2300)),
    "OY": ((560, 860, 2400), (420, 1800, 2600)),
}
# sonorant consonants: formants + amplitude shaping
_SONORANTS = {
    "M": (250, 1050, 2200), "N": (250, 1700, 2600), "NG": (250, 2300, 2750),
    "L": (360, 1300, 2700), "R": (420, 1300, 1690),
    "W": (300, 700, 2200), "Y": (280, 2250, 3000),
}
_NASALS = ("M", "N", "NG")
# fricatives: (noise center Hz, noise half-width Hz, level, voiced)
_FRICS = {
    "S": (6200, 2200, 1.0, False), "Z": (6200, 2200, 0.8, True),
    "SH": (3300, 1400, 1.0, False), "ZH": (3300, 1400, 0.8, True),
    "F": (4500, 3400, 0.35, False), "V": (4200, 3200, 0.30, True),
    "TH": (5200, 3400, 0.30, False), "DH": (5000, 3200, 0.28, True),
    "HH": (1500, 1800, 0.45, False),
}
# stops: (burst center Hz, burst half-width Hz, voiced)
_STOPS = {
    "P": (900, 1300, False), "B": (900, 1300, True),
    "T": (4200, 1900, False), "D": (4200, 1900, True),
    "K": (2200, 1200, False), "G": (2200, 1200, True),
}
# affricates expand to stop closure + fricative noise
_AFFRICS = {"CH": ("T", "SH"), "JH": ("D", "ZH")}

PHONES = (sorted(_VOWELS) + sorted(_DIPHS) + sorted(_SONORANTS)
          + sorted(_FRICS) + sorted(_STOPS) + sorted(_AFFRICS))

# mean duration in seconds
_DUR = {}
_DUR.update({p: 0.105 for p in _VOWELS})
_DUR.update({p: 0.150 for p in _DIPHS})
_DUR.update({p: 0.065 for p in _SONORANTS})
_DUR.update({p: 0.095 for p in _FRICS})
_DUR["HH"] = 0.060
_DUR.update({p: 0.060 for p in _STOPS})  # closure + burst
_DUR.update({p: 0.120 for p in _AFFRICS})


@dataclass
class Speaker:
    """Per-speaker acoustic parameters (the axes SAT/fMLLR must absorb)."""
    name: str
    warp: float = 1.0        # vocal-tract-length formant scale
    f0_base: float = 120.0   # Hz
    f0_range: float = 1.0    # pitch-excursion scale
    rate: float = 1.0        # speaking-rate (duration divisor)
    gain: float = 1.0
    breath: float = 0.01     # aspiration-noise floor during voicing
    tilt: float = 1.0        # spectral-tilt scale (glottal source shape)

    @classmethod
    def random(cls, name: str, rng: np.random.Generator) -> "Speaker":
        female = rng.random() < 0.5
        return cls(
            name=name,
            warp=float(rng.uniform(1.05, 1.22) if female
                       else rng.uniform(0.88, 1.05)),
            f0_base=float(rng.uniform(180, 240) if female
                          else rng.uniform(95, 140)),
            f0_range=float(rng.uniform(0.7, 1.4)),
            rate=float(rng.uniform(0.85, 1.2)),
            gain=float(rng.uniform(0.5, 1.5)),
            breath=float(rng.uniform(0.004, 0.03)),
            tilt=float(rng.uniform(0.8, 1.25)),
        )


# ------------------------------------------------------------- track building

def _phone_frames(phone: str, spk: Speaker, rng) -> list[dict]:
    """Expand one phone into a list of per-frame parameter dicts."""
    dur = _DUR[phone] * float(rng.uniform(0.75, 1.3)) / spk.rate
    n = max(2, int(round(dur / FRAME_S)))
    w = spk.warp

    def frames_formant(f_start, f_end, voiced, amp, hf=1.0, noise=None):
        out = []
        for i in range(n):
            a = i / max(1, n - 1)
            f = tuple(w * ((1 - a) * s + a * e) for s, e in zip(f_start, f_end))
            out.append(dict(formants=f, voiced=voiced, amp=amp, hf=hf,
                            noise=noise))
        return out

    if phone in _VOWELS:
        f = _VOWELS[phone]
        return frames_formant(f, f, 1.0, 1.0)
    if phone in _DIPHS:
        s, e = _DIPHS[phone]
        return frames_formant(s, e, 1.0, 1.0)
    if phone in _SONORANTS:
        f = _SONORANTS[phone]
        hf = 0.22 if phone in _NASALS else 0.8
        return frames_formant(f, f, 1.0, 0.55, hf=hf)
    if phone in _FRICS:
        c, hw, lvl, voiced = _FRICS[phone]
        out = []
        for _ in range(n):
            out.append(dict(formants=(500.0 * w, 1500.0 * w, 2500.0 * w),
                            voiced=0.35 if voiced else 0.0,
                            amp=0.28 if voiced else 0.0, hf=0.5,
                            noise=(c * w, hw * w, lvl)))
        return out
    if phone in _STOPS:
        c, hw, voiced = _STOPS[phone]
        n_burst = max(1, int(round(0.015 / FRAME_S)))
        n_clo = max(1, n - n_burst)
        clo = dict(formants=(250.0 * w, 1200.0 * w, 2400.0 * w),
                   voiced=0.5 if voiced else 0.0,
                   amp=0.10 if voiced else 0.0, hf=0.05, noise=None)
        burst = dict(formants=(400.0 * w, 1500.0 * w, 2500.0 * w),
                     voiced=0.0, amp=0.0, hf=0.3,
                     noise=(c * w, hw * w, 0.9))
        return [dict(clo) for _ in range(n_clo)] + \
               [dict(burst) for _ in range(n_burst)]
    if phone in _AFFRICS:
        stop, fric = _AFFRICS[phone]
        c, hw, lvl, voiced = _FRICS[fric]
        n_clo = max(1, int(round(0.04 / FRAME_S / spk.rate)))
        n_fric = max(2, n - n_clo)
        clo = dict(formants=(250.0 * w, 1200.0 * w, 2400.0 * w),
                   voiced=0.5 if _STOPS[stop][2] else 0.0,
                   amp=0.10 if _STOPS[stop][2] else 0.0, hf=0.05, noise=None)
        fr = dict(formants=(500.0 * w, 1500.0 * w, 2500.0 * w),
                  voiced=0.3 if voiced else 0.0,
                  amp=0.22 if voiced else 0.0, hf=0.5,
                  noise=(c * w, hw * w, lvl))
        return [dict(clo) for _ in range(n_clo)] + \
               [dict(fr) for _ in range(n_fric)]
    raise ValueError(f"unknown phone {phone!r}")


def _sil_frames(dur_s: float) -> list[dict]:
    n = max(1, int(round(dur_s / FRAME_S)))
    return [dict(formants=(500.0, 1500.0, 2500.0), voiced=0.0, amp=0.0,
                 hf=0.0, noise=None) for _ in range(n)]


def _smooth(x: np.ndarray, k: int) -> np.ndarray:
    """Box-filter smoothing along axis 0 (coarticulation of tracks)."""
    if k <= 1 or x.shape[0] < 3:
        return x
    k |= 1  # odd kernel keeps the output length equal to the input
    pad = np.concatenate([x[:1]] * (k // 2) + [x] + [x[-1:]] * (k // 2))
    ker = np.ones(k) / k
    return np.apply_along_axis(lambda v: np.convolve(v, ker, "valid"), 0, pad)


# ------------------------------------------------------------- frame renderer

_BWS = np.array([90.0, 110.0, 160.0])     # formant bandwidths
_FAMP = np.array([1.0, 0.55, 0.28])       # per-formant envelope amplitudes


def _render(frames: list[dict], spk: Speaker, rng) -> np.ndarray:
    """Render a frame-parameter track list into a 16 kHz waveform."""
    t_frames = len(frames)
    hop = int(SR * FRAME_S)
    n = t_frames * hop

    formants = _smooth(np.array([f["formants"] for f in frames]), 3)  # [T,3]
    voiced = _smooth(np.array([[f["voiced"]] for f in frames]), 3)[:, 0]
    amp = _smooth(np.array([[f["amp"]] for f in frames]), 3)[:, 0]
    hf = np.array([f["hf"] for f in frames])
    noise_c = np.array([f["noise"][0] if f["noise"] else 0.0 for f in frames])
    noise_w = np.array([f["noise"][1] if f["noise"] else 1.0 for f in frames])
    noise_l = _smooth(np.array([[f["noise"][2] if f["noise"] else 0.0]
                                for f in frames]), 2)[:, 0]

    # ---- f0 track: declination + micro-jitter + gentle accent wander
    decl = np.linspace(1.06, 0.82, t_frames)
    wander = 1.0 + 0.08 * spk.f0_range * np.sin(
        2 * np.pi * np.arange(t_frames) * FRAME_S / rng.uniform(0.8, 1.6)
        + rng.uniform(0, 6.28))
    jit = 1.0 + 0.02 * rng.standard_normal(t_frames)
    f0 = spk.f0_base * decl * wander * jit
    f0 = np.clip(f0, 60.0, 400.0)

    # ---- harmonic oscillator bank on the running phase
    f0_s = np.repeat(f0, hop)
    phase = np.cumsum(2 * np.pi * f0_s / SR)
    n_harm = min(60, int(7600.0 / float(f0.min())))
    k = np.arange(1, n_harm + 1, dtype=np.float64)           # [K]
    hf_k = k[:, None] * f0[None, :]                          # [K,T]
    env = np.zeros_like(hf_k)
    for i in range(3):
        env += _FAMP[i] / (1.0 + ((hf_k - formants[None, :, i])
                                  / (_BWS[i] * spk.warp)) ** 2)
    # glottal tilt ~ -6 dB/oct above 500 Hz, speaker-scaled; hf droop for
    # nasals/closures
    tilt = (1.0 + (hf_k / 500.0) ** 2) ** (-0.5 * spk.tilt)
    droop = np.where(hf_k > 1000.0, hf[None, :], 1.0)
    amp_kt = env * tilt * droop * (voiced * amp)[None, :]    # [K,T]
    # per-sample linear interpolation of harmonic amplitudes
    tpos = np.arange(n) / hop - 0.5
    i0 = np.clip(np.floor(tpos).astype(int), 0, t_frames - 1)
    i1 = np.clip(i0 + 1, 0, t_frames - 1)
    wfrac = np.clip(tpos - i0, 0.0, 1.0)
    amp_s = amp_kt[:, i0] * (1 - wfrac) + amp_kt[:, i1] * wfrac  # [K,N]
    phases0 = rng.uniform(0, 2 * np.pi, n_harm)
    voiced_sig = np.einsum("kn,kn->n", amp_s,
                           np.sin(k[:, None] * phase[None, :]
                                  + phases0[:, None]))

    # ---- noise source: per-frame spectral shaping via windowed overlap-add
    win_len = 2 * hop
    fft_n = 512
    freqs = np.fft.rfftfreq(fft_n, 1.0 / SR)                 # [F]
    # frication band + aspiration floor shaped by the formant envelope
    fric = (noise_l[:, None]
            * np.exp(-((freqs[None, :] - noise_c[:, None])
                       / noise_w[:, None]) ** 2))            # [T,F]
    form_env = np.zeros((t_frames, freqs.size))
    for i in range(3):
        form_env += _FAMP[i] / (1.0 + ((freqs[None, :] - formants[:, i:i+1])
                                       / (_BWS[i] * spk.warp)) ** 2)
    asp = spk.breath * (voiced * amp)[:, None] * form_env
    noise_spec = fric + asp
    noise = rng.standard_normal(n + win_len)
    idx = np.arange(win_len)[None, :] + hop * np.arange(t_frames)[:, None]
    segs = noise[idx] * np.hanning(win_len)[None, :]         # [T,W]
    spec = np.fft.rfft(segs, fft_n, axis=1) * noise_spec
    shaped = np.fft.irfft(spec, fft_n, axis=1)[:, :win_len]
    noise_sig = np.zeros(n + win_len)
    np.add.at(noise_sig, idx, shaped)
    noise_sig = noise_sig[:n]

    sig = voiced_sig + 1.6 * noise_sig
    # utterance-level amplitude envelope (soft attack/decay)
    edge = int(0.02 * SR)
    ramp = np.minimum(1.0, np.minimum(np.arange(n), n - np.arange(n))
                      / max(1, edge))
    return (sig * ramp).astype(np.float32)


# ------------------------------------------------------------------ top level

def synth_utterance(words: list[str], lexicon: dict, spk: Speaker,
                    rng: np.random.Generator, snr_db: float = 30.0,
                    peak: float = 8000.0) -> np.ndarray:
    """Synthesize one utterance.  ``lexicon``: word -> [(prob, phones)]."""
    frames: list[dict] = _sil_frames(rng.uniform(0.12, 0.30))
    for i, w in enumerate(words):
        prons = lexicon[w]
        phones = prons[int(rng.integers(len(prons)))][1]
        for p in phones:
            frames += _phone_frames(p, spk, rng)
        if i < len(words) - 1 and rng.random() < 0.18:
            frames += _sil_frames(rng.uniform(0.03, 0.12))
    frames += _sil_frames(rng.uniform(0.12, 0.30))
    sig = _render(frames, spk, rng)
    rms = float(np.sqrt(np.mean(sig**2)) + 1e-9)
    sig = sig * (peak * 0.22 * spk.gain / rms)
    noise_rms = peak * 0.22 * spk.gain * 10 ** (-snr_db / 20.0)
    sig = sig + noise_rms * rng.standard_normal(sig.size).astype(np.float32)
    return np.clip(sig, -30000, 30000).astype(np.float32)
