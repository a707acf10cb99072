"""K1 wrapper: the fused MFCC frame chain (``csrc/mfcc.cu``).

Replaces the Pallas kernel ``voicebridge_tpu/ops/pallas_mfcc.py``
(``_mfcc_kernel``).  The kernel takes every padded window size up to
``MAX_FFT`` points: a power of two from 64 through its FFT, any other size
through its DFT product.  Its output rows are cepstra, log-mel bins or,
for PLP, mel energies (``MfccTables.mode``).  A CPU tensor goes to the plain
version ``ops.features.mfcc_from_frames``; a CUDA tensor goes to the kernel
or raises.  Launches in ``mel_power`` mode count apart, as
``mfcc_mel_power``.
"""

from __future__ import annotations

import torch

from .. import _build
from ..device import stream_handle
from . import features

MAX_FFT = 4096  # 85 ms frames at 48 kHz


def mfcc_frames(frames: torch.Tensor, tables: "features.MfccTables") -> torch.Tensor:
    """``[N, window_size]`` dithered frames -> ``[N, tables.out_cols]``:
    cepstra (log-mel bins in ``fbank`` mode, mel energies in ``mel_power``
    mode), then the log energy."""
    if frames.device.type == "cpu":
        return features.mfcc_from_frames(frames, tables)
    opts = tables.opts
    fo = opts.frame_opts
    n_fft = fo.padded_window_size
    ws = fo.window_size
    nb = opts.mel_opts.num_bins
    if frames.device.type != "cuda":
        raise ValueError(f"unsupported device {frames.device}")
    if frames.dtype != torch.float32 or frames.dim() != 2 or frames.shape[1] != ws:
        raise ValueError(f"frames must be float32 [N, {ws}], got "
                         f"{frames.dtype} {tuple(frames.shape)}")
    if not frames.is_contiguous():
        raise ValueError("frames must be contiguous")
    if n_fft > MAX_FFT:
        raise ValueError(f"padded window of {n_fft} points: the MFCC kernel takes at most "
                         f"{MAX_FFT} ({fo.frame_length_ms} ms at {fo.samp_freq} Hz is too long)")
    if nb > n_fft // 2 or (tables.mode == "mfcc" and opts.num_ceps > nb):
        raise ValueError(f"{nb} mel bins and {opts.num_ceps} cepstra do not fit a "
                         f"{n_fft}-point FFT")
    tabs = (tables.window, tables.twiddle, tables.mel_lo, tables.mel_len, tables.mel_band,
            tables.dct_t, tables.lifter)
    if any(t.device != frames.device for t in tabs):
        raise ValueError("tables and frames lie on different devices")
    out = torch.empty((frames.shape[0], tables.out_cols), dtype=torch.float32,
                      device=frames.device)
    if frames.shape[0] == 0:
        return out
    _build.launch(
        "mfcc_frames", frames.data_ptr(), frames.shape[0], ws, n_fft,
        tables.window.data_ptr(), tables.twiddle.data_ptr(), tables.mel_lo.data_ptr(),
        tables.mel_len.data_ptr(), tables.mel_band.data_ptr(), nb, tables.dct_t.data_ptr(),
        tables.lifter.data_ptr(), opts.num_ceps, int(fo.remove_dc_offset), fo.preemph_coeff,
        int(opts.raw_energy), tables.mel_floor, features.MODES.index(tables.mode),
        out.data_ptr(), stream_handle(frames.device),
        count="mfcc_mel_power" if tables.mode == "mel_power" else "mfcc_frames")
    return out
