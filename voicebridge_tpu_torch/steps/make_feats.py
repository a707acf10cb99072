"""Feature pipeline step: batched MFCC [+ pitch] + per-speaker CMVN (+ deltas/splice).

Port of ``voicebridge_tpu/steps/make_feats.py`` (the reference's MakeMfcc +
ComputeCmvnStats + apply-cmvn | add-deltas | splice-feats chain).  Utterances are padded
into length buckets and framed, transformed and filterbanked together on the
given device; on CUDA every bucket goes through the fused MFCC kernel, on the
CPU through its plain version.  Features stay on the device as tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DeltaOptions, MfccOptions, SpliceOptions

from ..device import ieee_fp32_entry, resolve_device
from ..ops.features import MfccExtractor, add_deltas_batch, splice_frames_batch
from ..transforms.cmvn import acc_cmvn_stats_batch, apply_cmvn_batch
from ..utils import profiling


def _bucket(lengths: list[int], num_buckets: int = 4) -> list[int]:
    """Pad-length per utterance: quantile buckets to bound pad waste."""
    arr = np.sort(np.unique(lengths))
    qs = [arr[min(int(len(arr) * (i + 1) / num_buckets), len(arr) - 1)]
          for i in range(num_buckets)]
    out = []
    for n in lengths:
        out.append(int(next(q for q in qs if q >= n)))
    return out


def pad_features(feats: dict[str, torch.Tensor], utts: list[str]):
    """Stack ``utts``' ``[T_u, D]`` features into ``([B, T_max, D], [B] frame
    counts)`` zero-padded tensors on the features' device."""
    batch = torch.nn.utils.rnn.pad_sequence([feats[u] for u in utts], batch_first=True)
    nf = torch.tensor([feats[u].shape[0] for u in utts], dtype=torch.int32,
                      device=batch.device)
    return batch, nf


@ieee_fp32_entry
def compute_mfcc(waves: dict[str, np.ndarray], opts: MfccOptions, *, device=None,
                 dither_seed: int | None = 0) -> dict[str, torch.Tensor]:
    """utt -> samples  =>  utt -> [T, num_ceps] MFCC on ``device``, batched
    by length bucket.  Dither noise of a bucket is drawn from a
    ``torch.Generator`` seeded with ``dither_seed + pad_len``."""
    device = resolve_device(device)
    ext = MfccExtractor(opts, device=device)
    utts = sorted(waves)
    by_bucket: dict[int, list[str]] = {}
    for u, b in zip(utts, _bucket([len(waves[u]) for u in utts])):
        by_bucket.setdefault(b, []).append(u)
    out: dict[str, torch.Tensor] = {}
    for pad_len, us in sorted(by_bucket.items()):
        batch = np.zeros((len(us), pad_len), np.float32)
        for i, u in enumerate(us):
            batch[i, : len(waves[u])] = waves[u]
        ns = torch.tensor([len(waves[u]) for u in us], dtype=torch.int64)
        gen = None
        if opts.frame_opts.dither != 0.0 and dither_seed is not None:
            gen = torch.Generator(device=device)
            gen.manual_seed(dither_seed + pad_len)
        feats, counts = ext.batched(torch.from_numpy(batch).to(device), ns,
                                    opts.frame_opts.num_frames(pad_len), gen)
        for i, (u, n) in enumerate(zip(us, profiling.to_host(counts, "frame_counts").tolist())):
            out[u] = feats[i, :n]
    return out


def compute_cmvn(feats: dict[str, torch.Tensor],
                 utt2spk: dict[str, str]) -> dict[str, torch.Tensor]:
    """Per-speaker CMVN stats: spk -> [2, D+1]."""
    utts = sorted(feats)
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    batch, nf = pad_features(feats, utts)
    sid = torch.tensor([spk_idx[utt2spk[u]] for u in utts], device=batch.device)
    stats = acc_cmvn_stats_batch(batch, nf, sid, len(speakers))
    return {s: stats[spk_idx[s]] for s in speakers}


@ieee_fp32_entry
def apply_feature_chain(feats: dict[str, torch.Tensor], utt2spk: dict[str, str],
                        cmvn_stats: dict[str, torch.Tensor],
                        deltas: DeltaOptions | None = DeltaOptions(),
                        splice: SpliceOptions | None = None) -> dict[str, torch.Tensor]:
    """apply-cmvn [-> add-deltas | splice-feats] for every utterance, batched.
    With ``deltas=None`` and ``splice=None`` the CMVN'd base features."""
    utts, out, nf = _cmvn_applied(feats, utt2spk, cmvn_stats)
    return _context_added(feats, utts, out, nf, deltas, splice)


def _cmvn_applied(feats: dict[str, torch.Tensor], utt2spk: dict[str, str],
                  cmvn_stats: dict[str, torch.Tensor]):
    """apply-cmvn of every utterance as one padded batch: (utts, [B, T, D],
    [B] frame counts)."""
    utts = sorted(feats)
    batch, nf = pad_features(feats, utts)
    speakers = sorted({utt2spk[u] for u in utts})
    spk_idx = {s: i for i, s in enumerate(speakers)}
    stats = torch.stack([cmvn_stats[s] for s in speakers])
    sid = torch.tensor([spk_idx[utt2spk[u]] for u in utts], device=batch.device)
    return utts, apply_cmvn_batch(batch, stats, sid), nf


def _context_added(feats: dict[str, torch.Tensor], utts: list[str], out: torch.Tensor,
                   nf: torch.Tensor, deltas: DeltaOptions | None,
                   splice: SpliceOptions | None) -> dict[str, torch.Tensor]:
    """add-deltas or splice-feats of the CMVN'd batch (neither: as it is),
    cut back to one tensor per utterance."""
    if deltas is not None:
        out = add_deltas_batch(out, nf, deltas)
    elif splice is not None:
        out = splice_frames_batch(out, nf, splice)
    return {u: out[i, : feats[u].shape[0]] for i, u in enumerate(utts)}


def paste_pitch(mfcc: dict[str, torch.Tensor], waves: dict[str, np.ndarray],
                mfcc_opts: MfccOptions) -> dict[str, torch.Tensor]:
    """MakeMfccPitch's side chain: each utterance's 3-dim pitch features
    (``ops.pitch.compute_pitch_feats``, on the host) pasted onto its MFCC on
    the MFCC's device, both cut to the shorter length (paste-feats)."""
    from ..ops.pitch import PitchOptions, compute_pitch_feats

    fo = mfcc_opts.frame_opts
    popts = PitchOptions(samp_freq=fo.samp_freq, frame_shift_ms=fo.frame_shift_ms,
                         frame_length_ms=fo.frame_length_ms)
    out = {}
    for u, f in mfcc.items():
        pitch = torch.from_numpy(compute_pitch_feats(waves[u], popts)).to(f.device)
        t = min(f.shape[0], pitch.shape[0])
        out[u] = torch.cat([f[:t], pitch[:t]], dim=1)
    return out


@ieee_fp32_entry
def make_features(waves: dict[str, np.ndarray], utt2spk: dict[str, str],
                  mfcc_opts: MfccOptions,
                  deltas: DeltaOptions | None = DeltaOptions(),
                  splice: SpliceOptions | None = None, *, device=None,
                  dither_seed: int | None = 0, pitch: bool = False) -> dict[str, torch.Tensor]:
    """Full frontend on ``device``: MFCC [+ pitch] -> per-speaker CMVN ->
    deltas or splice (neither: the CMVN'd MFCC that the LDA path takes).
    ``pitch=True`` pastes the 3-dim pitch features (MakeMfccPitch role)
    before CMVN."""
    with profiling.span("features"):
        with profiling.span("features.mfcc"):
            mfcc = compute_mfcc(waves, mfcc_opts, device=device, dither_seed=dither_seed)
            if pitch:
                mfcc = paste_pitch(mfcc, waves, mfcc_opts)
        with profiling.span("features.cmvn"):
            cmvn = compute_cmvn(mfcc, utt2spk)
            utts, out, nf = _cmvn_applied(mfcc, utt2spk, cmvn)
        with profiling.span("features.deltas"):
            return _context_added(mfcc, utts, out, nf, deltas, splice)
