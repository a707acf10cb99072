"""Parity of the PyTorch port's feature frontend with the JAX package.

The same numpy waves go through both packages on the CPU.  The port's MFCC
here is the plain version of its fused kernel (``torch.fft.rfft``); it is
held to the JAX XLA extractor and to the Pallas kernel in interpret mode with
the Pallas tests' tolerance (rtol 2e-4, atol 2e-3: fp32 FFTs of different
structure).  CMVN and deltas are elementwise sums: atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.config import DeltaOptions, FrameOptions, MelOptions, MfccOptions
from voicebridge_tpu.ops import features as JF
from voicebridge_tpu.ops.pallas_mfcc import MfccPallas
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu.transforms import cmvn as JC
from voicebridge_tpu_torch.ops import features as TF
from voicebridge_tpu_torch.ops import mfcc_kernel
from voicebridge_tpu_torch.steps.make_feats import make_features, pad_features
from voicebridge_tpu_torch.transforms import cmvn as TC

from synth import make_corpus

torch.set_num_threads(2)
MFCC_TOL = dict(rtol=2e-4, atol=2e-3)


def _wave(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (3000 * np.sin(2 * np.pi * 313 * t)
            + 1200 * np.sin(2 * np.pi * 1170 * t + 0.3)
            + 80 * rng.standard_normal(n)).astype(np.float32)


def _opts(sr, **kw):
    return MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0),
                       mel_opts=MelOptions(num_bins=23), **kw)


def _port_single(opts, wave, fbank=False):
    ext = TF.MfccExtractor(opts, device="cpu", fbank=fbank)
    nf = opts.frame_opts.num_frames(len(wave))
    feats, counts = ext.batched(torch.from_numpy(wave[None]), torch.tensor([len(wave)]), nf)
    assert int(counts[0]) == nf
    return feats[0].numpy()


@pytest.mark.parametrize("sr", [8000.0, 16000.0])
@pytest.mark.parametrize("use_energy,htk_compat",
                         [(True, False), (False, False), (False, True), (True, True)])
def test_mfcc_matches_jax(sr, use_energy, htk_compat):
    opts = _opts(sr, use_energy=use_energy, htk_compat=htk_compat,
                 energy_floor=1e-10 if use_energy else 0.0)
    wave = _wave(int(sr), sr, seed=2)
    ref = JF.MfccExtractor(opts)(wave)
    np.testing.assert_allclose(_port_single(opts, wave), ref, **MFCC_TOL)


@pytest.mark.parametrize("sr,pow2", [(22050.0, True), (48000.0, True), (16000.0, False)])
def test_mfcc_matches_jax_any_rate(sr, pow2):
    """The port's MfccExtractor against the JAX package's at 22.05 kHz
    (1024 points), 48 kHz (2048) and 16 kHz without rounding to a power of
    two (400): the sizes the K1 kernel took up besides 256 and 512."""
    fo = dict(samp_freq=sr, dither=0.0, round_to_power_of_two=pow2)
    opts = MfccOptions(frame_opts=FrameOptions(**fo), mel_opts=MelOptions(num_bins=23))
    wave = _wave(int(sr) // 2, sr, seed=4)
    ref = JF.MfccExtractor(opts)(wave)
    np.testing.assert_allclose(_port_single(opts, wave), ref, **MFCC_TOL)


@pytest.mark.parametrize("sr,ms,pow2,bins", [
    (8000.0, 25.0, False, 23), (8000.0, 25.0, True, 23), (16000.0, 25.0, False, 23),
    (16000.0, 25.0, True, 40), (22050.0, 25.0, False, 23), (22050.0, 25.0, True, 80),
    (44100.0, 25.02, False, 23), (44100.0, 25.0, True, 23), (48000.0, 25.0, False, 40),
    (48000.0, 60.0, True, 80)])
def test_mel_bands_reproduce_bank(sr, ms, pow2, bins):
    """K1's sparse mel: each bin's [lo, lo + len) range and band weights,
    scattered back, give ``mel_bank_matrix`` exactly, and every weight
    outside the ranges is zero."""
    fo = FrameOptions(samp_freq=sr, frame_length_ms=ms, round_to_power_of_two=pow2)
    mel = TF.mel_bank_matrix(bins, fo)
    lo, length, band = TF.mel_bands(mel)
    assert lo.dtype == length.dtype == np.int32 and band.shape == (length.max(), bins)
    dense = np.zeros_like(mel)
    for b in range(bins):
        dense[b, lo[b]: lo[b] + length[b]] = band[: length[b], b]
        assert (band[length[b]:, b] == 0).all()
    np.testing.assert_array_equal(dense, mel)
    assert (length > 0).all() and int(length.sum()) < mel.size // 4
    tables = TF.MfccTables.build(MfccOptions(frame_opts=fo, mel_opts=MelOptions(num_bins=bins)),
                                 False, "cpu")
    assert tables.twiddle.shape == (fo.padded_window_size, 2)
    np.testing.assert_array_equal(tables.mel_band.numpy(), band)


@pytest.mark.parametrize("sr,ws_pad", [(8000.0, 256), (16000.0, 512)])
def test_mfcc_matches_pallas_interpret(sr, ws_pad):
    """The K1 plain version's raw rows (cepstra, then energy) against the
    Pallas kernel's tiles, and the assembled features against MfccPallas."""
    opts = _opts(sr)
    wave = _wave(int(sr), sr, seed=7)
    pk = MfccPallas(opts, interpret=True)
    assert pk.ws_pad == ws_pad
    nf = opts.frame_opts.num_frames(len(wave))
    frames = JF.extract_frames(jnp.asarray(wave), nf, opts.frame_opts)
    ref_raw = np.asarray(pk._run(jnp.pad(frames, ((0, 0), (0, ws_pad - frames.shape[1])))))
    tables = TF.MfccTables.build(opts, False, "cpu")
    raw = mfcc_kernel.mfcc_frames(torch.from_numpy(np.array(frames)), tables)
    np.testing.assert_allclose(raw.numpy(), ref_raw[:, : opts.num_ceps + 1], **MFCC_TOL)
    np.testing.assert_allclose(_port_single(opts, wave), pk(wave), **MFCC_TOL)


@pytest.mark.parametrize("use_energy", [False, True])
def test_fbank_matches_jax(use_energy):
    opts = _opts(8000.0, use_energy=use_energy)
    wave = _wave(8000, 8000.0, seed=3)
    ref = JF.FbankExtractor(opts, use_energy=use_energy)(wave)
    got = _port_single(opts, wave, fbank=True)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **MFCC_TOL)


def test_mfcc_batched_ragged():
    opts = _opts(8000.0)
    waves = np.stack([_wave(8000, 8000.0, seed=s) for s in range(3)])
    lens = np.array([8000, 6500, 4000])
    for i, n in enumerate(lens):
        waves[i, n:] = 0.0
    fa, ca = JF.MfccExtractor(opts).batched(jnp.asarray(waves), jnp.asarray(lens), 99)
    fb, cb = TF.MfccExtractor(opts, device="cpu").batched(
        torch.from_numpy(waves), torch.from_numpy(lens), 99)
    np.testing.assert_array_equal(np.asarray(ca), cb.numpy())
    for i in range(3):
        n = int(ca[i])
        np.testing.assert_allclose(fb[i, :n].numpy(), np.asarray(fa)[i, :n], **MFCC_TOL)


def test_mfcc_dither_noise_from_generator():
    """Dither is dither * N(0, 1) from the given torch.Generator, added to
    the frames before the chain: the same noise fed to the JAX chain gives
    the same features."""
    fo = FrameOptions(samp_freq=8000.0, dither=1.0)
    opts = MfccOptions(frame_opts=fo)
    wave = _wave(4000, 8000.0, seed=6)
    nf = fo.num_frames(len(wave))
    got, _ = TF.MfccExtractor(opts, device="cpu").batched(
        torch.from_numpy(wave[None]), torch.tensor([len(wave)]), nf,
        torch.Generator().manual_seed(5))
    noise = torch.randn((nf, fo.window_size), generator=torch.Generator().manual_seed(5))
    jext = JF.MfccExtractor(opts)
    frames = JF.extract_frames(jnp.asarray(wave), nf, fo) + jnp.asarray(noise.numpy())
    ref = JF.mfcc_from_frames(frames, opts, jext.window, jext.mel_mat, jext.dct_mat,
                              jext.lifter, None)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref), **MFCC_TOL)


@pytest.mark.parametrize("norm_vars", [False, True])
def test_cmvn_matches_jax(norm_vars):
    rng = np.random.default_rng(0)
    feats = (rng.standard_normal((5, 40, 13)) * 3 + 1).astype(np.float32)
    nf = np.array([40, 31, 7, 40, 1], np.int32)
    spk = np.array([0, 1, 0, 2, 1], np.int32)
    ref_stats = np.array(JC.acc_cmvn_stats_batch(jnp.asarray(feats), jnp.asarray(nf),
                                                   jnp.asarray(spk), 3))
    stats = TC.acc_cmvn_stats_batch(torch.from_numpy(feats), torch.from_numpy(nf),
                                    torch.from_numpy(spk), 3)
    np.testing.assert_allclose(stats.numpy(), ref_stats, rtol=1e-6, atol=1e-5)
    ref = JC.apply_cmvn_batch(jnp.asarray(feats), jnp.asarray(ref_stats), jnp.asarray(spk),
                              norm_vars=norm_vars)
    got = TC.apply_cmvn_batch(torch.from_numpy(feats), torch.from_numpy(ref_stats),
                              torch.from_numpy(spk), norm_vars=norm_vars)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_cmvn_eight_speakers_unsorted():
    """Eight speakers in no order, some with one utterance, one with none:
    the float64 one-hot product gives the JAX package's segment sums."""
    rng = np.random.default_rng(8)
    feats = (rng.standard_normal((20, 30, 13)) * 4 + 2).astype(np.float32)
    nf = rng.integers(1, 31, 20).astype(np.int32)
    spk = np.array([5, 2, 7, 0, 2, 5, 1, 3, 7, 0, 6, 2, 5, 3, 0, 1, 7, 2, 6, 5], np.int32)
    want = np.array(JC.acc_cmvn_stats_batch(jnp.asarray(feats), jnp.asarray(nf),
                                             jnp.asarray(spk), 9))
    got = TC.acc_cmvn_stats_batch(torch.from_numpy(feats), torch.from_numpy(nf),
                                  torch.from_numpy(spk), 9)
    assert got.dtype == torch.float32 and got.shape == (9, 2, 14)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    assert (got[4] == 0).all() and (got[8] == 0).all()


@pytest.mark.parametrize("order,window", [(2, 2), (1, 3)])
def test_deltas_match_jax(order, window):
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 40, 13)).astype(np.float32)
    nf = np.array([40, 25, 1], np.int32)
    opts = DeltaOptions(order=order, window=window)
    ref = np.asarray(JF.add_deltas_batch(jnp.asarray(feats), jnp.asarray(nf), opts))
    got = TF.add_deltas_batch(torch.from_numpy(feats), torch.from_numpy(nf), opts).numpy()
    for i, n in enumerate(nf):
        np.testing.assert_allclose(got[i, :n], ref[i, :n], atol=1e-5)


def test_make_features_yesno():
    """The whole frontend (MFCC -> per-utterance CMVN -> deltas) on the
    Yes-No test waves, from waves in both packages."""
    _train, test = make_corpus(num_train=24, num_test=8, seed=7)
    waves = {u: w for u, (w, _) in test.items()}
    utt2spk = {u: u for u in test}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=8000.0, dither=0.0))
    ref = jax_make_features(waves, utt2spk, opts)
    got = make_features(waves, utt2spk, opts, device="cpu")
    assert sorted(got) == sorted(ref)
    for u in ref:
        assert got[u].shape == ref[u].shape
        np.testing.assert_allclose(got[u].numpy(), ref[u], **MFCC_TOL)
    batch, nf = pad_features(got, sorted(got))
    assert batch.shape == (8, max(f.shape[0] for f in ref.values()), 39)
    assert nf.tolist() == [ref[u].shape[0] for u in sorted(ref)]


def test_wrappers_reject_other_devices():
    tables = TF.MfccTables.build(_opts(8000.0), False, "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        mfcc_kernel.mfcc_frames(torch.empty((4, 200), device="meta"), tables)
    if not torch.cuda.is_available():  # no device means the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TF.MfccExtractor(_opts(8000.0), device=None)
