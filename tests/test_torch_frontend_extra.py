"""The port's remaining frontends against the JAX package's, on the CPU.

The same numpy waves (made from seeds) go through both packages with dither
off.  PLP, fbank and the spectrogram are held with the MFCC tolerance of
``tests/test_torch_features.py`` (rtol 2e-4, atol 2e-3: fp32 FFTs of
different structure); the port's PLP tail is in the JAX package's order of
operations, so its LPC recursion amplifies nothing past that.  The VTLN
banks, the CMVN helpers and the pitch chain (numpy copies) are held to be
identical; the pitch chain also to the goldens of
``tests/test_pitch_golden.py`` with their tolerance (atol 2e-4).
``make_features(pitch=True)`` is held to the JAX package's with the MFCC
tolerance.
"""

import numpy as np
import pytest
import torch

from voicebridge_tpu.config import FrameOptions, MelOptions, MfccOptions, PlpOptions
from voicebridge_tpu.ops import features as JF
from voicebridge_tpu.ops import pitch as JP
from voicebridge_tpu.steps.make_feats import make_features as jax_make_features
from voicebridge_tpu.transforms import cmvn as JC
from voicebridge_tpu_torch.ops import features as TF
from voicebridge_tpu_torch.ops import mfcc_kernel
from voicebridge_tpu_torch.ops import pitch as TP
from voicebridge_tpu_torch.steps.make_feats import make_features
from voicebridge_tpu_torch.transforms import cmvn as TC

from synth import SR, make_corpus
from test_pitch_golden import _FRAMES, _GOLDEN, _waves

torch.set_num_threads(2)
MFCC_TOL = dict(rtol=2e-4, atol=2e-3)


def _wave(n, sr, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (3000 * np.sin(2 * np.pi * 313 * t)
            + 1200 * np.sin(2 * np.pi * 1170 * t + 0.3)
            + 80 * rng.standard_normal(n)).astype(np.float32)


# ---------------------------------------------------------------------------
# VTLN banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warp", [0.85, 1.0, 1.15])
@pytest.mark.parametrize("sr,bins", [(8000.0, 23), (16000.0, 40)])
def test_vtln_banks_are_identical(warp, sr, bins):
    fo = FrameOptions(samp_freq=sr)
    for kw in ({}, {"vtln_low": 200.0, "vtln_high": -800.0}, {"low_freq": 60.0,
                                                             "high_freq": -400.0}):
        got = TF.mel_bank_matrix(bins, fo, vtln_warp=warp, **kw)
        np.testing.assert_array_equal(got, JF.mel_bank_matrix(bins, fo, vtln_warp=warp, **kw))
        # a warped triangle is still contiguous: its band form sums the same
        lo, length, band = TF.mel_bands(got)
        for b in range(bins):
            nz = np.flatnonzero(got[b])
            assert len(nz) == length[b] and (len(nz) == 0 or nz[-1] - nz[0] + 1 == len(nz))
            np.testing.assert_array_equal(band[: length[b], b], got[b, lo[b]: lo[b] + length[b]])
    freqs = np.linspace(0.0, sr / 2, 97)
    np.testing.assert_array_equal(TF.vtln_warp_freq(100.0, sr / 2 - 500, 20.0, sr / 2, warp, freqs),
                                  JF.vtln_warp_freq(100.0, sr / 2 - 500, 20.0, sr / 2, warp, freqs))
    np.testing.assert_array_equal(TF.inverse_mel_scale(TF.mel_scale(freqs)),
                                  JF.inverse_mel_scale(JF.mel_scale(freqs)))


# ---------------------------------------------------------------------------
# K1's mel_power mode, PLP, fbank and the spectrogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("htk_mode", [False, True])
def test_mel_power_mode_rows(htk_mode):
    """The plain version's ``mel_power`` rows are the mel energies (floored
    at 1.0 in HTK mode only) and the log energy of its ``fbank`` rows."""
    opts = MfccOptions(frame_opts=FrameOptions(dither=0.0),
                       mel_opts=MelOptions(htk_mode=htk_mode))
    fo = opts.frame_opts
    frames = TF.extract_frames(torch.from_numpy(_wave(8000, 16000.0, 1)), 40, fo)
    frames[3] = 0.0  # a silent frame: zero mel energies
    mel = mfcc_kernel.mfcc_frames(frames, TF.MfccTables.build(opts, "mel_power", "cpu"))
    fb = mfcc_kernel.mfcc_frames(frames, TF.MfccTables.build(opts, True, "cpu"))
    assert mel.shape == fb.shape == (40, 24)
    np.testing.assert_array_equal(mel[:, -1].numpy(), fb[:, -1].numpy())
    floor = 1.0 if htk_mode else float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(torch.log(torch.clamp_min(mel[:, :-1], floor)).numpy(),
                               fb[:, :-1].numpy(), rtol=1e-6, atol=1e-6)
    assert float(mel[3, :-1].min()) == (1.0 if htk_mode else 0.0)
    with pytest.raises(ValueError, match="mode must be one of"):
        TF.MfccTables.build(opts, "plp", "cpu")


PLP_CASES = {
    "default": dict(),
    "no_energy": dict(use_energy=False),
    "htk_compat": dict(htk_compat=True),
    "htk_compat_no_energy": dict(htk_compat=True, use_energy=False),
    "energy_floor": dict(energy_floor=1.0),
    "scaled_no_lifter": dict(cepstral_scale=1.5, cepstral_lifter=0.0, use_energy=False),
    "order_8": dict(lpc_order=8, num_ceps=9),
    # PLP's own mel bank, not a default MelOptions: 30 bins, HTK floor
    "mel_opts": dict(mel_opts=MelOptions(num_bins=30, htk_mode=True), use_energy=False),
}


@pytest.mark.parametrize("sr", [8000.0, 16000.0])
@pytest.mark.parametrize("case", sorted(PLP_CASES))
def test_plp_matches_jax(sr, case):
    opts = PlpOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0), **PLP_CASES[case])
    wave = _wave(int(sr), sr, seed=4)
    want = JF.PlpExtractor(opts)(wave)
    got = TF.PlpExtractor(opts, device="cpu")(wave).numpy()
    assert got.shape == want.shape == (opts.frame_opts.num_frames(len(wave)), opts.num_ceps)
    np.testing.assert_allclose(got, want, **MFCC_TOL)


def test_plp_tail_against_float64():
    """The fp32 PLP chain against the same chain in float64 (the K1 plain
    version and the tail on float64 tables): the LPC recursion's
    amplification of fp32 rounding stays within the MFCC tolerance."""
    opts = PlpOptions(frame_opts=FrameOptions(dither=0.0))
    tables = TF.PlpTables.build(opts, "cpu")
    frames = TF.extract_frames(torch.from_numpy(_wave(16000, 16000.0, 5)), 98,
                               opts.frame_opts)
    got = TF.plp_from_frames(frames, tables)
    k1 = tables.k1
    t64 = TF.PlpTables(opts, type(k1)(**{**vars(k1), **{
        f: getattr(k1, f).double() for f in ("window", "mel_t", "dct_t", "lifter")}}),
        tables.eql.double(), tables.idft.double(), tables.lifter.double())
    want = TF.plp_from_frames(frames.double(), t64)
    torch.testing.assert_close(got.double(), want, **MFCC_TOL)


def test_plp_batched_equals_single():
    """Within the JAX package's own batched-vs-single tolerance (1e-4): the
    CPU's products block a batch otherwise than one utterance."""
    fo = FrameOptions(dither=0.0)
    ext = TF.PlpExtractor(PlpOptions(frame_opts=fo), device="cpu")
    lens = [4000, 6400, 300]
    waves = np.zeros((3, 6400), np.float32)
    for i, n in enumerate(lens):
        waves[i, :n] = _wave(n, 16000.0, seed=i)
    feats, counts = ext.batched(waves, np.asarray(lens), fo.num_frames(6400))
    assert counts.tolist() == [fo.num_frames(n) for n in lens]
    for i, n in enumerate(lens):
        single = ext(waves[i, :n])
        assert single.shape == (counts[i], 13)
        torch.testing.assert_close(feats[i, : int(counts[i])], single, rtol=1e-4, atol=1e-4)


def test_plp_dither_follows_the_generator():
    opts = PlpOptions(frame_opts=FrameOptions(dither=1.0))
    ext = TF.PlpExtractor(opts, device="cpu")
    wave = _wave(4000, 16000.0, 6)

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return ext(wave, generator=g)

    assert torch.equal(run(3), run(3)) and not torch.equal(run(3), run(4))
    assert torch.equal(ext(wave), TF.PlpExtractor(PlpOptions(frame_opts=FrameOptions(
        dither=0.0)), device="cpu")(wave))  # no generator: no dither
    with pytest.raises(ValueError, match="num_ceps"):
        TF.PlpExtractor(PlpOptions(lpc_order=8, num_ceps=13), device="cpu")


@pytest.mark.parametrize("use_energy", [False, True])
@pytest.mark.parametrize("sr,bins", [(8000.0, 23), (16000.0, 40)])
def test_fbank_extractor_matches_jax(use_energy, sr, bins):
    """Its own ``use_energy`` (energy first, no ``energy_floor``), not
    ``MfccOptions.use_energy``, which defaults to True."""
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0),
                       mel_opts=MelOptions(num_bins=bins), energy_floor=1e5)
    wave = _wave(int(sr), sr, seed=7)
    want = JF.FbankExtractor(opts, use_energy=use_energy)(wave)
    ext = TF.FbankExtractor(opts, use_energy=use_energy, device="cpu")
    got = ext(wave).numpy()
    assert got.shape == want.shape == (opts.frame_opts.num_frames(len(wave)), ext.dim)
    np.testing.assert_allclose(got, want, **MFCC_TOL)


@pytest.mark.parametrize("sr,pow2", [(8000.0, True), (16000.0, True), (16000.0, False)])
def test_spectrogram_matches_jax(sr, pow2):
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=sr, dither=0.0,
                                               round_to_power_of_two=pow2))
    wave = _wave(int(sr), sr, seed=8)
    want = JF.SpectrogramExtractor(opts)(wave)
    ext = TF.SpectrogramExtractor(opts, device="cpu")
    got = ext(wave).numpy()
    assert got.shape == want.shape == (opts.frame_opts.num_frames(len(wave)), ext.dim)
    np.testing.assert_allclose(got, want, **MFCC_TOL)
    assert ext(wave[:10]).shape == (0, ext.dim)


# ---------------------------------------------------------------------------
# CMVN helpers
# ---------------------------------------------------------------------------


def test_cmvn_helpers_are_identical():
    rng = np.random.default_rng(9)
    a = rng.standard_normal((50, 13)).astype(np.float32) + 2.0
    b = rng.standard_normal((50, 13)).astype(np.float32)
    np.testing.assert_array_equal(TC.acc_cmvn_stats(a), JC.acc_cmvn_stats(a))
    np.testing.assert_array_equal(TC.fake_cmvn_stats(13), JC.fake_cmvn_stats(13))
    for bb in (b, b[:30]):
        for got, want in zip(TC.acc_cmvn_stats_two_channel(a, bb, 0.02),
                             JC.acc_cmvn_stats_two_channel(a, bb, 0.02)):
            np.testing.assert_array_equal(got, want)
    rows = [("c1-A", "c1", "A"), ("c1-B", "c1", "B"), ("c2-A", "c2", "A"),
            ("c0-A", "c0", "A"), ("c0-B", "c0", "B"), ("c0-C", "c0", "C")]
    assert TC.utterance_pairs(rows) == JC.utterance_pairs(rows)
    stats = JC.acc_cmvn_stats(a)
    for kw in ({}, {"skip_dims": [0, 3]}, {"convert_to_mean_and_var": True},
               {"skip_dims": [12], "convert_to_mean_and_var": True}):
        np.testing.assert_array_equal(TC.modify_cmvn_stats(stats, **kw),
                                      JC.modify_cmvn_stats(stats, **kw))
    for norm_vars in (False, True):
        got = TC.apply_cmvn(torch.from_numpy(b), stats, norm_vars=norm_vars)
        want = np.asarray(JC.apply_cmvn(b, stats, norm_vars=norm_vars))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Pitch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(_waves()))
def test_pitch_matches_jax_and_goldens(name):
    wave = _waves()[name]
    raw = TP.compute_kaldi_pitch(wave, TP.PitchOptions())
    np.testing.assert_array_equal(raw, JP.compute_kaldi_pitch(wave, JP.PitchOptions()))
    for opts in (TP.ProcessPitchOptions(), TP.ProcessPitchOptions(add_raw_log_pitch=True,
                                                                  add_delta_pitch=False)):
        np.testing.assert_array_equal(TP.process_pitch(raw, opts, seed=5),
                                      JP.process_pitch(raw, JP.ProcessPitchOptions(**vars(opts)),
                                                       seed=5))
    proc = TP.process_pitch(raw, TP.ProcessPitchOptions(delta_pitch_noise_stddev=0.0))
    np.testing.assert_allclose(proc[_FRAMES], _GOLDEN[name], atol=2e-4, rtol=0)
    np.testing.assert_array_equal(TP.compute_pitch_feats(wave), JP.compute_pitch_feats(wave))


@pytest.mark.parametrize("name", sorted(_waves()))
def test_built_pitch_viterbi_equals_numpy(name):
    """The g++-built ``csrc/pitch.cpp`` track equals the numpy recursion's;
    the library lands in the package's ``_build/``."""
    nccf, _pov, lags = TP.compute_nccf(_waves()[name], TP.PitchOptions())
    track = TP.viterbi_pitch(nccf, lags, TP.PitchOptions())
    np.testing.assert_array_equal(track, TP.viterbi_pitch_plain(nccf, lags, TP.PitchOptions()))
    assert TP._PITCH_LIB is not None
    assert "voicebridge_tpu_torch/_build/libvbt_pitch_" in TP._PITCH_LIB._name.replace("\\", "/")


@pytest.mark.parametrize("name", sorted(_waves()))
def test_zero_penalty_gives_a_finite_track(name):
    """``penalty_factor=0`` (``ifactor <= 0``, where the lower envelope would
    divide by zero) takes the numpy recursion: a finite track, equal to it;
    the library itself refuses such an ``ifactor``."""
    import ctypes

    opts = TP.PitchOptions(penalty_factor=0.0)
    wave = _waves()[name]
    nccf, _pov, lags = TP.compute_nccf(wave, opts)
    track = TP.viterbi_pitch(nccf, lags, opts)
    np.testing.assert_array_equal(track, TP.viterbi_pitch_plain(nccf, lags, opts))
    raw = TP.compute_kaldi_pitch(wave, opts)
    assert np.isfinite(raw).all() and np.isfinite(TP.process_pitch(raw)).all()
    local = np.zeros((3, 4))
    out = np.zeros(3, np.int32)
    assert TP._native_lib().vb_pitch_viterbi(
        3, 4, local.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 0.0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) == 1


def test_paste_and_empty_pitch():
    a, b = np.ones((5, 2), np.float32), np.zeros((3, 3), np.float32)
    np.testing.assert_array_equal(TP.paste_feats(a, b), JP.paste_feats(a, b))
    assert TP.compute_kaldi_pitch(np.zeros(100, np.float32)).shape == (0, 2)
    assert TP.process_pitch(np.zeros((0, 2), np.float32)).shape == (0, 3)


def test_make_features_with_pitch_matches_jax():
    """MakeMfccPitch: MFCC + 3 pitch dims pasted before CMVN, then deltas,
    on the synthetic corpus (8 kHz; pitch options from the frame options)."""
    train, _ = make_corpus(num_train=4, num_test=0, seed=12)
    waves = {u: w for u, (w, _) in train.items()}
    utt2spk = {u: "s" + u[-1] for u in waves}
    opts = MfccOptions(frame_opts=FrameOptions(samp_freq=SR, dither=0.0))
    want = jax_make_features(waves, utt2spk, opts, pitch=True)
    got = make_features(waves, utt2spk, opts, device="cpu", pitch=True)
    assert set(got) == set(want)
    for u in want:
        assert got[u].shape == want[u].shape and want[u].shape[1] == 48
        np.testing.assert_allclose(got[u].numpy(), want[u], **MFCC_TOL)
