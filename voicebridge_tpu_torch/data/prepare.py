"""Data preparation: wav/transcription scanning, train/test split, speaker
grouping, corpus + automatic LM generation.

Counterpart of the reference's ``PrepareData``
(``scr/utils/prepare_data.cpp:114-574``): scans a wav directory with sidecar
transcription files, splits train/test by percentage, derives speaker ids
from the ``idtype`` heuristic (:18-114 — 0: parent-directory name, 1: the
utterance id itself, >1: first N characters of the file name), writes the
Kaldi-style data tables (wav.scp/text/utt2spk/spk2utt roles), builds the
full-text corpus and estimates the task n-gram LM (MITLM's EstimateNgram
role -> lm/ngram.py) plus the vocabulary.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from ..config import LmOptions
from ..lm.arpa import ArpaModel
from ..lm.ngram import estimate_ngram
from ..utils.logging import get_logger
from ..utils.io import utt2spk_to_spk2utt, write_keyed_text

log = get_logger()


@dataclass
class DataDir:
    """In-memory equivalent of a Kaldi data directory."""

    wav_paths: dict = field(default_factory=dict)  # utt -> wav path (or recording id via segments)
    text: dict = field(default_factory=dict)  # utt -> list[str] words
    utt2spk: dict = field(default_factory=dict)
    segments: dict = field(default_factory=dict)  # utt -> (start_s, end_s); empty = whole file

    @property
    def utts(self) -> list:
        return sorted(self.wav_paths)

    def spk2utt(self) -> dict:
        return utt2spk_to_spk2utt(self.utt2spk)

    def subset(self, utts) -> "DataDir":
        keep = set(utts)
        return DataDir(
            {u: p for u, p in self.wav_paths.items() if u in keep},
            {u: t for u, t in self.text.items() if u in keep},
            {u: s for u, s in self.utt2spk.items() if u in keep},
            {u: s for u, s in self.segments.items() if u in keep},
        )

    def save(self, path: str | Path) -> None:
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        write_keyed_text(path / "wav.scp",
                         {u: str(p) for u, p in self.wav_paths.items()})
        write_keyed_text(path / "text", self.text)
        write_keyed_text(path / "utt2spk", self.utt2spk)
        write_keyed_text(path / "spk2utt", self.spk2utt())

    def validate(self) -> list:
        """ValidateData-style consistency checks; returns list of problems."""
        problems = []
        for u in self.wav_paths:
            if u not in self.text:
                problems.append(f"utt {u} has no transcription")
            if u not in self.utt2spk:
                problems.append(f"utt {u} has no speaker")
        for u in self.text:
            if u not in self.wav_paths:
                problems.append(f"text for unknown utt {u}")
            if not self.text[u]:
                problems.append(f"empty transcription for {u}")
        return problems


def load_waves(data: DataDir, expected_rate: float | None = None,
               max_fail_frac: float = 0.2) -> dict:
    """Read every utterance's samples, applying ``segments`` windows
    (extract-segments role) and optional resampling to ``expected_rate``.

    Corrupt/unreadable files are skipped and logged (the reference's per-job
    error path); more than ``max_fail_frac`` failures aborts loudly
    (utils/health.py failure model)."""
    from ..utils.health import FailureTracker
    from ..utils.wave import extract_segment, read_wave, resample

    tracker = FailureTracker("load_waves", total=len(data.utts))
    out = {}
    for u in data.utts:
        try:
            rate, samples = read_wave(data.wav_paths[u])
            if u in data.segments:
                start, end = data.segments[u]
                samples = extract_segment(samples, rate, start, end)
            if expected_rate and rate != expected_rate:
                samples = resample(samples, rate, expected_rate)
            if samples.size == 0:
                raise ValueError("empty waveform")
        except Exception as e:  # corrupt RIFF, short read, bad segment
            tracker.record(u, str(e))
            continue
        out[u] = samples
    tracker.finish(max_fail_frac)
    return out


def fix_data_dir(data: DataDir) -> tuple[DataDir, list]:
    """FixDataDir (scr/utils/fix_data_dir.cpp): drop utterances missing from
    any table so wav/text/utt2spk agree; returns (fixed copy, removed utts)."""
    complete = [u for u in data.wav_paths
                if u in data.text and data.text[u] and u in data.utt2spk]
    removed = sorted(set(list(data.wav_paths) + list(data.text) +
                         list(data.utt2spk)) - set(complete))
    if removed:
        log.info("fix_data_dir: removed %d inconsistent utterances", len(removed))
    return data.subset(complete), removed


def filter_scp(keys, table: dict) -> dict:
    """FilterScp: keep only entries whose key is in ``keys``."""
    keep = set(keys)
    return {k: v for k, v in table.items() if k in keep}


def speaker_id_for(path: Path, idtype: int) -> str:
    """The reference's speaker-id heuristic (prepare_data.cpp:18-80)."""
    if idtype == 0:
        return path.parent.name.replace(" ", "_")
    if idtype == 1:
        return path.stem
    return path.stem[:idtype]


def scan_wav_dir(waves_dir: str | Path, transc_ext: str = ".txt",
                 idtype: int = 1) -> DataDir:
    """Recursively pair ``*.wav`` files with sidecar transcriptions."""
    waves_dir = Path(waves_dir)
    data = DataDir()
    for wav in sorted(waves_dir.rglob("*.wav")):
        utt = wav.stem
        transc = wav.with_suffix(transc_ext)
        if not transc.exists():
            transc = Path(str(wav) + transc_ext)
        if not transc.exists():
            log.warning("prepare_data: no transcription for %s", wav)
            continue
        words = transc.read_text(encoding="utf-8").split()
        if not words:
            log.warning("prepare_data: empty transcription for %s", wav)
            continue
        data.wav_paths[utt] = wav
        data.text[utt] = [w.upper() for w in words]
        data.utt2spk[utt] = speaker_id_for(wav, idtype)
    return data


def split_train_test(data: DataDir, percentage_train: int, seed: int = 777
                     ) -> tuple[DataDir, DataDir]:
    """Deterministic split respecting speaker boundaries when possible (the
    reference splits the sorted utt list; we additionally keep a speaker's
    utterances together when there are enough speakers)."""
    import random

    rnd = random.Random(seed)
    spk2utt = data.spk2utt()
    speakers = sorted(spk2utt)
    n_train_target = int(round(len(data.utts) * percentage_train / 100.0))
    if len(speakers) >= 4:
        order = speakers[:]
        rnd.shuffle(order)
        train_utts: list = []
        for s in order:
            if len(train_utts) >= n_train_target:
                break
            train_utts.extend(spk2utt[s])
        train_set = set(train_utts[: max(n_train_target, 1)]) \
            if len(train_utts) > n_train_target else set(train_utts)
    else:
        utts = data.utts[:]
        rnd.shuffle(utts)
        train_set = set(utts[:n_train_target])
    test_set = [u for u in data.utts if u not in train_set]
    return data.subset(sorted(train_set)), data.subset(test_set)


def build_lm_and_vocab(train: DataDir, opts: LmOptions = LmOptions()
                       ) -> tuple[ArpaModel, list]:
    """Full-text corpus -> ARPA LM + vocab (prepare_data.cpp:377-394)."""
    sentences = [train.text[u] for u in train.utts]
    arpa = estimate_ngram(sentences, order=opts.order, smoothing=opts.smoothing)
    vocab = sorted({w for s in sentences for w in s})
    return arpa, vocab


def prepare_data(waves_dir: str | Path, percentage_train: int = 90,
                 transc_ext: str = ".txt", idtype: int = 1,
                 lm_opts: LmOptions = LmOptions(), out_dir: str | Path | None = None):
    """Complete PrepareData: returns (train DataDir, test DataDir, ArpaModel,
    vocab list)."""
    data = scan_wav_dir(waves_dir, transc_ext, idtype)
    problems = data.validate()
    if problems:
        for p in problems[:10]:
            log.warning("prepare_data: %s", p)
    if not data.utts:
        raise RuntimeError(f"no usable wav/transcription pairs in {waves_dir}")
    train, test = split_train_test(data, percentage_train)
    arpa, vocab = build_lm_and_vocab(train, lm_opts)
    log.info("prepare_data: %d train / %d test utts, %d speakers, vocab %d",
             len(train.utts), len(test.utts), len(set(data.utt2spk.values())),
             len(vocab))
    if out_dir:
        out = Path(out_dir)
        train.save(out / "train")
        test.save(out / "test")
        arpa.write(out / "task.arpabo")
        (out / "vocab.txt").write_text("\n".join(vocab) + "\n", encoding="utf-8")
    return train, test, arpa, vocab
