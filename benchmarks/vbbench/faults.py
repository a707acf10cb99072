"""Faults planted in the program underneath a run, to show that the
comparison deciding ``correct`` catches them: each is a context manager
that patches one of the program's functions for its span.

Decode: ``answer_altered`` (one surviving arc's acoustic cost moved by 1
where the lattices are produced), ``half_batch`` (lattices returned for
half of the request's utterances only).  Training: ``state_unchanged``
(the M-step returns the model as it was), ``state_unchanged_later`` (the
M-step updates the model on its first call, in set-up, and never after),
``half_batch`` (the E-step sums
half of the utterances and doubles them: the mean over the rest),
``answer_altered`` (one state of the longest utterance's alignment entered
a frame late).  One chip, so no fault of an exchange between chips.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np


@contextlib.contextmanager
def _patched(owner, name: str, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _decode_answer_altered(original):
    def decode_lattice(self, utts, *args, **kwargs):
        out = original(self, utts, *args, **kwargs)
        lat = out[utts[0]]
        cost = lat.acoustic_cost.copy()
        cost[len(cost) // 2] += 1.0
        out[utts[0]] = dataclasses.replace(lat, acoustic_cost=cost)
        return out
    return decode_lattice


def _decode_half_batch(original):
    def decode_lattice(self, utts, *args, **kwargs):
        out = original(self, utts, *args, **kwargs)
        return {u: out[u] for u in utts[: len(utts) // 2]}
    return decode_lattice


def _state_unchanged(_original):
    def m_step(*_args, **_kwargs):
        return None
    return m_step


def _state_unchanged_later(original):
    calls = []

    def m_step(*args, **kwargs):
        calls.append(1)
        return original(*args, **kwargs) if len(calls) == 1 else None
    return m_step


def _half_batch_estep(original):
    def e_step(am, trans_model, x, tids, weights):
        half = weights.copy()
        half[len(half) // 2:] = 0.0
        occ, macc, vacc, tstats, ll = original(am, trans_model, x, tids, half)
        return 2 * occ, 2 * macc, 2 * vacc, 2 * tstats, 2 * ll
    return e_step


def delay_entry(tids: np.ndarray, num_frames: int) -> bool:
    """Enter one state of an alignment (transition ids of the chain graphs,
    ``1 + 3 rank + kind``) a frame later: the first frame entering a state
    by its next arc whose following frame is that state's self-loop becomes
    the previous state's self-loop, and the following frame the entry."""
    kind = (tids[:num_frames] - 1) % 3
    base = tids[:num_frames] - kind
    for f in range(1, num_frames - 1):
        if kind[f] == 1 and kind[f + 1] == 0 and base[f + 1] == base[f]:
            tids[f], tids[f + 1] = base[f - 1], tids[f]
            return True
    return False


def _answer_altered(original):
    def realign(aset, am, feats, num_frames, tids, weights, *args, **kwargs):
        original(aset, am, feats, num_frames, tids, weights, *args, **kwargs)
        u = int(np.argmax(num_frames))
        delay_entry(tids[u], int(num_frames[u]))
    return realign


@contextlib.contextmanager
def planted(cell_runner: str, fault: str):
    """Plant ``fault`` in the program for a cell of the runner ``cell_runner``."""
    if cell_runner == "lattice_decode":
        from voicebridge_tpu_torch.steps.decode import Decoder

        make = {"answer_altered": _decode_answer_altered,
                "half_batch": _decode_half_batch}[fault]
        with _patched(Decoder, "decode_lattice", make):
            yield
    elif cell_runner == "train_realign":
        from voicebridge_tpu_torch.steps import train_tri

        name, make = {"state_unchanged": ("m_step", _state_unchanged),
                      "state_unchanged_later": ("m_step", _state_unchanged_later),
                      "half_batch": ("e_step", _half_batch_estep),
                      "answer_altered": ("realign", _answer_altered)}[fault]
        with _patched(train_tri, name, make):
            yield
    else:
        raise ValueError(f"no faults for runner {cell_runner}")


FAULTS = {"lattice_decode": ("answer_altered", "half_batch"),
          "train_realign": ("state_unchanged", "state_unchanged_later", "half_batch",
                            "answer_altered")}
