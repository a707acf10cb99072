"""HMM topology: per-phone state graphs with pdf-classes and transition probs.

Counterpart of Kaldi ``HmmTopology`` (``hmm/hmm-topology.h:94``) and the
reference's topology generator (``scr/utils/gen_topo.cpp:57-116``,
``prepare_lang.cpp GenerateTopology``): non-silence phones get a 3-state
Bakis chain (self 0.75 / next 0.25), silence phones a 5-state topology whose
first state fans out to states 0..3, middle states are fully connected among
1..4, and the last emitting state is non-skippable (self 0.75 / final 0.25).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class TopologyState:
    pdf_class: int  # -1 for non-emitting
    transitions: tuple  # tuple[(next_state, prob)]


class HmmTopology:
    """Maps phone id -> tuple of TopologyState (last state non-emitting)."""

    def __init__(self, entries: dict[int, tuple]):
        self.entries = entries  # phone -> tuple[TopologyState]

    def states_for(self, phone: int) -> tuple:
        return self.entries[phone]

    def num_emitting_states(self, phone: int) -> int:
        return sum(1 for s in self.entries[phone] if s.pdf_class >= 0)

    def num_pdf_classes(self, phone: int) -> int:
        return 1 + max(s.pdf_class for s in self.entries[phone] if s.pdf_class >= 0)

    def phones(self) -> list[int]:
        return sorted(self.entries)

    # -- serialization ------------------------------------------------------
    def save(self, path: str | Path) -> None:
        obj = {
            str(p): [
                {"pdf_class": s.pdf_class,
                 "transitions": [[int(n), float(pr)] for n, pr in s.transitions]}
                for s in states
            ]
            for p, states in self.entries.items()
        }
        Path(path).write_text(json.dumps(obj))

    @classmethod
    def load(cls, path: str | Path) -> "HmmTopology":
        obj = json.loads(Path(path).read_text())
        entries = {}
        for p, states in obj.items():
            entries[int(p)] = tuple(
                TopologyState(s["pdf_class"],
                              tuple((n, pr) for n, pr in s["transitions"]))
                for s in states
            )
        return cls(entries)


def bakis_chain(num_states: int) -> tuple:
    """num_states emitting states, self 0.75 / next 0.25, + final non-emitting
    (gen_topo.cpp:62-66)."""
    states = []
    for s in range(num_states):
        states.append(TopologyState(s, ((s, 0.75), (s + 1, 0.25))))
    states.append(TopologyState(-1, ()))
    return tuple(states)


def silence_topology(num_states: int) -> tuple:
    """Reference silence topology (gen_topo.cpp:71-103): state 0 -> 0..n-2
    uniformly; states 1..n-3 -> 1..n-1 uniformly; state n-1 self 0.75 /
    final 0.25."""
    if num_states <= 1:
        return bakis_chain(max(num_states, 1))
    transp = 1.0 / (num_states - 1)
    states = []
    states.append(TopologyState(0, tuple((ns, transp) for ns in range(num_states - 1))))
    for s in range(1, num_states - 1):
        states.append(TopologyState(s, tuple((ns, transp) for ns in range(1, num_states))))
    states.append(TopologyState(num_states - 1, ((num_states - 1, 0.75), (num_states, 0.25))))
    states.append(TopologyState(-1, ()))
    return tuple(states)


def generate_topology(nonsil_phones: list[int], sil_phones: list[int],
                      num_nonsil_states: int = 3, num_sil_states: int = 5) -> HmmTopology:
    """prepare_lang's GenerateTopology (prepare_lang.cpp:1366, defaults 3/5)."""
    entries: dict[int, tuple] = {}
    chain = bakis_chain(num_nonsil_states)
    sil = silence_topology(num_sil_states)
    for p in nonsil_phones:
        entries[p] = chain
    for p in sil_phones:
        entries[p] = sil
    return HmmTopology(entries)
