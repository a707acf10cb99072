"""Core WFST data structure (mutable vector FST over the tropical semiring).

Counterpart of OpenFst's ``VectorFst<StdArc>`` (the only arc type the reference
pipeline uses, plus the lattice semiring handled separately).  Weights are
floats in the -log ("cost") domain; ``plus`` is min (tropical) or -logsumexp
(log semiring) selected per algorithm, matching how the reference switches
``fstdeterminizestar --use-log=true`` for LG.

Epsilon label is 0, as in OpenFst.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np

EPS = 0
ZERO = math.inf  # semiring zero (infinite cost)
NO_STATE_ID = -1


def log_plus(a: float, b: float) -> float:
    """-log(e^-a + e^-b): 'plus' of the log semiring in cost domain."""
    if a == ZERO:
        return b
    if b == ZERO:
        return a
    m = min(a, b)
    return m - math.log1p(math.exp(m - max(a, b)))


def trop_plus(a: float, b: float) -> float:
    return min(a, b)


@dataclass
class Arc:
    ilabel: int
    olabel: int
    weight: float
    nextstate: int

    def copy(self) -> "Arc":
        return Arc(self.ilabel, self.olabel, self.weight, self.nextstate)


class Fst:
    """Mutable WFST: list-of-arc-lists + final costs + start state."""

    def __init__(self):
        self.arcs: list[list[Arc]] = []
        self.finals: list[float] = []  # cost; ZERO = not final
        self.start: int = NO_STATE_ID

    # -- construction -------------------------------------------------------
    def add_state(self) -> int:
        self.arcs.append([])
        self.finals.append(ZERO)
        return len(self.arcs) - 1

    def add_states(self, n: int) -> int:
        first = len(self.arcs)
        for _ in range(n):
            self.add_state()
        return first

    def add_arc(self, state: int, ilabel: int, olabel: int, weight: float,
                nextstate: int) -> None:
        self.arcs[state].append(Arc(ilabel, olabel, weight, nextstate))

    def set_start(self, s: int) -> None:
        self.start = s

    def set_final(self, s: int, weight: float = 0.0) -> None:
        self.finals[s] = weight

    # -- accessors ----------------------------------------------------------
    @property
    def num_states(self) -> int:
        return len(self.arcs)

    @property
    def num_arcs(self) -> int:
        return sum(len(a) for a in self.arcs)

    def is_final(self, s: int) -> bool:
        return self.finals[s] != ZERO

    def final(self, s: int) -> float:
        return self.finals[s]

    def states(self) -> range:
        return range(len(self.arcs))

    def copy(self) -> "Fst":
        f = Fst()
        f.start = self.start
        f.finals = list(self.finals)
        f.arcs = [[a.copy() for a in arcs] for arcs in self.arcs]
        return f

    # -- simple mutations ----------------------------------------------------
    def arcsort(self, sort_type: str = "ilabel") -> "Fst":
        """In-place arc sort (fstarcsort)."""
        if sort_type == "ilabel":
            key = lambda a: (a.ilabel, a.olabel, a.nextstate)
        elif sort_type == "olabel":
            key = lambda a: (a.olabel, a.ilabel, a.nextstate)
        else:
            raise ValueError(sort_type)
        for arcs in self.arcs:
            arcs.sort(key=key)
        return self

    def project(self, output: bool = False) -> "Fst":
        """In-place projection (fstproject)."""
        for arcs in self.arcs:
            for a in arcs:
                if output:
                    a.ilabel = a.olabel
                else:
                    a.olabel = a.ilabel
        return self

    def invert(self) -> "Fst":
        for arcs in self.arcs:
            for a in arcs:
                a.ilabel, a.olabel = a.olabel, a.ilabel
        return self

    def relabel(self, imap: Optional[dict[int, int]] = None,
                omap: Optional[dict[int, int]] = None) -> "Fst":
        for arcs in self.arcs:
            for a in arcs:
                if imap is not None:
                    a.ilabel = imap.get(a.ilabel, a.ilabel)
                if omap is not None:
                    a.olabel = omap.get(a.olabel, a.olabel)
        return self

    def connect(self) -> "Fst":
        """Trim states not on a successful path (fstconnect); renumbers."""
        n = self.num_states
        if self.start == NO_STATE_ID or n == 0:
            self.arcs, self.finals, self.start = [], [], NO_STATE_ID
            return self
        # forward reachability
        fwd = np.zeros(n, dtype=bool)
        stack = [self.start]
        fwd[self.start] = True
        while stack:
            s = stack.pop()
            for a in self.arcs[s]:
                if not fwd[a.nextstate]:
                    fwd[a.nextstate] = True
                    stack.append(a.nextstate)
        # backward reachability from finals (over reversed graph)
        radj: list[list[int]] = [[] for _ in range(n)]
        for s in range(n):
            if fwd[s]:
                for a in self.arcs[s]:
                    radj[a.nextstate].append(s)
        bwd = np.zeros(n, dtype=bool)
        stack = [s for s in range(n) if fwd[s] and self.finals[s] != ZERO]
        for s in stack:
            bwd[s] = True
        while stack:
            s = stack.pop()
            for p in radj[s]:
                if not bwd[p]:
                    bwd[p] = True
                    stack.append(p)
        keep = fwd & bwd
        remap = -np.ones(n, dtype=np.int64)
        remap[keep] = np.arange(int(keep.sum()))
        new_arcs: list[list[Arc]] = []
        new_finals: list[float] = []
        for s in range(n):
            if not keep[s]:
                continue
            new_arcs.append(
                [Arc(a.ilabel, a.olabel, a.weight, int(remap[a.nextstate]))
                 for a in self.arcs[s] if keep[a.nextstate]]
            )
            new_finals.append(self.finals[s])
        self.arcs = new_arcs
        self.finals = new_finals
        self.start = int(remap[self.start]) if keep[self.start] else NO_STATE_ID
        return self

    # -- checks --------------------------------------------------------------
    def is_ilabel_sorted(self) -> bool:
        return all(
            all(arcs[i].ilabel <= arcs[i + 1].ilabel for i in range(len(arcs) - 1))
            for arcs in self.arcs
        )

    def is_stochastic(self, delta: float = 0.01, log_semiring: bool = True) -> tuple[bool, float, float]:
        """fstisstochastic: per-state 'sum' of arc+final costs; returns
        (ok, min_residue, max_residue)."""
        plus = log_plus if log_semiring else trop_plus
        lo, hi = math.inf, -math.inf
        for s in self.states():
            tot = self.finals[s]
            for a in self.arcs[s]:
                tot = plus(tot, a.weight)
            if tot == ZERO:
                continue
            lo, hi = min(lo, tot), max(hi, tot)
        if lo is math.inf:
            return True, 0.0, 0.0
        return (hi - 0.0 <= delta and 0.0 - lo <= delta) or (hi - lo <= delta), lo, hi

    # -- text I/O (OpenFst text format; used by tests and debugging) ---------
    def to_text(self) -> str:
        lines = []
        if self.start == NO_STATE_ID:
            return ""
        order = [self.start] + [s for s in self.states() if s != self.start]
        for s in order:
            for a in self.arcs[s]:
                if a.weight != 0.0:
                    lines.append(f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}\t{a.weight}")
                else:
                    lines.append(f"{s}\t{a.nextstate}\t{a.ilabel}\t{a.olabel}")
            if self.finals[s] != ZERO:
                if self.finals[s] != 0.0:
                    lines.append(f"{s}\t{self.finals[s]}")
                else:
                    lines.append(f"{s}")
        return "\n".join(lines) + "\n"

    @classmethod
    def from_text(cls, text: str | Iterable[str],
                  isym: Optional[Callable[[str], int]] = None,
                  osym: Optional[Callable[[str], int]] = None) -> "Fst":
        """Compile text-format FST (fstcompile).  First state mentioned is the
        start state.  ``isym``/``osym`` map label strings to ids (default int)."""
        if isinstance(text, str):
            lines = text.splitlines()
        else:
            lines = list(text)
        isym = isym or int
        osym = osym or int
        f = cls()
        ids: dict[int, int] = {}

        def state(x: str) -> int:
            k = int(x)
            if k not in ids:
                ids[k] = f.add_state()
            return ids[k]

        for line in lines:
            parts = line.split()
            if not parts:
                continue
            s = state(parts[0])
            if f.start == NO_STATE_ID:
                f.start = s
            if len(parts) == 1:
                f.set_final(s, 0.0)
            elif len(parts) == 2:
                f.set_final(s, float(parts[1]))
            elif len(parts) in (4, 5):
                ns = state(parts[1])
                w = float(parts[4]) if len(parts) == 5 else 0.0
                f.add_arc(s, isym(parts[2]), osym(parts[3]), w, ns)
            else:
                raise ValueError(f"bad fst text line: {line!r}")
        return f

    # -- binary I/O (compact npz) -------------------------------------------
    def save(self, path: str | Path) -> None:
        src, ilab, olab, wt, dst = self.to_arrays()
        np.savez_compressed(
            path,
            src=src, ilabel=ilab, olabel=olab, weight=wt, nextstate=dst,
            finals=np.asarray(self.finals, dtype=np.float32),
            start=np.asarray([self.start], dtype=np.int64),
        )

    @classmethod
    def load(cls, path: str | Path) -> "Fst":
        z = np.load(path)
        f = cls()
        finals = z["finals"]
        f.add_states(len(finals))
        f.finals = [float(x) for x in finals]
        f.start = int(z["start"][0])
        for s, i, o, w, ns in zip(z["src"], z["ilabel"], z["olabel"], z["weight"], z["nextstate"]):
            f.add_arc(int(s), int(i), int(o), float(w), int(ns))
        return f

    def to_arrays(self):
        """Flatten to (src, ilabel, olabel, weight, nextstate) numpy arrays,
        arcs grouped by source state — the device-decoder ingestion format."""
        n = self.num_arcs
        src = np.empty(n, dtype=np.int32)
        ilab = np.empty(n, dtype=np.int32)
        olab = np.empty(n, dtype=np.int32)
        wt = np.empty(n, dtype=np.float32)
        dst = np.empty(n, dtype=np.int32)
        k = 0
        for s in self.states():
            for a in self.arcs[s]:
                src[k], ilab[k], olab[k], wt[k], dst[k] = (
                    s, a.ilabel, a.olabel, a.weight, a.nextstate)
                k += 1
        return src, ilab, olab, wt, dst

    def __repr__(self) -> str:
        return f"Fst(states={self.num_states}, arcs={self.num_arcs}, start={self.start})"


def linear_fst(labels: Iterable[int], olabels: Optional[Iterable[int]] = None,
               weight_per_arc: float = 0.0) -> Fst:
    """Linear chain acceptor/transducer (used for transcripts in training
    graphs; reference: TrainingGraphCompiler's word acceptor)."""
    labels = list(labels)
    olabels = list(olabels) if olabels is not None else labels
    f = Fst()
    s = f.add_state()
    f.set_start(s)
    for i, o in zip(labels, olabels):
        ns = f.add_state()
        f.add_arc(s, i, o, weight_per_arc, ns)
        s = ns
    f.set_final(s, 0.0)
    return f


def equivalent_paths(f: Fst, g: Fst, num_paths: int = 50, seed: int = 0) -> bool:
    """Cheap randomized equivalence check for tests: sample paths from ``f``,
    verify ``g`` accepts with the same total cost (and vice versa).
    Only suitable for deterministic, eps-free machines (like post-determinize
    outputs); full equivalence is overkill for unit tests."""
    import random

    rnd = random.Random(seed)

    def sample(h: Fst):
        for _ in range(num_paths):
            path, cost, s = [], 0.0, h.start
            for _ in range(1000):
                choices = list(h.arcs[s])
                stop_ok = h.finals[s] != ZERO
                if stop_ok and (not choices or rnd.random() < 0.3):
                    yield path, cost + h.finals[s]
                    break
                if not choices:
                    break
                a = rnd.choice(choices)
                path.append((a.ilabel, a.olabel))
                cost += a.weight
                s = a.nextstate

    def accepts_with_cost(h: Fst, path) -> Optional[float]:
        # deterministic-by-ilabel walk
        s, cost = h.start, 0.0
        for il, ol in path:
            nxt = [a for a in h.arcs[s] if a.ilabel == il and a.olabel == ol]
            if len(nxt) != 1:
                return None
            cost += nxt[0].weight
            s = nxt[0].nextstate
        if h.finals[s] == ZERO:
            return None
        return cost + h.finals[s]

    for a, b in ((f, g), (g, f)):
        for path, cost in sample(a):
            other = accepts_with_cost(b, path)
            if other is None or abs(other - cost) > 1e-3:
                return False
    return True
