"""Encoded minimization (fstminimizeencoded).

The reference minimizes deterministic FSTs after encoding (ilabel, olabel,
weight) into a single symbol, i.e. unweighted-acceptor minimization without
weight pushing (``fstbin/fstminimizeencoded.cpp``).  Implemented as Moore
partition refinement — robust and plenty fast for offline graph builds.
"""

from __future__ import annotations

from .core import Fst, NO_STATE_ID, ZERO


def minimize_encoded(fst: Fst) -> Fst:
    if fst.start == NO_STATE_ID or fst.num_states == 0:
        return fst.copy()
    f = fst.copy()
    f.connect()
    n = f.num_states
    if n == 0:
        return f

    # encode arcs: (ilabel, olabel, quantized weight) -> symbol id
    enc: dict[tuple, int] = {}

    def sym(a) -> int:
        key = (a.ilabel, a.olabel, round(a.weight, 5))
        if key not in enc:
            enc[key] = len(enc)
        return enc[key]

    enc_arcs = [sorted((sym(a), a.nextstate) for a in f.arcs[s]) for s in range(n)]

    # initial partition: by final weight (quantized)
    def fkey(s):
        return None if f.finals[s] == ZERO else round(f.finals[s], 5)

    part_of = {}
    blocks: dict = {}
    for s in range(n):
        blocks.setdefault(fkey(s), []).append(s)
    for i, members in enumerate(blocks.values()):
        for s in members:
            part_of[s] = i
    num_blocks = len(blocks)

    # Moore refinement to fixpoint
    while True:
        sigs: dict[tuple, int] = {}
        new_part = [0] * n
        next_id = 0
        for s in range(n):
            sig = (fkey(s), tuple((a, part_of[ns]) for a, ns in enc_arcs[s]))
            if sig not in sigs:
                sigs[sig] = next_id
                next_id += 1
            new_part[s] = sigs[sig]
        if next_id == num_blocks:
            break
        num_blocks = next_id
        part_of = {s: new_part[s] for s in range(n)}

    # build quotient
    out = Fst()
    out.add_states(num_blocks)
    seen = set()
    for s in range(n):
        b = part_of[s]
        if b in seen:
            continue
        seen.add(b)
        if f.finals[s] != ZERO:
            out.set_final(b, f.finals[s])
        for a in f.arcs[s]:
            out.add_arc(b, a.ilabel, a.olabel, a.weight, part_of[a.nextstate])
    out.set_start(part_of[f.start])
    out.connect()
    return out
