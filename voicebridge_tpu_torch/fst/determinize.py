"""DeterminizeStar: epsilon-removing determinization of functional WFSTs.

Counterpart of Kaldi ``fstdeterminizestar`` (``fstext/determinize-star.h``),
used on LG (in the log semiring, ``--use-log=true``) and on HCLGa / training
graphs (tropical).  Differences from plain OpenFst determinization: input
epsilons are removed as part of the algorithm, and output *strings* (from
factoring subsets) are emitted as chains of epsilon-input arcs.

Requires the input to be functional on the input side (guaranteed by the
pipeline's disambiguation symbols, reference ``add_lex_disambig.cpp``).
"""

from __future__ import annotations

from .core import EPS, Fst, NO_STATE_ID, ZERO, log_plus, trop_plus

_MAX_CLOSURE_ITERS = 10_000_000


class NonFunctionalError(RuntimeError):
    pass


def _quantize(w: float) -> float:
    return round(w, 5)


def determinize_star(fst: Fst, use_log: bool = False, max_states: int = 0) -> Fst:
    """Determinize ``fst``; ``use_log=True`` sums subset weights in the log
    semiring (preserves stochasticity), else tropical (min)."""
    if fst.start == NO_STATE_ID:
        return Fst()
    plus = log_plus if use_log else trop_plus

    def eps_closure(elements: dict[tuple[int, tuple], float]) -> dict[tuple[int, tuple], float]:
        """Close {(state, ostring): weight} over input-epsilon arcs."""
        closed = dict(elements)
        queue = list(elements.items())
        iters = 0
        while queue:
            (s, ostr), w = queue.pop()
            iters += 1
            if iters > _MAX_CLOSURE_ITERS:
                raise NonFunctionalError("epsilon cycle detected in determinize_star")
            for a in fst.arcs[s]:
                if a.ilabel != EPS:
                    continue
                no = ostr + (a.olabel,) if a.olabel != EPS else ostr
                nw = w + a.weight
                key = (a.nextstate, no)
                old = closed.get(key, ZERO)
                new = plus(old, nw)
                # re-expand only on improvement (tropical) / meaningful change (log)
                if new < old - 1e-9:
                    closed[key] = new
                    queue.append((key, new))
                elif key not in closed:
                    closed[key] = new
                    queue.append((key, new))
        return closed

    def normalize(elements: dict[tuple[int, tuple], float]):
        """Factor out common weight and common output prefix; return
        (key, norm_weight, prefix, canonical_elements)."""
        total = ZERO
        for w in elements.values():
            total = plus(total, w)
        ostrings = [o for (_, o) in elements.keys()]
        prefix = ostrings[0]
        for o in ostrings[1:]:
            k = 0
            while k < len(prefix) and k < len(o) and prefix[k] == o[k]:
                k += 1
            prefix = prefix[:k]
            if not prefix:
                break
        p = len(prefix)
        canon = {}
        for (s, o), w in elements.items():
            key = (s, o[p:])
            rw = w - total
            old = canon.get(key)
            canon[key] = plus(old, rw) if old is not None else rw
        subset_key = frozenset((s, o, _quantize(w)) for (s, o), w in canon.items())
        return subset_key, total, prefix, canon

    out = Fst()
    subset_ids: dict[frozenset, int] = {}
    subsets: list[dict] = []
    stack: list[int] = []

    def get_subset(canon: dict, key: frozenset) -> int:
        if key not in subset_ids:
            sid = out.add_state()
            subset_ids[key] = sid
            subsets.append(canon)
            stack.append(sid)
            if max_states and len(subsets) > max_states:
                raise NonFunctionalError(
                    f"determinize_star exceeded max_states={max_states}")
        return subset_ids[key]

    start_elems = eps_closure({(fst.start, ()): 0.0})
    skey, sweight, sprefix, scanon = normalize(start_elems)
    # start-state factored weight/prefix must be empty/zero; fold any nonzero
    # weight back in (can happen if start has eps arcs cheaper than staying)
    if sprefix:
        # rare: every path from start emits a common prefix before any input —
        # reattach it to the elements to keep the start state clean
        scanon = {(s, sprefix + o): w + sweight for (s, o), w in scanon.items()}
        skey = frozenset((s, o, _quantize(w)) for (s, o), w in scanon.items())
        sweight = 0.0
    elif sweight != 0.0:
        scanon = {k: w + sweight for k, w in scanon.items()}
        skey = frozenset((s, o, _quantize(w)) for (s, o), w in scanon.items())
        sweight = 0.0
    out.set_start(get_subset(scanon, skey))

    # final residues: (subset_state, ostring, weight) emitted after main loop
    final_residues: list[tuple[int, tuple, float]] = []
    # long output strings: (src, ilabel, ostring, weight, dst)
    long_arcs: list[tuple[int, int, tuple, float, int]] = []

    while stack:
        sid = stack.pop()
        elements = subsets[sid]

        # finals
        fin: dict[tuple, float] = {}
        for (s, o), w in elements.items():
            fw = fst.finals[s]
            if fw != ZERO:
                tot = w + fw
                fin[o] = plus(fin.get(o, ZERO), tot)
        if fin:
            if len(fin) > 1 and any(len(o) > 0 for o in fin):
                # genuinely diverging final output strings => not functional
                nonempty = [o for o in fin if o]
                if len(fin) > 1:
                    raise NonFunctionalError(
                        f"diverging final output strings {sorted(fin.keys())[:4]}")
            for o, w in fin.items():
                if not o:
                    out.set_final(sid, w)
                else:
                    final_residues.append((sid, o, w))

        # group outgoing non-eps arcs by ilabel
        by_ilabel: dict[int, dict[tuple[int, tuple], float]] = {}
        for (s, o), w in elements.items():
            for a in fst.arcs[s]:
                if a.ilabel == EPS:
                    continue
                no = o + (a.olabel,) if a.olabel != EPS else o
                key = (a.nextstate, no)
                d = by_ilabel.setdefault(a.ilabel, {})
                nw = w + a.weight
                old = d.get(key)
                d[key] = plus(old, nw) if old is not None else nw

        for ilabel, elems in sorted(by_ilabel.items()):
            closed = eps_closure(elems)
            key, weight, prefix, canon = normalize(closed)
            dst = get_subset(canon, key)
            if len(prefix) <= 1:
                olabel = prefix[0] if prefix else EPS
                out.add_arc(sid, ilabel, olabel, weight, dst)
            else:
                long_arcs.append((sid, ilabel, prefix, weight, dst))

    # expand long output strings into chains of eps-input arcs
    for src, ilabel, ostr, weight, dst in long_arcs:
        s = src
        for k, o in enumerate(ostr):
            last = k == len(ostr) - 1
            ns = dst if last else out.add_state()
            out.add_arc(s, ilabel if k == 0 else EPS, o, weight if k == 0 else 0.0, ns)
            s = ns
    # expand final residues: chain emitting remaining outputs, then final
    for src, ostr, weight in final_residues:
        s = src
        for k, o in enumerate(ostr):
            ns = out.add_state()
            out.add_arc(s, EPS, o, weight if k == 0 else 0.0, ns)
            s = ns
        out.set_final(s, 0.0)

    return out
