"""H transducer and self-loop expansion (HMM level of HCLG).

Counterparts: ``GetHmmAsFst`` / ``GetHTransducer`` / ``AddSelfLoops``
(``kaldi-master/src/hmm/hmm-utils.cc:30-560``) and the ``make-h-transducer`` /
``add-self-loops`` wrapped binaries.

Weight semantics (verified against the reference):

* H pieces carry, per non-self-loop transition-id, weight
  ``transition_scale * -log( p(tid) / (1 - p_self(tstate)) )``
  (GetTransitionLogProbIgnoringSelfLoops, transition-model.cc:457-461).
* ``add_self_loops`` (reorder=true, dan-style): states are split so all
  incoming arcs share one transition-state class; that class's self-loop tid
  is attached with weight ``self_loop_scale * -log(p_self)`` and all outgoing
  arcs/finals get ``self_loop_scale * -log(1 - p_self)`` added
  (AddSelfLoopsBefore, hmm-utils.cc:434-506).

``ilabel_info`` convention (as in fstext/context-fst): entry 0 = () = epsilon,
disambiguation symbols = single-element tuples of *negated* symbol ids,
phone-in-context windows = N-tuples of phone ids.
"""

from __future__ import annotations

import math

from ..models.transition import TransitionModel
from .core import EPS, Arc, Fst, ZERO


def make_hmm_piece(phone_window: tuple, tree, trans_model: TransitionModel,
                   transition_scale: float) -> Fst:
    """HMM-as-FST for one phone-in-context, without self-loops
    (GetHmmAsFst, hmm-utils.cc:30-146).  ilabels = olabels = transition-ids."""
    topo = trans_model.topo
    phone = phone_window[tree.central_position] if len(phone_window) > 1 else phone_window[0]
    states = topo.states_for(phone)
    pdfs = [tree.map(phone_window, c) if len(phone_window) > 1 else
            tree.map_mono(phone, c)
            for c in range(topo.num_pdf_classes(phone))]
    f = Fst()
    ids = [f.add_state() for _ in states]
    f.set_start(ids[0])
    f.set_final(ids[-1], 0.0)
    for hmm_state, st in enumerate(states):
        if st.pdf_class < 0:
            continue
        pdf = pdfs[st.pdf_class]
        ts = trans_model.tuple_to_tstate(phone, hmm_state, pdf)
        # log(1 - p_self): total non-self-loop probability of this tstate
        p_nonself = sum(p for ns, p in st.transitions if ns != hmm_state)
        log_nonself = math.log(max(p_nonself, 1e-20))
        for trans_idx, (ns, _p) in enumerate(st.transitions):
            if ns == hmm_state:
                continue  # self-loops added later
            tid = trans_model.pair_to_tid(ts, trans_idx)
            log_prob = float(trans_model.log_probs[tid]) - log_nonself
            f.add_arc(ids[hmm_state], tid, tid,
                      transition_scale * (-log_prob), ids[ns])
    return f


def make_h_transducer(ilabel_info: list, tree, trans_model: TransitionModel,
                      transition_scale: float = 1.0,
                      piece_cache: dict | None = None) -> tuple[Fst, list[int]]:
    """Ha: input transition-ids (+ left disambig symbols), output = indices
    into ``ilabel_info`` (= CLG input labels).  Loop FST: start state is final;
    each entry's piece hangs off it with the ilabel-info index emitted on the
    entering arc (GetHTransducer + MakeLoopFst).  ``piece_cache`` can be
    shared across utterances (HmmCacheType role, hmm-utils.cc:244)."""
    h = Fst()
    loop = h.add_state()
    h.set_start(loop)
    h.set_final(loop, 0.0)
    first_disambig = trans_model.num_transition_ids + 1
    next_disambig = first_disambig
    disambig_tids: list[int] = []
    if piece_cache is None:
        piece_cache = {}

    for j in range(1, len(ilabel_info)):
        entry = tuple(ilabel_info[j])
        if len(entry) == 1 and entry[0] <= 0:
            # disambiguation symbol: single pass-through arc
            sym = next_disambig
            next_disambig += 1
            disambig_tids.append(sym)
            h.add_arc(loop, sym, j, 0.0, loop)
            continue
        piece = piece_cache.get(entry)
        if piece is None:
            piece = make_hmm_piece(entry, tree, trans_model, transition_scale)
            piece_cache[entry] = piece
        # splice the piece in: entry arc emits j, exit arc returns to loop
        offset = h.num_states
        for s in piece.states():
            h.add_state()
        for s in piece.states():
            for a in piece.arcs[s]:
                h.add_arc(offset + s, a.ilabel, EPS, a.weight, offset + a.nextstate)
            if piece.finals[s] != ZERO:
                h.add_arc(offset + s, EPS, EPS, piece.finals[s], loop)
        h.add_arc(loop, EPS, j, 0.0, offset + piece.start)
    return h, disambig_tids


# ---------------------------------------------------------------------------
# Self-loop expansion
# ---------------------------------------------------------------------------


def _label_class(label: int, trans_model: TransitionModel, disambig: set) -> int:
    """tid -> its transition-state; eps/disambig -> 0 (TidToTstateMapper)."""
    if 1 <= label <= trans_model.num_transition_ids:
        return int(trans_model.id2state[label])
    if label == EPS or label in disambig:
        return 0
    raise ValueError(f"unexpected input label {label}")


def make_preceding_input_symbols_same_class(fst: Fst, trans_model: TransitionModel,
                                            disambig: set) -> list[int]:
    """Split states so all incoming arcs of a state share one label class;
    returns per-state class (-1 = no incoming arcs).  In-place."""
    # collect incoming classes
    n = fst.num_states
    classes: list[set] = [set() for _ in range(n)]
    for s in range(n):
        for a in fst.arcs[s]:
            classes[a.nextstate].add(_label_class(a.ilabel, trans_model, disambig))

    state_class = [-1] * n
    copies: dict[tuple[int, int], int] = {}  # (orig, class) -> new id

    for s in range(n):
        cl = classes[s]
        needs_split = len(cl) > 1 or (s == fst.start and len(cl) == 1 and 0 not in cl)
        if not needs_split:
            if cl:
                state_class[s] = next(iter(cl))
            continue
        for c in sorted(cl):
            if s == fst.start or c != min(cl):
                ns = fst.add_state()
                state_class.append(c)
                fst.finals.append(fst.finals[s])
                # copy outgoing arcs (note: self-loops shouldn't exist yet)
                fst.arcs[ns] = [Arc(a.ilabel, a.olabel, a.weight, a.nextstate)
                                for a in fst.arcs[s]]
                copies[(s, c)] = ns
            else:
                state_class[s] = c
        if s == fst.start:
            state_class[s] = -1  # start keeps no incoming arcs

    if copies:
        for s in range(fst.num_states):
            for a in fst.arcs[s]:
                c = _label_class(a.ilabel, trans_model, disambig)
                key = (a.nextstate, c)
                if key in copies:
                    a.nextstate = copies[key]
    return state_class


def add_self_loops(fst: Fst, trans_model: TransitionModel,
                   disambig_tids: list[int], self_loop_scale: float = 0.1) -> Fst:
    """Reorder (dan-style) self-loop expansion, in place (AddSelfLoopsBefore)."""
    disambig = set(disambig_tids)
    state_class = make_preceding_input_symbols_same_class(fst, trans_model, disambig)
    for s in range(fst.num_states):
        ts = state_class[s]
        if ts <= 0:
            continue
        self_tid = trans_model.self_loop_tid_of(ts)
        if self_tid == 0:
            continue
        log_self = float(trans_model.log_probs[self_tid])
        log_nonself = math.log(max(1.0 - math.exp(log_self), 1e-20))
        corr = self_loop_scale * (-log_nonself)
        if fst.finals[s] != ZERO:
            fst.finals[s] += corr
        for a in fst.arcs[s]:
            a.weight += corr
        fst.add_arc(s, self_tid, EPS, self_loop_scale * (-log_self), s)
    return fst


def remove_input_symbols(fst: Fst, symbols: set) -> Fst:
    """fstrmsymbols: map the given input labels to epsilon, in place."""
    for s in fst.states():
        for a in fst.arcs[s]:
            if a.ilabel in symbols:
                a.ilabel = EPS
    return fst
