"""Transition model: transition-ids <-> (phone, hmm-state, pdf) + MLE update.

Counterpart of Kaldi ``TransitionModel`` (``hmm/transition-model.h:122``).
Transition-ids are 1-based (0 is reserved = epsilon on graph input labels,
exactly as in the reference), enumerating, for every "transition state"
(a tuple (phone, hmm_state, pdf)), each outgoing topology transition.

The probabilities live in a flat numpy array ``log_probs[tid]`` so that the
device decoder/aligner can gather them; the M-step is a vectorized update from
a transition-id occupancy vector (psum-reduced across the mesh by callers).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from .topology import HmmTopology


class TransitionModel:
    def __init__(self, topo: HmmTopology, tree):
        """``tree`` must provide ``map(phone_window, pdf_class) -> pdf`` and
        ``num_pdfs``; for monophone it is a trivial table
        (models/tree.py MonophoneTree)."""
        self.topo = topo
        self.tree = tree
        # tuples: 1-based transition-state -> (phone, hmm_state, pdf);
        # enumerates all (phone, state, pdf) the tree can produce
        # (TransitionModel ctor via ContextDependency::GetPdfInfo)
        self.tuples: list[tuple[int, int, int]] = []
        seen = set()
        for phone in topo.phones():
            states = topo.states_for(phone)
            for hmm_state, st in enumerate(states):
                if st.pdf_class < 0:
                    continue
                for pdf in tree.possible_pdfs(phone, st.pdf_class):
                    key = (phone, hmm_state, pdf)
                    if key not in seen:
                        seen.add(key)
                        self.tuples.append(key)
        self.tuples.sort()
        # transition-state (1-based) indexing
        self._tuple2tstate = {t: i + 1 for i, t in enumerate(self.tuples)}
        # per transition-state: number of transitions (from topology)
        self.state2id = [0, 1]  # state2id[tstate] = first tid of tstate
        for (phone, hmm_state, _pdf) in self.tuples:
            ntrans = len(topo.states_for(phone)[hmm_state].transitions)
            self.state2id.append(self.state2id[-1] + ntrans)
        self.num_transition_ids = self.state2id[-1] - 1
        # id -> tstate
        self.id2state = np.zeros(self.num_transition_ids + 1, dtype=np.int32)
        for ts in range(1, len(self.tuples) + 1):
            self.id2state[self.state2id[ts]: self.state2id[ts + 1]] = ts
        # initial log probs from topology
        self.log_probs = np.zeros(self.num_transition_ids + 1, dtype=np.float32)
        for ts, (phone, hmm_state, _pdf) in enumerate(self.tuples, start=1):
            trans = topo.states_for(phone)[hmm_state].transitions
            for i, (_ns, p) in enumerate(trans):
                self.log_probs[self.state2id[ts] + i] = math.log(max(p, 1e-20))
        # flat lookup arrays for device consumption
        self._build_lookup()

    # -- lookups -------------------------------------------------------------
    def _build_lookup(self):
        n = self.num_transition_ids + 1
        self.tid2pdf = np.zeros(n, dtype=np.int32)
        self.tid2phone = np.zeros(n, dtype=np.int32)
        self.tid2hmm_state = np.zeros(n, dtype=np.int32)
        self.tid_is_self_loop = np.zeros(n, dtype=bool)
        for tid in range(1, n):
            ts = int(self.id2state[tid])
            phone, hmm_state, pdf = self.tuples[ts - 1]
            self.tid2pdf[tid] = pdf
            self.tid2phone[tid] = phone
            self.tid2hmm_state[tid] = hmm_state
            ti = tid - self.state2id[ts]
            nxt = self.topo.states_for(phone)[hmm_state].transitions[ti][0]
            self.tid_is_self_loop[tid] = (nxt == hmm_state)

    @property
    def num_pdfs(self) -> int:
        return self.tree.num_pdfs

    def tuple_to_tstate(self, phone: int, hmm_state: int, pdf: int) -> int:
        return self._tuple2tstate[(phone, hmm_state, pdf)]

    def pair_to_tid(self, tstate: int, trans_index: int) -> int:
        return self.state2id[tstate] + trans_index

    def tid_info(self, tid: int) -> tuple[int, int, int, int]:
        """-> (phone, hmm_state, pdf, trans_index)"""
        ts = int(self.id2state[tid])
        phone, hmm_state, pdf = self.tuples[ts - 1]
        return phone, hmm_state, pdf, tid - self.state2id[ts]

    def self_loop_tid_of(self, tstate: int) -> int:
        """Transition-id of the self-loop of a transition state, or 0."""
        phone, hmm_state, _pdf = self.tuples[tstate - 1]
        trans = self.topo.states_for(phone)[hmm_state].transitions
        for i, (ns, _p) in enumerate(trans):
            if ns == hmm_state:
                return self.state2id[tstate] + i
        return 0

    def self_loop_logprob(self, tstate: int) -> float:
        tid = self.self_loop_tid_of(tstate)
        return float(self.log_probs[tid]) if tid else -np.inf

    # -- alignment utilities -------------------------------------------------
    def split_to_phones(self, tids) -> tuple[list[int], "np.ndarray"]:
        """Segment an alignment into phone instances (hmm/hmm-utils
        SplitToPhones): a new phone starts at a non-self-loop transition out
        of topology state 0.  Returns (phone per segment, segment id per
        frame)."""
        seg_phones: list[int] = []
        seg_of_frame = np.zeros(len(tids), np.int32)
        for i, t in enumerate(tids):
            if (self.tid2hmm_state[t] == 0 and not self.tid_is_self_loop[t]) \
                    or not seg_phones:
                seg_phones.append(int(self.tid2phone[t]))
            seg_of_frame[i] = len(seg_phones) - 1
        return seg_phones, seg_of_frame

    def convert_alignment(self, tids, new_model: "TransitionModel",
                          context_width: int = 3, central_position: int = 1):
        """Map an alignment to a new transition model / tree (convert-ali):
        keeps phone durations and hmm-state paths, re-derives pdfs through the
        new tree with phonetic context."""
        seg_phones, seg_of_frame = self.split_to_phones(tids)
        n_segs = len(seg_phones)
        tree = new_model.tree
        out = []
        for i, t in enumerate(tids):
            seg = int(seg_of_frame[i])
            window = []
            for k in range(context_width):
                rel = seg + (k - central_position)
                window.append(seg_phones[rel] if 0 <= rel < n_segs else 0)
            phone, hmm_state, _pdf, trans_index = self.tid_info(int(t))
            pdf_class = self.topo.states_for(phone)[hmm_state].pdf_class
            if tree.context_width == 1:
                new_pdf = tree.map_mono(phone, pdf_class)
            else:
                new_pdf = tree.map(tuple(window), pdf_class)
            ts = new_model.tuple_to_tstate(phone, hmm_state, new_pdf)
            out.append(new_model.pair_to_tid(ts, trans_index))
        return out

    # -- MLE update (gmm-est --write-occs / TransitionModel::MleUpdate) ------
    def mle_update(self, tid_counts: np.ndarray, floor: float = 0.01,
                   min_count: float = 5.0) -> float:
        """Update transition probs from transition-id occupancies; returns the
        auxiliary-function improvement per frame (log-likelihood gain).
        Mirrors ``TransitionModel::MleUpdate`` (hmm/transition-model.cc)."""
        counts = np.asarray(tid_counts, dtype=np.float64)
        objf_impr, tot_count = 0.0, 0.0
        for ts in range(1, len(self.tuples) + 1):
            lo, hi = self.state2id[ts], self.state2id[ts + 1]
            c = counts[lo:hi]
            tot = c.sum()
            if tot < min_count:
                continue
            old = np.exp(self.log_probs[lo:hi].astype(np.float64))
            new = c / tot
            new = np.maximum(new, floor)
            new /= new.sum()
            objf_impr += float((c * (np.log(new) - np.log(np.maximum(old, 1e-20)))).sum())
            tot_count += tot
            self.log_probs[lo:hi] = np.log(new).astype(np.float32)
        return objf_impr / max(tot_count, 1.0)

    # -- serialization -------------------------------------------------------
    def save(self, path: str | Path) -> None:
        obj = {
            "tuples": [list(t) for t in self.tuples],
            "log_probs": self.log_probs.tolist(),
        }
        Path(path).write_text(json.dumps(obj))

    def load_probs(self, path: str | Path) -> None:
        obj = json.loads(Path(path).read_text())
        assert [tuple(t) for t in obj["tuples"]] == self.tuples
        self.log_probs = np.asarray(obj["log_probs"], dtype=np.float32)
