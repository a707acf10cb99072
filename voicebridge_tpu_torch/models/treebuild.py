"""Phonetic decision-tree building for tied triphone states.

Counterparts in the reference: ``acc-tree-stats`` / ``sum-tree-stats`` /
``cluster-phones`` / ``compile-questions`` / ``build-tree``
(``kaldi-win/src/bin``, L3 ``tree/``: build-tree.h, cluster-utils.h:129-209,
``GaussClusterable``) as orchestrated by train_deltas.cpp:243-392.

All statistics are diagonal-Gaussian sufficient stats (count, sum x,
sum x^2); the objective is the standard ML criterion

    objf(stats) = -0.5 * count * sum_d (log var_d + 1 + log 2pi)

and both phone clustering (questions) and top-down splitting greedily maximize
objf gain.  Host-side: the tree is built once per training stage.

Numpy copy of ``voicebridge_tpu/models/treebuild.py``: the same stats and
the same tree from the same alignments and features.  Its mesh branch
(``acc_tree_stats(..., mesh=)``) sums the statistics on the ranks' devices
through ``parallel/mesh.acc_tree_stats_sharded``.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from .tree import ContextTree

M_LOG_2PI = math.log(2.0 * math.pi)


class GaussStats:
    __slots__ = ("count", "sum_x", "sum_x2")

    def __init__(self, dim: int):
        self.count = 0.0
        self.sum_x = np.zeros(dim)
        self.sum_x2 = np.zeros(dim)

    def add(self, other: "GaussStats") -> "GaussStats":
        self.count += other.count
        self.sum_x += other.sum_x
        self.sum_x2 += other.sum_x2
        return self

    def add_arrays(self, count, sum_x, sum_x2):
        self.count += count
        self.sum_x += sum_x
        self.sum_x2 += sum_x2
        return self

    def copy(self) -> "GaussStats":
        s = GaussStats(len(self.sum_x))
        s.count = self.count
        s.sum_x = self.sum_x.copy()
        s.sum_x2 = self.sum_x2.copy()
        return s

    def objf(self, var_floor: float = 0.01) -> float:
        if self.count <= 1e-10:
            return 0.0
        mean = self.sum_x / self.count
        var = np.maximum(self.sum_x2 / self.count - mean * mean, var_floor)
        return -0.5 * self.count * float((np.log(var) + 1.0 + M_LOG_2PI).sum())


def objf_of_sum(stats_list, var_floor: float = 0.01) -> float:
    if not stats_list:
        return 0.0
    total = stats_list[0].copy()
    for s in stats_list[1:]:
        total.add(s)
    return total.objf(var_floor)


# ---------------------------------------------------------------------------
# Tree-stats accumulation (acc-tree-stats)
# ---------------------------------------------------------------------------


def frame_event_ids(alignments: dict, feats_by_utt: dict, trans_model,
                    context_width: int = 3, central_position: int = 1,
                    ci_phones: set | None = None):
    """Per-frame tree-event keying.

    alignments: utt -> list[tid]; event key = (phone_window tuple, pdf_class).
    Context positions beyond utterance edges are phone 0.  Context-independent
    phones (silence) get windows with zeroed context (Kaldi --ci-phones).
    Returns (events list[key], feats [N, D] concatenated frames,
    event_ids [N] index into events).
    """
    ci_phones = ci_phones or set()
    n, p = context_width, central_position
    events: dict = {}
    feat_parts, id_parts = [], []
    for utt, tids in alignments.items():
        if not tids:
            continue
        feats = feats_by_utt[utt]
        phones = trans_model.tid2phone[tids]
        pdf_classes = np.asarray(
            [trans_model.topo.states_for(int(ph)).__getitem__(
                int(trans_model.tid2hmm_state[t])).pdf_class
             for t, ph in zip(tids, phones)], np.int32)
        seg_phone, seg_of_frame = trans_model.split_to_phones(tids)
        num_segs = len(seg_phone)
        ids = np.empty(len(tids), np.int32)
        for i in range(len(tids)):
            seg = seg_of_frame[i]
            window = []
            for k in range(n):
                rel = seg + (k - p)
                if 0 <= rel < num_segs:
                    window.append(seg_phone[rel])
                else:
                    window.append(0)
            ph = seg_phone[seg]
            if ph in ci_phones:
                window = [0] * n
                window[p] = ph
            key = (tuple(window), int(pdf_classes[i]))
            eid = events.get(key)
            if eid is None:
                eid = events[key] = len(events)
            ids[i] = eid
        feat_parts.append(np.asarray(feats[: len(tids)], np.float32))
        id_parts.append(ids)
    if not feat_parts:
        return [], np.zeros((0, 1), np.float32), np.zeros(0, np.int32)
    return (list(events.keys()), np.concatenate(feat_parts),
            np.concatenate(id_parts))


def stats_from_arrays(events: list, count: np.ndarray, sum_x: np.ndarray,
                      sum_x2: np.ndarray) -> dict:
    """(events, per-event count/sum_x/sum_x2 arrays) -> dict event ->
    GaussStats (the build_tree input format)."""
    stats: dict = {}
    for eid, key in enumerate(events):
        if count[eid] <= 0:
            continue
        st = GaussStats(sum_x.shape[1])
        st.add_arrays(float(count[eid]), sum_x[eid], sum_x2[eid])
        stats[key] = st
    return stats


def acc_tree_stats(alignments: dict, feats_by_utt: dict, trans_model,
                   context_width: int = 3, central_position: int = 1,
                   ci_phones: set | None = None, mesh=None) -> dict:
    """Accumulate per-event Gaussian stats from alignments (acc-tree-stats +
    sum-tree-stats roles) as a vectorized per-event scatter-add in float64.
    ``feats_by_utt`` holds float32 arrays.  With ``mesh`` set
    (``parallel/mesh.make_mesh``) the frames are sharded over the data axis,
    summed by ``index_add_`` in float64 on each rank's device and reduced
    over the axis (the reference sums per-job .treeacc files,
    ``train_deltas.cpp:294``).  Returns dict event -> GaussStats.
    """
    events, feats, event_ids = frame_event_ids(
        alignments, feats_by_utt, trans_model, context_width,
        central_position, ci_phones)
    if not events:
        return {}
    ne = len(events)
    if mesh is not None:
        from ..parallel.mesh import acc_tree_stats_sharded, pad_to_mesh

        feats_p, ids_p, w_p = pad_to_mesh(mesh, feats, event_ids)
        count, sx, sx2 = (a.cpu().numpy() for a in
                          acc_tree_stats_sharded(mesh, ne)(feats_p, ids_p, w_p))
        return stats_from_arrays(events, count, sx, sx2)
    d = feats.shape[1]
    count = np.zeros(ne, np.float64)
    sx = np.zeros((ne, d), np.float64)
    sx2 = np.zeros((ne, d), np.float64)
    np.add.at(count, event_ids, 1.0)
    np.add.at(sx, event_ids, feats)
    np.add.at(sx2, event_ids, feats * feats)
    return stats_from_arrays(events, count, sx, sx2)


# ---------------------------------------------------------------------------
# Questions (cluster-phones + compile-questions)
# ---------------------------------------------------------------------------


def cluster_phones(stats: dict, phones: list[int], central_position: int = 1,
                   max_questions: int = 0) -> list[frozenset]:
    """Agglomerative clustering of phones by their pooled central-phone stats;
    every intermediate cluster becomes a membership question."""
    per_phone: dict[int, GaussStats] = {}
    dim = None
    for (window, _pc), st in stats.items():
        ph = window[central_position] if len(window) > 1 else window[0]
        dim = dim or len(st.sum_x)
        per_phone.setdefault(ph, GaussStats(dim)).add(st)
    active = {ph: st for ph, st in per_phone.items() if ph in set(phones)}
    clusters: list[tuple[frozenset, GaussStats]] = [
        (frozenset([ph]), st.copy()) for ph, st in sorted(active.items())]
    questions = [c for c, _ in clusters]
    # greedy merges: pick pair with least objf loss
    while len(clusters) > 1:
        best = None
        for i in range(len(clusters)):
            for j in range(i + 1, len(clusters)):
                merged = clusters[i][1].copy().add(clusters[j][1])
                loss = clusters[i][1].objf() + clusters[j][1].objf() - merged.objf()
                if best is None or loss < best[0]:
                    best = (loss, i, j, merged)
        _loss, i, j, merged = best
        new_set = clusters[i][0] | clusters[j][0]
        clusters = [c for k, c in enumerate(clusters) if k not in (i, j)]
        clusters.append((new_set, merged))
        questions.append(new_set)
    return questions


# ---------------------------------------------------------------------------
# Top-down tree building (build-tree)
# ---------------------------------------------------------------------------


class _Node:
    __slots__ = ("events", "stats", "objf", "key", "values", "yes", "no", "pdf")

    def __init__(self, events, dim):
        self.events = events  # list[(event_key, GaussStats)]
        total = GaussStats(dim)
        for _e, s in events:
            total.add(s)
        self.stats = total
        self.objf = total.objf()
        self.key = None
        self.values = None
        self.yes = None
        self.no = None
        self.pdf = None


def _best_split(node: _Node, questions_by_key: dict, dim: int,
                min_count: float):
    """Find the best (key, value-subset) split of a leaf; returns
    (gain, key, values, yes_events, no_events) or None."""
    best = None
    for key, questions in questions_by_key.items():
        # value of this key per event
        def val(ev):
            window, pdf_class = ev
            return pdf_class if key == -1 else window[key]

        # pool stats by value to evaluate subsets fast
        by_val: dict = {}
        for e, s in node.events:
            v = val(e)
            if v not in by_val:
                by_val[v] = GaussStats(dim)
            by_val[v].add(s)
        if len(by_val) <= 1:
            continue
        for q in questions:
            yes = GaussStats(dim)
            no = GaussStats(dim)
            for v, s in by_val.items():
                (yes if v in q else no).add(s)
            if yes.count < min_count or no.count < min_count:
                continue
            gain = yes.objf() + no.objf() - node.objf
            if best is None or gain > best[0]:
                yes_events = [(e, s) for e, s in node.events if val(e) in q]
                no_events = [(e, s) for e, s in node.events if val(e) not in q]
                best = (gain, key, frozenset(q), yes_events, no_events)
    return best


def build_tree(stats: dict, lang, context_width: int = 3,
               central_position: int = 1, num_leaves: int = 2000,
               min_gain: float = 0.0, min_count: float = 3.0,
               cluster_thresh: float = -1.0) -> ContextTree:
    """Top-down splitting with roots per base phone (positional variants of a
    phone share a root and split together, like prepare_lang's roots with
    'shared split').  Silence phones are kept context-independent: their roots
    are never split on context keys."""
    dim = next(iter(stats.values())).sum_x.shape[0] if stats else 1
    phones = lang.phone_ids
    sil = set(lang.silence_phone_ids)

    # questions: phone-membership for context keys + pdf-class questions
    nonsil_questions = cluster_phones(stats, [p for p in phones],
                                      central_position)
    max_pdf_class = max(pc for (_w, pc) in stats.keys())
    pdf_class_questions = [frozenset(range(k + 1))
                           for k in range(max_pdf_class)]
    questions_by_key = {}
    for k in range(context_width):
        questions_by_key[k] = nonsil_questions
    questions_by_key[-1] = pdf_class_questions

    # roots: group positional variants of each base phone
    base_groups: dict[str, list[int]] = defaultdict(list)
    for ph in phones:
        base_groups[lang.base_phone_of.get(ph, str(ph))].append(ph)

    events_by_root: dict[str, list] = defaultdict(list)
    phone_to_base = {ph: b for b, phs in base_groups.items() for ph in phs}
    for (window, pdf_class), st in stats.items():
        ph = window[central_position]
        base = phone_to_base.get(ph)
        if base is None:
            continue
        events_by_root[base].append(((window, pdf_class), st))

    # initialize one leaf per root; silence roots never split on context
    leaves: list[tuple[_Node, bool]] = []  # (node, splittable_on_context)
    for base, evs in sorted(events_by_root.items()):
        is_sil = any(p in sil for p in base_groups[base])
        leaves.append((_Node(evs, dim), not is_sil))

    # priority-driven greedy splitting
    import heapq

    heap = []
    nodes: list[_Node] = []

    def push(node: _Node, ctx_ok: bool):
        qk = questions_by_key if ctx_ok else {-1: questions_by_key[-1]}
        split = _best_split(node, qk, dim, min_count)
        nodes.append(node)
        if split is not None and split[0] > min_gain:
            heapq.heappush(heap, (-split[0], len(nodes) - 1, split, ctx_ok))

    for node, ctx_ok in leaves:
        push(node, ctx_ok)

    num_cur = len(leaves)
    while heap and num_cur < num_leaves:
        neg_gain, idx, split, ctx_ok = heapq.heappop(heap)
        node = nodes[idx]
        _gain, key, values, yes_events, no_events = split
        node.key = key
        node.values = values
        yes_node = _Node(yes_events, dim)
        no_node = _Node(no_events, dim)
        node.yes = yes_node
        node.no = no_node
        push(yes_node, ctx_ok)
        push(no_node, ctx_ok)
        num_cur += 1

    # assign pdf ids to leaves (stable order: DFS over roots)
    flat_nodes: list[dict] = []
    num_pdfs = 0

    def emit(node: _Node) -> int:
        nonlocal num_pdfs
        my_id = len(flat_nodes)
        if node.yes is None:
            flat_nodes.append({"pdf": num_pdfs})
            num_pdfs += 1
            return my_id
        flat_nodes.append({})
        yes_id = emit(node.yes)
        no_id = emit(node.no)
        flat_nodes[my_id] = {"key": node.key, "values": set(node.values),
                             "yes": yes_id, "no": no_id}
        return my_id

    # root dispatch: first split on central phone to find the right root
    # implemented as a chain of membership tests over base groups
    root_ids = {}
    chain_start = len(flat_nodes)
    bases = sorted(events_by_root.keys())
    # build dispatch chain nodes lazily after roots are emitted
    dispatch_slots = []
    for _ in range(max(len(bases) - 1, 0)):
        flat_nodes.append({})
        dispatch_slots.append(len(flat_nodes) - 1)
    for base, (node, _ctx) in zip(bases, (x for x in leaves)):
        root_ids[base] = emit(node)
    # fill dispatch chain: test membership of central phone per base
    cur = 0  # index into dispatch_slots / bases
    for i, base in enumerate(bases[:-1]):
        slot = dispatch_slots[i]
        nxt = dispatch_slots[i + 1] if i + 1 < len(dispatch_slots) else root_ids[bases[-1]]
        flat_nodes[slot] = {
            "key": central_position,
            "values": set(base_groups[base]),
            "yes": root_ids[base],
            "no": nxt,
        }
    # tree entry point must be node 0: rotate if needed
    entry = dispatch_slots[0] if dispatch_slots else root_ids[bases[0]]
    if entry != 0:
        # remap: swap node 0 and entry
        perm = list(range(len(flat_nodes)))
        perm[0], perm[entry] = entry, 0
        remapped = [None] * len(flat_nodes)
        inv = {old: new for new, old in enumerate(perm)}
        for old, node in enumerate(flat_nodes):
            nn = dict(node)
            if "yes" in nn:
                nn["yes"] = inv[nn["yes"]]
                nn["no"] = inv[nn["no"]]
            remapped[inv[old]] = nn
        flat_nodes = remapped

    return ContextTree(context_width, central_position, flat_nodes, num_pdfs)
