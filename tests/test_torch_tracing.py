"""The port's spans and counters (``utils/profiling.py``): nesting and self
time, when they record, the spans and counters of ``Decoder.decode_lattice``,
``train_tri.realign`` and K2 at tiny sizes on the CPU (K2's on every path
that calls it), the Chrome trace on the profiler's clock, and
``StageTimer``."""

import json
import math
import time

import numpy as np
import pytest
import torch

from voicebridge_tpu_torch.config import DecodeOptions, TriTrainOptions
from voicebridge_tpu_torch.ops import align_band as AB
from voicebridge_tpu_torch.ops import gmm_kernel
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.ops import lattice as LAT
from voicebridge_tpu_torch.parallel import mesh as M
from voicebridge_tpu_torch.steps import train_tri
from voicebridge_tpu_torch.steps.align import AlignmentSet
from voicebridge_tpu_torch.steps.decode import Decoder
from voicebridge_tpu_torch.testing import random_am, synth_decode_graph, synth_train_graph
from voicebridge_tpu_torch.transforms import regtree as R
from voicebridge_tpu_torch.utils import profiling as P

import k2_cases


def _by_name(sess) -> dict:
    out: dict = {}
    for s in sess.spans:
        out.setdefault(s.name, []).append(s)
    return out


def _children(sess, parent) -> list:
    return [s for s in sess.spans if s.parent == parent.id]


def test_nesting_ids_and_self_time():
    with P.recording():
        with P.span("outer"):
            time.sleep(0.002)
            with P.span("inner"):
                time.sleep(0.003)
                with P.span("leaf"):
                    time.sleep(0.001)
            with P.span("inner"):
                pass
            P.count("things", 3)
            P.count("things")
        with P.span("second"):
            pass
    sess = P.session()
    outer, inner, leaf, inner2, second = sess.spans
    assert [s.name for s in sess.spans] == ["outer", "inner", "leaf", "inner", "second"]
    assert [s.id for s in sess.spans] == [0, 1, 2, 3, 4]
    assert (outer.parent, inner.parent, leaf.parent, inner2.parent) == (None, 0, 1, 0)
    assert {outer.root, inner.root, leaf.root, inner2.root} == {0}
    assert second.parent is None and second.root == second.id
    for s in sess.spans:
        kids = _children(sess, s)
        assert s.start_ns <= s.end_ns
        assert all(s.start_ns <= k.start_ns <= k.end_ns <= s.end_ns for k in kids)
        assert s.self_ns == (s.end_ns - s.start_ns) - sum(k.end_ns - k.start_ns for k in kids)
    assert leaf.self_ns >= 1_000_000 and inner.self_ns >= 3_000_000
    assert sess.counters == {"things": 4}
    pc, unix = sess.anchor
    assert pc <= outer.start_ns and abs(unix - time.time_ns()) < 60e9


def test_nothing_is_recorded_when_recording_is_off():
    with P.recording():
        with P.span("kept"):
            P.count("kept")
    before = P.session()
    assert not torch.autograd._profiler_enabled()
    # off: the one preallocated no-op context, no counter, a bare .cpu()
    assert P.span("a") is P.span("b") is P.host_wait("c")
    with P.span("dropped"):
        P.count("dropped", 5)
    x = torch.arange(4)
    assert P.to_host(x, "x") is x
    after = P.session()
    assert [s.name for s in after.spans] == ["kept"] and after.counters == {"kept": 1}
    assert after.anchor == before.anchor


def test_a_session_starts_under_the_profiler_and_a_new_profile_clears_it():
    with P.recording():
        with P.span("before"):
            pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with P.span("first"):
            P.to_host(torch.ones(3), "read")
    first = P.session()
    assert [s.name for s in first.spans] == ["first", "sync.read"]
    assert first.counters == {"host_sync": 1, "host_sync_bytes": 12}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        P.count("second")
    second = P.session()
    assert second.spans == [] and second.counters == {"second": 1}
    assert second.anchor[0] > first.anchor[0]


@pytest.fixture(scope="module")
def lattice_call():
    """A decode_lattice of 5 utterances in sub-batches of 2 over a
    300-state graph, recorded."""
    graph = synth_decode_graph(300, 8, num_pdfs=40, seed=3)
    dec = Decoder.from_dense_graph(graph, random_am(40, 2, 13, seed=4),
                                   DecodeOptions(lattice_beam=4.0), device="cpu")
    dec._lattice_chunk = lambda t, d: 2
    rng = np.random.default_rng(5)
    nf = np.array([37, 50, 12, 44, 29], np.int32)
    feats = torch.from_numpy(rng.standard_normal((5, 50, 13)).astype(np.float32))
    utts = [f"u{i}" for i in range(5)]
    with P.recording():
        lats = dec.decode_lattice(utts, feats, torch.from_numpy(nf))
    return dec, utts, nf, lats, P.session()


def test_decode_lattice_spans_and_counters(lattice_call):
    dec, utts, nf, lats, sess = lattice_call
    names = _by_name(sess)
    (root,) = names["decode_lattice"]
    assert root.parent is None
    subs = [nf[i:i + 2] for i in range(0, len(nf), 2)]
    s1, rows = dec.plan.num_states + 1, dec.plan.num_rows
    windows = sum(math.ceil(int(c.max()) / LAT.lattice_window(int(c.max()), s1, rows, len(c))[0])
                  for c in subs)
    c = sess.counters
    assert c["lattice.sub_batches"] == len(subs) == 3
    assert c["lattice.windows"] == windows
    assert c["lattice.frames"] == int(nf.sum())
    assert c["lattice.survivor_arcs"] == sum(lats[u].num_arcs for u in utts) > 0
    for name in ("lattice.loglikes", "lattice.forward", "lattice.backward", "lattice.order",
                 "lattice.survivors"):
        assert len(names[name]) == len(subs), name
        assert all(s.parent == root.id for s in names[name]), name
    syncs = [s for s in sess.spans if s.name.startswith("sync.")]
    assert all(s.root == root.id for s in syncs)
    assert len(syncs) == 1 + 5 * len(subs) + windows == c["host_sync"]
    assert len(names["sync.compaction"]) == windows
    assert {s.name for s in syncs} == {"sync.frame_counts", "sync.compaction",
                                       "sync.survivor_counts", "sync.use_final", "sync.costs",
                                       "sync.frames", "sync.arcs"}


def test_realign_spans_cover_the_call():
    rng = np.random.default_rng(7)
    graphs = [synth_train_graph(int(n), 30, rng) for n in rng.integers(20, 40, 12)]
    nf = np.array([2 * g.num_states + int(rng.integers(0, 20)) for g in graphs], np.int32)
    feats = torch.from_numpy(rng.standard_normal((12, int(nf.max()), 13)).astype(np.float32))
    am = random_am(30, 2, 13, seed=8)
    aset = AlignmentSet(graphs, device="cpu")
    aset._batch_chunk = lambda t, p, d, s: 5
    tids = np.zeros(feats.shape[:2], np.int32)
    weights = np.zeros(feats.shape[:2], np.float32)
    with P.recording():
        train_tri.realign(aset, am, feats, nf, tids, weights, [], TriTrainOptions(),
                          "test realign", [f"u{i}" for i in range(12)])
    sess = P.session()
    names = _by_name(sess)
    (root,) = names["realign"]
    assert len(names["align.prepare"]) == 2
    for name in ("align.loglikes", "align.search", "align.to_host", "align.assemble"):
        assert len(names[name]) == 3, name
    assert len(names["align.apply"]) == 1
    kids = _children(sess, root)
    assert {s.name for s in kids} == {"align.prepare", "align.loglikes", "align.search",
                                      "align.to_host", "align.assemble", "align.apply"}
    assert sum(s.end_ns - s.start_ns for s in kids) >= 0.9 * (root.end_ns - root.start_ns)
    assert sess.counters["align.sub_batches"] == 3
    assert sess.counters["align.utterances"] == 12
    assert sess.counters["align.failed"] == int((weights.sum(axis=1) == 0).sum())
    assert len(names["sync.align_tids"]) == len(names["sync.align_ok"]) == 3
    assert sess.counters["host_sync"] == 6
    assert sess.counters["align.tid_blocks"] == sess.counters["align.sub_batches"] == 3
    order = np.argsort(-nf, kind="stable")
    frames = sum(len(c) * int(nf[c].max()) for c in np.split(order, [5, 10]))
    assert sess.counters["gmm.live"] == frames * am.num_gauss
    assert sess.counters["gmm.slots"] == frames * 16 * 2 * 2  # 2 sub-tiles of 2 slabs


def test_gmm_counters_are_the_calls_sizes():
    """``gmm.live`` counts the frames times the live Gaussians, ``gmm.slots``
    the frames times the layout's slots, from the host's record of the
    model; a K2 call reads nothing back from the device."""
    live = k2_cases.live_mask("dead_between")
    gmm = K.pack_gmm(k2_cases.am_with_live(live, 13, seed=3), "cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 50, 13))
                         .astype(np.float32))
    with P.recording():
        gmm_kernel.loglikes_batch(x, gmm)
        gmm_kernel.loglikes(x[1, :7].contiguous(), gmm)
    sess = P.session()
    lay = gmm_kernel.layout(live)
    assert sess.counters["gmm.live"] == 107 * int(live.sum())
    assert sess.counters["gmm.slots"] == 107 * lay.slots >= sess.counters["gmm.live"]
    assert "host_sync" not in sess.counters
    assert not [s for s in sess.spans if s.name.startswith("sync.")]


def _decode(am, with_model: bool, feats, nf) -> None:
    graph = synth_decode_graph(100, 4, num_pdfs=am.num_pdfs, seed=1)
    dec = Decoder.from_dense_graph(graph, random_am(am.num_pdfs, 2, am.dim, seed=2)
                                   if with_model else am, device="cpu")
    if with_model:
        dec = dec.with_model(am, DecodeOptions())
    dec._batch_chunk = lambda t, d: len(nf)
    with P.recording():
        dec.decode_batch([f"u{i}" for i in range(len(nf))], feats, nf)


def _realign(am, feats, nf) -> None:
    rng = np.random.default_rng(6)
    graphs = [synth_train_graph(int(n) // 2, am.num_pdfs, rng) for n in nf]
    aset = AlignmentSet(graphs, device="cpu")
    aset._batch_chunk = lambda t, p, d, s: len(nf)
    tids = np.zeros(feats.shape[:2], np.int32)
    with P.recording():
        train_tri.realign(aset, am, feats, nf, tids, np.zeros(feats.shape[:2], np.float32), [],
                          TriTrainOptions(), "test realign", [f"u{i}" for i in range(len(nf))])


def _regtree(am, feats, bclass_of) -> None:
    eye = np.concatenate([np.eye(am.dim), np.zeros((am.dim, 1))], axis=1)
    with P.recording():
        R.regtree_fmllr_loglikes(K.pack_gmm(am, "cpu"), feats.reshape(-1, am.dim),
                                 np.stack([eye, 1.1 * eye]), np.array([0, 1]), bclass_of)


def _mesh_step(am, feats, nf) -> None:
    import torch.distributed as dist

    rng = np.random.default_rng(6)
    band = AB.build_band_plan([synth_train_graph(int(n) // 2, am.num_pdfs, rng) for n in nf])
    b, t = feats.shape[:2]
    pdf_ids = rng.integers(0, am.num_pdfs, (b, t)).astype(np.int32)
    try:
        mesh = M.make_mesh(devices="cpu")
        step = M.em_estep_sharded_banded(mesh, am.num_pdfs, 4, band.offsets)
        with P.recording():
            step(K.pack_gmm(am, "cpu"), band.W, band.pdf, band.alpha0, feats, nf,
                 np.zeros((b, t), np.int32), pdf_ids, np.ones((b, t), np.float32), 0.1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", ["decoder", "with_model", "realign", "regtree", "mesh"])
def test_the_hosts_live_mask_reaches_k2_on_every_path(path):
    """Every caller hands K2 the host's record of a ragged model's live
    Gaussians: ``gmm.live`` counts the frames times the live Gaussians and
    ``gmm.slots`` the frames times the ragged layout's slots, below the dense
    ``P * M`` slots; in the regression-tree scoring each class's call counts
    only the live Gaussians of its class (a Gaussian of no class in none)."""
    live = k2_cases.live_mask("dead_between")
    am = k2_cases.am_with_live(live, 13, seed=3)
    rng = np.random.default_rng(5)
    nf = np.array([40, 31, 36], np.int32)
    feats = torch.from_numpy(rng.standard_normal((3, 40, 13)).astype(np.float32))
    frames = feats.shape[0] * feats.shape[1]
    lays = [gmm_kernel.layout(live)]
    if path in ("decoder", "with_model"):
        _decode(am, path == "with_model", feats, nf)
    elif path == "realign":
        _realign(am, feats, nf)
    elif path == "mesh":
        _mesh_step(am, feats, nf)
    else:
        bclass_of = np.where(live, rng.integers(-1, 2, live.shape), -1)
        _regtree(am, feats, bclass_of)
        lays = [gmm_kernel.layout(live & (bclass_of == r)) for r in (0, 1)]
    sess = P.session()
    assert sess.counters["gmm.live"] == frames * sum(lay.live for lay in lays)
    assert sess.counters["gmm.slots"] == frames * sum(lay.slots for lay in lays)
    if path == "regtree":
        assert sess.counters["gmm.live"] < frames * live.sum()
    assert sess.counters["gmm.slots"] < frames * live.size * len(lays)


def test_the_chrome_trace_puts_spans_on_the_profilers_clock(tmp_path):
    x = torch.ones(256, 256)
    with P.trace(tmp_path):
        with P.span("outer"):
            y = torch.mm(x, x)
    assert float(y[0, 0]) == 256.0
    assert [s.name for s in P.session().spans] == ["outer"]
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    (outer,) = [e for e in events if e["name"] == "vbt.outer"]
    ops = [e for e in events if e["name"] == "aten::mm"]
    assert ops and all(outer["ts"] <= e["ts"] and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]
                       for e in ops)


def test_stage_timer_stages_are_spans():
    timer = P.StageTimer()
    with P.recording():
        with timer.stage("mfcc", audio_s=4.0):
            with P.span("inside"):
                pass
    sess = P.session()
    stage, inside = sess.spans
    assert (stage.name, inside.name, inside.parent) == ("mfcc", "inside", stage.id)
    report = timer.report()
    assert report["mfcc"]["calls"] == 1 and report["mfcc"]["audio_s"] == 4.0


FMLLR_CHILDREN = {"fmllr.si_lattices", "fmllr.posteriors", "fmllr.stats", "fmllr.solve",
                  "fmllr.apply", "fmllr.adapted_lattices", "fmllr.rescore", "fmllr.determinize",
                  "sync.frame_counts"}


def test_decode_fmllr_spans_and_counters(monkeypatch):
    """``FmllrDecoder.decode`` of 2 speakers' 8 utterances: the ``fmllr.*``
    spans are the children of one root ``decode_fmllr`` and cover it, two
    ``fmllr.posteriors``, ``fmllr.stats``, ``fmllr.solve`` and
    ``fmllr.apply``, the lattice passes' ``decode_lattice`` inside theirs,
    and the counters hold the call's speakers, posterior entries,
    determinized states and halvings (each determinization here made to
    report two)."""
    from test_torch_sat_reference import OPTS, one_thread, sat_inputs

    from voicebridge_tpu_torch.steps import decode_fmllr as DF

    real = DF.determinize_lattices

    def halved_twice(*args, **kwargs):
        return [(clat, halved + 2) for clat, halved in real(*args, **kwargs)]

    monkeypatch.setattr(DF, "determinize_lattices", halved_twice)
    c = sat_inputs(seed=5)
    with one_thread():
        dec = DF.FmllrDecoder(c.dense, c.tm, c.am, c.alimdl, c.lang, OPTS, device="cpu")
        with P.recording():
            results, trans = dec.decode(c.utts, c.feats, c.nf, c.utt2spk)
        sess = P.session()
    names = _by_name(sess)
    (root,) = names["decode_fmllr"]
    assert root.parent is None and len(results) == len(c.utts)
    kids = _children(sess, root)
    assert {k.name for k in kids} == FMLLR_CHILDREN
    assert [k.name for k in kids].count("fmllr.posteriors") == 2
    for name in ("fmllr.stats", "fmllr.solve", "fmllr.apply"):
        assert len(names[name]) == 2 and all(s.parent == root.id for s in names[name])
    for name in ("fmllr.si_lattices", "fmllr.adapted_lattices"):
        (outer,) = names[name]
        assert [k.name for k in _children(sess, outer)] == ["decode_lattice"]
    assert all(s.root == root.id for s in sess.spans)
    assert sum(k.end_ns - k.start_ns for k in kids) >= 0.95 * (root.end_ns - root.start_ns)
    assert sess.counters["fmllr.speakers"] == 2
    assert sess.counters["fmllr.det_retries"] == 2 * len(c.utts)
    assert sess.counters["fmllr.det_states"] >= len(c.utts)
    assert 0 < sess.counters["fmllr.post_entries"] <= 2 * DF.K_POST * c.nf.sum()
    assert trans.shape == (2, 40, 41)
