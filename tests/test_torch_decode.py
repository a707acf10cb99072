"""Parity of the port's decode core with the JAX package's: the host graph
and plan builders array for array (and the real-slot counts K3 and K5 read),
the per-frame relaxation (the K3 plain version, which is also the wrapper's
CPU path) against JAX ``_emit_step``, the window scan against JAX
``viterbi_scan``, the block backtrace (the ``backtrace_best`` plain version)
against JAX ``backtrace_scan``, and the full best-path decode in keep and
recompute modes, against JAX ``decode_best_path`` and against the JAX
package's arc-parallel searches ``viterbi_forward_shared`` and
``viterbi_forward_shared_fused``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.ops import decode_core as JDC
from voicebridge_tpu.ops import viterbi as JV
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.ops import decode_core as DC
from voicebridge_tpu_torch.ops.graph import DenseGraph, compile_dense_graph
from voicebridge_tpu_torch.testing import load_yesno_mono, random_codes, synth_decode_graph

torch.set_num_threads(2)


def _bench_graph(num_states=600, num_pdfs=50, seed=0):
    return synth_decode_graph(num_states, arcs_per_state=8, num_pdfs=num_pdfs, seed=seed)


def _random_graph(rng, s=40, a=200, p=7):
    """Random epsilon-free graph with distinct weights (no argmax ties)."""
    alpha0 = np.full(s, DC.NEG_INF, np.float32)
    alpha0[0] = 0.0
    final_score = np.full(s, DC.NEG_INF, np.float32)
    finals = rng.choice(s, size=max(2, s // 4), replace=False)
    final_score[finals] = -rng.random(len(finals)).astype(np.float32)
    arc_pdf = rng.integers(0, p, size=a).astype(np.int32)
    return DenseGraph(
        num_states=s, arc_src=rng.integers(0, s, size=a).astype(np.int32),
        arc_dst=rng.integers(0, s, size=a).astype(np.int32), arc_tid=arc_pdf + 1,
        arc_pdf=arc_pdf, arc_score=(-rng.random(a) * 3.0).astype(np.float32),
        arc_oseq=rng.integers(0, 3, size=a).astype(np.int32), alpha0=alpha0,
        start_oseq=np.zeros(s, np.int32), final_score=final_score,
        final_oseq=np.zeros(s, np.int32), oseqs=[(), (5,), (6, 7)])


def _assert_same_tuple(a, b):
    assert type(a)._fields == type(b)._fields
    for name in type(a)._fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            assert x == y, name


@pytest.mark.parametrize("d", [None, 8])
@pytest.mark.parametrize("which", ["yesno", "bench"])
def test_graph_and_plan_match_jax(which, d):
    if which == "yesno":
        m = load_yesno_mono()
        graph = compile_dense_graph(m.hclg, m.trans_model.tid2pdf)
        _assert_same_tuple(graph, JV.compile_dense_graph(m.hclg, m.trans_model.tid2pdf))
    else:
        graph = _bench_graph()
    plan = DC.build_emit_plan(graph, d=d)
    jplan = JDC.build_emit_plan(JV.DenseGraph(**graph._asdict()), d=d)
    _assert_same_tuple(plan, convert.emit_plan_from_jax(jplan))


@pytest.mark.parametrize("which", ["yesno", "bench"])
def test_row_real_slots_match_row_arc(which):
    """The derived count of real slots per row equals the count of
    ``row_arc >= 0`` on the forward and the backward (transposed) plan, the
    pads trail, and ``plan_to_device`` carries it."""
    if which == "yesno":
        m = load_yesno_mono()
        graph = compile_dense_graph(m.hclg, m.trans_model.tid2pdf)
    else:
        graph = _bench_graph()
    for g in (graph, graph._replace(arc_src=graph.arc_dst, arc_dst=graph.arc_src)):
        for d in (None, 3, 8):
            plan = DC.build_emit_plan(g, d=d)
            real = DC.row_real_slots(plan)
            assert real.dtype == np.uint8
            np.testing.assert_array_equal(real, (plan.row_arc >= 0).sum(axis=1))
            pos = np.arange(plan.d)[None, :]
            np.testing.assert_array_equal(plan.row_arc >= 0, pos < real[:, None])
            assert (real == 0).any()  # the pad state's dead row at least
            np.testing.assert_array_equal(DC.plan_to_device(plan, "cpu").row_real.numpy(), real)


def test_row_real_slots_rejects_interleaved_pads():
    plan = DC.build_emit_plan(_bench_graph(num_states=100, num_pdfs=10), d=4)
    r = int(np.flatnonzero((plan.row_arc >= 0).sum(axis=1) == 2)[0])
    arc = plan.row_arc.copy()
    arc[r, [0, 1]] = arc[r, [1, 0]]
    arc[r, 0] = -1  # a pad before a real slot
    with pytest.raises(ValueError, match="real slots first"):
        DC.row_real_slots(plan._replace(row_arc=arc))


def _step_inputs(seed, b=5):
    rng = np.random.default_rng(seed)
    graph = _bench_graph(num_states=300, num_pdfs=20, seed=seed)
    plan = DC.build_emit_plan(graph, d=4)
    s1 = plan.num_states + 1
    alpha = (rng.standard_normal((s1, b)) * 10 - 50).astype(np.float32)
    alpha[rng.random((s1, b)) < 0.2] = DC.NEG_INF
    alpha[-1] = DC.NEG_INF
    ll_t = (rng.standard_normal((20, b)) * 5 - 30).astype(np.float32)
    return plan, alpha, ll_t


@pytest.mark.parametrize("seed", [0, 1])
def test_emit_step_matches_jax(seed):
    plan, alpha, ll_t = _step_inputs(seed)
    acwt = float(np.float32(1.0 / 13.0))
    ja, jcode = JDC._emit_step(jnp.asarray(alpha), jnp.asarray(ll_t), JDC.plan_to_device(plan),
                               jnp.float32(acwt), plan.rspec, plan.packed)
    ta, tcode = DC._emit_step(torch.from_numpy(alpha), torch.from_numpy(ll_t),
                              DC.plan_to_device(plan, "cpu"), acwt, plan.rspec, plan.packed)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    assert tcode.dtype == (torch.uint8 if plan.packed else torch.int16)
    np.testing.assert_array_equal(tcode.numpy(), np.asarray(jcode))


def test_viterbi_step_masks_like_jax_scan():
    """The wrapper's CPU path applies the num_frames mask and the
    alpha_at_end capture as one step of JAX ``viterbi_scan``."""
    plan, alpha, ll_t = _step_inputs(2)
    nf = np.array([0, 1, 2, 1, 5], np.int32)
    ae = np.full_like(alpha, DC.NEG_INF)
    acwt = float(np.float32(0.5))
    (ja, jae), jbps = JDC.viterbi_scan(
        JDC.plan_to_device(plan), jnp.asarray(alpha), jnp.asarray(ae),
        jnp.asarray(ll_t.T[:, None, :]), jnp.asarray(nf), jnp.int32(0), jnp.float32(acwt),
        jnp.float32(0.0), plan.rspec, plan.packed)
    bp = torch.empty(alpha.shape, dtype=torch.uint8 if plan.packed else torch.int16)
    ta, tae = DC.viterbi_step(torch.from_numpy(alpha), torch.from_numpy(ae),
                              torch.from_numpy(ll_t), DC.plan_to_device(plan, "cpu"),
                              torch.from_numpy(nf), 0, acwt, plan.rspec, plan.packed, bp)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tae.numpy(), np.asarray(jae), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbps)[0])


@pytest.mark.parametrize("with_bp", [True, False])
@pytest.mark.parametrize("t0", [0, 7])
def test_viterbi_window_matches_jax_scan(t0, with_bp):
    """``viterbi_scan`` without a beam (one ``viterbi_window``, its plain
    version on the CPU) against JAX ``viterbi_scan`` over a window of 6
    frames starting at ``t0``: lanes that end before, inside and after the
    window; alpha and alpha_at_end within 1e-6, equal backpointers."""
    plan, alpha, _ll = _step_inputs(3)
    w, b = 6, alpha.shape[1]
    ll = (np.random.default_rng(4).standard_normal((w, 20, b)) * 5 - 30).astype(np.float32)
    nf = np.array([0, t0 + 1, t0 + 3, t0 + 6, t0 + 9], np.int32)
    ae = np.where(np.random.default_rng(5).random(alpha.shape) < 0.5, alpha,
                  DC.NEG_INF).astype(np.float32)
    acwt = float(np.float32(1.0 / 13.0))
    (ja, jae), jbps = JDC.viterbi_scan(
        JDC.plan_to_device(plan), jnp.asarray(alpha), jnp.asarray(ae),
        jnp.asarray(ll.transpose(2, 0, 1)), jnp.asarray(nf), jnp.int32(t0), jnp.float32(acwt),
        jnp.float32(0.0), plan.rspec, plan.packed, with_bp=with_bp)
    (ta, tae), tbps = DC.viterbi_scan(DC.plan_to_device(plan, "cpu"), torch.from_numpy(alpha),
                                      torch.from_numpy(ae), torch.from_numpy(ll),
                                      torch.from_numpy(nf), t0, acwt, plan.rspec, plan.packed,
                                      with_bp=with_bp)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-6, atol=0)
    np.testing.assert_allclose(tae.numpy(), np.asarray(jae), rtol=1e-6, atol=0)
    if with_bp:
        np.testing.assert_array_equal(tbps.numpy(), np.asarray(jbps))
    else:
        assert tbps is None and jbps is None


@pytest.mark.parametrize("mode", ["keep", "recompute"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_best_path_matches_jax(seed, mode):
    rng = np.random.default_rng(seed)
    graph = _random_graph(rng)
    b, t, p = 3, 37, 7
    ll = rng.standard_normal((b, t, p)).astype(np.float32)
    nf = np.array([37, 20, 1], np.int32)
    plan = DC.build_emit_plan(graph, d=4)
    ref = JDC.decode_best_path(JV.DenseGraph(**graph._asdict()), plan,
                               JDC.plan_to_device(plan), jnp.asarray(ll), nf,
                               acoustic_scale=0.5)
    budget = {"keep": 1 << 40, "recompute": 1}[mode]  # recompute: 16-frame blocks
    got = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, "cpu"),
                              torch.from_numpy(ll), nf, acoustic_scale=0.5,
                              bp_bytes_budget=budget)
    for r, rr in zip(got, ref):
        assert r["words"] == rr["words"]
        assert np.isclose(r["score"], rr["score"], rtol=1e-5, atol=0)
        # distinct random weights: no exact ties, so the arcs agree too
        assert r["arcs"] == rr["arcs"] and r["tids"] == rr["tids"]


def test_bench_graph_paths_span_every_frame():
    """On the bench-style graph (every state final) every utterance's best
    path has exactly num_frames arcs, as bench.py asserts."""
    graph = _bench_graph(num_states=400, num_pdfs=30, seed=3)
    plan = DC.build_emit_plan(graph, d=8)
    nf = np.array([25, 11], np.int32)
    ll = np.random.default_rng(4).standard_normal((2, 25, 30)).astype(np.float32)
    got = DC.decode_best_path(graph, plan, DC.plan_to_device(plan, "cpu"),
                              torch.from_numpy(ll), nf, acoustic_scale=1.0 / 13.0)
    ref = JDC.decode_best_path(JV.DenseGraph(**graph._asdict()), plan,
                               JDC.plan_to_device(plan), jnp.asarray(ll), nf,
                               acoustic_scale=1.0 / 13.0)
    assert [len(r["arcs"]) for r in got] == [25, 11]
    for r, rr in zip(got, ref):
        assert np.isclose(r["score"], rr["score"], rtol=1e-5, atol=0)


def test_viterbi_step_rejects_other_devices():
    plan, alpha, ll_t = _step_inputs(0, b=2)
    meta = torch.empty(alpha.shape, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        DC.viterbi_step(meta, meta, ll_t, DC.plan_to_device(plan, "cpu"),
                        torch.zeros(2, dtype=torch.int32), 0, 1.0, plan.rspec, plan.packed)


def test_decode_rejects_loglikes_narrower_than_graph_pdfs():
    graph = _random_graph(np.random.default_rng(0))  # pdfs 0..6
    plan = DC.build_emit_plan(graph, d=4)
    with pytest.raises(ValueError, match="graph uses pdf 6"):
        DC.decode_best_path(graph, plan, DC.plan_to_device(plan, "cpu"),
                            torch.zeros((1, 3, 6)), np.array([3], np.int32), 0.5)


def _hub_graph(seed):
    """A graph whose hub state has hundreds of in-degree rows, so the
    backpointer codes need int16."""
    g = _bench_graph(num_states=300, num_pdfs=20, seed=seed)
    rng = np.random.default_rng(seed)
    extra = 400
    src = np.concatenate([g.arc_src, rng.integers(0, 300, extra).astype(np.int32)])
    dst = np.concatenate([g.arc_dst, np.full(extra, 7, np.int32)])
    pdf = np.concatenate([g.arc_pdf, rng.integers(0, 20, extra).astype(np.int32)])
    score = np.concatenate([g.arc_score, (-rng.exponential(1.0, extra)).astype(np.float32)])
    return g._replace(arc_src=src, arc_dst=dst, arc_pdf=pdf, arc_tid=pdf, arc_score=score,
                      arc_oseq=np.zeros_like(src))


@pytest.mark.parametrize("which", ["packed", "int16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_backtrace_scan_matches_jax(which, seed):
    """The backtrace's plain version (the ``backtrace_scan`` wrapper's CPU
    path) against JAX ``backtrace_scan`` on random backpointer codes, over
    two blocks walked in reverse with the state carried from one to the
    other: lanes that end before, inside and after each block.  Equal codes
    and states; the arcs are ``row_arc`` of the codes (-1 at pads and
    inactive frames)."""
    rng = np.random.default_rng(seed)
    graph = _bench_graph(num_states=300, num_pdfs=20, seed=seed) if which == "packed" \
        else _hub_graph(seed)
    plan = DC.build_emit_plan(graph, d=4)
    assert plan.packed == (which == "packed")
    b, w1, w2 = 7, 6, 5
    bps = random_codes(rng, plan, w1 + w2, b)
    nf = np.array([0, 1, 3, w1, w1 + 2, w1 + w2, w1 + w2 - 1], np.int32)
    end = rng.integers(0, plan.num_states, b).astype(np.int32)
    dev = DC.plan_to_device(plan, "cpu")
    jrow_start = jnp.asarray(plan.row_start)
    jrow_src = jnp.asarray(plan.row_src.reshape(-1))
    state_j, state_t = jnp.asarray(end), torch.from_numpy(end)
    row_arc = plan.row_arc.reshape(-1)
    for lo, hi in ((w1, w1 + w2), (0, w1)):
        codes_j, state_j = JDC.backtrace_scan(jrow_start, jrow_src, plan.d, jnp.asarray(bps[lo:hi]),
                                              state_j, jnp.asarray(nf), lo)
        codes_t, arcs_t, state_t = DC.backtrace_scan(dev, torch.from_numpy(bps[lo:hi]), state_t,
                                                     torch.from_numpy(nf), lo)
        assert codes_t.dtype == arcs_t.dtype == state_t.dtype == torch.int32
        np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
        np.testing.assert_array_equal(state_t.numpy(), np.asarray(state_j))
        codes = codes_t.numpy()
        np.testing.assert_array_equal(arcs_t.numpy(),
                                      np.where(codes >= 0, row_arc[np.maximum(codes, 0)], -1))
        active = (lo + np.arange(hi - lo))[:, None] < nf[None, :]
        assert ((codes >= 0) == active).all()


@pytest.mark.parametrize("variant", ["tree", "fused"])
@pytest.mark.parametrize("seed", [2, 3])
def test_decode_best_path_matches_jax_forward_shared(variant, seed):
    """The port's exact search (``viterbi_scan`` over the emit plan, the
    device backtrace) against the JAX package's arc-parallel searches over
    the same graph, ``viterbi_forward_shared`` (reduction tree) and
    ``viterbi_forward_shared_fused``, with ``backtrace_shared``: the same
    words, tids and arcs (distinct random weights: no ties), scores within
    rtol 1e-5, and alpha at each utterance's end within rtol 1e-6 (the same
    float32 sums, in another grouping)."""
    rng = np.random.default_rng(seed)
    graph = _random_graph(rng)
    jg = JV.DenseGraph(**graph._asdict())
    b, t, p = 4, 29, 7
    ll = rng.standard_normal((b, t, p)).astype(np.float32)
    nf = np.array([29, 13, 1, 0], np.int32)
    acwt = float(np.float32(0.5))
    if variant == "tree":
        levels = tuple(jnp.asarray(x) for x in
                       JV.build_reduction_plan(graph.arc_dst, graph.num_states, k=4).levels)
        alpha_end, bps = JV.viterbi_forward_shared(
            jnp.asarray(graph.arc_src), levels, jnp.asarray(graph.arc_pdf),
            jnp.asarray(graph.arc_score), jnp.asarray(graph.alpha0), jnp.asarray(ll),
            jnp.asarray(nf), np.float32(acwt), np.float32(1e9), graph.num_states)
    else:
        alpha_end, bps = JV.viterbi_forward_shared_fused(
            JV.build_fused_plan(jg, k=4), jnp.asarray(graph.alpha0), jnp.asarray(ll),
            jnp.asarray(nf), np.float32(acwt), np.float32(1e9), graph.num_states)
    ref = JV.backtrace_shared(jg, np.asarray(alpha_end), np.asarray(bps), nf)
    plan = DC.build_emit_plan(graph, d=4)
    dev = DC.plan_to_device(plan, "cpu")
    got = DC.decode_best_path(graph, plan, dev, torch.from_numpy(ll), nf, acoustic_scale=acwt)
    for r, rr in zip(got, ref):
        assert r["words"] == rr["words"] and r["tids"] == rr["tids"]
        assert r["arcs"] == rr["arcs"]
        if np.isfinite(rr["score"]):
            assert np.isclose(r["score"], rr["score"], rtol=1e-5, atol=0)
        else:
            assert r["score"] == rr["score"]
    s1 = plan.num_states + 1
    alpha0 = np.concatenate([graph.alpha0[plan.sperm[:-1]], [DC.NEG_INF]]).astype(np.float32)
    alpha = torch.from_numpy(alpha0)[:, None].expand(s1, b).contiguous()
    nf_t = torch.from_numpy(nf)
    (_, ae), _ = DC.viterbi_scan(dev, alpha, torch.where((nf_t == 0)[None, :], alpha, DC.NEG_INF),
                                 torch.from_numpy(ll.transpose(1, 2, 0).copy()), nf_t, 0, acwt,
                                 plan.rspec, plan.packed, with_bp=False)
    ae_graph = np.empty((b, graph.num_states), np.float32)
    ae_graph[:, plan.sperm[:-1]] = ae.numpy()[:-1].T
    np.testing.assert_allclose(ae_graph, np.asarray(alpha_end), rtol=1e-6, atol=0)
