"""The port's lane-major lattice forward-backward (``ops/lattice.py``
``lattice_forward_backward``: its plain version on the CPU) against the JAX
package's ``lattice_forward_backward`` on the same inputs.

Inputs: the tiny cyclic graph of ``tests/test_lattice.py``, the random
graphs of ``tests/test_lat_determinize.py`` and a 200-state synthetic decode
graph with 4 lanes x 50 frames; exact search and a finite beam,
``max_active`` 0 and 3, windows of 4 frames and larger than T, lanes that end
early and one with no frame, a graph whose final states cannot be
reached (the partial-path fallback, ``use_final`` False), and a graph with
a hub state (40 more in- and out-arcs, out of source order) and states of
no in-arcs and of no out-arcs.

``lane_pieces``, the split of the kernels' CSR rows into pieces (hubs), is
checked against its definition.

Tolerances: the survivor masks and ``use_final`` equal; ``total_best`` and
``alpha_at_end`` within rtol 1e-5, atol 1e-4 (the JAX package adds the same
terms in the same order, but XLA may fuse them differently).  On the tiny
graph the port's mask is also held to the lattice-beam invariant by brute
force over every complete path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voicebridge_tpu.ops import lattice as JLAT
from voicebridge_tpu.ops import viterbi as JV

from voicebridge_tpu_torch.ops import lattice as LAT
from voicebridge_tpu_torch.ops.graph import DenseGraph
from voicebridge_tpu_torch.testing import synth_decode_graph, synth_hub_graph

from test_lat_determinize import random_graph
from test_lattice import enumerate_paths, tiny_graph

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-4)


def _run_both(jg, ll, nf, acwt, beam, lbeam, max_active, window, k=None):
    kw = {} if k is None else dict(k=k)
    levels = JV.build_reduction_plan(jg.arc_dst, jg.num_states, **kw).levels
    rev = JLAT.build_src_plan(jg, **kw)
    want = JLAT.lattice_forward_backward(jg, levels, rev, jnp.asarray(ll), nf,
                                         acoustic_scale=acwt, beam=beam, lattice_beam=lbeam,
                                         max_active=max_active, window=window)
    g = DenseGraph(**jg._asdict())
    got = LAT.lattice_forward_backward(g, LAT.build_dst_plan(g), LAT.build_src_plan(g),
                                       torch.from_numpy(ll), nf, acwt, beam, lbeam,
                                       max_active=max_active, window=window)
    return got, want


def _assert_same(got, want):
    mask, best, at_end, use_final = got
    assert mask.dtype == bool and mask.shape == want[0].shape
    np.testing.assert_array_equal(mask, want[0])
    np.testing.assert_array_equal(use_final, want[3])
    np.testing.assert_allclose(best, want[1], **TOL)
    np.testing.assert_allclose(at_end, want[2], **TOL)


def test_tiny_graph_matches_jax_and_the_beam_invariant():
    """``tests/test_lattice.py``'s tiny graph, 2 lanes (7 and 5 frames),
    window 4, lattice beam 4: JAX's results, and the survivors are exactly
    the arc instances on complete paths within the beam of the best."""
    f, tid2pdf = tiny_graph()
    jg = JV.compile_dense_graph(f, tid2pdf)
    rng = np.random.default_rng(42)
    t, p = 7, 3
    ll = rng.normal(size=(2, t, p)).astype(np.float32) * 2.0
    nf = np.asarray([t, t - 2], np.int32)
    got, want = _run_both(jg, ll, nf, 1.0, 1e9, 4.0, 0, 4, k=4)
    _assert_same(got, want)
    mask, best = got[0], got[1]
    for i in range(2):
        paths = enumerate_paths(jg, int(nf[i]), ll[i], 1.0)
        top = max(sc for sc, _a, _w in paths)
        expect = {(tt, a) for sc, arcs, _w in paths if sc >= top - 4.0 - 1e-4
                  for tt, a in enumerate(arcs)}
        tt, aa = np.nonzero(mask[:, i])
        assert set(zip(tt.tolist(), aa.tolist())) == expect
        assert abs(best[i] - top) < 1e-3


@pytest.mark.parametrize("lbeam", [1e9, 1.5])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_graphs_match_jax(seed, lbeam):
    """``tests/test_lat_determinize.py``'s random graphs, 6 frames."""
    f, tid2pdf = random_graph(seed)
    jg = JV.compile_dense_graph(f, tid2pdf)
    ll = np.random.default_rng(seed + 100).normal(
        size=(1, 6, int(tid2pdf.max()) + 1)).astype(np.float32)
    got, want = _run_both(jg, ll, np.asarray([6], np.int32), 1.0, 1e9, lbeam, 0, 4, k=4)
    _assert_same(got, want)


def _synth_inputs(finals: bool = True):
    g = synth_decode_graph(200, arcs_per_state=8, num_pdfs=20, seed=3)
    if not finals:
        g = g._replace(final_score=np.full(g.num_states, JV.NEG_INF, np.float32))
    ll = (np.random.default_rng(0).standard_normal((4, 50, 20)) * 3 - 10).astype(np.float32)
    return JV.DenseGraph(**g._asdict()), ll, np.asarray([50, 37, 0, 50], np.int32)


@pytest.mark.parametrize("window", [4, 64])
@pytest.mark.parametrize("max_active", [0, 3])
@pytest.mark.parametrize("beam", [1e9, 13.0])
def test_synth_graph_matches_jax(beam, max_active, window):
    """200 states x 8 arcs, 4 lanes of 50, 37, 0 and 50 frames, acoustic
    scale 1/13, lattice beam 6."""
    jg, ll, nf = _synth_inputs()
    got, want = _run_both(jg, ll, nf, 1.0 / 13.0, beam, 6.0, max_active, window)
    _assert_same(got, want)
    assert got[0][:, 2].sum() == 0  # the empty lane has no survivor
    assert got[0][37:, 1].sum() == 0


def test_unreachable_finals_use_the_partial_path():
    """No final state: ``use_final`` False, the best partial path's score as
    total_best, every state final with cost 0 in the backward pass."""
    jg, ll, nf = _synth_inputs(finals=False)
    got, want = _run_both(jg, ll, nf, 1.0 / 13.0, 1e9, 6.0, 0, 16)
    _assert_same(got, want)
    assert not got[3].any()
    assert got[0].any()


@pytest.mark.parametrize("beam,max_active", [(1e9, 0), (13.0, 9)])
def test_hub_and_no_arc_graph_matches_jax(beam, max_active):
    """``synth_hub_graph(120, 40)``: a hub of 40 extra in- and out-arcs
    appended out of source order, states with no in-arcs and with no
    out-arcs; 3 lanes of 20, 13 and 20 frames, window 8."""
    g = synth_hub_graph(120, 40)
    jg = JV.DenseGraph(**g._asdict())
    ll = (np.random.default_rng(5).standard_normal((3, 20, 20)) * 3 - 10).astype(np.float32)
    got, want = _run_both(jg, ll, np.asarray([20, 13, 20], np.int32), 1.0 / 13.0, beam, 6.0,
                          max_active, 8)
    _assert_same(got, want)
    assert got[0].any()


@pytest.mark.parametrize("a", [1, 8, 13, 64])
def test_packbits_plain_matches_numpy(a):
    keep = np.random.default_rng(a).random((3, 2, a)) < 0.4
    got = LAT.packbits_plain(torch.from_numpy(keep)).numpy()
    np.testing.assert_array_equal(got, np.packbits(keep, axis=-1))
    np.testing.assert_array_equal(np.unpackbits(got, axis=-1, count=a).astype(bool), keep)


def test_csr_plans_group_arcs_in_order():
    """``build_dst_plan`` / ``build_src_plan`` list each state's arcs in arc
    order, the states in order."""
    g = synth_decode_graph(50, arcs_per_state=4, num_pdfs=5, seed=1)
    for plan, key in ((LAT.build_dst_plan(g), g.arc_dst), (LAT.build_src_plan(g), g.arc_src)):
        assert plan.start[0] == 0 and plan.start[-1] == g.num_arcs
        for s in range(g.num_states):
            arcs = plan.arc[plan.start[s]:plan.start[s + 1]]
            np.testing.assert_array_equal(arcs, np.flatnonzero(key == s))


def test_lane_pieces_cover_each_row():
    """``lane_pieces``: every state's CSR row is covered, in order, by pieces
    of at most ``size`` entries (an empty piece for a state of no arcs), and
    exactly the states of more than ``size`` entries are hubs, each with its
    slot on all of its pieces."""
    g = synth_hub_graph(120, 40)
    size = 16
    for plan in (LAT.build_dst_plan(g), LAT.build_src_plan(g)):
        piece, hubs = LAT.lane_pieces(plan.start, size)
        assert piece.dtype == np.int32 and piece.shape[1] == 4
        deg = np.diff(plan.start)
        np.testing.assert_array_equal(hubs, np.flatnonzero(deg > size))
        for s in range(g.num_states):
            rows = piece[piece[:, 0] == s]
            assert len(rows) == max(1, -(-deg[s] // size))
            np.testing.assert_array_equal(rows[:, 1], plan.start[s] + size * np.arange(len(rows)))
            np.testing.assert_array_equal(rows[:, 2], np.minimum(rows[:, 1] + size,
                                                                 plan.start[s + 1]))
            slot = np.flatnonzero(hubs == s)
            assert (rows[:, 3] == (slot[0] if len(slot) else -1)).all()
        assert (np.diff(piece[:, 0]) >= 0).all()

