"""The port's native lattice determinization (``lat/determinize.py`` over
``csrc/lat_determinize.cpp``) against the JAX package's Python subset
construction on the same lattices: the same states, arcs, weights,
transition-id strings and finals, in the same order, on random graphs
(pruned and exact, several scales, words in sequences of up to three,
lattices with and without final costs), and the same state-limit errors."""

import numpy as np
import pytest

from voicebridge_tpu.lat import determinize as JD
from voicebridge_tpu.lat.lattice import Lattice
from voicebridge_tpu_torch.lat import determinize as PD

from test_lat_determinize import make_lattice, random_graph
from test_lattice import tiny_graph


def _same(got, want):
    assert got.num_states == want.num_states
    for name in ("arc_src", "arc_dst", "arc_word", "arc_graph_cost", "arc_acoustic_cost"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.arc_tids == want.arc_tids
    assert list(got.finals.items()) == list(want.finals.items())


def _lattice(seed, frames, lbeam=1e9):
    f, tid2pdf = random_graph(seed, ns=7, na=18)
    try:
        _g, _ll, lat = make_lattice(f, tid2pdf, t=frames, lbeam=lbeam, seed=seed)
    except Exception:
        pytest.skip("degenerate random graph")
    return lat


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("beam,acwt", [(1e9, 1.0), (3.0, 1.0), (2.0, 0.1)])
def test_native_determinization_is_the_packages(seed, beam, acwt):
    lat = _lattice(seed, frames=12)
    _same(PD.determinize_lattice_pruned(lat, beam=beam, acoustic_scale=acwt),
          JD.determinize_lattice_pruned(lat, beam=beam, acoustic_scale=acwt))


@pytest.mark.parametrize("use_final", [True, False])
def test_word_sequences_and_final_costs(use_final):
    """Arcs that output two or three words (chains of word arcs), final
    words, and a lattice read with and without its final costs."""
    lat = _lattice(3, frames=10)
    g = lat.graph
    oseqs = [()] + [(w, 1 + w % 2) if w % 2 else (w, 2, w) for w in range(1, len(g.oseqs))]
    final_oseq = np.where(np.arange(g.num_states) % 2, 1, 0).astype(g.final_oseq.dtype)
    g = g._replace(oseqs=oseqs, final_oseq=final_oseq)
    lat = Lattice(g, lat.nf, lat.arc_t, lat.arc_id, lat.acoustic_cost, use_final)
    for beam in (1e9, 2.5):
        want = JD.determinize_lattice_pruned(lat, beam=beam, lm_scale=0.5, acoustic_scale=0.7)
        _same(PD.determinize_lattice_pruned(lat, beam=beam, lm_scale=0.5, acoustic_scale=0.7),
              want)
        assert want.num_arcs > 0


def test_a_lattice_with_no_path_and_the_state_limit():
    f, tid2pdf = tiny_graph()
    _g, _ll, lat = make_lattice(f, tid2pdf, t=6, seed=13)
    with pytest.raises(PD.DetStateLimitError):
        PD.determinize_lattice_pruned(lat, beam=1e9, max_states=2)
    cut = Lattice(lat.graph, lat.nf, lat.arc_t[:-3], lat.arc_id[:-3],
                  np.full(lat.num_arcs - 3, np.inf, np.float32), lat.use_final)
    want = JD.determinize_lattice_pruned_safe(lat, beam=4.0, max_states=3)
    for threads in (1, 3):
        got = PD.determinize_lattices([lat, cut, lat], beam=4.0, max_states=3, threads=threads)
        _same(got[0][0], want)
        _same(got[2][0], want)
        assert got[0][1] == got[2][1] > 0 and got[1][1] == 0
    with pytest.raises(PD.DetStateLimitError):
        PD.determinize_lattices([lat], beam=4.0, max_states=1, max_retries=1)
    _same(PD.determinize_lattice_pruned(cut), JD.determinize_lattice_pruned(cut))
    assert PD.determinize_lattice_pruned(cut).num_arcs == 0
