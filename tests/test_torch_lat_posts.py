"""The port's batched lattice posteriors (``lat.lattice_posts_batch``, one
sweep over many lattices' arcs frame by frame) against the JAX package's
``lattice_to_post`` one lattice at a time: the same entries, in the same
order, to the last bit, on batches of random lattices of different lengths
(pruned and exact, with and without final costs, one whose arcs all tie,
one with no path) at several scales."""

from dataclasses import replace

import numpy as np
import pytest

from voicebridge_tpu.lat.lattice import Lattice, lattice_to_post
from voicebridge_tpu_torch.lat.lattice import lattice_posts_batch

from test_lat_determinize import make_lattice, random_graph


def _lattices(seeds, lbeam):
    lats = []
    for k, seed in enumerate(seeds):
        f, tid2pdf = random_graph(seed, ns=7, na=18)
        try:
            _g, _ll, lat = make_lattice(f, tid2pdf, t=8 + 5 * k, lbeam=lbeam, seed=seed)
        except Exception:
            continue  # a degenerate random graph
        lats.append(lat)
    if len(lats) < 3:
        pytest.skip("degenerate random graphs")
    return lats


def _want(lats, acwt, lms, min_post):
    """(lattice, frame, tid, pdf, post) rows of ``lattice_to_post`` on each."""
    rows = []
    for i, lat in enumerate(lats):
        if not lat.num_arcs:
            continue
        _ap, per_frame = lattice_to_post(lat, acoustic_scale=acwt, lm_scale=lms,
                                         min_post=min_post)
        rows += [(i, t, tid, pdf, p) for t, entries in enumerate(per_frame)
                 for tid, pdf, p in entries]
    return rows


def _same(lats, acwt=1.0, lms=1.0, min_post=1e-4):
    utt, t, tid, pdf, post = lattice_posts_batch(lats, acoustic_scale=acwt, lm_scale=lms,
                                                 min_post=min_post)
    want = _want(lats, acwt, lms, min_post)
    assert len(utt) == len(want) > 0
    for name, got, col in (("lattice", utt, 0), ("frame", t, 1), ("tid", tid, 2),
                           ("pdf", pdf, 3)):
        np.testing.assert_array_equal(got, [r[col] for r in want], err_msg=name)
    assert post.dtype == np.float64
    np.testing.assert_array_equal(post, [r[4] for r in want])


@pytest.mark.parametrize("first", [0, 10, 20])
@pytest.mark.parametrize("lbeam,acwt,lms", [(1e9, 1.0, 1.0), (3.0, 0.5, 1.0),
                                            (2.0, 0.1, 0.7)])
def test_batched_posteriors_are_lattice_to_posts(first, lbeam, acwt, lms):
    _same(_lattices(range(first, first + 6), lbeam), acwt, lms)


def test_ties_no_final_costs_and_a_lattice_without_a_path():
    lats = _lattices(range(30, 34), 1e9)
    a, b = lats[0], lats[1]
    lats[0] = replace(a, acoustic_cost=np.zeros_like(a.acoustic_cost), _states={})
    lats[1] = Lattice(b.graph, b.nf, b.arc_t, b.arc_id, b.acoustic_cost, False)
    cut = Lattice(a.graph, a.nf, a.arc_t[:-3], a.arc_id[:-3],
                  np.full(a.num_arcs - 3, np.inf, np.float32), a.use_final)
    empty = Lattice(a.graph, a.nf, a.arc_t[:0], a.arc_id[:0], a.acoustic_cost[:0],
                    a.use_final)
    _same([empty] + lats + [cut], min_post=0.01)
