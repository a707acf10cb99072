"""The port's multi-device statistics (``voicebridge_tpu_torch/parallel/``
and the ``mesh=`` branches) against the JAX package's, on the CPU.

Ranks are fresh interpreters started with the ``spawn`` method, one
``gloo`` group per world size (1, 2, 4, 8) rendezvousing through a
``file://`` store under the test's temporary directory (no TCP port: the
suite runs on several workers at once).  A module fixture starts each world
once; every rank runs all the cases of ``torch_parallel_worker.py`` (which
imports only the port) on the same global inputs, the JAX package's
``tests/test_parallel.py`` setup, and saves numpy results.  A world that has
not finished within ``JOIN_S`` is killed and fails its tests.

Tolerances.  Against the JAX package (unsharded, or its one-device mesh):
the JAX tests' own, ``occ``/``tstats`` rtol 1e-5 atol 1e-4, ``macc`` 1e-4 /
1e-3, ``ll`` relative 1e-2, ``alpha_end`` 1e-4 / 1e-3, LDA 1e-5 / 1e-4,
MLLT and fMLLR 1e-4 / 1e-3, tree statistics as ``test_parallel.py``.
Against the port's own world size 1 and unsharded functions, tighter: the
statistics the port sums in float64 (transition counts, LDA, MLLT, fMLLR
and tree statistics) within rtol 1e-9, K6's sums (float32 segment sums in
its plain version) within rtol 1e-5, alignments, K3's scores and codes bit
for bit, the banded ``alpha_end`` under the band plan's permutation.
"""

import multiprocessing as mp
import os
import pickle
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_parallel_worker as W

from voicebridge_tpu_torch.ops import align_band as AB
from voicebridge_tpu_torch.ops import decode_core as DC
from voicebridge_tpu_torch.ops import gmm_kernels as K
from voicebridge_tpu_torch.ops import viterbi as V
from voicebridge_tpu_torch.transforms import fmllr as TFM
from voicebridge_tpu_torch.transforms import lda as TL
from voicebridge_tpu_torch.transforms import mllt as TM

torch.set_num_threads(2)
WORLDS = (1, 2, 4, 8)
JOIN_S = 120.0
TIGHT = dict(rtol=1e-9, atol=0.0)
BLAS_THREADS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def run_world(n: int, tmp, join_s: float = JOIN_S, ranks=None) -> list:
    """Start ``n`` ranks (or only ``ranks``) with ``spawn``, wait at most
    ``join_s`` seconds for all, kill what is left and fail; returns each
    rank's result dict."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=W.main, args=(r, n, str(tmp / "store"), str(tmp)), daemon=True)
             for r in (range(n) if ranks is None else ranks)]
    # one BLAS thread a rank: the ranks share the cores with each other and the other workers
    saved = {k: os.environ.get(k) for k in BLAS_THREADS}
    os.environ.update(dict.fromkeys(BLAS_THREADS, "1"))
    try:
        for p in procs:
            p.start()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    deadline = time.monotonic() + join_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        raise RuntimeError(f"world size {n}: {len(hung)} rank(s) did not finish in {join_s} s")
    out = []
    for r, p in zip(range(n), procs):
        path = tmp / f"rank{r}.pkl"
        if not path.exists():
            raise RuntimeError(f"world size {n}: rank {r} exited with {p.exitcode} and wrote "
                               "no result")
        with open(path, "rb") as f:
            res = pickle.load(f)
        if "error" in res:
            raise RuntimeError(f"world size {n}, rank {r}:\n{res['error']}")
        out.append(res)
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {n: run_world(n, tmp_path_factory.mktemp(f"world{n}")) for n in WORLDS}


@pytest.fixture(scope="module")
def setup():
    return W.build_setup()


@pytest.fixture(scope="module")
def jax_setup(setup):
    """The JAX package's objects for the same setup (its own host modules),
    with the arrays checked equal to the port's."""
    from voicebridge_tpu.config import LangOptions
    from voicebridge_tpu.data.lang import prepare_lang
    from voicebridge_tpu.fst.hclg import TrainingGraphCompiler
    from voicebridge_tpu.models.gmm import AmDiagGmm
    from voicebridge_tpu.models.transition import TransitionModel
    from voicebridge_tpu.ops import viterbi as JV
    from voicebridge_tpu.steps.train_mono import make_mono_tree

    lang = prepare_lang(W.LEXICON, ["SIL"], "SIL", LangOptions())
    tree = make_mono_tree(lang)
    tm = TransitionModel(lang.topo, tree)
    am = AmDiagGmm.flat_start(tree.num_pdfs, np.random.default_rng(0).standard_normal(W.DIM),
                              np.ones(W.DIM))
    compiler = TrainingGraphCompiler(lang, tree, tm)
    graphs = [JV.compile_dense_graph(f, tm.tid2pdf)
              for f in compiler.compile_batch(setup["transcripts"])]
    padded = JV.pad_graphs(graphs)
    for key in ("arc_src", "arc_pdf", "arc_score", "alpha0"):
        np.testing.assert_array_equal(padded[key], setup["padded"][key])
    np.testing.assert_array_equal(am.means(), setup["am"].means())
    return dict(am=am, tm=tm, tree=tree, graphs=graphs, padded=padded)


def _jax_estep(setup, js, banded: bool):
    from voicebridge_tpu.ops import align_band as JAB
    from voicebridge_tpu.ops import gmm_kernels as JK
    from voicebridge_tpu.parallel import mesh as JM

    mesh = JM.make_mesh(num_data=1)
    params = JM.replicate(mesh, JK.pack_gmm(js["am"]))
    data = JM.shard_batch(mesh, dict(feats=setup["feats"], nf=setup["nf"], tids=setup["tids"],
                                     pdf_ids=setup["pdf_ids"], weights=setup["weights"]))
    args = (data["feats"], data["nf"], data["tids"], data["pdf_ids"], data["weights"],
            jnp.float32(0.1))
    if banded:
        band = JAB.build_band_plan(js["graphs"])
        step = JM.em_estep_sharded_banded(mesh, js["tree"].num_pdfs,
                                          js["tm"].num_transition_ids, band.offsets)
        res = step(params, band.W, band.pdf, band.alpha0, *args)
    else:
        p = js["padded"]
        step = JM.em_estep_sharded(mesh, p["num_states"], js["tree"].num_pdfs,
                                   js["tm"].num_transition_ids)
        res = step(params, p["arc_src"], p["levels"], p["arc_pdf"], p["arc_score"],
                   p["alpha0"], *args)
    return [np.asarray(x) for x in res]


@pytest.fixture(scope="module")
def jax_ref(setup, jax_setup):
    from voicebridge_tpu.ops import gmm_kernels as JK
    from voicebridge_tpu.transforms.fmllr import acc_fmllr_stats
    from voicebridge_tpu.transforms.lda import acc_lda_stats
    from voicebridge_tpu.transforms.mllt import acc_mllt_stats

    am = jax_setup["am"]
    params = JK.pack_gmm(am)
    x, pdfs, w = _flat(setup)
    num_pdfs = jax_setup["tree"].num_pdfs
    means, ivars = jnp.asarray(am.means()), jnp.asarray(am.inv_vars)
    return dict(
        estep=_jax_estep(setup, jax_setup, False),
        estep_banded=_jax_estep(setup, jax_setup, True),
        lda=[np.asarray(a) for a in acc_lda_stats(jnp.asarray(x), jnp.asarray(pdfs),
                                                  jnp.asarray(setup["w_lda"]), num_pdfs)],
        mllt=[np.asarray(a) for a in acc_mllt_stats(params, means, ivars, x, pdfs, w)],
        fmllr=[np.asarray(a) for a in acc_fmllr_stats(params, means, ivars, x, pdfs, w,
                                                      setup["spk"], W.NUM_SPK)])


def _flat(setup):
    return (setup["feats"].reshape(-1, W.DIM), setup["pdf_ids"].reshape(-1),
            setup["weights"].reshape(-1))


@pytest.fixture(scope="module")
def port_ref(setup):
    """The port's unsharded functions on the CPU."""
    x, pdfs, w = _flat(setup)
    p = setup["padded"]
    params = K.pack_gmm(setup["am"], "cpu")
    ll = K.loglikes_batch(params, torch.from_numpy(setup["feats"]))
    alpha_end, bps = V.viterbi_forward_batched(
        p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"], p["alpha0"], ll,
        setup["nf"], 0.1, 1e9, p["num_states"])
    band = AB.build_band_plan(setup["graphs"])
    ae_b, bps_b = AB.viterbi_forward_banded(
        torch.from_numpy(band.W), torch.from_numpy(band.pdf), torch.from_numpy(band.alpha0),
        ll, torch.from_numpy(setup["nf"]), 0.1, tuple(band.offsets))
    tflat = torch.from_numpy(setup["tids"].reshape(-1))
    wt = torch.from_numpy(w)
    sums = K.acc_gmm_stats_sums(params, x, x, pdfs, setup["tree"].num_pdfs, w)
    num_pdfs = setup["tree"].num_pdfs
    means, ivars = setup["am"].means(), setup["am"].inv_vars
    mllt = TM._mllt_chunk(params, torch.from_numpy(means).float(), torch.from_numpy(ivars).float(),
                          torch.from_numpy(x), torch.from_numpy(pdfs).long(), wt)
    d = W.decode_inputs()
    (a, ae), dbps = DC.viterbi_scan(
        DC.plan_to_device(d["plan"], "cpu"), torch.from_numpy(d["alpha"]),
        torch.from_numpy(d["alpha_end"]), torch.from_numpy(d["ll"]).permute(1, 2, 0).contiguous(),
        torch.from_numpy(d["nf"]), 0, d["acwt"], d["plan"].rspec, d["plan"].packed)
    return dict(
        alpha_end=alpha_end.numpy(), bps=bps.numpy(), band=band, ae_b=ae_b.numpy(),
        bps_b=bps_b.numpy(),
        stats=[s.numpy() for s in sums[:3]] + [
            K.transition_sums(tflat, setup["tm"].num_transition_ids, wt).numpy(),
            sums[3].numpy()],
        lda=[s.numpy() for s in TL.lda_sums(torch.from_numpy(x), pdfs, setup["w_lda"],
                                            num_pdfs)],
        lda32=[s.numpy() for s in TL.acc_lda_stats(torch.from_numpy(x), pdfs, setup["w_lda"],
                                                   num_pdfs)],
        mllt=[s.numpy() for s in mllt],
        mllt32=TM.acc_mllt_stats(params, means, ivars, x, pdfs, w, chunk=64),
        fmllr=[s.numpy() for s in TFM.fmllr_sums(params, means, ivars, x, pdfs, w,
                                                 setup["spk"], W.NUM_SPK)],
        fmllr32=[s.numpy() for s in TFM.acc_fmllr_stats(params, means, ivars, x, pdfs, w,
                                                        setup["spk"], W.NUM_SPK,
                                                        device="cpu")],
        decode=(a.numpy(), ae.numpy(), dbps.numpy()))


def _stats_vs_jax(got, ref):
    occ, macc, _vacc, tstats, ll = got
    np.testing.assert_allclose(occ.astype(np.float32), ref[2], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(macc.astype(np.float32), ref[3], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(tstats.astype(np.float32), ref[5], rtol=1e-5, atol=1e-4)
    assert abs(float(ll) - float(ref[6])) < 1e-2 * max(abs(float(ref[6])), 1)


def _stats_vs_port(got, ref):
    for g, r in zip(got[:3], ref[:3]):  # K6's sums
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[3], ref[3], **TIGHT)  # float64 transition counts
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-5)


@pytest.mark.parametrize("n", WORLDS)
def test_estep_generic(worlds, jax_ref, port_ref, n):
    """The sharded generic E-step: statistics against JAX and the port's
    unsharded sums, alignments and alpha_end bit for bit against the
    unsharded aligner and world size 1."""
    got = worlds[n][0]["estep"]
    ref = jax_ref["estep"]
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-4, atol=1e-3)
    _stats_vs_jax(got[2:], ref)
    np.testing.assert_array_equal(got[0], port_ref["alpha_end"])
    np.testing.assert_array_equal(got[1], port_ref["bps"])
    _stats_vs_port(got[2:], port_ref["stats"])
    one = worlds[1][0]["estep"]
    np.testing.assert_allclose(got[5], one[5], **TIGHT)


@pytest.mark.parametrize("n", WORLDS)
def test_estep_banded(worlds, jax_ref, port_ref, setup, n):
    """The sharded banded E-step (K4's plain version here): statistics as
    the generic one's; alpha_end equal to the generic alpha_end under the
    band plan's state permutation; band slots equal to the unsharded K4's."""
    got = worlds[n][0]["estep_banded"]
    _stats_vs_jax(got[2:], jax_ref["estep_banded"])
    _stats_vs_port(got[2:], port_ref["stats"])
    band = port_ref["band"]
    for i, g in enumerate(setup["graphs"]):
        n2o = band.n2o[i, : g.num_states]
        np.testing.assert_allclose(got[0][i, : g.num_states], jax_ref["estep"][0][i, n2o],
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_array_equal(got[0][i, : g.num_states],
                                      port_ref["alpha_end"][i, n2o])
    np.testing.assert_array_equal(got[0], port_ref["ae_b"])
    np.testing.assert_array_equal(got[1], port_ref["bps_b"])


@pytest.mark.parametrize("n", WORLDS)
def test_lda_stats(worlds, jax_ref, port_ref, n):
    """``acc_lda_stats_sharded`` and ``acc_lda_stats(mesh=)``."""
    got = worlds[n][0]["lda"]
    for g, j, p, one in zip(got, jax_ref["lda"], port_ref["lda"], worlds[1][0]["lda"]):
        np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(g, p, **TIGHT)
        np.testing.assert_allclose(g, one, **TIGHT)
    for g, p in zip(worlds[n][0]["lda_mesh"], port_ref["lda32"]):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, p, **TIGHT)


@pytest.mark.parametrize("n", WORLDS)
def test_mllt_stats(worlds, jax_ref, port_ref, n):
    """``acc_mllt_stats_sharded`` and ``acc_mllt_stats(mesh=)`` (chunks of 64
    frames, padded to the data axis)."""
    g, beta = worlds[n][0]["mllt"]
    np.testing.assert_allclose(g, np.asarray(jax_ref["mllt"][0]), rtol=1e-4, atol=1e-3)
    assert abs(float(beta) - float(jax_ref["mllt"][1])) < 1e-3 * max(abs(float(beta)), 1)
    np.testing.assert_allclose(g, port_ref["mllt"][0], **TIGHT)
    np.testing.assert_allclose(beta, port_ref["mllt"][1], **TIGHT)
    np.testing.assert_allclose(g, worlds[1][0]["mllt"][0], **TIGHT)
    g32, beta32 = worlds[n][0]["mllt_mesh"]
    np.testing.assert_allclose(g32, port_ref["mllt32"][0].numpy(), **TIGHT)
    assert beta32 == pytest.approx(port_ref["mllt32"][1], rel=1e-9)


@pytest.mark.parametrize("n", WORLDS)
def test_fmllr_stats(worlds, jax_ref, port_ref, n):
    """``acc_fmllr_stats_sharded`` over speaker-major rows and
    ``acc_fmllr_stats(mesh=)`` over 3 speakers, reduced in float64."""
    for g, j, p, one in zip(worlds[n][0]["fmllr"], jax_ref["fmllr"], port_ref["fmllr"],
                            worlds[1][0]["fmllr"]):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(g, p, **TIGHT)
        np.testing.assert_allclose(g, one, **TIGHT)
    for g, p in zip(worlds[n][0]["fmllr_mesh"], port_ref["fmllr32"]):
        np.testing.assert_allclose(g, p, **TIGHT)


@pytest.mark.parametrize("n", WORLDS)
def test_tree_stats(worlds, setup, jax_setup, n):
    """``acc_tree_stats(mesh=)`` against the JAX package's and the port's
    unsharded statistics."""
    from voicebridge_tpu.models.treebuild import acc_tree_stats as jax_tree
    from voicebridge_tpu_torch.models.treebuild import acc_tree_stats

    feats_by_utt = {f"u{i}": setup["feats"][i] for i in range(W.B)}
    alis = {f"u{i}": list(setup["tids"][i]) for i in range(W.B)}
    ref = jax_tree(alis, feats_by_utt, jax_setup["tm"])
    own = acc_tree_stats(alis, feats_by_utt, setup["tm"])
    got = worlds[n][0]["tree_mesh"]
    assert ref and set(got) == set(ref) == set(own)
    for key, st in ref.items():
        count, sx, sx2 = got[key]
        np.testing.assert_allclose(count, st.count, rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(sx, st.sum_x, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(sx2, st.sum_x2, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(count, own[key].count, **TIGHT)
        np.testing.assert_allclose(sx, own[key].sum_x, **TIGHT)
        np.testing.assert_allclose(sx2, own[key].sum_x2, **TIGHT)


@pytest.mark.parametrize("n", WORLDS)
def test_decode_forward(worlds, port_ref, n):
    """``decode_forward_sharded``: each rank's lanes through K3's plain
    version, joined, equal to the unsharded ``viterbi_scan`` and to the JAX
    package's scan (scores within 1e-6, codes equal)."""
    from voicebridge_tpu.ops import decode_core as JDC

    d = W.decode_inputs()
    (ja, jae), jbps = JDC.viterbi_scan(
        JDC.plan_to_device(d["plan"]), jnp.asarray(d["alpha"]), jnp.asarray(d["alpha_end"]),
        jnp.asarray(d["ll"]), jnp.asarray(d["nf"]), jnp.int32(0), jnp.float32(d["acwt"]),
        jnp.float32(0.0), d["plan"].rspec, d["plan"].packed, False)
    a, ae, bps = worlds[n][0]["decode"]
    for g, r in zip((a, ae, bps), port_ref["decode"]):
        np.testing.assert_array_equal(g, r)
    np.testing.assert_allclose(a, np.asarray(ja), rtol=1e-6, atol=0)
    np.testing.assert_allclose(ae, np.asarray(jae), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(bps, np.asarray(jbps))


@pytest.mark.parametrize("n", WORLDS)
def test_pad_to_mesh(worlds, setup, n):
    from voicebridge_tpu.parallel import mesh as JM

    x, pdfs, _ = _flat(setup)
    ref = JM.pad_to_mesh(JM.make_mesh(num_data=n), x[:13], pdfs[:13])
    for g, r in zip(worlds[n][0]["pad_to_mesh"], ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("n", WORLDS)
def test_bucket_and_stream(worlds, tmp_path, n):
    """``host_shard`` (rank and world size from the group),
    ``bucket_by_length`` and ``stream_batches`` (padded to the world size)
    give the JAX package's shards and batches."""
    from voicebridge_tpu.parallel.data import bucket_by_length, host_shard, stream_batches
    from voicebridge_tpu.utils.io import write_archive

    rng = np.random.default_rng(1)
    data = {f"u{i}": rng.standard_normal((int(rng.integers(5, 40)), 13)).astype(np.float32)
            for i in range(30)}
    nf = {u: v.shape[0] for u, v in data.items()}
    ref_stream = list(stream_batches(write_archive(tmp_path / "f", data), nf, batch_size=8,
                                     pad_multiple=n))
    ref_bucket = bucket_by_length(nf, batch_size=8, max_pad_ratio=0.2)
    for r, res in enumerate(worlds[n]):
        assert res["host_shard"] == host_shard(sorted(data), r, n)
        assert res["bucket"] == ref_bucket
        assert len(res["stream"]) == len(ref_stream)
        for (u, f, k), (ru, rf, rk) in zip(res["stream"], ref_stream):
            assert u == ru
            np.testing.assert_array_equal(f, rf)
            np.testing.assert_array_equal(k, rk)
    shards = [u for res in worlds[n] for u in res["host_shard"]]
    assert sorted(shards) == sorted(data)
    dev, feats = worlds[n][0]["global_batch"]["feats"]  # the process's own arrays, on its device
    assert dev == "cpu"
    np.testing.assert_array_equal(feats, W.build_setup()["feats"][:2])


@pytest.mark.parametrize("n", WORLDS)
def test_train_lda_mllt_mesh(worlds, setup, n):
    """A short tri2b run (LDA to 8 dims, one MLLT update, tree statistics)
    with ``mesh=`` gives the transforms of ``mesh=None``, row by row up to
    the sign: an eigenvector's sign is arbitrary, and the ranks' BLAS (one
    thread) and this process's may pick either."""
    from voicebridge_tpu_torch.config import LdaOptions, TriTrainOptions
    from voicebridge_tpu_torch.steps.train_lda_mllt import train_lda_mllt

    li = W.lda_mllt_inputs(setup)
    topts = TriTrainOptions(num_iters=2, mllt_iters=(1,), realign_iters=(), num_leaves=20,
                            totgauss=40, max_iter_inc=1)
    _, ref = train_lda_mllt(li["base"], li["transcripts"], li["alignments"], setup["lang"],
                            topts, LdaOptions(dim=8), prev_trans_model=setup["tm"],
                            device="cpu")
    got = worlds[n][0]["train_lda_mllt"]
    sign = np.where(np.sum(got * ref, axis=1) < 0, -1.0, 1.0)[:, None]
    np.testing.assert_allclose(got * sign, ref, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n", WORLDS)
def test_ranks_agree(worlds, n):
    """Every rank returns the same reduced statistics and joined blocks."""
    keys = ("estep", "estep_banded", "lda", "mllt", "fmllr", "lda_mesh", "fmllr_mesh",
            "decode", "train_lda_mllt")
    for res in worlds[n][1:]:
        for key in keys:
            a, b = res[key], worlds[n][0][key]
            for x, y in zip(a if isinstance(a, (tuple, list)) else [a],
                            b if isinstance(b, (tuple, list)) else [b]):
                np.testing.assert_array_equal(x, y, err_msg=key)


def test_a_missing_rank_fails_within_the_join_limit(tmp_path):
    """A world whose second rank never starts does not hang the suite: the
    first rank waits in the rendezvous, is killed at the join limit, and the
    run fails."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="did not finish"):
        run_world(2, tmp_path, join_s=6.0, ranks=[0])
    assert time.monotonic() - t0 < 30
