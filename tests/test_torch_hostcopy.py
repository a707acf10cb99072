"""The port's own numpy host modules against the JAX package's: the same
inputs give identical arrays, files written by one package load in the
other, ``convert`` builds the port's objects from the JAX package's arrays,
and the native WFST library (built at first use) gives the FSTs of the
pure-Python implementations."""

import importlib
import json

import numpy as np
import pytest

from voicebridge_tpu_torch import convert

from synth import LEXICON

HOST_MODULES = [
    "config", "utils.logging", "utils.text", "utils.health", "utils.io", "utils.checkpoint",
    "models.topology", "models.transition", "models.tree", "models.gmm", "fst.core",
    "fst.compose", "fst.context", "fst.determinize", "fst.epsilon", "fst.hmm_graph",
    "fst.lexicon", "fst.minimize", "fst.push", "fst.shortest", "fst.misc", "fst.hclg",
    "fst.native_bridge", "data.lang", "lm.arpa", "lm.ngram", "steps.score", "steps.mbr",
    "models.treebuild", "utils.wave", "data.prepare", "data.dict", "g2p.joint",
    "lat.word_align", "steps.diagnostic", "testing.corpus", "testing.synthesis",
    "utils.profiling", "ops.pitch", "steps.get_prons", "lm.interp", "transforms.basis_fmllr",
]
# modules of which the port copies the host half (numpy) and ports the rest
HOST_HALVES = {
    "models.full_gmm": ["M_LOG_2PI", "FullGmm"],
    "transforms.regtree": ["RegressionTree", "build_regression_tree",
                           "choose_regression_classes", "_pool_by_class",
                           "estimate_regtree_fmllr", "estimate_regtree_mllr",
                           "apply_regtree_mllr"],
    "transforms.cmvn": ["acc_cmvn_stats", "fake_cmvn_stats", "acc_cmvn_stats_two_channel",
                        "utterance_pairs", "modify_cmvn_stats"],
}

SENTENCES = [["YES", "NO", "YES"], ["NO", "NO"], ["YES"], ["NO", "YES", "YES", "NO"]]


def _both(name: str):
    return (importlib.import_module("voicebridge_tpu_torch." + name),
            importlib.import_module("voicebridge_tpu." + name))


def _fst_arrays(f):
    return (*f.to_arrays(), np.asarray(f.finals, np.float64), np.asarray([f.start]))


def _assert_same_fst(got, want, weight_atol=0.0):
    """States, arcs and labels identical; weights identical too unless
    ``weight_atol`` allows for float32 against float64 arithmetic."""
    for a, b in zip(_fst_arrays(got), _fst_arrays(want)):
        if weight_atol and a.dtype.kind == "f":
            np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
            np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=0,
                                       atol=weight_atol)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", HOST_MODULES)
def test_host_module_is_a_copy_with_the_same_names(name):
    """Every copied module offers the public names of its counterpart."""
    port, jax_mod = _both(name)
    assert port.__file__ != jax_mod.__file__
    public = {n for n in vars(jax_mod) if not n.startswith("_")}
    if name == "fst.hclg":  # the port always takes the native library
        public -= {"remove_eps_local"}
    if name == "fst.native_bridge":  # built at first use (``_build``) or raises
        public -= {"available", "Path", "subprocess"}
    if name == "utils.profiling":  # the port's StageTimer writes no file of its own
        public -= {"json"}
    assert public <= set(vars(port))


@pytest.mark.parametrize("name", sorted(HOST_HALVES))
def test_host_half_is_a_copy(name):
    """The numpy half of a partly ported module: the same names, and the
    same source text apart from the package's own docstrings."""
    import inspect

    port, jax_mod = _both(name)
    for attr in HOST_HALVES[name]:
        a, b = getattr(port, attr), getattr(jax_mod, attr)
        if callable(a):
            assert inspect.getsource(a) == inspect.getsource(b), attr
        else:
            assert a == b, attr


def test_npz_files_are_interchangeable(tmp_path):
    """``FullGmm`` and ``FmllrBasis`` written by one package load in the
    other to the same arrays."""
    rng = np.random.default_rng(6)
    p, m, d = 2, 3, 4
    a = rng.standard_normal((p, m, d, d))
    args = (rng.random((p, m)) + 0.1, rng.standard_normal((p, m, d)),
            np.einsum("pmde,pmfe->pmdf", a, a) + np.eye(d))
    basis = (rng.standard_normal((5, d, d + 1)), rng.standard_normal((d, d + 1, d + 1)))
    for writer, reader in (("voicebridge_tpu_torch", "voicebridge_tpu"),
                           ("voicebridge_tpu", "voicebridge_tpu_torch")):
        wg = importlib.import_module(writer + ".models.full_gmm").FullGmm(*args)
        wb = importlib.import_module(writer + ".transforms.basis_fmllr").FmllrBasis(*basis)
        wg.save(tmp_path / f"{writer}_full.npz")
        wb.save(tmp_path / f"{writer}_basis.npz")
        rg = importlib.import_module(reader + ".models.full_gmm").FullGmm.load(
            tmp_path / f"{writer}_full.npz")
        rb = importlib.import_module(reader + ".transforms.basis_fmllr").FmllrBasis.load(
            tmp_path / f"{writer}_basis.npz")
        assert type(rg) is not type(wg) and type(rb) is not type(wb)
        for name in ("weights", "means", "inv_covars", "gconsts"):
            np.testing.assert_array_equal(getattr(rg, name), getattr(wg, name))
        np.testing.assert_array_equal(rb.bases, wb.bases)
        np.testing.assert_array_equal(rb.precond, wb.precond)


def _build_hclg(pkg: str):
    cfg = importlib.import_module(pkg + ".config")
    lang_mod = importlib.import_module(pkg + ".data.lang")
    hclg_mod = importlib.import_module(pkg + ".fst.hclg")
    arpa = importlib.import_module(pkg + ".lm.arpa")
    ngram = importlib.import_module(pkg + ".lm.ngram")
    tree_mod = importlib.import_module(pkg + ".models.tree")
    trans_mod = importlib.import_module(pkg + ".models.transition")
    lang = lang_mod.prepare_lang(LEXICON, ["SIL"], "SIL", cfg.LangOptions())
    model = ngram.estimate_ngram(SENTENCES, order=2)
    g = arpa.arpa_to_fst(model, lang.words.id, lang.word_disambig_id)
    pdf_classes = {p: lang.topo.num_emitting_states(p) for p in lang.topo.phones()}
    tree = tree_mod.MonophoneTree([[p] for p in sorted(pdf_classes)], pdf_classes)
    tm = trans_mod.TransitionModel(lang.topo, tree)
    hclg = hclg_mod.mkgraph(lang, tree, tm, g)
    compiler = hclg_mod.TrainingGraphCompiler(lang, tree, tm)
    train = compiler.compile([lang.words.id("YES"), lang.words.id("NO")])
    return dict(lang=lang, arpa=model, g=g, tree=tree, tm=tm, hclg=hclg, train=train)


@pytest.fixture(scope="module")
def graphs():
    return _build_hclg("voicebridge_tpu_torch"), _build_hclg("voicebridge_tpu")


@pytest.mark.parametrize("which", ["g", "hclg", "train"])
def test_graph_builds_are_identical(graphs, which):
    """ARPA -> G, mkgraph and a training graph on the Yes-No lang."""
    port, jax_side = graphs
    assert port[which].num_states > 1
    _assert_same_fst(port[which], jax_side[which])


def test_lang_and_transition_model_are_identical(graphs):
    port, jax_side = graphs
    assert list(port["lang"].phones.items()) == list(jax_side["lang"].phones.items())
    assert list(port["lang"].words.items()) == list(jax_side["lang"].words.items())
    assert port["tm"].tuples == jax_side["tm"].tuples
    np.testing.assert_array_equal(port["tm"].log_probs, jax_side["tm"].log_probs)
    np.testing.assert_array_equal(port["tm"].tid2pdf, jax_side["tm"].tid2pdf)
    assert port["arpa"].ngrams == jax_side["arpa"].ngrams


def test_native_library_matches_python_paths(graphs):
    """The g++-built library (no binary is committed) against the port's
    pure-Python compose / determinize / minimize / remove-eps-local: the
    same states, arcs and labels, weights within 1e-6 (the library computes
    in float32, Python in float64)."""
    from voicebridge_tpu_torch.fst import native_bridge as nb
    from voicebridge_tpu_torch.fst.compose import compose
    from voicebridge_tpu_torch.fst.determinize import determinize_star
    from voicebridge_tpu_torch.fst.epsilon import remove_eps_local
    from voicebridge_tpu_torch.fst.minimize import minimize_encoded

    lang, g = graphs[0]["lang"], graphs[0]["g"]
    l_fst = lang.L_disambig
    lg_py = compose(l_fst, g)
    _assert_same_fst(nb.compose(l_fst, g), lg_py, 1e-6)
    det_py = determinize_star(lg_py, use_log=True)
    _assert_same_fst(nb.determinize_star(lg_py, True), det_py, 1e-6)
    _assert_same_fst(nb.minimize_encoded(det_py), minimize_encoded(det_py), 1e-6)
    _assert_same_fst(nb.remove_eps_local(det_py), remove_eps_local(det_py), 1e-6)
    assert "voicebridge_tpu_torch/_build" in str(nb._build()).replace("\\", "/")


def test_mle_update_is_identical():
    port, jax_mod = _both("models.gmm")
    rng = np.random.default_rng(0)
    p, m, d = 7, 3, 5
    args = (rng.standard_normal((p, m, d)).astype(np.float32),
            np.abs(rng.standard_normal((p, m, d))).astype(np.float32) + 0.5,
            np.full((p, m), 1.0 / m, np.float32))
    occ = rng.uniform(0.0, 40.0, (p, m))
    occ[2, 1] = 0.0
    mean_acc = rng.standard_normal((p, m, d)) * occ[..., None]
    var_acc = (rng.standard_normal((p, m, d)) ** 2 + 1.0) * occ[..., None]
    ams = []
    for mod in (port, jax_mod):
        am = mod.AmDiagGmm(*[a.copy() for a in args])
        am.mle_update(occ.copy(), mean_acc.copy(), var_acc.copy())
        am.split_to_target(p * m + 4, occ)
        ams.append(am)
    for name in ("means_invvars", "inv_vars", "weights", "gconsts"):
        np.testing.assert_array_equal(getattr(ams[0], name), getattr(ams[1], name))


def test_mllt_host_steps_are_identical():
    """``est_mllt``, ``compose_transforms`` and ``transform_model_means``:
    numpy copies, identical arrays from the same inputs."""
    import voicebridge_tpu.transforms.mllt as jax_mllt
    import voicebridge_tpu_torch.transforms.mllt as port_mllt

    port_gmm, jax_gmm = _both("models.gmm")
    rng = np.random.default_rng(3)
    d, n = 6, 400
    x = rng.standard_normal((n, d)) @ rng.standard_normal((d, d))
    g = np.stack([(x * rng.uniform(0.5, 2.0, n)[:, None]).T @ x for _ in range(d)])
    g = g.astype(np.float32)
    m_port, impr_port = port_mllt.est_mllt(g, float(n))
    m_jax, impr_jax = jax_mllt.est_mllt(g, float(n))
    np.testing.assert_array_equal(m_port, m_jax)
    assert impr_port == impr_jax > 0
    lda = rng.standard_normal((d, 3 * d + 1)).astype(np.float32)
    for a, b in ((m_port, lda), (lda[:, :-1], np.eye(3 * d, dtype=np.float32)),
                 (lda, rng.standard_normal((3 * d, 2 * d)).astype(np.float32)),
                 (lda, rng.standard_normal((3 * d, 3 * d + 1)).astype(np.float32))):
        np.testing.assert_array_equal(port_mllt.compose_transforms(a, b),
                                      jax_mllt.compose_transforms(a, b))
    with pytest.raises(ValueError, match="incompatible"):
        port_mllt.compose_transforms(lda, lda)
    args = (rng.standard_normal((4, 3, d)).astype(np.float32),
            rng.uniform(0.5, 2.0, (4, 3, d)).astype(np.float32),
            np.full((4, 3), 1.0 / 3, np.float32))
    ams = [mod.AmDiagGmm(*[a.copy() for a in args]) for mod in (port_gmm, jax_gmm)]
    port_mllt.transform_model_means(ams[0], m_port)
    jax_mllt.transform_model_means(ams[1], m_jax)
    for name in ("means_invvars", "inv_vars", "gconsts"):
        np.testing.assert_array_equal(getattr(ams[0], name), getattr(ams[1], name))


def test_fmllr_host_steps_are_identical():
    """``estimate_fmllr_batch`` and ``estimate_fmllr``: numpy copies,
    identical transforms and improvements from the same statistics (two
    speakers estimated, one below ``min_count``)."""
    import voicebridge_tpu.transforms.fmllr as jax_fmllr
    import voicebridge_tpu_torch.transforms.fmllr as port_fmllr

    rng = np.random.default_rng(4)
    d, n = 5, 600
    beta = np.array([n, n / 2, 40.0], np.float32)
    k = np.zeros((3, d, d + 1), np.float32)
    g = np.zeros((3, d, d + 1, d + 1), np.float32)
    for s in range(3):
        xhat = np.concatenate([rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, d)
                               + rng.standard_normal(d), np.ones((n, 1))], axis=1)
        iv = rng.uniform(0.5, 2.0, d)
        k[s] = (iv[:, None] * rng.standard_normal((d, 1))) * xhat.sum(0)[None] / 2
        g[s] = iv[:, None, None] * (xhat.T @ xhat)[None]
    got = port_fmllr.estimate_fmllr_batch(beta, k, g, min_count=100.0)
    want = jax_fmllr.estimate_fmllr_batch(beta, k, g, min_count=100.0)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[1][0] > 0 and got[1][2] == 0.0
    one = port_fmllr.estimate_fmllr(float(beta[1]), k[1], g[1], min_count=100.0)
    np.testing.assert_array_equal(one[0], jax_fmllr.estimate_fmllr(float(beta[1]), k[1], g[1],
                                                                   min_count=100.0)[0])


def test_scoring_and_mbr_are_identical():
    port_score, jax_score = _both("steps.score")
    port_mbr, jax_mbr = _both("steps.mbr")
    refs = {"a": ["YES", "NO", "YES"], "b": ["NO"], "c": ["YES", "YES"]}
    hyps_by = {(7, 0.0): {"a": ["YES", "YES"], "b": ["NO"], "c": ["YES", "NO", "YES"]},
               (9, 0.5): {"a": ["YES", "NO", "YES"], "b": [], "c": ["YES", "YES"]}}
    for hyps in hyps_by.values():
        got, want = port_score.compute_wer_set(refs, hyps), jax_score.compute_wer_set(refs, hyps)
        assert vars(got) == vars(want)
    got, want = port_score.score_sweep(refs, hyps_by), jax_score.score_sweep(refs, hyps_by)
    assert (got.best_lmwt, vars(got.best_wer)) == (want.best_lmwt, vars(want.best_wer))
    nbest = [(["YES", "NO"], 0.5), (["YES", "YES"], 0.3), (["NO"], 0.2)]
    assert port_mbr.mbr_decode(nbest) == jax_mbr.mbr_decode(nbest)


@pytest.mark.parametrize("writer,reader", [("voicebridge_tpu_torch", "voicebridge_tpu"),
                                           ("voicebridge_tpu", "voicebridge_tpu_torch")])
def test_files_written_by_one_load_in_the_other(graphs, tmp_path, writer, reader):
    src = graphs[0] if writer == "voicebridge_tpu_torch" else graphs[1]
    rd = {n: importlib.import_module(f"{reader}.{n}")
          for n in ("fst.core", "models.gmm", "models.topology", "models.tree",
                    "models.transition", "data.lang", "lm.arpa")}
    wr_gmm = importlib.import_module(writer + ".models.gmm")
    rng = np.random.default_rng(1)
    am = wr_gmm.AmDiagGmm(rng.standard_normal((4, 2, 3)).astype(np.float32),
                          np.abs(rng.standard_normal((4, 2, 3))).astype(np.float32) + 0.5,
                          np.full((4, 2), 0.5, np.float32))
    am.save(tmp_path / "am.npz")
    src["hclg"].save(tmp_path / "hclg.npz")
    src["lang"].topo.save(tmp_path / "topo.json")
    src["tree"].save(tmp_path / "tree.json")
    src["tm"].save(tmp_path / "trans.json")
    src["lang"].save(tmp_path / "lang")
    src["arpa"].write(tmp_path / "lm.arpa")

    am2 = rd["models.gmm"].AmDiagGmm.load(tmp_path / "am.npz")
    assert type(am2) is not type(am)
    np.testing.assert_array_equal(am2.means_invvars, am.means_invvars)
    np.testing.assert_array_equal(am2.gconsts, am.gconsts)
    hclg2 = rd["fst.core"].Fst.load(tmp_path / "hclg.npz")
    for a, b in zip(hclg2.to_arrays(), src["hclg"].to_arrays()):
        np.testing.assert_array_equal(a, b)
    tm2 = rd["models.transition"].TransitionModel(
        rd["models.topology"].HmmTopology.load(tmp_path / "topo.json"),
        rd["models.tree"].load_tree(tmp_path / "tree.json"))
    tm2.load_probs(tmp_path / "trans.json")
    assert tm2.tuples == src["tm"].tuples
    np.testing.assert_array_equal(tm2.tid2pdf, src["tm"].tid2pdf)
    lang2 = rd["data.lang"].Lang.load(tmp_path / "lang")
    assert list(lang2.words.items()) == list(src["lang"].words.items())
    assert rd["lm.arpa"].ArpaModel.read(tmp_path / "lm.arpa").order == src["arpa"].order


def test_convert_builds_the_ports_objects_from_arrays(graphs, tmp_path):
    """The JAX package's objects, handed over as arrays and json objects."""
    from voicebridge_tpu_torch.fst.core import Fst
    from voicebridge_tpu_torch.models.gmm import AmDiagGmm
    from voicebridge_tpu_torch.models.transition import TransitionModel

    _, jax_mod = _both("models.gmm")
    j = graphs[1]
    rng = np.random.default_rng(2)
    jam = jax_mod.AmDiagGmm(rng.standard_normal((4, 2, 3)).astype(np.float32),
                            np.abs(rng.standard_normal((4, 2, 3))).astype(np.float32) + 0.5,
                            np.full((4, 2), 0.5, np.float32))
    am = convert.am_from_arrays(jam.means_invvars, jam.inv_vars, jam.weights)
    assert type(am) is AmDiagGmm
    np.testing.assert_array_equal(am.gconsts, jam.gconsts)
    f = convert.fst_from_arrays(*j["hclg"].to_arrays(), j["hclg"].finals, j["hclg"].start)
    assert type(f) is Fst
    for a, b in zip(f.to_arrays(), j["hclg"].to_arrays()):
        np.testing.assert_array_equal(a, b)
    j["lang"].topo.save(tmp_path / "topo.json")
    j["tree"].save(tmp_path / "tree.json")
    j["tm"].save(tmp_path / "trans.json")
    tm = convert.transition_model_from_json(
        *[json.loads((tmp_path / n).read_text()) for n in ("topo.json", "tree.json",
                                                            "trans.json")])
    assert type(tm) is TransitionModel
    assert tm.tuples == j["tm"].tuples
    np.testing.assert_array_equal(tm.log_probs, j["tm"].log_probs)
    np.testing.assert_array_equal(tm.tid2pdf, j["tm"].tid2pdf)


@pytest.mark.parametrize("pad_multiple", [1, 4])
def test_parallel_data_gives_identical_batches(tmp_path, pad_multiple):
    """``parallel/data.py``'s numpy copies give the JAX package's shards,
    padded arrays and batches on the same inputs, streamed from an archive
    each package wrote."""
    port, jax_mod = _both("parallel.data")
    port_io, jax_io = _both("utils.io")
    rng = np.random.default_rng(3)
    data = {f"u{i:02d}": rng.standard_normal((int(rng.integers(3, 60)), 5)).astype(np.float32)
            for i in range(41)}
    nf = {u: v.shape[0] for u, v in data.items()}
    for pc in (1, 3, 8):
        for pi in range(pc):
            assert port.host_shard(list(data), pi, pc) == jax_mod.host_shard(list(data), pi, pc)
    arrays = {"feats": rng.standard_normal((7, 4, 3)), "nf": np.arange(7, dtype=np.int32)}
    got, want = (m.pad_to_multiple(arrays, pad_multiple) for m in (port, jax_mod))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for ratio, seed in ((0.2, 0), (0.05, 4)):
        assert (port.bucket_by_length(nf, 6, ratio, seed)
                == jax_mod.bucket_by_length(nf, 6, ratio, seed))
    got = list(port.stream_batches(port_io.write_archive(tmp_path / "p", data), nf, 6,
                                   pad_multiple=pad_multiple))
    want = list(jax_mod.stream_batches(jax_io.write_archive(tmp_path / "j", data), nf, 6,
                                       pad_multiple=pad_multiple))
    assert len(got) == len(want)
    for (u, f, k), (ru, rf, rk) in zip(got, want):
        assert u == ru
        assert f.dtype == rf.dtype and k.dtype == rk.dtype
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(k, rk)
