"""The port's speaker adaptation and full-covariance GMM against the JAX
package's, on the CPU: regression-tree fMLLR / MLLR
(``transforms/regtree.py``), basis fMLLR (``transforms/basis_fmllr.py``) and
``models/full_gmm.py``.

The same numpy GMMs and frames (from seeds) go to both packages.  Host
copies (the tree, the class choice, the row solves, the basis, ``FullGmm``'s
M-step) must give identical arrays from identical inputs.  Device
functions, with their tolerances:

* fMLLR statistics within 1e-6 of the largest entry (as the port's fMLLR
  tests), transforms estimated from them within 1e-2 of the largest entry
  (as PR 9's, for ill-conditioned speakers);
* log-likelihoods with the GMM tolerance, rtol 2e-5 / atol 2e-4;
* MLLR and full-covariance statistics rtol 1e-5 plus 1e-5 of the largest
  entry (float32 sums in another order).

Then the JAX tests' own behaviour (``tests/test_regtree.py``,
``tests/test_models.py::TestFullGmm`` and the basis cases of
``tests/test_transforms.py``) on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voicebridge_tpu.models import full_gmm as JG
from voicebridge_tpu.models.gmm import AmDiagGmm as JaxAm
from voicebridge_tpu.ops import gmm_kernels as JK
from voicebridge_tpu.transforms import basis_fmllr as JB
from voicebridge_tpu.transforms import fmllr as JFM
from voicebridge_tpu.transforms import regtree as JR
from voicebridge_tpu_torch import convert
from voicebridge_tpu_torch.models import full_gmm as TG
from voicebridge_tpu_torch.ops import gmm_kernels as TK
from voicebridge_tpu_torch.transforms import basis_fmllr as TB
from voicebridge_tpu_torch.transforms import fmllr as TFM
from voicebridge_tpu_torch.transforms import regtree as TR

torch.set_num_threads(2)
LL_TOL = dict(rtol=2e-5, atol=2e-4)


def two_group_gmm(rng, dim=6, mix=2, pdfs=6):
    """Half the pdfs near -8, half near +8 (``tests/test_regtree.py``)."""
    means = np.zeros((pdfs, mix, dim))
    means[: pdfs // 2] = -8.0 + rng.standard_normal((pdfs // 2, mix, dim))
    means[pdfs // 2:] = 8.0 + rng.standard_normal((pdfs - pdfs // 2, mix, dim))
    variances = 0.5 + rng.random((pdfs, mix, dim))
    w = np.full((pdfs, mix), 1.0 / mix)
    return ((means / variances).astype(np.float32), (1.0 / variances).astype(np.float32),
            w.astype(np.float32))


def sample(rng, arrays, n):
    miv, iv, w = arrays
    means, var = miv / iv, 1.0 / iv
    p = rng.integers(0, w.shape[0], n).astype(np.int32)
    m = rng.integers(0, w.shape[1], n)
    x = means[p, m] + rng.standard_normal((n, means.shape[2])) * np.sqrt(var[p, m])
    return x.astype(np.float32), p


def both(arrays):
    """(JAX ``AmDiagGmm``, its ``GmmParams``, the port's ``AmDiagGmm``, its
    ``GmmParams`` on the CPU) from the same three arrays."""
    jam = JaxAm(*[a.copy() for a in arrays])
    tam = convert.am_from_arrays(*arrays)
    return jam, JK.pack_gmm(jam), tam, TK.pack_gmm(tam, "cpu")


def adapted(rng, arrays, n, pdfs=6):
    """Frames of each half of the pdfs through its own affine transform."""
    x, p = sample(rng, arrays, n)
    d = x.shape[1]
    a1, a2 = (np.eye(d) + 0.25 * rng.standard_normal((d, d)) for _ in range(2))
    b1, b2 = 2.0 * rng.standard_normal(d), -1.5 * rng.standard_normal(d)
    x = np.where((p >= pdfs // 2)[:, None], x @ a2.T + b2, x @ a1.T + b1)
    return x.astype(np.float32), p


def assert_close_to_largest(got, want, frac):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


def assert_stats_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# Regression tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def regtree_case():
    rng = np.random.default_rng(11)
    arrays = two_group_gmm(rng, dim=6, mix=3)
    x, p = adapted(rng, arrays, 3000)
    w = np.ones(len(p), np.float32)
    w[::7] = 0.3
    w[::11] = 0.0
    jam, jparams, tam, tparams = both(arrays)
    return dict(arrays=arrays, x=x, p=p, w=w, jam=jam, jparams=jparams, tam=tam,
                tparams=tparams)


@pytest.mark.parametrize("num_classes", [1, 2, 4, 8])
def test_tree_and_class_choice_are_identical(regtree_case, num_classes):
    c = regtree_case
    jt = JR.build_regression_tree(c["jam"].means(), c["jam"].weights, num_classes, seed=2)
    tt = TR.build_regression_tree(c["tam"].means(), c["tam"].weights, num_classes, seed=2)
    np.testing.assert_array_equal(tt.bclass_of, jt.bclass_of)
    np.testing.assert_array_equal(tt.parent, jt.parent)
    assert tt.num_leaves == jt.num_leaves == num_classes
    for occ_scale in (1.0, 50.0, 1e6):
        occ = np.arange(1, tt.num_leaves + 1, dtype=np.float64) * occ_scale
        got, want = TR.choose_regression_classes(tt, occ, 100.0), \
            JR.choose_regression_classes(jt, occ, 100.0)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    conv = convert.regression_tree_from_arrays(jt.bclass_of, jt.parent, jt.num_leaves)
    assert type(conv) is TR.RegressionTree and conv.num_nodes == jt.num_nodes


@pytest.mark.parametrize("num_classes", [2, 4])
def test_regtree_fmllr_stats_and_estimate_match_jax(regtree_case, num_classes):
    c = regtree_case
    tree = TR.build_regression_tree(c["tam"].means(), c["tam"].weights, num_classes)
    jtree = JR.build_regression_tree(c["jam"].means(), c["jam"].weights, num_classes)
    want = [np.asarray(a) for a in JR.acc_regtree_fmllr_stats(
        c["jparams"], jnp.asarray(c["jam"].means()), jnp.asarray(c["jam"].inv_vars),
        jnp.asarray(c["x"]), jnp.asarray(c["p"]), jnp.asarray(c["w"]), jtree.bclass_of,
        num_classes)]
    # chunks of 1024 rows: whole blocks, the last chunk a partial one
    got = [a.numpy() for a in TR.acc_regtree_fmllr_stats(
        c["tparams"], c["tam"].means(), c["tam"].inv_vars, c["x"], c["p"], c["w"],
        tree.bclass_of, num_classes, chunk=1024, device="cpu")]
    one_chunk = TR.acc_regtree_fmllr_stats(
        c["tparams"], c["tam"].means(), c["tam"].inv_vars, c["x"], c["p"], c["w"],
        tree.bclass_of, num_classes, device="cpu")
    for g, o, wnt in zip(got, one_chunk, want):
        assert g.shape == wnt.shape
        assert_close_to_largest(g, wnt, 1e-6)
        assert_close_to_largest(o.numpy(), wnt, 1e-6)
    for min_count in (10.0, 1e7):
        # identical statistics in: identical transforms out (host copies)
        tw, tl2c, timp = TR.estimate_regtree_fmllr(tree, *want, min_count=min_count)
        jw, jl2c, jimp = JR.estimate_regtree_fmllr(jtree, *want, min_count=min_count)
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tl2c, jl2c)
        assert timp == jimp
        # the port's own statistics: transforms within 1e-2 of the largest entry
        pw, pl2c, _ = TR.estimate_regtree_fmllr(tree, *got, min_count=min_count)
        np.testing.assert_array_equal(pl2c, jl2c)
        assert_close_to_largest(pw, jw, 1e-2)


@pytest.mark.parametrize("num_classes", [1, 2, 8])
def test_regtree_fmllr_loglikes_match_jax(regtree_case, num_classes):
    """Through K2 a class at a time (its plain version on the CPU) and in
    the JAX formulation, against the JAX package's single logsumexp; a pdf
    whose Gaussians are all inactive comes out -inf in all three."""
    c = regtree_case
    rng = np.random.default_rng(num_classes)
    tree = JR.build_regression_tree(c["jam"].means(), c["jam"].weights, num_classes)
    bclass = tree.bclass_of.copy()
    bclass[4] = -1  # pdf 4: no active Gaussian
    bclass[1, 0] = -1  # pdf 1: one inactive Gaussian
    d = c["x"].shape[1]
    eye = np.concatenate([np.eye(d), np.zeros((d, 1))], axis=1)
    trans = (eye + 0.1 * rng.standard_normal((num_classes, d, d + 1))).astype(np.float32)
    l2c = np.arange(num_classes, dtype=np.int32)[rng.permutation(num_classes)]
    x = c["x"][:700]
    want = np.asarray(JR.regtree_fmllr_loglikes(c["jparams"], jnp.asarray(x), trans, l2c,
                                                bclass))
    got = TR.regtree_fmllr_loglikes(c["tparams"], torch.from_numpy(x), trans, l2c,
                                    bclass).numpy()
    plain = TR.regtree_fmllr_loglikes_plain(c["tparams"], torch.from_numpy(x), trans, l2c,
                                            bclass).numpy()
    for out in (got, plain):
        assert out.shape == want.shape == (700, 6)
        assert np.isneginf(out[:, 4]).all() and np.isneginf(want[:, 4]).all()
        np.testing.assert_allclose(np.delete(out, 4, 1), np.delete(want, 4, 1), **LL_TOL)
    # one class for every leaf: one K2 launch over the transformed features
    glob = TR.regtree_fmllr_loglikes(c["tparams"], torch.from_numpy(x), trans[:1],
                                     np.zeros(num_classes, np.int32), tree.bclass_of).numpy()
    x1 = x @ trans[0, :, :d].T + trans[0, :, d]
    direct = TK.loglikes(c["tparams"], torch.from_numpy(x1.astype(np.float32))).numpy()
    np.testing.assert_allclose(glob, direct + np.linalg.slogdet(trans[0, :, :d])[1], **LL_TOL)


def test_regtree_mllr_stats_and_estimate_match_jax(regtree_case):
    c = regtree_case
    tree = JR.build_regression_tree(c["jam"].means(), c["jam"].weights, 2)
    want = [np.asarray(a) for a in JR.acc_regtree_mllr_stats(
        c["jparams"], jnp.asarray(c["x"]), jnp.asarray(c["p"]), jnp.asarray(c["w"]))]
    got = TR.acc_regtree_mllr_stats(c["tparams"], c["x"], c["p"], c["w"])
    for g, wnt in zip(got, want):
        assert g.shape == wnt.shape
        assert_stats_close(g, wnt)
    ttree = convert.regression_tree_from_arrays(tree.bclass_of, tree.parent, tree.num_leaves)
    for min_count in (10.0, 1e7):
        tx, tl = TR.estimate_regtree_mllr(ttree, *want, c["tam"].means(), c["tam"].inv_vars,
                                          min_count=min_count)
        jx, jl = JR.estimate_regtree_mllr(tree, *want, c["jam"].means(), c["jam"].inv_vars,
                                          min_count=min_count)
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(TR.apply_regtree_mllr(c["tam"].means(), ttree, tx, tl),
                                      JR.apply_regtree_mllr(c["jam"].means(), tree, jx, jl))
        px, _ = TR.estimate_regtree_mllr(ttree, *got, c["tam"].means(), c["tam"].inv_vars,
                                         min_count=min_count)
        assert_close_to_largest(px, jx, 1e-2)


class TestRegtreeBehaviour:
    """``tests/test_regtree.py`` on the port."""

    def test_tree_separates_groups(self):
        arrays = two_group_gmm(np.random.default_rng(1))
        am = convert.am_from_arrays(*arrays)
        tree = TR.build_regression_tree(am.means(), am.weights, 2)
        bc = tree.bclass_of
        assert tree.num_leaves == 2 and len(set(bc[:3].ravel())) == 1
        assert len(set(bc[3:].ravel())) == 1 and bc[0, 0] != bc[5, 0]
        assert (tree.parent == -1).sum() == 1

    def test_two_class_beats_global(self):
        rng = np.random.default_rng(2)
        arrays = two_group_gmm(rng)
        x, p = adapted(rng, arrays, 3000)
        am = convert.am_from_arrays(*arrays)
        params = TK.pack_gmm(am, "cpu")
        tree = TR.build_regression_tree(am.means(), am.weights, 2)
        beta, k, g = [a.numpy() for a in TR.acc_regtree_fmllr_stats(
            params, am.means(), am.inv_vars, x, p, np.ones(len(p), np.float32),
            tree.bclass_of, 2, device="cpu")]
        w_glob, _ = TFM.estimate_fmllr(beta.sum(), k.sum(0), g.sum(0), min_count=1.0)
        w_tree, l2c, _ = TR.estimate_regtree_fmllr(tree, beta, k, g, min_count=10.0)
        assert w_tree.shape[0] == 2
        xt = torch.from_numpy(x)
        n = np.arange(len(p))
        t = TR.regtree_fmllr_loglikes(params, xt, w_tree, l2c, tree.bclass_of).numpy()[n, p]
        gl = TR.regtree_fmllr_loglikes(params, xt, w_glob[None], np.zeros(2, np.int32),
                                       tree.bclass_of).numpy()[n, p]
        no = TK.loglikes(params, xt).numpy()[n, p]
        assert gl.mean() > no.mean() + 0.1 and t.mean() > gl.mean() + 0.1

    def test_min_count_degrades_to_global(self):
        rng = np.random.default_rng(3)
        arrays = two_group_gmm(rng)
        x, p = adapted(rng, arrays, 800)
        am = convert.am_from_arrays(*arrays)
        tree = TR.build_regression_tree(am.means(), am.weights, 2)
        beta, k, g = [a.numpy() for a in TR.acc_regtree_fmllr_stats(
            TK.pack_gmm(am, "cpu"), am.means(), am.inv_vars, x, p,
            np.ones(len(p), np.float32), tree.bclass_of, 2, device="cpu")]
        w_tree, l2c, _ = TR.estimate_regtree_fmllr(tree, beta, k, g, min_count=1e7)
        w_glob, _ = TFM.estimate_fmllr(beta.sum(), k.sum(0), g.sum(0), min_count=1.0)
        assert w_tree.shape[0] == 1 and (l2c == 0).all()
        np.testing.assert_allclose(w_tree[0], w_glob, atol=1e-4)

    def test_mllr_recovers_mean_shift(self):
        rng = np.random.default_rng(4)
        arrays = two_group_gmm(rng)
        x, p = sample(rng, arrays, 4000)
        shift = np.array([1.5, -2.0], np.float32)
        x = (x + shift[(p >= 3).astype(int)][:, None]).astype(np.float32)
        am = convert.am_from_arrays(*arrays)
        params = TK.pack_gmm(am, "cpu")
        tree = TR.build_regression_tree(am.means(), am.weights, 2)
        occ, xbar = TR.acc_regtree_mllr_stats(params, x, p, np.ones(len(p), np.float32))
        xf, l2c = TR.estimate_regtree_mllr(tree, occ, xbar, am.means(), am.inv_vars,
                                           min_count=10.0)
        new_means = TR.apply_regtree_mllr(am.means(), tree, xf, l2c)
        am2 = convert.am_from_arrays(new_means * am.inv_vars, am.inv_vars, am.weights)
        n = np.arange(len(p))
        xt = torch.from_numpy(x)
        ll_old = TK.loglikes(params, xt).numpy()[n, p].mean()
        ll_new = TK.loglikes(TK.pack_gmm(am2, "cpu"), xt).numpy()[n, p].mean()
        assert ll_new > ll_old + 0.5
        assert abs(float((new_means[:3] - am.means()[:3]).mean()) - 1.5) < 0.5
        assert abs(float((new_means[3:] - am.means()[3:]).mean()) + 2.0) < 0.5


# ---------------------------------------------------------------------------
# Full-covariance GMM
# ---------------------------------------------------------------------------


def full_arrays(p=3, m=4, d=5, seed=5, inactive=True):
    rng = np.random.default_rng(seed)
    w = rng.random((p, m)) + 0.2
    if inactive:
        w[1, m - 1] = 0.0
    w /= w.sum(axis=1, keepdims=True)
    mu = rng.standard_normal((p, m, d)) * 2
    ic = np.zeros((p, m, d, d))
    for i in range(p):
        for j in range(m):
            a = rng.standard_normal((d, d)) * 0.3
            ic[i, j] = np.linalg.inv(a @ a.T + np.eye(d))
    return w, mu, ic


def test_full_gmm_host_half_is_identical():
    args = full_arrays()
    jg, tg = JG.FullGmm(*args), convert.full_gmm_from_arrays(*args)
    np.testing.assert_array_equal(tg.gconsts, jg.gconsts)
    x = np.random.default_rng(1).standard_normal(5)
    for pdf in range(3):
        assert tg.loglike(pdf, x) == jg.loglike(pdf, x)
    td, jd = tg.to_diag(), jg.to_diag()
    for name in ("means_invvars", "inv_vars", "weights", "gconsts"):
        np.testing.assert_array_equal(getattr(td, name), getattr(jd, name))
    np.testing.assert_array_equal(TG.FullGmm.from_diag(td).inv_covars,
                                  JG.FullGmm.from_diag(jd).inv_covars)
    rng = np.random.default_rng(2)
    occ = rng.uniform(0.0, 40.0, (3, 4))
    occ[0, 1] = 3.0  # below min_occ
    x_acc = rng.standard_normal((3, 4, 5)) * occ[..., None]
    xx = rng.standard_normal((3, 4, 8, 5))
    xx_acc = np.einsum("pmnd,pmne->pmde", xx, xx) * occ[..., None, None] / 8 + \
        np.einsum("pmd,pme->pmde", x_acc, x_acc) / np.maximum(occ, 1e-9)[..., None, None]
    assert tg.mle_update(occ, x_acc, xx_acc) == jg.mle_update(occ, x_acc, xx_acc)
    for name in ("weights", "means", "inv_covars", "gconsts"):
        np.testing.assert_array_equal(getattr(tg, name), getattr(jg, name))


@pytest.mark.parametrize("chunk", [None, 64, 1000])
def test_full_gmm_device_functions_match_jax(chunk):
    """``loglikes_full`` and ``acc_full_stats`` against the JAX package's,
    in one chunk and in chunks across a boundary (64 of 300 frames; 1000
    frames of statistics is more than a pdf's)."""
    args = full_arrays()
    jg, tg = JG.FullGmm(*args), convert.full_gmm_from_arrays(*args)
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((300, 5)) * 1.5).astype(np.float32)
    pdf = rng.integers(0, 3, 300).astype(np.int32)
    w = rng.random(300).astype(np.float32)
    jp, tp = JG.pack_full_gmm(jg), TG.pack_full_gmm(tg, "cpu")
    want = np.asarray(JG.loglikes_full(jp, jnp.asarray(x)))
    got = TG.loglikes_full(tp, torch.from_numpy(x), chunk=chunk).numpy()
    np.testing.assert_allclose(got, want, **LL_TOL)
    for weights in (None, w):
        want = [np.asarray(a) for a in JG.acc_full_stats(
            jp, jnp.asarray(x), jnp.asarray(pdf), 4, None if weights is None
            else jnp.asarray(weights))]
        got = [a.numpy() for a in TG.acc_full_stats(tp, x, pdf, 4, weights, chunk=chunk)]
        for g, wnt in zip(got, want):
            assert g.shape == wnt.shape
            assert_stats_close(g, wnt)


class TestFullGmmBehaviour:
    """``tests/test_models.py::TestFullGmm`` on the port."""

    def test_loglik_matches_formula(self):
        g = convert.full_gmm_from_arrays(*full_arrays(inactive=False))
        x = np.random.default_rng(6).standard_normal((12, g.dim)).astype(np.float32)
        dev = TG.loglikes_full(TG.pack_full_gmm(g, "cpu"), torch.from_numpy(x)).numpy()
        for n in range(12):
            for p in range(g.num_pdfs):
                dens = 0.0
                for j in range(g.max_mix):
                    diff = x[n] - g.means[p, j]
                    ic = g.inv_covars[p, j]
                    dens += np.exp(np.log(g.weights[p, j]) + 0.5 * np.linalg.slogdet(ic)[1]
                                   - 0.5 * g.dim * np.log(2 * np.pi) - 0.5 * diff @ ic @ diff)
                assert abs(dev[n, p] - np.log(dens)) < 1e-3

    def test_em_monotone_and_recovers(self):
        rng = np.random.default_rng(3)
        d = 3
        a1 = rng.standard_normal((d, d)) * 0.4 + np.eye(d)
        x = np.concatenate([rng.multivariate_normal([2, 0, -1], a1 @ a1.T, 400),
                            rng.multivariate_normal([-2, 1, 1], np.eye(d) * 0.5, 400),
                            ]).astype(np.float32)
        pdf = np.zeros(len(x), np.int32)
        mu0 = x.mean(axis=0)
        g = TG.FullGmm(np.array([[0.5, 0.5]]), np.stack([[mu0 + 0.1, mu0 - 0.1]]),
                       np.broadcast_to(np.eye(d), (1, 2, d, d)).copy())
        lls = []
        for _ in range(8):
            packed = TG.pack_full_gmm(g, "cpu")
            lls.append(float(TG.loglikes_full(packed, torch.from_numpy(x)).sum()))
            occ, xa, xxa = TG.acc_full_stats(packed, x, pdf, 1)
            g.mle_update(occ.double().numpy(), xa.double().numpy(), xxa.double().numpy())
        assert all(b >= a - 1e-2 for a, b in zip(lls, lls[1:])), lls
        assert lls[-1] > lls[0] + 100

    def test_diag_roundtrip(self):
        rng = np.random.default_rng(7)
        var = 0.5 + rng.random((4, 2, 5))
        am = convert.am_from_arrays(rng.standard_normal((4, 2, 5)) / var, 1.0 / var,
                                    np.full((4, 2), 0.5))
        full = TG.FullGmm.from_diag(am)
        x = rng.standard_normal(5)
        for p in range(4):
            assert abs(full.loglike(p, x) - am.loglike(p, x)) < 1e-3
        np.testing.assert_allclose(full.to_diag().inv_vars, am.inv_vars, rtol=1e-5)


# ---------------------------------------------------------------------------
# Basis fMLLR
# ---------------------------------------------------------------------------


def speaker_stats(arrays, n, seed):
    """One speaker's fMLLR statistics from each package: frames of the GMM
    through a random affine transform."""
    rng = np.random.default_rng(seed)
    x, p = sample(rng, arrays, n)
    d = x.shape[1]
    x = (x @ (np.eye(d) + 0.25 * rng.standard_normal((d, d))).T
         + 0.5 * rng.standard_normal(d)).astype(np.float32)
    jam, jparams, tam, tparams = both(arrays)
    ones, zeros = np.ones(n, np.float32), np.zeros(n, np.int32)
    want = [np.asarray(a)[0] for a in JFM.acc_fmllr_stats(
        jparams, jnp.asarray(jam.means()), jnp.asarray(jam.inv_vars), jnp.asarray(x),
        jnp.asarray(p), jnp.asarray(ones), jnp.asarray(zeros), 1)]
    got = [a.numpy()[0] for a in TFM.acc_fmllr_stats(
        tparams, tam.means(), tam.inv_vars, x, p, ones, zeros, 1, device="cpu")]
    return got, want, (x, p, tparams)


@pytest.fixture(scope="module")
def basis_case():
    rng = np.random.default_rng(21)
    var = 0.5 + rng.random((5, 1, 5))
    arrays = ((rng.standard_normal((5, 1, 5)) * 4.0 / var).astype(np.float32),
              (1.0 / var).astype(np.float32), np.ones((5, 1), np.float32))
    stats = [speaker_stats(arrays, 400, 100 + s) for s in range(8)]
    return arrays, stats


def _stack(stats, which):
    return [np.asarray([s[which][0] for s in stats])] + \
        [np.stack([s[which][i] for s in stats]) for i in (1, 2)]


def test_basis_training_and_estimate_match_jax(basis_case):
    arrays, stats = basis_case
    want_stats = _stack(stats, 1)
    tb = TB.train_fmllr_basis(*want_stats, num_bases=20)
    jb = JB.train_fmllr_basis(*want_stats, num_bases=20)
    np.testing.assert_array_equal(tb.bases, jb.bases)
    np.testing.assert_array_equal(tb.precond, jb.precond)
    # the port's own statistics (on the CPU) within 1e-6 of the largest entry
    got_stats = _stack(stats, 0)
    for g, w in zip(got_stats, want_stats):
        assert_close_to_largest(g, w, 1e-6)
    (beta, k, g), _want, _ = speaker_stats(arrays, 60, 999)
    for kw in (dict(size_scale=0.2, min_count=20), dict(size_scale=1.0, num_iters=30),
               dict(min_count=1e6)):
        got = TB.estimate_fmllr_basis(tb, float(beta), k, g, **kw)
        want = JB.estimate_fmllr_basis(jb, float(beta), k, g, **kw)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    conv = convert.fmllr_basis_from_arrays(jb.bases, jb.precond)
    assert type(conv) is TB.FmllrBasis and conv.size == 20 and conv.dim == 5


def test_basis_improves_sparse_speaker(basis_case):
    """``tests/test_transforms.py``'s sparse-speaker case on the port's
    statistics."""
    arrays, stats = basis_case
    basis = TB.train_fmllr_basis(*_stack(stats, 0), num_bases=20)
    assert basis.size == 20 and basis.dim == 5
    (beta, k, g), _want, (x, p, params) = speaker_stats(arrays, 60, 999)
    w, impr, n = TB.estimate_fmllr_basis(basis, float(beta), k, g, size_scale=0.2,
                                         min_count=20)
    assert 0 < n <= 12 and impr > 0.05
    x_ad = torch.from_numpy((x @ w[:, :5].T + w[:, 5]).astype(np.float32))
    pid = torch.from_numpy(p)
    assert float(TK.aligned_loglike(params, x_ad, pid)) > float(
        TK.aligned_loglike(params, torch.from_numpy(x), pid))
    w0, impr0, n0 = TB.estimate_fmllr_basis(basis, 10.0, k, g, min_count=50.0)
    assert n0 == 0 and impr0 == 0.0
    np.testing.assert_array_equal(w0, np.concatenate([np.eye(5), np.zeros((5, 1))], 1))
