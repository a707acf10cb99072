"""One rank of the port's multi-device statistics tests
(``tests/test_torch_parallel.py``): it imports only the port, joins a
``gloo`` group through a file store, runs every case on the same global
inputs and saves its numpy results for the test process.

    python -c "import torch_parallel_worker as w; w.main(rank, world, store, out)"

is what ``run_world`` starts, once per rank, in fresh interpreters.
"""

from __future__ import annotations

import logging
import pickle
import sys
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

B, T, DIM = 8, 24, 12  # the JAX package's tests/test_parallel.py setup
NUM_SPK = 3
LEXICON = {"YES": [(1.0, ("Y", "EH", "S"))], "NO": [(1.0, ("N", "OW"))]}


def build_setup() -> dict:
    """The JAX package's ``tests/test_parallel.py`` setup built with the
    port's numpy copies (the same arrays from the same seed): the YES/NO
    lexicon, a flat-start monophone GMM of 12 dims, 8 utterances x 24 frames
    with their training graphs and equal alignments."""
    from voicebridge_tpu_torch.config import LangOptions
    from voicebridge_tpu_torch.data.lang import prepare_lang
    from voicebridge_tpu_torch.fst.hclg import TrainingGraphCompiler
    from voicebridge_tpu_torch.models.gmm import AmDiagGmm
    from voicebridge_tpu_torch.models.transition import TransitionModel
    from voicebridge_tpu_torch.ops import viterbi as V
    from voicebridge_tpu_torch.steps.align import equal_align
    from voicebridge_tpu_torch.steps.train_mono import make_mono_tree

    lang = prepare_lang(LEXICON, ["SIL"], "SIL", LangOptions())
    tree = make_mono_tree(lang)
    tm = TransitionModel(lang.topo, tree)
    rng = np.random.default_rng(0)
    am = AmDiagGmm.flat_start(tree.num_pdfs, rng.standard_normal(DIM), np.ones(DIM))
    transcripts = [[lang.words.id("YES")], [lang.words.id("NO")]] * (B // 2)
    compiler = TrainingGraphCompiler(lang, tree, tm)
    graphs = [V.compile_dense_graph(f, tm.tid2pdf) for f in compiler.compile_batch(transcripts)]
    padded = V.pad_graphs(graphs)
    feats = rng.standard_normal((B, T, DIM)).astype(np.float32)
    tids = np.zeros((B, T), np.int32)
    for i, g in enumerate(graphs):
        tids[i] = g.arc_tid[equal_align(g, T, seed=i)]
    w_lda = np.ones(B * T, np.float32)
    w_lda[::7] = 0.25  # non-trivial weights, as the JAX test's LDA case
    return dict(lang=lang, tree=tree, tm=tm, am=am, graphs=graphs, padded=padded,
                transcripts=transcripts, feats=feats, nf=np.full(B, T, np.int32), tids=tids,
                pdf_ids=tm.tid2pdf[tids].astype(np.int32), weights=np.ones((B, T), np.float32),
                w_lda=w_lda, spk=np.repeat(np.arange(B, dtype=np.int32) % NUM_SPK, T))


def decode_inputs() -> dict:
    """A 200-state synthetic decode graph, its emit plan and 8 lanes x 12
    frames of log-likelihoods (lanes ending at different frames)."""
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.testing import synth_decode_graph

    graph = synth_decode_graph(200, arcs_per_state=8, num_pdfs=20, seed=1)
    plan = DC.build_emit_plan(graph, d=4)
    rng = np.random.default_rng(2)
    s1 = plan.row_start.shape[0] - 1
    alpha = np.full((s1, B), DC.NEG_INF, np.float32)
    alpha[plan.sperm[np.flatnonzero(graph.alpha0 > DC.NEG_INF / 2)]] = 0.0
    return dict(plan=plan, alpha=alpha, alpha_end=np.full((s1, B), DC.NEG_INF, np.float32),
                ll=(rng.standard_normal((B, 12, 20)) * 5 - 30).astype(np.float32),
                nf=np.array([12, 11, 0, 5, 12, 9, 1, 12], np.int32),
                acwt=float(np.float32(1.0 / 13.0)))


def lda_mllt_inputs(setup: dict) -> dict:
    """A short tri2b run's inputs: 13-dim base features of the setup's
    utterances and their equal alignments."""
    rng = np.random.default_rng(7)
    utts = [f"u{i}" for i in range(B)]
    base = {u: rng.standard_normal((T, 13)).astype(np.float32) for u in utts}
    return dict(base=base, transcripts=dict(zip(utts, setup["transcripts"])),
                alignments={u: [int(x) for x in setup["tids"][i]] for i, u in enumerate(utts)})


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (tuple, list)):
        return type(x)(_np(v) for v in x)
    return x


def run_cases(mesh) -> dict:
    """Every case on this rank; sharded outputs joined over the ranks."""
    from voicebridge_tpu_torch.config import LdaOptions, TriTrainOptions
    from voicebridge_tpu_torch.models.treebuild import acc_tree_stats
    from voicebridge_tpu_torch.ops import align_band as AB
    from voicebridge_tpu_torch.ops import decode_core as DC
    from voicebridge_tpu_torch.ops import gmm_kernels as K
    from voicebridge_tpu_torch.parallel import data as D
    from voicebridge_tpu_torch.parallel import mesh as M
    from voicebridge_tpu_torch.steps.train_lda_mllt import train_lda_mllt
    from voicebridge_tpu_torch.transforms.fmllr import acc_fmllr_stats
    from voicebridge_tpu_torch.transforms.lda import acc_lda_stats
    from voicebridge_tpu_torch.transforms.mllt import acc_mllt_stats
    from voicebridge_tpu_torch.utils.io import write_archive

    s = build_setup()
    out = {}
    params = K.pack_gmm(s["am"], "cpu")
    p = s["padded"]
    data = (s["feats"], s["nf"], s["tids"], s["pdf_ids"], s["weights"])
    acwt = np.float32(0.1)
    step = M.em_estep_sharded(mesh, p["num_states"], s["tree"].num_pdfs,
                              s["tm"].num_transition_ids)
    res = step(params, p["arc_src"], p["arc_dst"], p["arc_pdf"], p["arc_score"], p["alpha0"],
               *data, acwt)
    out["estep"] = _np((M.join_blocks(mesh, res[0]), M.join_blocks(mesh, res[1], axis=1))
                       + tuple(res[2:]))
    band = AB.build_band_plan(s["graphs"])
    step = M.em_estep_sharded_banded(mesh, s["tree"].num_pdfs, s["tm"].num_transition_ids,
                                     band.offsets)
    res = step(params, band.W, band.pdf, band.alpha0, *data, acwt)
    out["estep_banded"] = _np((M.join_blocks(mesh, res[0]), M.join_blocks(mesh, res[1], axis=1))
                              + tuple(res[2:]))

    x = s["feats"].reshape(B * T, DIM)
    pdfs = s["pdf_ids"].reshape(-1)
    w = s["weights"].reshape(-1)
    means, ivars = s["am"].means(), s["am"].inv_vars
    out["lda"] = _np(M.acc_lda_stats_sharded(mesh, s["tree"].num_pdfs)(x, pdfs, s["w_lda"]))
    out["mllt"] = _np(M.acc_mllt_stats_sharded(mesh)(params, means, ivars, x, pdfs, w))
    out["lda_mesh"] = _np(acc_lda_stats(x, pdfs, s["w_lda"], s["tree"].num_pdfs, mesh=mesh))
    out["mllt_mesh"] = _np(acc_mllt_stats(params, means, ivars, x, pdfs, w, chunk=64, mesh=mesh))
    out["fmllr_mesh"] = _np(acc_fmllr_stats(params, means, ivars, x, pdfs, w, s["spk"], NUM_SPK,
                                            mesh=mesh))
    # the builder on speaker-major rows of 8 frames (3 speakers, 8 rows each)
    order = np.argsort(s["spk"], kind="stable")
    rows = order.reshape(-1, 8)
    out["fmllr"] = _np(M.acc_fmllr_stats_sharded(mesh, NUM_SPK)(
        params, means, ivars, x[rows], pdfs[rows], w[rows], s["spk"][rows[:, 0]]))
    feats_by_utt = {f"u{i}": s["feats"][i] for i in range(B)}
    alis = {f"u{i}": list(s["tids"][i]) for i in range(B)}
    tree = acc_tree_stats(alis, feats_by_utt, s["tm"], mesh=mesh)
    out["tree_mesh"] = {k: (st.count, st.sum_x, st.sum_x2) for k, st in tree.items()}

    d = decode_inputs()
    step = M.decode_forward_sharded(mesh, d["plan"].packed, d["plan"].rspec)
    a, ae, bps = step(DC.plan_to_device(d["plan"], "cpu"), d["alpha"], d["alpha_end"], d["ll"],
                      d["nf"], d["acwt"])
    out["decode"] = _np((M.join_blocks(mesh, a, axis=1), M.join_blocks(mesh, ae, axis=1),
                         M.join_blocks(mesh, bps, axis=2)))

    nd = mesh.shape[M.DATA_AXIS]
    feats_p, ids_p, w_p = M.pad_to_mesh(mesh, x[:13], pdfs[:13])
    out["pad_to_mesh"] = (feats_p, ids_p, w_p)
    rng = np.random.default_rng(1)
    arc_data = {f"u{i}": rng.standard_normal((int(rng.integers(5, 40)), 13)).astype(np.float32)
                for i in range(30)}
    mine = D.host_shard(sorted(arc_data))
    arc = write_archive(Path(OUT_DIR) / f"arc{mesh.data_index}", arc_data)
    nf = {u: v.shape[0] for u, v in arc_data.items()}
    out["host_shard"] = mine
    local = D.global_batch(mesh, {"feats": s["feats"][:2], "nf": s["nf"][:2]})
    out["global_batch"] = {k: (v.device.type, _np(v)) for k, v in local.items()}
    out["bucket"] = D.bucket_by_length(nf, batch_size=8, max_pad_ratio=0.2)
    out["stream"] = list(D.stream_batches(arc, nf, batch_size=8, pad_multiple=nd))

    li = lda_mllt_inputs(s)
    topts = TriTrainOptions(num_iters=2, mllt_iters=(1,), realign_iters=(), num_leaves=20,
                            totgauss=40, max_iter_inc=1)
    _, final_mat = train_lda_mllt(li["base"], li["transcripts"], li["alignments"], s["lang"],
                                  topts, LdaOptions(dim=8), prev_trans_model=s["tm"],
                                  mesh=mesh, device="cpu")
    out["train_lda_mllt"] = final_mat
    return out


OUT_DIR = "."


def main(rank: int, world: int, store: str, out_dir: str) -> None:
    """Join the group (``file://`` store, ``gloo``), run the cases and write
    ``out_dir/rank<rank>.pkl``; on an error write the traceback instead."""
    global OUT_DIR
    OUT_DIR = out_dir
    torch.set_num_threads(1)
    from voicebridge_tpu_torch.utils.logging import get_logger

    get_logger().setLevel(logging.WARNING)
    result: dict
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        from voicebridge_tpu_torch.parallel import mesh as M

        result = run_cases(M.make_mesh(devices="cpu"))
        dist.barrier()
        dist.destroy_process_group()
    except Exception:  # reported by the test process
        result = {"error": traceback.format_exc()}
    with open(Path(out_dir) / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
