"""Data-parallel EM statistics over a ``torch.distributed`` device mesh.

Port of ``voicebridge_tpu/parallel/mesh.py``.  The JAX package is one SPMD
program over a ``jax.sharding.Mesh``: each ``shard_map`` takes global arrays,
runs on each device's block of the leading (or batch) axis and ``psum``\\ s the
statistics.  Here every rank is one process with one device, running the same
program, and keeps those semantics:

* every rank is given the same global inputs, as ``shard_map`` is;
* each rank computes on its own block of the leading axis (the lanes of the
  batch-minor decode slabs) and on no other rank's block;
* the statistics are summed over the mesh's ``"data"`` group with one
  ``all_reduce`` a call, so every rank returns the same reduced result;
* outputs the JAX package leaves sharded (the E-steps' ``alpha_end`` and
  ``bps``, the decode's ``alpha``, ``alpha_end`` and ``bps``) come back as the
  rank's own block; ``join_blocks`` joins them ("hypotheses join on the
  host").

Each statistic is reduced in float64, the dtype the port sums it in (K6's
sums, the transition counts, LDA, MLLT, fMLLR and tree statistics); the
builders hand the float64 sums back, and the ``mesh=`` branches of
``transforms/`` and ``models/treebuild.py`` convert them as their unsharded
functions do.  The per-shard bodies are the port's own functions and
kernels: K2 (``ops/gmm_kernel.py``), the generic aligner or K4, K6
(``ops/gmm_kernels.acc_gmm_stats_sums``), ``acc_transition_stats``'s sums,
``transforms/lda.lda_sums``, ``transforms/mllt._mllt_chunk``,
``transforms/fmllr.fmllr_sums`` and K3 (``ops/decode_core.viterbi_scan``).

A process group is needed: ``make_mesh`` makes a world-size-1 group on an
in-process store when none is initialized (single-host JAX degrades to the
identity the same way); more ranks are started by the caller, who gives
``init_process_group`` its store, world size and rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..device import ieee_fp32_entry, resolve_device
from ..ops import align_band as AB
from ..ops import decode_core as DC
from ..ops import gmm_kernel
from ..ops import gmm_kernels as K
from ..ops import viterbi as V
from ..ops.gmm_kernels import GmmParams

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """This rank's view of a ``("data", "model")`` device mesh: the
    ``DeviceMesh``, the rank's device, ``shape`` as a dict (so that
    ``mesh.shape[DATA_AXIS]`` reads as it does in JAX), the rank's index
    along ``"data"`` and that axis's process group."""

    def __init__(self, device_mesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(device_mesh.mesh_dim_names, device_mesh.mesh.shape))
        self.data_index = device_mesh.get_local_rank(DATA_AXIS)
        self.data_group = device_mesh.get_group(DATA_AXIS)
        self.backend = dist.get_backend(self.data_group)


def make_mesh(num_data: int | None = None, num_model: int = 1, devices=None) -> Mesh:
    """The mesh of every rank of the process group, ``num_data`` x
    ``num_model`` (``num_data`` defaults to the world size over
    ``num_model``).  ``devices`` is this rank's device: ``None`` means
    ``cuda:<rank>``, and a CUDA device that does not exist raises.  With no
    process group initialized, a world-size-1 group is made on an in-process
    store (``gloo`` for the CPU, ``nccl`` for a card): no address is read
    and no port opened."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = resolve_device(f"cuda:{rank}" if devices is None else devices)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"a {num_data} x {num_model} mesh needs {num_data * num_model} "
                         f"ranks, the process group has {world}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(init_device_mesh(device.type, (num_data, num_model),
                                 mesh_dim_names=(DATA_AXIS, MODEL_AXIS)), device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _tensor(x, device: torch.device):
    return x.to(device) if isinstance(x, GmmParams) else torch.as_tensor(x).to(device)


def _block(mesh: Mesh, x, axis: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` (which the data axis must
    divide, as ``shard_map`` requires), on the mesh's device."""
    x = torch.as_tensor(x)
    nd = mesh.shape[DATA_AXIS]
    n = x.shape[axis]
    if n % nd:
        raise ValueError(f"axis {axis} of size {n} does not divide over {nd} ranks")
    return x.narrow(axis, mesh.data_index * (n // nd), n // nd).to(mesh.device).contiguous()


def shard_batch(mesh: Mesh, tree):
    """This rank's block of the leading axis of every array or tensor in
    ``tree``, on the mesh's device (data-parallel)."""
    return _map(lambda x: _block(mesh, x), tree)


def replicate(mesh: Mesh, tree):
    """Every array, tensor or ``GmmParams`` in ``tree``, whole, on the mesh's
    device."""
    return _map(lambda x: _tensor(x, mesh.device), tree)


def all_reduce_stats(mesh: Mesh, tensors) -> list:
    """Sum float64 tensors over the data group in ONE ``all_reduce`` (the
    ``psum``).  Returns new tensors of the same shapes on their device.
    ``gloo`` reduces host tensors: statistics on a card are copied to the
    host for it and back, the same reduction."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    if mesh.backend == "gloo" and flat.device.type != "cpu":
        host = flat.cpu()
        dist.all_reduce(host, group=mesh.data_group)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat, group=mesh.data_group)
    out, lo = [], 0
    for t in tensors:
        out.append(flat[lo:lo + t.numel()].view(t.shape))
        lo += t.numel()
    return out


def join_blocks(mesh: Mesh, block: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The ranks' equal-sized blocks of a sharded output joined along
    ``axis`` in rank order, on every rank (``all_gather``; for tests and for
    a host that wants the whole)."""
    src = block.contiguous()
    if mesh.backend == "gloo" and src.device.type != "cpu":
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.shape[DATA_AXIS])]
    dist.all_gather(parts, src, group=mesh.data_group)
    return torch.cat(parts, dim=axis).to(block.device)


def pad_to_mesh(mesh: Mesh, feats, ids, weights=None):
    """Pad frame-major ``feats [N, ...]`` and ``ids [N]`` so that the data
    axis divides N, returning (feats, ids, weights) with weight 0 on the
    padding rows (so that they add nothing to any reduced statistic).
    Numpy in, numpy out; tensors in, tensors out on the features' device."""
    n = feats.shape[0]
    nd = mesh.shape[DATA_AXIS]
    n_pad = -(-max(n, 1) // nd) * nd
    if isinstance(feats, torch.Tensor):
        dev = feats.device
        ids = torch.as_tensor(ids).to(dev)
        w = (torch.ones(n, dtype=torch.float32, device=dev) if weights is None
             else torch.as_tensor(weights).to(dev, torch.float32))
        if n_pad != n:
            feats = torch.cat([feats, feats.new_zeros((n_pad - n,) + tuple(feats.shape[1:]))])
            ids = torch.cat([ids, ids.new_zeros(n_pad - n)])
            w = torch.cat([w, w.new_zeros(n_pad - n)])
        return feats, ids, w
    w = (np.ones(n, np.float32) if weights is None else np.asarray(weights, np.float32))
    if n_pad != n:
        feats = np.concatenate([feats, np.zeros((n_pad - n,) + feats.shape[1:], feats.dtype)])
        ids = np.concatenate([ids, np.zeros(n_pad - n, ids.dtype)])
        w = np.concatenate([w, np.zeros(n_pad - n, np.float32)])
    return feats, ids, w


def _estep_stats(params: GmmParams, feats: torch.Tensor, tids, pdf_ids, weights,
                 num_pdfs: int, num_tids: int) -> list:
    """One rank's float64 E-step sums of the given alignment (K6 and the
    transition counts): [occ, mean_acc, var_acc, tstats, ll]."""
    b, t, d = feats.shape
    x = feats.reshape(b * t, d)
    w = weights.reshape(-1).to(torch.float32)
    occ, macc, vacc, ll = K.acc_gmm_stats_sums(params, x, x, pdf_ids.reshape(-1), num_pdfs, w)
    tstats = K.transition_sums(tids.reshape(-1), num_tids, w)
    return [occ, macc, vacc, tstats, ll]


def em_estep_sharded(mesh: Mesh, num_states: int, num_pdfs: int, num_tids: int):
    """The mesh-sharded EM E-step over per-utterance graphs:

    step(params, arc_src, arc_dst, arc_pdf, arc_score, alpha0 (``pad_graphs``
    arrays [B, A] / [B, S]), feats [B, T, D], num_frames [B], tids, pdf_ids,
    weights [B, T], acwt) -> (alpha_end [B/n, S], bps [T, B/n, S] (this
    rank's utterances), occ, mean_acc, var_acc, tstats, ll (float64, summed
    over the data axis)).

    Each rank scores its utterances with K2 and runs the generic aligner over
    them (``ops/viterbi.viterbi_forward_batched``, exact search); the
    statistics come from the given (previous) alignment, through K6, as in
    the reference's EM loop.  The JAX package passes its graphs' reduction
    ``levels``; the port's aligner reads ``arc_dst`` in their place (a CSR by
    destination), and the operand lists differ there alone."""

    @ieee_fp32_entry
    def step(params, arc_src, arc_dst, arc_pdf, arc_score, alpha0, feats, num_frames, tids,
             pdf_ids, weights, acwt):
        p = replicate(mesh, params)
        arcs = shard_batch(mesh, (arc_src, arc_dst, arc_pdf, arc_score, alpha0))
        x, nf, tid, pdf, w = shard_batch(mesh, (feats, num_frames, tids, pdf_ids, weights))
        x = x.to(torch.float32)
        ll = gmm_kernel.loglikes_batch(x, p)
        alpha_end, bps = V.viterbi_forward_batched(*arcs, ll, nf, float(acwt), 1e9, num_states)
        stats = _estep_stats(p, x, tid, pdf, w, num_pdfs, num_tids)
        return (alpha_end, bps, *all_reduce_stats(mesh, stats))

    return step


def em_estep_sharded_banded(mesh: Mesh, num_pdfs: int, num_tids: int, offsets):
    """The banded variant of :func:`em_estep_sharded` (the production
    alignment path, K4): step(params, W [B, S, K], pdf [B, S], alpha0
    [B, S], feats, num_frames, tids, pdf_ids, weights, acwt) -> (alpha_end
    [B/n, S] in band-plan state order, bps [T, B/n, S] uint8 band slots,
    occ, mean_acc, var_acc, tstats, ll).  ``offsets`` is the plan's band
    offset tuple.  The JAX package's constraint on T (<= 128 or a multiple
    of 128) belongs to its scan's chunking and does not apply here."""
    offs = [int(o) for o in offsets]

    @ieee_fp32_entry
    def step(params, w_band, pdf_band, alpha0, feats, num_frames, tids, pdf_ids, weights,
             acwt):
        p = replicate(mesh, params)
        wb, pb, a0 = shard_batch(mesh, (w_band, pdf_band, alpha0))
        x, nf, tid, pdf, w = shard_batch(mesh, (feats, num_frames, tids, pdf_ids, weights))
        x = x.to(torch.float32)
        ll = gmm_kernel.loglikes_batch(x, p)
        alpha_end, bps = AB.viterbi_forward_banded(
            wb.to(torch.float32), pb.to(torch.int32), a0.to(torch.float32), ll,
            nf.to(torch.int32), float(acwt),
            torch.tensor(offs, dtype=torch.int32, device=mesh.device))
        stats = _estep_stats(p, x, tid, pdf, w, num_pdfs, num_tids)
        return (alpha_end, bps, *all_reduce_stats(mesh, stats))

    return step


def acc_lda_stats_sharded(mesh: Mesh, num_pdfs: int):
    """Mesh-sharded LDA accumulation (the reference sums per-job
    ``lda.JOBID.acc`` files, ``train_lda_mllt.cpp:305-376``): frames sharded
    over the data axis.  -> acc(feats [N, D], pdf_ids [N], weights [N]) ->
    float64 (counts [C], mean_acc [C, D], scatter [D, D]), the sums of
    ``transforms/lda.lda_sums`` over every rank."""
    from ..transforms.lda import lda_sums

    @ieee_fp32_entry
    def acc(feats, pdf_ids, weights):
        x, ids, w = shard_batch(mesh, (feats, pdf_ids, weights))
        return tuple(all_reduce_stats(mesh, lda_sums(x.to(torch.float32), ids, w, num_pdfs)))

    return acc


def _block_share(mesh: Mesh, n: int, block: int) -> slice:
    """This rank's frames when ``n`` frames are cut into blocks of ``block``
    from the first and the blocks are shared out in order, as evenly as they
    go."""
    nb, nd, r = -(-n // block), mesh.shape[DATA_AXIS], mesh.data_index
    return slice(min(n, r * nb // nd * block), min(n, (r + 1) * nb // nd * block))


def acc_mllt_stats_sharded(mesh: Mesh):
    """Mesh-sharded MLLT accumulation (per-job ``m.JOBID.macc`` summed by
    est-mllt, ``train_lda_mllt.cpp:694-``): frames sharded over the data
    axis in whole blocks of ``transforms/mllt.SUB_FRAMES`` (the blocks of
    the unsharded function, whose fp32 products are summed in float64: each
    rank's blocks give the same bits, and only the float64 sums' order
    differs).  -> acc(params, means [P, M, D], inv_vars, feats [N, D],
    pdf_ids [N], weights [N]) -> float64 (G [D, D, D], beta 0-d)."""
    from ..transforms.mllt import SUB_FRAMES, _mllt_chunk

    @ieee_fp32_entry
    def acc(params, means, inv_vars, feats, pdf_ids, weights):
        p, mu, iv = replicate(mesh, (params, means, inv_vars))
        share = _block_share(mesh, feats.shape[0], SUB_FRAMES)
        x, ids, w = (torch.as_tensor(a)[share].to(mesh.device)
                     for a in (feats, pdf_ids, weights))
        g, beta = _mllt_chunk(p, mu.to(torch.float32), iv.to(torch.float32),
                              x.to(torch.float32), ids.to(torch.int64), w.to(torch.float32))
        return tuple(all_reduce_stats(mesh, [g, beta]))

    return acc


def acc_fmllr_stats_sharded(mesh: Mesh, num_speakers: int):
    """Mesh-sharded per-speaker fMLLR accumulation (per-job fMLLR accs
    composed per speaker, ``train_sat.cpp:906-954``).  Rows of a
    speaker-major layout are sharded over the data axis: every frame of a
    row belongs to one speaker, each rank sums its rows into their speaker
    slots (float64 segment sums, ``transforms/fmllr.fmllr_sums``), and the
    reduction merges disjoint slots.

    -> acc(params, means, inv_vars, feats [R, T, D], pdf_ids [R, T], weights
    [R, T] (0 on padding), spk_slot [R]) -> float64 (beta [S], K [S, D,
    D+1], G [S, D, D+1, D+1]).  Unlike the JAX package's sharded form, which
    sums in float32, the sums stay in float64 to the end."""
    from ..transforms.fmllr import fmllr_sums

    @ieee_fp32_entry
    def acc(params, means, inv_vars, feats, pdf_ids, weights, spk_slot):
        p, mu, iv = replicate(mesh, (params, means, inv_vars))
        x, ids, w, slot = shard_batch(mesh, (feats, pdf_ids, weights, spk_slot))
        r, t, d = x.shape
        spk = slot.to(torch.int64).repeat_interleave(t)
        sums = fmllr_sums(p, mu.to(torch.float32), iv.to(torch.float32),
                          x.reshape(r * t, d).to(torch.float32), ids.reshape(-1),
                          w.reshape(-1).to(torch.float32), spk, num_speakers)
        return tuple(all_reduce_stats(mesh, sums))

    return acc


def acc_tree_stats_sharded(mesh: Mesh, num_events: int):
    """Mesh-sharded tree-statistics accumulation (per-job ``JOBID.treeacc``
    summed by sum-tree-stats, ``train_deltas.cpp:294``): frames sharded over
    the data axis, per-event Gaussian sums by ``index_add_`` in float64 on
    the device (the squares taken in float32, as the unsharded numpy sums
    take them).  Event ids are built on the host
    (``models/treebuild.frame_event_ids``).

    -> acc(feats [N, D], event_ids [N], weights [N]) -> float64 (count [E],
    sum_x [E, D], sum_x2 [E, D])."""

    def acc(feats, event_ids, weights):
        x, ids, w = shard_batch(mesh, (feats, event_ids, weights))
        x, ids, w = x.to(torch.float32), ids.to(torch.int64), w.to(torch.float64)
        d = x.shape[1]
        cnt = torch.zeros(num_events, dtype=torch.float64, device=mesh.device)
        sx = torch.zeros((num_events, d), dtype=torch.float64, device=mesh.device)
        sx2 = torch.zeros((num_events, d), dtype=torch.float64, device=mesh.device)
        cnt.index_add_(0, ids, w)
        sx.index_add_(0, ids, x.double() * w[:, None])
        sx2.index_add_(0, ids, (x * x).double() * w[:, None])
        return tuple(all_reduce_stats(mesh, [cnt, sx, sx2]))

    return acc


def decode_forward_sharded(mesh: Mesh, packed: bool, rspec: tuple):
    """Mesh-sharded decode forward over a replicated graph: K3
    (``ops/decode_core.viterbi_scan``) over this rank's lanes of the
    batch-minor slabs, with no communication (each rank advances its own
    utterances; hypotheses join on the host).

    -> step(dev: EmitPlanDev, alpha [S+1, B], alpha_end [S+1, B], loglikes
    [B, T, P], num_frames [B], acwt) -> (alpha [S+1, B/n], alpha_end
    [S+1, B/n], bps [T, S+1, B/n]) for this rank's lanes."""

    def step(dev, alpha, alpha_end, loglikes, num_frames, acwt):
        plan = replicate(mesh, dev)
        a = _block(mesh, alpha, axis=1).to(torch.float32)
        ae = _block(mesh, alpha_end, axis=1).to(torch.float32)
        ll = _block(mesh, loglikes).to(torch.float32).permute(1, 2, 0).contiguous()
        nf = _block(mesh, num_frames).to(torch.int32)
        (a, ae), bps = DC.viterbi_scan(plan, a, ae, ll, nf, 0, float(np.float32(acwt)), rspec,
                                       packed)
        return a, ae, bps

    return step
