"""Parameter conversion into the port's layouts.

The JAX package's parameters arrive as numpy arrays (``np.asarray`` of its
device arrays, or the arrays of its host objects) or as the npz/json files
both packages write, so both packages can compute from identical numbers and
this module imports nothing of the JAX package:

* GMM arrays ``means_invvars, inv_vars, weights`` -> the port's ``AmDiagGmm``
  (``am_from_arrays``), and from there its device form ``GmmParams``
  (``ops.gmm_kernels.pack_gmm``);
* flat arc arrays -> the port's ``Fst`` (``fst_from_arrays``);
* the json objects of a topology, a tree and a transition model -> the
  port's ``HmmTopology``, tree and ``TransitionModel`` (``*_from_json``);
* a splice+LDA(+MLLT) matrix (``final.mat.npy``) -> a checked float32
  affine array (``final_mat_from_array``);
* a SAT model (its AM, ``alimdl``, topology, tree and transition model, and
  its per-speaker fMLLR transforms as a dict) -> the port's ``SatModel``
  (``sat_model_from_arrays``), the transforms as one ``[S, D, D+1]`` array
  in sorted speaker order (``transforms_from_dict``);
* the JAX ``GmmParams`` (``w_matrix [2D, P*M]``, ``gconsts [P, M]``) and the
  Pallas ``w3 [128, M, P_pad]`` -> the port's ``GmmParams``;
* a JAX ``EmitPlan`` -> the port's ``EmitPlan`` (then
  ``ops.decode_core.plan_to_device``);
* a JAX ``BandPlan`` -> the port's ``BandPlan`` (then
  ``ops.align_band.plan_to_device``);
* a full-covariance GMM (``weights, means, inv_covars``), a regression tree
  (``bclass_of, parent, num_leaves``) and an fMLLR basis (``bases,
  precond``) -> the port's ``FullGmm``, ``RegressionTree`` and
  ``FmllrBasis`` (``full_gmm_from_arrays``, ``regression_tree_from_arrays``,
  ``fmllr_basis_from_arrays``); the two packages' npz files of a
  ``FullGmm`` and an ``FmllrBasis`` are the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .fst.core import Fst
from .models.full_gmm import FullGmm
from .models.gmm import AmDiagGmm
from .models.topology import HmmTopology, TopologyState
from .models.transition import TransitionModel
from .models.tree import ContextTree, MonophoneTree
from .ops.align_band import BandPlan
from .ops.decode_core import EmitPlan
from .ops.gmm_kernels import DEAD, GmmParams
from .steps.train_mono import TrainedModel
from .steps.train_sat import SatModel
from .transforms.basis_fmllr import FmllrBasis
from .transforms.regtree import RegressionTree


def am_from_arrays(means_invvars: np.ndarray, inv_vars: np.ndarray,
                   weights: np.ndarray) -> AmDiagGmm:
    """The three arrays of a diagonal GMM (``[P, M, D]``, ``[P, M, D]``,
    ``[P, M]``; what ``am.npz`` holds) -> the port's ``AmDiagGmm``."""
    return AmDiagGmm(np.array(means_invvars, np.float32), np.array(inv_vars, np.float32),
                     np.array(weights, np.float32))


def fst_from_arrays(src, ilabel, olabel, weight, nextstate, finals, start: int) -> Fst:
    """Flat arc arrays (``Fst.to_arrays`` order), per-state final weights and
    the start state (what ``Fst.save`` writes) -> the port's ``Fst``."""
    f = Fst()
    f.add_states(len(finals))
    f.finals = [float(x) for x in finals]
    f.start = int(start)
    for s, i, o, w, ns in zip(src, ilabel, olabel, weight, nextstate):
        f.add_arc(int(s), int(i), int(o), float(w), int(ns))
    return f


def topology_from_json(obj: dict) -> HmmTopology:
    """The object ``HmmTopology.save`` writes -> the port's ``HmmTopology``."""
    return HmmTopology({
        int(p): tuple(TopologyState(s["pdf_class"],
                                    tuple((n, pr) for n, pr in s["transitions"]))
                      for s in states)
        for p, states in obj.items()})


def tree_from_json(obj: dict):
    """The object a tree's ``save`` writes -> ``MonophoneTree`` or
    ``ContextTree`` of the port."""
    if obj["type"] == "mono":
        t = MonophoneTree.__new__(MonophoneTree)
        t.context_width = 1
        t.central_position = 0
        t._map = {(p, c): v for p, c, v in obj["map"]}
        t.num_pdfs = obj["num_pdfs"]
        return t
    nodes = [{"pdf": n["pdf"]} if "pdf" in n else
             {"key": n["key"], "values": set(n["values"]), "yes": n["yes"], "no": n["no"]}
             for n in obj["nodes"]]
    return ContextTree(obj["N"], obj["P"], nodes, obj["num_pdfs"])


def transition_model_from_json(topo: dict, tree: dict, trans: dict) -> TransitionModel:
    """The three json objects of a transition model (topology, tree, and the
    ``tuples``/``log_probs`` that ``TransitionModel.save`` writes) -> the
    port's ``TransitionModel``."""
    tm = TransitionModel(topology_from_json(topo), tree_from_json(tree))
    if [tuple(t) for t in trans["tuples"]] != tm.tuples:
        raise ValueError("transition tuples do not match the topology and tree")
    tm.log_probs = np.asarray(trans["log_probs"], dtype=np.float32)
    return tm


def final_mat_from_array(mat) -> np.ndarray:
    """The feature transform an LDA stage saves (``final.mat.npy``; affine
    ``[E, D+1]``) -> float32 ``[E, D+1]`` array, checked finite and
    affine."""
    mat = np.array(mat, np.float32)
    if mat.ndim != 2 or mat.shape[1] < 2 or not np.isfinite(mat).all():
        raise ValueError(f"need a finite affine matrix [E, D+1], got shape {mat.shape}")
    return mat


def transforms_from_dict(transforms: dict) -> tuple[list, np.ndarray]:
    """Per-speaker affine transforms ``{speaker: [D, D+1]}`` (what
    ``train_sat`` returns) -> (speakers sorted, float32 ``[S, D, D+1]``),
    checked finite and of one affine shape."""
    speakers = sorted(transforms)
    mats = np.array([np.asarray(transforms[s], np.float32) for s in speakers], np.float32)
    if (mats.ndim != 3 or mats.shape[2] != mats.shape[1] + 1
            or not np.isfinite(mats).all()):
        raise ValueError(f"need finite affine transforms [S, D, D+1], got shape {mats.shape}")
    return speakers, mats


def sat_model_from_arrays(am: tuple, alimdl: tuple, topo: dict, tree: dict, trans: dict,
                          lang, transforms: dict):
    """A SAT model trained elsewhere (``am`` and ``alimdl`` as the three GMM
    arrays each, the json objects of its topology, tree and transition
    model, the ``Lang``, and ``{speaker: [D, D+1]}``) -> the port's
    ``steps/train_sat.SatModel``."""
    tm = transition_model_from_json(topo, tree, trans)
    speakers, mats = transforms_from_dict(transforms)
    return SatModel(model=TrainedModel(am_from_arrays(*am), tm, tm.tree, lang, aligner=""),
                    alimdl=am_from_arrays(*alimdl), transforms=dict(zip(speakers, mats)))


def _gmm(w: np.ndarray, device) -> GmmParams:
    """``w [P, M, 2D+1]`` (rows ``[miv, -0.5*iv, gconst]``) -> ``GmmParams``
    on ``device``, its live components those of the host's gconsts."""
    w = np.ascontiguousarray(w, np.float32)
    return GmmParams(torch.tensor(w, device=device), w[..., -1] > DEAD)


def gmm_from_jax(w_matrix: np.ndarray, gconsts: np.ndarray, device) -> GmmParams:
    """JAX ``GmmParams`` arrays -> the port's ``GmmParams``."""
    gconsts = np.asarray(gconsts, np.float32)
    w = np.asarray(w_matrix, np.float32).T.reshape(*gconsts.shape, -1)
    return _gmm(np.concatenate([w, gconsts[..., None]], axis=2), device)


def gmm_from_pallas(w3: np.ndarray, num_pdfs: int, dim: int, device) -> GmmParams:
    """Pallas ``w3 [K, M, P_pad]`` (rows ``[miv, -0.5*iv, gconst, 0...]``)
    -> the port's ``GmmParams``."""
    return _gmm(np.transpose(np.asarray(w3, np.float32)[: 2 * dim + 1, :, :num_pdfs],
                             (2, 1, 0)), device)


def emit_plan_from_jax(plan) -> EmitPlan:
    """A JAX ``EmitPlan`` (a NamedTuple of numpy arrays) -> the port's."""
    return EmitPlan(**{f: getattr(plan, f) for f in EmitPlan._fields})


def band_plan_from_jax(plan) -> BandPlan:
    """A JAX ``BandPlan`` (a NamedTuple of numpy arrays) -> the port's."""
    return BandPlan(**{f: getattr(plan, f) for f in BandPlan._fields})


def full_gmm_from_arrays(weights, means, inv_covars):
    """A full-covariance GMM's arrays (``[P, M]``, ``[P, M, D]``, ``[P, M, D,
    D]``; what its npz holds) -> the port's ``FullGmm``."""
    return FullGmm(np.array(weights, np.float64), np.array(means, np.float64),
                   np.array(inv_covars, np.float64))


def regression_tree_from_arrays(bclass_of, parent, num_leaves: int):
    """A regression tree's arrays (``bclass_of [P, M]``, ``parent [nodes]``)
    and leaf count -> the port's ``RegressionTree``."""
    return RegressionTree(np.array(bclass_of, np.int32), np.array(parent, np.int32),
                          int(num_leaves))


def fmllr_basis_from_arrays(bases, precond):
    """An fMLLR basis' arrays (``bases [N, D, D+1]``, ``precond [D, D+1,
    D+1]``; what its npz holds) -> the port's ``FmllrBasis``."""
    return FmllrBasis(bases=np.array(bases, np.float64), precond=np.array(precond, np.float64))
