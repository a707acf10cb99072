"""HCLG graph compilation: decode graphs (mkgraph) and training graphs.

Counterparts: ``scr/utils/mkgraph.cpp`` (call trace SURVEY.md §3.3) and
``decoder/training-graph-compiler.{h,cc}`` via ``compile-train-graphs``.

    LG   = det*_log(L_disambig . G)  -> minimize -> push_special
    CLG  = C . LG (lazy context expansion)
    Ha   = H transducer (no self-loops, transition probs scaled)
    HCLGa= det*(Ha . CLG) -> rm disambig -> rm-eps-local -> minimize
    HCLG = add-self-loops(self_loop_scale, reorder)

Training graphs use the same pipeline with G = linear word acceptor of the
transcript (per utterance) and skip minimize/push (as the reference does).
"""

from __future__ import annotations

from ..data.lang import Lang
from ..models.transition import TransitionModel
from ..utils.logging import get_logger
from . import native_bridge
from .context import compose_context
from .core import Fst, linear_fst
from .hmm_graph import add_self_loops, make_h_transducer, remove_input_symbols
from .push import push_special

log = get_logger()


# the graph algebra runs in the native library (built at first use; the
# reference keeps this whole layer in C++).  The Python implementations in
# this package give the same FSTs and are held to it by the tests.
compose = native_bridge.compose
determinize_star = native_bridge.determinize_star
minimize_encoded = native_bridge.minimize_encoded
rm_eps_local = native_bridge.remove_eps_local


def _context_params(tree) -> tuple[int, int]:
    return tree.context_width, tree.central_position


def compile_lg(lang: Lang, g: Fst) -> Fst:
    """LG = pushspecial(minimizeencoded(det*_log(L_disambig . G)))
    (mkgraph.cpp:79-99)."""
    ld = lang.L_disambig.copy().arcsort("olabel")
    g = g.copy().arcsort("ilabel")
    lg = compose(ld, g)
    lg = determinize_star(lg, use_log=True)
    lg = minimize_encoded(lg)
    lg = push_special(lg)
    lg.arcsort("ilabel")
    return lg


def compile_hclg_from_lg(lg: Fst, lang: Lang, tree, trans_model: TransitionModel,
                         transition_scale: float = 1.0,
                         self_loop_scale: float = 0.1,
                         minimize: bool = True,
                         piece_cache: dict | None = None) -> Fst:
    n, p = _context_params(tree)
    phones = set(lang.phone_ids)
    disambig = set(lang.disambig_ids)
    clg, ilabel_info = compose_context(lg, phones, disambig, n, p)
    clg.arcsort("ilabel")
    ha, disambig_tids = make_h_transducer(ilabel_info, tree, trans_model,
                                          transition_scale, piece_cache)
    hclga = compose(ha, clg)
    hclga = determinize_star(hclga)
    remove_input_symbols(hclga, set(disambig_tids))
    hclga = rm_eps_local(hclga)
    if minimize:
        hclga = minimize_encoded(hclga)
    add_self_loops(hclga, trans_model, [], self_loop_scale)
    hclga.connect()
    return hclga


def mkgraph(lang: Lang, tree, trans_model: TransitionModel, g: Fst,
            transition_scale: float = 1.0, self_loop_scale: float = 0.1) -> Fst:
    """Full decode-graph build (MkGraph, mkgraph.cpp:21-341)."""
    lg = compile_lg(lang, g)
    ok, lo, hi = lg.is_stochastic()
    if not ok:
        log.info("mkgraph: LG not fully stochastic (residues %.4f..%.4f)", lo, hi)
    hclg = compile_hclg_from_lg(lg, lang, tree, trans_model,
                                transition_scale, self_loop_scale)
    if hclg.num_states == 0:
        raise RuntimeError("mkgraph produced an empty HCLG")
    log.info("mkgraph: HCLG states=%d arcs=%d", hclg.num_states, hclg.num_arcs)
    return hclg


class TrainingGraphCompiler:
    """Per-utterance training graphs (decoder/training-graph-compiler.h:57).

    Shares the context/H machinery across utterances of a batch; for mono
    (N=1) the H transducer is built once for all phones.
    """

    def __init__(self, lang: Lang, tree, trans_model: TransitionModel,
                 transition_scale: float = 1.0, self_loop_scale: float = 0.1):
        self.lang = lang
        self.tree = tree
        self.trans_model = trans_model
        self.transition_scale = transition_scale
        self.self_loop_scale = self_loop_scale
        self._ld = lang.L_disambig.copy().arcsort("olabel")
        self._piece_cache: dict = {}  # shared HMM pieces across utterances

    def compile(self, word_ids: list[int]) -> Fst:
        g = linear_fst(word_ids)
        lg = compose(self._ld, g)
        lg = determinize_star(lg, use_log=True)
        lg.arcsort("ilabel")
        return compile_hclg_from_lg(
            lg, self.lang, self.tree, self.trans_model,
            self.transition_scale, self.self_loop_scale, minimize=True,
            piece_cache=self._piece_cache)

    def compile_batch(self, transcripts: list[list[int]]) -> list[Fst]:
        return [self.compile(t) for t in transcripts]
