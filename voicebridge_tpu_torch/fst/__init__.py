"""Host-side WFST toolbox.

A compact re-design of the graph side of the reference (OpenFst 1.6 +
Kaldi fstext, SURVEY.md §2.2/§2.4): enough weighted finite-state machinery to
build L, G, C, H and the composed HCLG decoding/training graphs, plus the
lattice semiring utilities.  Graph *compilation* is offline and stays on the
host; only the compiled graph's flat arc arrays ship to the decoder on the
card (`ops/graph.py`, `ops/decode_core.py`).
"""

from .core import NO_STATE_ID, Arc, Fst, ZERO
from .compose import compose
from .determinize import determinize_star
from .minimize import minimize_encoded
from .epsilon import remove_eps_local, rm_epsilon
from .misc import randgen, replace, topsort
from .shortest import shortest_distance, shortest_path
