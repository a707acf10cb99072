"""Lattice types and algebra on the host (numpy copies of
``voicebridge_tpu/lat``; the device forward-backward that fills them is
``ops/lattice.py``)."""

from .determinize import (CompactLattice, DetStateLimitError,
                          determinize_lattice_pruned,
                          determinize_lattice_pruned_safe)
from .lattice import (Lattice, build_lattices, build_lattices_packed,
                      build_lattices_sparse,
                      lattice_best_path, lattice_best_path_grid,
                      lattice_depth_per_frame, lattice_nbest, lattice_to_post,
                      lattice_mbr, rescore_lattice_acoustics)

__all__ = [
    "Lattice", "build_lattices", "build_lattices_packed",
    "build_lattices_sparse", "lattice_best_path",
    "lattice_best_path_grid", "lattice_to_post",
    "lattice_nbest", "lattice_depth_per_frame", "lattice_mbr",
    "rescore_lattice_acoustics", "CompactLattice", "DetStateLimitError",
    "determinize_lattice_pruned", "determinize_lattice_pruned_safe",
]
