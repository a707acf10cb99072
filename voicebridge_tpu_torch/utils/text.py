"""Symbol tables and text mapping utilities.

Covers the reference's ``words.txt``/``phones.txt`` symbol-table files and the
``sym2int``/``int2sym``/``apply_map`` utilities
(``kaldi-win/scr/utils/{sym2int.cpp,int2sym.cpp,apply_map.cpp}``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Sequence


class SymbolTable:
    """Bidirectional string<->int table, serialized as ``symbol id`` lines."""

    def __init__(self):
        self._sym2id: dict[str, int] = {}
        self._id2sym: dict[int, str] = {}

    @classmethod
    def from_symbols(cls, symbols: Iterable[str], start: int = 0) -> "SymbolTable":
        t = cls()
        for i, s in enumerate(symbols):
            t.add(s, start + i)
        return t

    def add(self, sym: str, idx: int | None = None) -> int:
        if sym in self._sym2id:
            if idx is not None and self._sym2id[sym] != idx:
                raise ValueError(f"symbol {sym!r} already has id {self._sym2id[sym]}")
            return self._sym2id[sym]
        if idx is None:
            idx = max(self._id2sym, default=-1) + 1
        if idx in self._id2sym:
            raise ValueError(f"id {idx} already bound to {self._id2sym[idx]!r}")
        self._sym2id[sym] = idx
        self._id2sym[idx] = sym
        return idx

    def __contains__(self, sym: str) -> bool:
        return sym in self._sym2id

    def __len__(self) -> int:
        return len(self._sym2id)

    def id(self, sym: str) -> int:
        return self._sym2id[sym]

    def get(self, sym: str, default: int | None = None) -> int | None:
        return self._sym2id.get(sym, default)

    def sym(self, idx: int) -> str:
        return self._id2sym[idx]

    def symbols(self) -> list[str]:
        return [self._id2sym[i] for i in sorted(self._id2sym)]

    def items(self):
        return sorted(self._id2sym.items())

    def max_id(self) -> int:
        return max(self._id2sym, default=-1)

    # -- serialization (same text format as OpenFst symbol tables) ----------
    def write(self, path: str | Path) -> None:
        with open(path, "w") as f:
            for idx, sym in self.items():
                f.write(f"{sym} {idx}\n")

    @classmethod
    def read(cls, path: str | Path) -> "SymbolTable":
        t = cls()
        for line in Path(path).read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            if len(parts) != 2:
                raise ValueError(f"bad symbol-table line: {line!r}")
            t.add(parts[0], int(parts[1]))
        return t


def sym2int(
    table: SymbolTable,
    words: Sequence[str],
    map_oov: int | None = None,
) -> list[int]:
    """Map symbols to ints; unknown symbols map to ``map_oov`` if given
    (reference: ``sym2int.cpp`` with ``--map-oov``)."""
    out = []
    for w in words:
        i = table.get(w)
        if i is None:
            if map_oov is None:
                raise KeyError(f"symbol {w!r} not in table and no map_oov given")
            i = map_oov
        out.append(i)
    return out


def int2sym(table: SymbolTable, ids: Sequence[int]) -> list[str]:
    return [table.sym(i) for i in ids]
