"""Phonetic-context decision trees (pdf tying).

Counterparts: Kaldi ``ContextDependency`` (``tree/context-dep.h:59``) and the
``EventMap`` machinery (``tree/event-map.h``).  Two implementations:

* :class:`MonophoneTree` — the gmm-init-mono tree: each (phone, pdf_class)
  gets its own pdf, with optional shared-phone groups
  (``gmmbin/gmm-init-mono.cpp:89-98``).
* :class:`ContextTree` — N-phone context tree built from tree statistics by
  top-down entropy splitting (``build-tree.h``); the JAX package's
  ``models/treebuild.py`` builds one.

Both expose ``map(phone_window, pdf_class) -> pdf`` where ``phone_window`` is
the N-phone context (N=1 for mono, N=3/P=1 for triphone), and ``num_pdfs``.
"""

from __future__ import annotations

import json
from pathlib import Path


class MonophoneTree:
    def __init__(self, phone_sets: list[list[int]], pdf_classes_per_phone: dict[int, int]):
        """``phone_sets``: groups of phones sharing pdfs (normally singletons);
        ``pdf_classes_per_phone``: phone -> number of pdf classes (emitting
        states)."""
        self.context_width = 1
        self.central_position = 0
        self._map: dict[tuple[int, int], int] = {}
        num = 0
        for group in phone_sets:
            n_classes = max(pdf_classes_per_phone[p] for p in group)
            for c in range(n_classes):
                for p in group:
                    if c < pdf_classes_per_phone[p]:
                        self._map[(p, c)] = num + c
            num += n_classes
        self.num_pdfs = num

    def map_mono(self, phone: int, pdf_class: int) -> int:
        return self._map[(phone, pdf_class)]

    def map(self, phone_window: tuple, pdf_class: int) -> int:
        return self._map[(phone_window[self.central_position], pdf_class)]

    def possible_pdfs(self, phone: int, pdf_class: int) -> list:
        """All pdfs this (phone, pdf-class) can map to (GetPdfInfo role)."""
        p = self._map.get((phone, pdf_class))
        return [p] if p is not None else []

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps({
            "type": "mono",
            "map": [[p, c, v] for (p, c), v in sorted(self._map.items())],
            "num_pdfs": self.num_pdfs,
        }))

    @classmethod
    def load(cls, path: str | Path) -> "MonophoneTree":
        obj = json.loads(Path(path).read_text())
        t = cls.__new__(cls)
        t.context_width = 1
        t.central_position = 0
        t._map = {(p, c): v for p, c, v in obj["map"]}
        t.num_pdfs = obj["num_pdfs"]
        return t


class ContextTree:
    """N-phone context-dependency tree: a decision tree over event keys
    (context positions and pdf-class), stored as a flat node list.

    Node: ``{"key": k, "values": set, "yes": i, "no": j}`` internal or
    ``{"pdf": p}`` leaf.  Key -1 = pdf-class, 0..N-1 = phone at context
    position (matching Kaldi's event-key convention, event-map.h).
    """

    def __init__(self, context_width: int, central_position: int,
                 nodes: list[dict], num_pdfs: int):
        self.context_width = context_width
        self.central_position = central_position
        self.nodes = nodes
        self.num_pdfs = num_pdfs

    def map(self, phone_window: tuple, pdf_class: int) -> int:
        i = 0
        while True:
            node = self.nodes[i]
            if "pdf" in node:
                return node["pdf"]
            key = node["key"]
            val = pdf_class if key == -1 else phone_window[key]
            i = node["yes"] if val in node["values"] else node["no"]

    def map_mono(self, phone: int, pdf_class: int) -> int:
        # used when context window is just the phone (mono graph compilation)
        window = tuple(0 if i != self.central_position else phone
                       for i in range(self.context_width))
        return self.map(window, pdf_class)

    def possible_pdfs(self, phone: int, pdf_class: int) -> list:
        """All leaves reachable with the central phone and pdf-class fixed,
        context positions free (Kaldi ContextDependency::GetPdfInfo)."""
        out: set[int] = set()
        stack = [0]
        while stack:
            i = stack.pop()
            node = self.nodes[i]
            if "pdf" in node:
                out.add(node["pdf"])
                continue
            key = node["key"]
            if key == -1:
                stack.append(node["yes"] if pdf_class in node["values"]
                             else node["no"])
            elif key == self.central_position:
                stack.append(node["yes"] if phone in node["values"]
                             else node["no"])
            else:
                stack.append(node["yes"])
                stack.append(node["no"])
        return sorted(out)

    def save(self, path: str | Path) -> None:
        nodes = []
        for n in self.nodes:
            if "pdf" in n:
                nodes.append({"pdf": n["pdf"]})
            else:
                nodes.append({"key": n["key"], "values": sorted(n["values"]),
                              "yes": n["yes"], "no": n["no"]})
        Path(path).write_text(json.dumps({
            "type": "context",
            "N": self.context_width, "P": self.central_position,
            "nodes": nodes, "num_pdfs": self.num_pdfs,
        }))

    @classmethod
    def load(cls, path: str | Path) -> "ContextTree":
        obj = json.loads(Path(path).read_text())
        nodes = []
        for n in obj["nodes"]:
            if "pdf" in n:
                nodes.append({"pdf": n["pdf"]})
            else:
                nodes.append({"key": n["key"], "values": set(n["values"]),
                              "yes": n["yes"], "no": n["no"]})
        return cls(obj["N"], obj["P"], nodes, obj["num_pdfs"])


def load_tree(path: str | Path):
    obj = json.loads(Path(path).read_text())
    if obj["type"] == "mono":
        return MonophoneTree.load(path)
    return ContextTree.load(path)
