"""Tests of the benchmark harness.  CPU tests run the harness on a tiny copy
of the cells (``tiny_bench``); tests marked ``card`` need the NVIDIA card and
skip without one, decided inside the ``card`` fixture.

    python -m pytest benchmarks/tests -q            # CPU, about a minute
    python -m pytest benchmarks/tests -q -m card    # on the card
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
for entry in (str(ROOT), str(BENCH)):
    if entry not in sys.path:
        sys.path.insert(0, entry)

# Sizes of the tiny cells: every width a run reads, cut to what the CPU's
# plain versions of the kernels run in seconds.
TINY = {
    "configs/tri1-libri.json": {"model": {"num_pdfs": 40, "num_gauss": 80},
                                "graph": {"num_states": 300, "max_jump": 16}},
    "traffic/batch128_10s.json": {"batch_utts": 4, "speakers": 2, "frames": 40,
                                  "pool_batches": 2, "warmup_batches": 1},
    "workloads/tri1.lattice.json": {"check": {"batches": 1, "utts_per_batch": 2}},
    "configs/tri2b-libri.json": {"model": {"num_pdfs": 60, "num_gauss": 150},
                                 "topology": {"num_phones": 10},
                                 "train_set": {"num_utts": 12}},
    "traffic/train10k_2to20s.json": {"seconds": [0.5, 2.0]},
    "workloads/tri2b.train_realign.json": {"check": {"utts": 6}},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs the NVIDIA card; skips without one")


def _merge(obj: dict, over: dict) -> dict:
    for k, v in over.items():
        obj[k] = _merge(obj[k], v) if isinstance(v, dict) and isinstance(obj.get(k), dict) else v
    return obj


def copy_bench(dst: Path, sizes: dict | None = None) -> Path:
    """A copy of the benchmark's data files, readers and ``BENCHMARK.json``
    under ``dst`` (``dst/benchmarks``), with ``sizes`` merged into its
    files; returns the copy's ``benchmarks`` directory."""
    b = dst / "benchmarks"
    for sub in ("configs", "workloads", "traffic", "metrics", "layers"):
        shutil.copytree(BENCH / sub, b / sub)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for rel, over in (sizes or {}).items():
        path = b / rel
        path.write_text(json.dumps(_merge(json.loads(path.read_text()), over)))
    return b


@pytest.fixture(scope="session")
def tiny_bench(tmp_path_factory) -> Path:
    return copy_bench(tmp_path_factory.mktemp("tiny"), TINY)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the NVIDIA card")
    return torch.device("cuda", 0)
