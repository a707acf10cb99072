"""The port, its chip smoke script and its examples import with jax and the
JAX package unavailable, and the device checks refuse what they must."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from voicebridge_tpu_torch import device as D

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "voicebridge_tpu")


class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, NoJax())
import voicebridge_tpu_torch
names = [m.name for m in pkgutil.walk_packages(voicebridge_tpu_torch.__path__,
                                                "voicebridge_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("transforms.fmllr", "steps.train_sat", "steps.decode_fmllr", "project",
             "testing.corpus", "testing.synthesis", "utils.profiling", "ops.pitch",
             "steps.get_prons", "lm.interp", "models.full_gmm", "transforms.regtree",
             "transforms.basis_fmllr", "parallel", "parallel.mesh", "parallel.data"):
    assert "voicebridge_tpu_torch." + name in names, name
import chip_smoke
sys.path.insert(0, "examples")
for name in ("yesno_synthetic_torch", "full_pipeline_synthetic_torch",
             "librispeech_shaped_torch"):
    importlib.import_module(name)
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
assert not (voicebridge_tpu_torch._build._lib), "importing must not build"
print(len(names), "modules")
"""


def test_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 86


def test_resolve_device():
    assert D.resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert D.resolve_device(None) == torch.device("cuda", 0)
    else:  # no device means the card, and there is none
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            D.resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        D.resolve_device("meta")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.resolve_device("cuda")


def test_every_cuda_source_is_built():
    """Each ``csrc/*.cu`` is in ``_build.SOURCES`` (``lattice_lane.cu``
    among them), so the library the smoke builds holds every kernel."""
    from voicebridge_tpu_torch import _build

    cu = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    assert "lattice_lane.cu" in cu
    assert sorted(_build.SOURCES) == cu
    assert set(_build._SIGNATURES) >= {"vbt_lattice_lane_forward", "vbt_lattice_lane_backward"}


def _imports_convert(path: Path) -> bool:
    """Whether the module at ``path`` imports the port's ``convert``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if module.split(".")[-1] == "convert" or (
                    module in ("", "voicebridge_tpu_torch")
                    and any(a.name == "convert" for a in node.names)):
                return True
        elif isinstance(node, ast.Import):
            if any(a.name == "voicebridge_tpu_torch.convert" for a in node.names):
                return True
    return False


def test_no_layer_of_the_port_imports_convert():
    """``convert.py`` brings the JAX package's arrays to the tests and
    ``testing/``; the layers of the program, from the models up to the
    steps, do not import it (``testing/`` does, which shows the check
    sees such an import)."""
    pkg = ROOT / "voicebridge_tpu_torch"
    paths = [p for d in ("ops", "steps", "transforms", "parallel", "lat", "models")
             for p in sorted((pkg / d).rglob("*.py"))]
    assert len(paths) > 40
    assert [str(p.relative_to(pkg)) for p in paths if _imports_convert(p)] == []
    assert _imports_convert(pkg / "testing" / "__init__.py")
