"""The port and its chip smoke script import with jax unavailable, and the
explicit-device checks refuse what they must."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from voicebridge_tpu_torch import device as D

ROOT = Path(__file__).resolve().parent.parent

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys

class NoJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"{name} is blocked")

sys.meta_path.insert(0, NoJax())
import voicebridge_tpu_torch
names = [m.name for m in pkgutil.walk_packages(voicebridge_tpu_torch.__path__,
                                                "voicebridge_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
assert not (voicebridge_tpu_torch._build._lib), "importing must not build"
print(len(names), "modules")
"""


def test_imports_without_jax():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         capture_output=True, text=True, timeout=120, check=False)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[0]) >= 21


def test_resolve_device():
    assert D.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="explicit device"):
        D.resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        D.resolve_device("meta")


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        D.resolve_device("cuda")
