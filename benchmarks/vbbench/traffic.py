"""What every traffic kind shares, and the kinds found by name.  A traffic
mix is a JSON file ``benchmarks/traffic/<mix>.json`` whose ``kind`` names
its generator, ``benchmarks/traffic/<kind>.py``; the rest of the file is
the generator's parameters.  Everything is drawn from a ``torch.Generator``
seeded with the run's seed, on the run's device, in a few large calls: the
same seed gives the same traffic, and every seed gives the same sizes.

A decode kind has ``requests(spec, feat, gen, device)``, the pool of
requests a closed loop sends; a training kind has ``corpus(spec, model,
roots, gen, device)``, the training set.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

import torch

TRAFFIC_DIR = Path(__file__).resolve().parent.parent / "traffic"
_KINDS: dict = {}


def kind(name: str, traffic_dir: Path = TRAFFIC_DIR):
    """The generator module of the traffic kind ``name``:
    ``<traffic_dir>/<name>.py``."""
    if not re.fullmatch(r"[A-Za-z0-9_]{1,64}", name):
        raise ValueError(f"bad traffic kind {name!r}")
    path = Path(traffic_dir) / f"{name}.py"
    if path not in _KINDS:
        if not path.is_file():
            raise ValueError(f"no generator for traffic kind {name}: {path}")
        spec = importlib.util.spec_from_file_location(f"vbbench_traffic_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _KINDS[path] = mod
    return _KINDS[path]


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one stream of draws (waves, model, corpus, sample)
    of a run, so that adding a draw to one stream moves no other."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + stream * 7919) % (1 << 63))
    return gen


def uniform(gen, shape, lo, hi, device, dtype=torch.float64) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=device, dtype=dtype)


def fixed_set(draw, gen, device) -> torch.Tensor:
    """Sizes that every seed shares: ``draw(g)`` made with a generator of a
    constant seed, put in an order drawn from the run's ``gen``.  The seed
    changes which utterance or pdf gets which size, never the set of sizes,
    so every seed asks the same work of the card."""
    values = draw(generator(0, device, 99))
    return values[torch.randperm(len(values), generator=gen, device=device)]
