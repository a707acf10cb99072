"""Input pipeline helpers for the data-parallel path.

Port of ``voicebridge_tpu/parallel/data.py``: each rank loads only its shard
of the utterances (``host_shard``), pads its batches so that the mesh's data
axis divides them (``pad_to_multiple``), and reads length-bucketed batches
from a memory-mapped archive (``bucket_by_length``, ``stream_batches``;
numpy copies of the JAX package's, the same batches).  With one process
``host_shard`` is the identity, so the same code runs from one card to many.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def host_shard(items: list, process_index: int | None = None,
               process_count: int | None = None) -> list:
    """Deterministic per-rank utterance shard (round-robin over the sorted
    list, so that shards stay balanced across length distributions).  The
    rank and world size come from ``torch.distributed`` when it is
    initialized, else 0 and 1."""
    on = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if on else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if on else 1) if process_count is None else process_count
    return [x for i, x in enumerate(sorted(items)) if i % pc == pi]


def pad_to_multiple(batch_arrays: dict, multiple: int, pad_axis: int = 0) -> dict:
    """Pad the leading (utterance) axis to a multiple of the mesh's data size
    with zero rows (weights already mask padding)."""
    out = {}
    for k, v in batch_arrays.items():
        n = v.shape[pad_axis]
        target = -(-n // multiple) * multiple
        if target != n:
            pad = [(0, 0)] * v.ndim
            pad[pad_axis] = (0, target - n)
            v = np.pad(v, pad)
        out[k] = v
    return out


def global_batch(mesh, local_arrays: dict) -> dict:
    """This process's arrays as tensors on the mesh's device.  In the JAX
    package they are assembled into one data-axis-sharded global array; here
    each process holds only its own block and the sharded builders of
    ``mesh.py`` take global inputs, so there is no global array to
    assemble."""
    return {k: torch.as_tensor(v).to(mesh.device) for k, v in local_arrays.items()}


# ---------------------------------------------------------------------------
# Length-bucketed batching + streaming loader (LibriSpeech-scale input)
# ---------------------------------------------------------------------------


def bucket_by_length(num_frames: dict, batch_size: int,
                     max_pad_ratio: float = 0.2, seed: int = 0) -> list:
    """Group utterances into fixed-size batches with bounded padding waste.

    Sort by length, cut greedily whenever adding the next utterance would
    push mean padding above ``max_pad_ratio`` or the batch is full, then
    shuffle the *batches* (not the members) so that training order is
    randomized without re-introducing padding waste.

    Returns a list of (utt_list, t_pad) tuples.
    """
    order = sorted(num_frames, key=lambda u: (num_frames[u], u))
    batches = []
    cur: list = []
    for u in order:
        if cur:
            t_pad = num_frames[u]  # ascending order: candidate max
            waste = sum(t_pad - num_frames[x] for x in cur + [u])
            if len(cur) >= batch_size or \
                    waste > max_pad_ratio * t_pad * (len(cur) + 1):
                batches.append((cur, num_frames[cur[-1]]))
                cur = []
        cur.append(u)
    if cur:
        batches.append((cur, num_frames[cur[-1]]))
    rng = np.random.default_rng(seed)
    rng.shuffle(batches)
    return batches


def stream_batches(archive, num_frames: dict, batch_size: int,
                   max_pad_ratio: float = 0.2, seed: int = 0,
                   pad_multiple: int = 1):
    """Yield (utts, feats [B, T_pad, D], nf [B]) batches from an
    ``ArrayArchive`` without materializing the full dataset: the archive is
    memory-mapped, so each batch reads only its own rows.

    ``pad_multiple`` rounds the batch's utterance count up (zero-frame rows)
    so that the leading axis divides the mesh's data-parallel size.
    """
    for utts, t_pad in bucket_by_length(num_frames, batch_size,
                                        max_pad_ratio, seed):
        b = -(-len(utts) // pad_multiple) * pad_multiple
        first = archive[utts[0]]
        feats = np.zeros((b, t_pad, *first.shape[1:]), first.dtype)
        nf = np.zeros(b, np.int32)
        for i, u in enumerate(utts):
            f = archive[u]
            feats[i, : f.shape[0]] = f
            nf[i] = f.shape[0]
        yield utts, feats, nf
