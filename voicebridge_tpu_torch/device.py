"""Device handling: every entry point of the port runs on the card unless
the caller asks for the CPU, and nothing falls back from CUDA to the CPU."""

from __future__ import annotations

import os

import torch


def resolve_device(device) -> torch.device:
    """Validate a device (``None``, ``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a
    ``torch.device``).  ``None`` means the card, ``cuda:0``.  A CUDA device
    must exist; an index-less one becomes the current CUDA device."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"device {dev} does not exist")
    return torch.device("cuda", index)


def free_bytes(device: torch.device) -> int:
    """Memory free on ``device`` now: the CUDA allocator's view of the card,
    or the host's available physical memory for the CPU."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
