"""Device handling: every entry point of the port runs on the card unless
the caller asks for the CPU, and nothing falls back from CUDA to the CPU."""

from __future__ import annotations

import contextlib
import functools
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


@contextlib.contextmanager
def ieee_fp32():
    """Run fp32 products in IEEE fp32 whatever the caller set, and give the
    caller's settings back on exit.

    ``torch.set_float32_matmul_precision("high")`` or ``allow_tf32`` let
    cuBLAS round fp32 inputs to TF32 (10 mantissa bits); the port's
    statistics, transforms and features are held to float64 and to the JAX
    package's HIGHEST-precision products, so its entry points enter this
    context.  It switches through the API the caller's state reads in: the
    legacy setters (``set_float32_matmul_precision``, cuDNN's
    ``allow_tf32``), which keep the legacy and the per-backend
    ``fp32_precision`` settings in step, unless the caller set the
    per-backend settings alone (torch then refuses the legacy getters), and
    then those.  Torch refuses a matmul whose two settings disagree, so the
    context never sets one without the other.  The flags are process-wide;
    setting them for the span of a call and restoring them is enough
    because the port never runs these products from several threads at
    once.  The hand kernels do not read the flags (K2 does its own
    3xTF32)."""
    try:
        legacy = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    except RuntimeError:  # the caller set the per-backend settings alone: keep to them
        backends = [b for b in (torch.backends.cuda.matmul, torch.backends.cudnn)
                    if hasattr(b, "fp32_precision")]
        saved = [b.fp32_precision for b in backends]
        try:
            for b in backends:
                b.fp32_precision = "ieee"
            yield
        finally:
            for b, value in zip(backends, saved):
                b.fp32_precision = value
        return
    try:
        torch.set_float32_matmul_precision("highest")
        torch.backends.cudnn.allow_tf32 = False
        yield
    finally:
        torch.set_float32_matmul_precision(legacy[0])
        torch.backends.cudnn.allow_tf32 = legacy[1]


def ieee_fp32_entry(fn):
    """Decorator: ``fn`` runs inside ``ieee_fp32()``."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with ieee_fp32():
            return fn(*args, **kwargs)

    return wrapper
