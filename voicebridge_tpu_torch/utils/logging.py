"""Twin logger: console + logfile, thread-safe.

Role of the reference's ``TwinLoggerMT`` (``kaldi-win/utility/TwinLoggerMT.h:15-43``):
every pipeline step logs to the console and to a per-project ``General.log`` (plus
per-step log files).  Here it is a thin wrapper over :mod:`logging` with helpers to
attach per-step log files, so steps can do ``with step_log(dir/'log'/'align.1.log'): ...``.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import threading
from pathlib import Path

_LOCK = threading.Lock()
_LOGGER = logging.getLogger("voicebridge_tpu_torch")


def get_logger() -> logging.Logger:
    with _LOCK:
        if not _LOGGER.handlers:
            handler = logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S")
            )
            _LOGGER.addHandler(handler)
            _LOGGER.setLevel(logging.INFO)
    return _LOGGER


def init_twin_log(logfile: str | Path, level: int = logging.INFO) -> logging.Logger:
    """Start twin logging (console + file), like TwinLoggerMT::init_log."""
    logger = get_logger()
    with _LOCK:
        Path(logfile).parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(logfile)
        fh.setFormatter(
            logging.Formatter("[%(asctime)s] %(levelname)s %(message)s", "%H:%M:%S")
        )
        logger.addHandler(fh)
        logger.setLevel(level)
    return logger


@contextlib.contextmanager
def step_log(logfile: str | Path):
    """Attach an extra per-step log file for the duration of a pipeline step
    (the reference writes e.g. ``traindir/log/align.{iter}.{job}.log``)."""
    logger = get_logger()
    Path(logfile).parent.mkdir(parents=True, exist_ok=True)
    fh = logging.FileHandler(logfile)
    fh.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
    logger.addHandler(fh)
    try:
        yield logger
    finally:
        logger.removeHandler(fh)
        fh.close()
