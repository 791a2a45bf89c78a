"""Logging mirroring the reference's ``thetis/log.py``: a package logger
plus a bare output logger with a memory buffer that can be replayed into
``outputs/log`` once the output directory is known (ref L75-147).

Copied from ``thetis_tpu/utils/log.py`` (plain Python); the logger names
differ, so both packages can log in one process without sharing
handlers or buffers, and a log file gets one handler however often it is
set.
"""
import logging
import sys

__all__ = ["logger", "output_logger", "print_output", "set_log_directory"]

logger = logging.getLogger("thetis_tpu_torch")
if not logger.handlers:
    h = logging.StreamHandler(sys.stderr)
    h.setFormatter(logging.Formatter("%(name)s:%(levelname)s %(message)s"))
    logger.addHandler(h)
    logger.setLevel(logging.INFO)

output_logger = logging.getLogger("thetis_tpu_torch_output")
if not output_logger.handlers:
    h = logging.StreamHandler(sys.stdout)
    h.setFormatter(logging.Formatter("%(message)s"))
    output_logger.addHandler(h)
    output_logger.setLevel(logging.INFO)

#: replayed into ``<outputdir>/log`` by :func:`set_log_directory`
_memory_buffer = []


def print_output(*args, **kwargs):
    """ref ``log.py:175``."""
    msg = " ".join(str(a) for a in args)
    _memory_buffer.append(msg)
    output_logger.info(msg)


def set_log_directory(path):
    """Attach a file handler replaying the memory buffer (ref L75-147);
    once per log file (a solver's ``iterate()`` calls this every time)."""
    import os

    os.makedirs(path, exist_ok=True)
    logfile = os.path.join(path, "log")
    if any(getattr(h, "baseFilename", None) == os.path.abspath(logfile)
           for h in output_logger.handlers):
        return
    fh = logging.FileHandler(logfile, mode="w")
    fh.setFormatter(logging.Formatter("%(message)s"))
    for msg in _memory_buffer:
        fh.emit(logging.LogRecord("thetis_tpu_torch_output", logging.INFO,
                                  "", 0, msg, None, None))
    output_logger.addHandler(fh)
