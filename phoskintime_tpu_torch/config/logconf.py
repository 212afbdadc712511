"""Coloured console and rotating file logging.

Counterpart of ``phoskintime_tpu/config/logconf.py``; the default logger
is named after the port, ``phoskintime_tpu_torch``.
"""

from __future__ import annotations

import logging
import logging.handlers
from pathlib import Path

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        base = super().format(record)
        return f"{color}{base}{_RESET}" if color else base


_LOGGERS: dict[str, logging.Logger] = {}


def setup_logger(name: str = "phoskintime_tpu_torch", log_dir: str | Path | None = None,
                 level: int = logging.INFO) -> logging.Logger:
    """Create (once) a logger with colored console and optional rotating file output."""
    key = f"{name}:{log_dir}"
    if key in _LOGGERS:
        return _LOGGERS[key]
    logger = logging.getLogger(name)
    logger.setLevel(level)
    logger.propagate = False
    # handlers are added per KIND, not gated on "any handler exists":
    # import-time console-only setup must not block a later
    # setup_logger(log_dir=...) from attaching the file handler (review:
    # the file was silently never written)
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        ch = logging.StreamHandler()
        ch.setFormatter(ColoredFormatter("%(asctime)s %(levelname)-7s %(message)s", "%H:%M:%S"))
        logger.addHandler(ch)
    if log_dir is not None:
        path = Path(log_dir) / f"{name}.log"
        already = any(isinstance(h, logging.handlers.RotatingFileHandler)
                      and Path(getattr(h, "baseFilename", "")) == path
                      for h in logger.handlers)
        if not already:
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            fh = logging.handlers.RotatingFileHandler(
                path, maxBytes=5_000_000, backupCount=3)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)-7s %(message)s"))
            logger.addHandler(fh)
    _LOGGERS[key] = logger
    return logger
