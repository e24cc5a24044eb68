"""Logging setup for the port's logger tree, ``lmrs_torch`` (a copy of the
reference's ``utils/logging.py``, which configures ``lmrs``).

Repeated ``setup_logging`` calls are honored: the managed handler's level,
stream, and format are UPDATED in place, so a later ``--quiet`` or a caller
moving logs to stderr takes effect after a library import configured
stdout; a swap away from a stream that was closed meanwhile works (the
reference's flush of it would raise).  Handlers installed by embedding
applications are left untouched.

``LMRS_LOG_JSON=1`` switches the managed handler to one JSON object per
line (``ts``/``level``/``logger``/``msg``, plus ``exc`` with a traceback);
the variable is re-read on every ``setup_logging`` call.
"""

from __future__ import annotations

import json
import logging
import sys

from lmrs_tpu_torch.utils.env import env_bool

ROOT = "lmrs_torch"
_FORMAT = "%(asctime)s - %(name)s - %(levelname)s - %(message)s"


class JsonFormatter(logging.Formatter):
    """One JSON object per line — machine-scrapable structured logs."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry, ensure_ascii=False)


def _managed_handler(root: logging.Logger) -> logging.StreamHandler | None:
    for h in root.handlers:
        if getattr(h, "_lmrs_managed", False):
            return h
    return None


def setup_logging(quiet: bool = False, level: int | None = None,
                  stream=None) -> None:
    """Configure the ``lmrs_torch`` logger tree.  quiet → WARNING.
    ``stream`` defaults to stdout; a caller whose stdout is machine-read
    (``chip_smoke.py``'s JSON lines) passes stderr.  Safe to call
    repeatedly — later calls update level/stream/format."""
    root = logging.getLogger(ROOT)
    formatter: logging.Formatter = (
        JsonFormatter() if env_bool("LMRS_LOG_JSON", False)
        else logging.Formatter(_FORMAT))
    handler = _managed_handler(root)
    if handler is None:
        # a pre-existing FOREIGN handler (an embedding app's) is respected:
        # only handlers created here are managed
        if not root.handlers:
            handler = logging.StreamHandler(stream if stream is not None
                                            else sys.stdout)
            handler._lmrs_managed = True
            root.addHandler(handler)
    elif stream is not None and stream is not handler.stream:
        if getattr(handler.stream, "closed", False):
            # setStream flushes the old stream first, and a closed one (a
            # caller that redirected stderr and closed it) would raise
            handler.stream = stream
        else:
            handler.setStream(stream)
    if handler is not None:
        handler.setFormatter(formatter)
    root.setLevel(level if level is not None
                  else (logging.WARNING if quiet else logging.INFO))
